// Gather convolution over a neighbour map for Hopper (sm_90a).
//
// Replaces: the Pallas kernel of occuseg_tpu/ops/pallas/gather_conv.py
// (`gather_conv_pallas` -> `_pallas_conv` -> `_kernel`), which computes
//
//   out[m] = sum_k (nbr_kn[k, m] >= 0 ? feats[nbr_kn[k, m]] : 0) @ W[k]
//
// for feats [N, Cin], the transposed map nbr_kn [K, M] int32 and W [K, Cin,
// Cout], with f32 accumulation and the output [M, Cout] in the feature
// dtype. M = N for a submanifold map; a strided convolution's child map
// has M coarse output rows over N fine source rows, a deconvolution's up
// map the reverse, and the gather convolution's d_feats runs this kernel
// over the transpose map with the roles of M and N swapped again. The TPU
// kernel keeps a whole level's features resident in VMEM and permutes them
// per offset (the one gather Mosaic lowers), which limits it
// to Cin % 128 == 0 and small levels. Here each block gathers its rows
// straight from device memory, so any Cin and Cout that are multiples of 8
// are taken.
//
// What bounds it on the H100: 2*Cin*Cout FLOP per valid (row, offset) pair
// against one gathered row of Cin elements per pair; at Cin = Cout = 256 in
// bf16 that is 256 FLOP per byte gathered, near the ridge, and the gathered
// rows of a coarse level fit in L2. The first version (WMMA 16x16x16,
// synchronous 16-byte gathers, two block barriers per offset and Cin tile)
// took 3.5x the chunk convolution (chunk_conv.cu) on the same levels: it
// was bound by its loads and barriers, not by the tensor cores.
//
// Design, bf16 (the chunk-conv forward's machinery, chunk_conv.cuh):
//  * one block of two warpgroups per (128 output rows, NT output columns,
//    split), NT = 64, 96 or 128 (the wrapper's `chunk_conv.col_tile`);
//    the grid, the tiles and the split are sized by the output rows M,
//    only the validity of an id by the source rows N;
//  * the tile's neighbour ids for every offset go to shared memory once,
//    by 4-byte cp.async, all in flight together (a -1, an id out of range
//    and a row past M are all missing); the warps then mark, per offset,
//    which 64-row half has a neighbour, and warp 0 lists the live offsets
//    in ascending order. An offset whose 128 ids are all -1 is
//    skipped whole: no gather, no W load, no MMA. The padded rows of a
//    level (past num_active) have no neighbour, so their tiles do no steps;
//  * a step is (live offset k, Cin tile of 64 columns), k ascending, then
//    Cin ascending. Its A tile, the 128 gathered rows, goes into a 128-byte
//    swizzled buffer by cp.async, 16 bytes a thread, with the zero-fill
//    form (src-size 0) for a missing neighbour and the columns past Cin: no
//    branch; its W[k] tile comes by TMA (a 3D tensor map of W [K, Cin,
//    Cout], zeros past Cin and Cout) onto an mbarrier. Three stages: step
//    s + 2's gather and W are in flight while step s is multiplied. One
//    block barrier a step publishes the gathered rows and frees the stage
//    the step before used;
//  * each warpgroup reads its A fragments with ldmatrix from the swizzled
//    rows and runs wgmma m64nNTk16 with B the swizzled W stage, in f32
//    registers; a half with no neighbour at k skips its MMAs;
//  * coarse levels, where the row and column tiles would leave SMs idle:
//    the wrapper splits each tile's steps into `splits` ranges, one block
//    each, launched as one thread-block cluster. Each block leaves its f32
//    partial in its shared memory; block r of the cluster then sums rows
//    r*128/S.. of all S partials in rank order through distributed shared
//    memory and writes them once, in bf16. One launch, no scratch in
//    device memory, and a fixed order: two launches give the same bits.
// What bounds it now (H100, the bench plan's L3-L5): the per-step
// skeleton. Without its MMAs a step still takes ~1.1 us at every level
// (`tools/conv_variants.py` gather_no_mma: -24 to -31%), the blocks' fixed
// cost (ids, liveness, the split's reduction, the launch) is ~0.010 ms at
// L5 (gather_no_steps), and every block reloads the W tiles it needs,
// where the chunk convolution stages each chunk's distinct rows once per
// Cin tile and reuses them over the 27 offsets.
// f32 (the training CLI's normal-guided convolutions; wgmma takes no f32)
// keeps the first version: one block
// (8 warps) per (64 output rows, 64 output columns); per offset and Cin
// tile of 32 columns the block gathers the [64, 32] A tile and the
// [32, 64] tile of W[k] with synchronous 16-byte loads, and each thread
// keeps a 4 x 4 register tile (FMA, exact products).

#include <cooperative_groups.h>

#include "chunk_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- bf16: wgmma over gathered rows ----

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kTile = 128;       // output rows per block
constexpr int kCiT = 64;         // Cin columns per step: one 128-byte row
constexpr int kStages = 3;       // the ring of (A, W) stages
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

struct GcArgs {
  const bf16* feats;
  const int32_t* nbr_kn;
  bf16* out;
  int N, cin, K, cout;
  int M;  // output rows (nbr_kn is [K, M]); N counts the source rows
};

// Shared memory plan shared by host and device, from a 1024-byte aligned
// base (the 128-byte swizzle needs it). After the steps, the ring holds
// the block's f32 partial [kTile, kLdp] when the steps are split.
template <int NT>
struct GcLayout {
  static constexpr int kBoxes = (NT + 63) / 64;  // 64-column W boxes
  static constexpr int kABytes = kTile * kBox;   // 128 swizzled rows
  static constexpr int kBoxBytes = kCiT * kBox;
  static constexpr int kStageBytes = kABytes + kBoxes * kBoxBytes;
  static constexpr int kLdp = NT + 8;  // partial row stride, in floats
  static_assert(kTile * kLdp * 4 <= kStages * kStageBytes,
                "the partial fits in the ring");
  size_t bar_off, ids_off, halves_off, klist_off, total;
  __host__ __device__ GcLayout(int K) {
    size_t off = static_cast<size_t>(kStages) * kStageBytes;
    bar_off = off;
    off += align128(kStages * sizeof(uint64_t) + sizeof(int));  // + n_live
    ids_off = off;
    off += align128(static_cast<size_t>(K) * kTile * sizeof(int32_t));
    halves_off = off;  // per offset: its live 64-row halves
    off += align128(static_cast<size_t>(K));
    klist_off = off;  // live offsets (k, half mask), ascending
    off += align128(static_cast<size_t>(K) * 2);
    total = off + 1024;  // room to align the base
  }
};

__device__ __forceinline__ bool valid_id(int id, int N) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(N);
}

template <int NT>
__global__ void __launch_bounds__(kWgThreads, 2)
gather_conv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                         const GcArgs a) {
  using L = GcLayout<NT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const L lay(a.K);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  int* n_live_s = reinterpret_cast<int*>(full + kStages);
  int32_t* ids_s = reinterpret_cast<int32_t*>(smem + lay.ids_off);
  uint8_t* halves_s = smem + lay.halves_off;
  uint8_t* klist_s = smem + lay.klist_off;  // [K][2]: k, half mask

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int N = a.N, M = a.M, K = a.K, cin = a.cin;
  const int r0 = blockIdx.x * kTile, co0 = blockIdx.y * NT;
  const int ncols = min(NT, a.cout - co0);
  const int n_cit = (cin + kCiT - 1) / kCiT;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    mbar_fence_init();
  }
  // the tile's neighbour ids, offset-major, all in flight at once; a row
  // past M is -1 (ids out of [0, N) are read as -1 where they are used)
  for (int i = t; i < K * kTile; i += kWgThreads) {
    const int row = r0 + i % kTile;
    if (row < M)
      cp_async4(ids_s + i, a.nbr_kn + static_cast<size_t>(i / kTile) * M + row);
    else
      ids_s[i] = -1;
  }
  cp_async_wait_all();
  __syncthreads();
  // each warp marks its offsets' live 64-row halves; then warp 0 lists
  // the live offsets in ascending order
  for (int k = warp; k < K; k += kWgThreads / 32) {
    const int32_t* ik = ids_s + k * kTile;
    const bool lo = __any_sync(kFull, valid_id(ik[lane], N) ||
                                          valid_id(ik[lane + 32], N));
    const bool hi = __any_sync(kFull, valid_id(ik[lane + 64], N) ||
                                          valid_id(ik[lane + 96], N));
    if (lane == 0) halves_s[k] = static_cast<uint8_t>(lo | (hi << 1));
  }
  __syncthreads();
  if (warp == 0) {
    int n_live = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int mine = k0 + lane < K ? halves_s[k0 + lane] : 0;
      const unsigned live = __ballot_sync(kFull, mine != 0);
      if (mine) {
        const int pos = n_live + __popc(live & ((1u << lane) - 1));
        klist_s[2 * pos] = static_cast<uint8_t>(k0 + lane);
        klist_s[2 * pos + 1] = static_cast<uint8_t>(mine);
      }
      n_live += __popc(live);
    }
    if (lane == 0) *n_live_s = n_live;
  }
  __syncthreads();
  // this block's range of the tile's steps (live offset, Cin tile)
  const int n_steps = *n_live_s * n_cit;
  const int j0 = static_cast<int>(static_cast<long long>(n_steps) * rank / S);
  const int n = static_cast<int>(static_cast<long long>(n_steps) * (rank + 1) /
                                 S) - j0;
  const int nbox = min(L::kBoxes, (ncols + 63) / 64);

  // step i of the range into ring stage i % kStages: every thread gathers
  // 4 of the tile's 1024 16-byte pieces, thread 0 starts the W boxes
  auto issue = [&](int i) {
    const int j = j0 + i, st = i % kStages;
    const int k = klist_s[2 * (j / n_cit)], ci0 = (j % n_cit) * kCiT;
    unsigned char* a_st = smem + st * L::kStageBytes;
    const int c = t & 7, col = ci0 + c * 8;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = (t >> 3) + 32 * q;
      const int id = ids_s[k * kTile + r];
      const bool ok = valid_id(id, N) && col < cin;
      cp_async16_zfill(a_st + swz(r, c),
                       ok ? a.feats + static_cast<size_t>(id) * cin + col
                          : a.feats,
                       ok ? 16 : 0);
    }
    if (t == 0) {
      mbar_arrive_expect_tx(full + st, nbox * L::kBoxBytes);
      for (int b = 0; b < nbox; ++b)
        tma_load_3d(a_st + L::kABytes + b * L::kBoxBytes, &wmap,
                    co0 + b * 64, ci0, k, full + st);
    }
  };

  // warpgroup g holds rows g*64..+64 and all NT columns; warp w of it
  // reads the A fragments of rows g*64 + (w % 4)*16..+16
  const int g = warp >> 2, row0 = g * 64 + (warp & 3) * 16;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();  // one group per step, empty past the range
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's pieces of step i
    __syncthreads();  // everyone's pieces; step i-1's stage is free
    if (i + kStages - 1 < n) issue(i + kStages - 1);
    cp_async_commit();
    const int j = j0 + i, st = i % kStages;
    const int halves = klist_s[2 * (j / n_cit) + 1];
    const int ci0 = (j % n_cit) * kCiT;
    mbar_wait(full + st, (i / kStages) & 1);
    __syncwarp();  // wgmma wants the warp converged
    if (!((halves >> g) & 1)) continue;  // uniform over the warpgroup
    const unsigned char* a_st = smem + st * L::kStageBytes;
    const int kk_n = min(kCiT / 16, (cin - ci0 + 15) / 16);
    const int r = row0 + (lane & 15);
    uint32_t af[kCiT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kCiT / 16; ++kk)
      if (kk < kk_n)
        ldmatrix_x4(af[kk], smem_u32(a_st + swz(r, 2 * kk + (lane >> 4))));
    const uint32_t w0 = smem_u32(a_st + L::kABytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCiT / 16; ++kk)
      if (kk < kk_n)
        wgmma_bf16<NT>(acc, af[kk],
                       wgmma_desc_b128(w0 + kk * 16 * kBox, L::kBoxBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(af);
    fence_regs(acc);
  }

  // the accumulator fragment: acc[4j + 2h + e] is row row0 + lane/4 + 8h,
  // column 8j + 2(lane % 4) + e of the tile
  if (S == 1) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      if (j * 8 >= ncols) continue;
      const int col = co0 + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + row0 + (lane >> 2) + h * 8;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(
              a.out + static_cast<size_t>(row) * a.cout + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }
  // split: the partial into the (now idle) ring, then block `rank` sums
  // its rows of all S partials in rank order
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(
          part + (row0 + (lane >> 2) + h * 8) * L::kLdp + j * 8 +
          (lane & 3) * 2) = make_float2(acc[4 * j + 2 * h],
                                        acc[4 * j + 2 * h + 1]);
  cluster.sync();
  const int m0 = kTile * rank / S, m1 = kTile * (rank + 1) / S;
  const int vpr = ncols / 4;
  for (int i = t; i < (m1 - m0) * vpr; i += kWgThreads) {
    const int m = m0 + i / vpr, c4 = (i % vpr) * 4;
    float* p = part + m * L::kLdp + c4;
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, 0));
    for (int q = 1; q < S; ++q) {
      const float4 w =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, q));
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    if (r0 + m < M) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(
          a.out + static_cast<size_t>(r0 + m) * a.cout + co0 + c4) = packed;
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int NT>
int launch_wgmma(const GcArgs& a, const void* w, int splits,
                 cudaStream_t stream) {
  // W [K, cin, cout] as a 3D tensor; one box is 64 rows of Cin by 128
  // bytes of Cout, swizzled, with zeros past Cin and Cout
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.cout),
                              static_cast<cuuint64_t>(a.cin),
                              static_cast<cuuint64_t>(a.K)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(a.cout) * sizeof(bf16),
      static_cast<cuuint64_t>(a.cin) * a.cout * sizeof(bf16)};
  const cuuint32_t box[3] = {kBox / sizeof(bf16), kCiT, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const EncodeTiled encode = encoder();
  if (encode == nullptr ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(w), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -4;
  const GcLayout<NT> lay(a.K);
  const int smem = static_cast<int>(lay.total);
  if (smem > max_dynamic_smem()) return -5;
  auto kernel = gather_conv_wgmma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.M + kTile - 1) / kTile, (a.cout + NT - 1) / NT,
                     splits);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = splits;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, wmap, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: the first version's FMA kernel ----

namespace fma {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // output rows per block
constexpr int kCols = 64;   // output columns per block
constexpr int kCiT = 32;    // Cin columns per tile

template <typename T>
struct Tiles {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16 B
  static constexpr int kLda = kCiT + kVec;      // A tile row stride
  static constexpr int kLdb = kCols + kVec;     // B tile row stride
};

// A tile: output rows r0.. (of M), columns ci0.. of feats [N, cin]
// gathered through nbr_kn[k].
template <typename T>
__device__ void load_a(T* a_s, const T* __restrict__ feats, int N, int M,
                       int cin, const int32_t* __restrict__ nbr_k, int r0,
                       int ci0) {
  using S = Tiles<T>;
  constexpr int kVpr = kCiT / S::kVec;
  for (int i = threadIdx.x; i < kRows * kVpr; i += kThreads) {
    const int m = i / kVpr, col = ci0 + (i % kVpr) * S::kVec;
    const int r = r0 + m;
    const int src = r < M ? nbr_k[r] : -1;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (src >= 0 && src < N && col < cin)
      v = *reinterpret_cast<const uint4*>(feats + static_cast<size_t>(src) * cin +
                                          col);
    *reinterpret_cast<uint4*>(a_s + m * S::kLda + (i % kVpr) * S::kVec) = v;
  }
}

// B tile: W[k][ci0..ci0+kCiT][co0..co0+kCols], zero past Cin / Cout.
template <typename T>
__device__ void load_b(T* b_s, const T* __restrict__ w, int k, int cin,
                       int cout, int ci0, int co0) {
  using S = Tiles<T>;
  constexpr int kVpr = kCols / S::kVec;
  for (int i = threadIdx.x; i < kCiT * kVpr; i += kThreads) {
    const int ci = ci0 + i / kVpr, col = co0 + (i % kVpr) * S::kVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ci < cin && col < cout)
      v = *reinterpret_cast<const uint4*>(
          w + (static_cast<size_t>(k) * cin + ci) * cout + col);
    *reinterpret_cast<uint4*>(b_s + (i / kVpr) * S::kLdb +
                              (i % kVpr) * S::kVec) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
gather_conv_f32_kernel(const float* __restrict__ feats, int N, int cin,
                       const int32_t* __restrict__ nbr_kn, int K, int M,
                       const float* __restrict__ w, int cout,
                       float* __restrict__ out) {
  using S = Tiles<float>;
  __shared__ __align__(16) float a_s[kRows * S::kLda];
  __shared__ __align__(16) float b_s[kCiT * S::kLdb];
  const int r0 = blockIdx.x * kRows, co0 = blockIdx.y * kCols;
  // thread tile: rows rg*4..+4, columns cg*4..+4 of the 64 x 64 block
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float acc[4][4];
  for (int r = 0; r < 4; ++r)
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int32_t* nbr_k = nbr_kn + static_cast<size_t>(k) * M;
    for (int ci0 = 0; ci0 < cin; ci0 += kCiT) {
      __syncthreads();
      load_a<float>(a_s, feats, N, M, cin, nbr_k, r0, ci0);
      load_b<float>(b_s, w, k, cin, cout, ci0, co0);
      __syncthreads();
      for (int ci = 0; ci < kCiT; ++ci) {
        const float4 b =
            *reinterpret_cast<const float4*>(b_s + ci * S::kLdb + cg * 4);
        for (int r = 0; r < 4; ++r) {
          const float a = a_s[(rg * 4 + r) * S::kLda + ci];
          acc[r][0] = fmaf(a, b.x, acc[r][0]);
          acc[r][1] = fmaf(a, b.y, acc[r][1]);
          acc[r][2] = fmaf(a, b.z, acc[r][2]);
          acc[r][3] = fmaf(a, b.w, acc[r][3]);
        }
      }
    }
  }
  const int col = co0 + cg * 4;
  if (col >= cout) return;
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + rg * 4 + r;
    if (row >= M) break;
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * cout + col) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

}  // namespace fma

}  // namespace

extern "C" {

// out [M, cout] = sum_k feats[nbr_kn[k]] @ w[k] (see the header); feats
// [N, cin], nbr_kn [K, M], w [K, cin, cout] in one dtype, cin and cout
// multiples of 8.
// bf16 runs in column tiles of nt (64, 96, 128) and `splits` (1-8) ranges
// of steps per tile, one cluster; f32 ignores both. Returns a
// cudaError_t, -2 when cin or cout is not a multiple of 8, -3 for an
// unsupported nt or splits, -4 when the tensor-map encoder is missing or
// refuses W, -5 when K's neighbour ids do not fit in shared memory.
int occ_gather_conv(const void* feats, int N, int cin, const void* nbr_kn,
                    int K, int M, const void* w, int cout, int nt,
                    int splits, void* out, int is_bf16, void* stream) {
  if (cin % 8 || cout % 8) return -2;
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (splits < 1 || splits > kMaxSplits) return -3;
    const GcArgs a{static_cast<const bf16*>(feats),
                   static_cast<const int32_t*>(nbr_kn),
                   static_cast<bf16*>(out), N, cin, K, cout, M};
    switch (nt) {
      case 64: return launch_wgmma<64>(a, w, splits, s);
      case 96: return launch_wgmma<96>(a, w, splits, s);
      case 128: return launch_wgmma<128>(a, w, splits, s);
    }
    return -3;
  }
  const dim3 grid((M + fma::kRows - 1) / fma::kRows,
                  (cout + fma::kCols - 1) / fma::kCols);
  fma::gather_conv_f32_kernel<<<grid, fma::kThreads, 0, s>>>(
      static_cast<const float*>(feats), N, cin,
      static_cast<const int32_t*>(nbr_kn), K, M, static_cast<const float*>(w),
      cout, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
