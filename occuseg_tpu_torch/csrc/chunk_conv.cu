// Chunk convolution forward for Hopper (sm_90a).
//
// Replaces: the Pallas forward kernel of occuseg_tpu/ops/pallas/chunk_conv.py
// (`_pallas_fwd` -> `_make_fwd_kernel` + `_build_g`, staged by the XLA gather
// `_stage`), which runs every submanifold (K=27), strided (child map, K=8)
// and deconvolution (up map, K=8) layer of the UNet forward:
//
//   out[c*M+m] = sum_k (lidx[c,k,m] >= 0 ? feats[in_idx[c, lidx[c,k,m]]] : 0)
//                      @ W[k]
//
// with f32 accumulation and the output in the feature dtype. The same kernel
// computes d_feats of the fused backward over the transpose plan
// (chunk_conv_bwd.cu). The TPU kernel permutes the staged rows with one-hot
// MXU products because Mosaic cannot gather rows; that formulation is not
// carried over: here the rows are gathered from shared memory directly.
//
// What bounds it on the H100: per chunk, M*K*Cin*Cout*2 FLOP against ~U*Cin
// staged input rows and M*Cout output elements, ~470 FLOP/byte at the bench
// L0 shape, above the bf16 ridge (~295), so a good kernel is tensor-core
// bound. Its first version (one block per 64 columns, WMMA) was bound by
// latency: per offset it copied an [M, CI_T] A tile inside shared memory,
// loaded W[k] with synchronous global loads and synchronised the block.
// This one still runs at ~25% of the tensor cores' dense rate: the staging
// of each Cin tile stops the block (only the other resident block covers
// it), and the A gathers read rows at random strides (bank conflicts).
// Every block reads all of W for its columns (W is not shared across
// chunks), but with W loaded only once per block the bench step measured
// ~3% faster: W traffic is not what bounds it.
//
// Design:
//  * one block per (chunk, NT-column tile, split): two warpgroups (8
//    warps). NT is 64, 96 or 128 in bf16 (the wrapper's `col_tile`), so
//    the chunk's rows are staged once per Cin tile for up to 128 columns;
//  * per Cin tile of CI_T columns the chunk's referenced rows (pad slots
//    skipped) are staged with 16-byte cp.async at a padded stride, with the
//    zero row at U that every missing neighbour (lidx = -1) points at;
//  * thread 0 streams the W[k] tiles of the block's (Cin tile, k) steps
//    through a ring of kStages stages: one TMA load per 128-byte-wide box
//    of a 2D tensor map of W [K*Cin, Cout] (128-byte swizzle, zeros past
//    Cout), completing on mbarriers; each warp releases a stage with one
//    arrive, and thread 0 refills it once all have. No global load sits on
//    the warps' path and there is no block-wide barrier per offset.
//    (Row-by-row bulk copies, 64 per stage, measured ~2x slower at L0: the
//    copy engine's cost per request set the pace. A separate producer warp
//    made 9 warps a block, capped the registers at 96 with spills, and
//    measured ~4% slower);
//  * bf16: warpgroup g owns rows g*64..+64 and all NT columns. Its warps
//    gather their A fragments with ldmatrix straight from the staged rows,
//    every lane's row address read from lidx (no A-tile copy), and the
//    group runs wgmma m64nNTk16 with A from registers and B = the swizzled
//    W stage through a shared-memory descriptor, accumulating in f32
//    registers. An (offset, 64-row group) with no valid reference is
//    skipped: a table of these flags is built once per chunk. (mma.sync
//    m16n8k16 from ldmatrix fragments of the same stage measured 12.05 ms
//    per bench step against 8.69 for wgmma; issuing a step's wgmma before
//    the previous one completes, with two sets of A fragments, measured
//    ~10% slower: the stage it holds is refilled a step later);
//  * f32 (the training CLI, parity checks): exact FMA products, each thread
//    an 8 x 4 register tile reading the staged rows through lidx (NT=64),
//    skipping the same dead groups;
//  * coarse levels, where chunks x column tiles would leave SMs idle: the
//    wrapper splits the (Cin tile, k) steps into `splits` ranges, one per
//    block; each writes an f32 partial and a second launch sums them in
//    split order and rounds to the feature dtype (deterministic);
//  * CI_T is the largest of 64/32/16 that divides Cin and whose shared
//    memory fits the device's opt-in limit; beyond it the call fails (the
//    wrapper raises) -- there is no other path;
//  * a chunk with no referenced row (all cap padding) writes zeros.

#include <type_traits>

#include "chunk_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // two warpgroups
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;                 // W ring depth

struct FwdArgs {
  const void* feats;
  const int32_t* in_idx;
  const int32_t* lidx;
  void* out;    // [C*M, cout], feature dtype (splits == 1)
  float* part;  // [splits, C*M, cout] f32 (splits > 1)
  int n_rows, cin, C, U, K, M, cout, splits;
};

// Shared memory plan shared by host and device, from a 1024-byte aligned
// base (the 128-byte swizzle of the W boxes needs it).
template <typename T, int CI_T, int NT>
struct FwdLayout {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLdg = CI_T + kVec;              // staged row stride
  static constexpr int kBoxCols = kBox / sizeof(T);     // columns per box
  static constexpr int kBoxes = (NT + kBoxCols - 1) / kBoxCols;
  static constexpr int kBoxBytes = CI_T * kBox;
  static constexpr int kStageBytes = kBoxes * kBoxBytes;  // one W tile
  size_t bar_off, in_off, lidx_off, live_off, gin_off, total;
  __host__ __device__ FwdLayout(int U, int K) {
    size_t off = static_cast<size_t>(kStages) * kStageBytes;  // W ring
    bar_off = off;
    off += align128(2 * kStages * sizeof(uint64_t));
    in_off = off;
    off += align128(static_cast<size_t>(U) * sizeof(int32_t));
    lidx_off = off;
    off += align128(static_cast<size_t>(K) * kMaxM * sizeof(int32_t));
    live_off = off;  // per (offset, 64-row group): any valid reference
    off += align128(static_cast<size_t>(K) * 2);
    gin_off = off;
    off += align128(static_cast<size_t>(U + 1) * kLdg * sizeof(T));
    total = off + 1024;  // room to align the base
  }
};

// bf16 consumer tile: warpgroup g holds rows g*64..+64 and all NT columns
// of the block's [128, NT] output as one wgmma accumulator (NT/2 f32 per
// thread); warp w of the group gathers the A fragments of rows
// g*64 + w*16..+16.
template <int CI_T, int NT>
struct WgTile {
  static constexpr int kLdg = CI_T + 8;
  float acc[NT / 2];
  int g, row0, lane;

  __device__ WgTile(int t) {
    const int warp = t / 32;
    lane = t % 32;
    g = warp >> 2;
    row0 = g * 64 + (warp & 3) * 16;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  }

  // out += G_k @ W_k over one Cin tile (lk = lidx of offset k, live_k its
  // two 64-row liveness flags). The A fragments are gathered with ldmatrix
  // straight from the staged rows, every lane's row address read from
  // lidx; B is the swizzled W stage. The MMAs complete before return: the
  // caller then releases the stage.
  __device__ void step(const bf16* gin_s, const bf16* w_b,
                       const int32_t* lk, const uint8_t* live_k, int M,
                       int U) {
    if (!live_k[g]) return;  // uniform over the warpgroup
    const int m = row0 + (lane & 15);
    const int l = m < M ? row_of(lk[m], U) : U;
    const uint32_t a_addr = smem_u32(gin_s + l * kLdg + (lane >> 4) * 8);
    uint32_t af[CI_T / 16][4];
#pragma unroll
    for (int kk = 0; kk < CI_T / 16; ++kk)
      ldmatrix_x4(af[kk], a_addr + kk * 32);
    const uint32_t w0 = smem_u32(w_b);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CI_T / 16; ++kk)
      wgmma_bf16<NT>(acc, af[kk],
                     wgmma_desc_b128(w0 + kk * 16 * kBox, CI_T * kBox));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(af);
    fence_regs(acc);
  }

  // Rows c*M.. of out (bf16) or of part (f32), columns co0..co0+ncols.
  __device__ void store(bf16* out, float* part, int cout, size_t rbase,
                        int M, int co0, int ncols) const {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      if (j * 8 >= ncols) continue;
      const int col = co0 + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + (lane >> 2) + h * 8;
        if (m >= M) continue;
        const size_t r = rbase + m;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (part)
          *reinterpret_cast<float2*>(part + r * cout + col) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + r * cout + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
};

// f32 consumer tile (NT = 64): thread (rg, cg) holds rows rg*8..+8 and
// columns cg*4..+4 in registers; exact FMA products. The W stage is two
// swizzled boxes of 32 columns.
template <int CI_T, int NT>
struct FmaTile {
  static_assert(NT == 64, "the f32 tile is 64 columns wide");
  static constexpr int kLdg = CI_T + 4;
  float acc[8][4];
  int rg, cg;

  __device__ FmaTile(int t) : rg(t / 16), cg(t % 16) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
  }

  __device__ void step(const float* gin_s, const float* w_b,
                       const int32_t* lk, const uint8_t* live_k, int M,
                       int U) {
    if (!live_k[rg >> 3]) return;  // rows rg*8.. lie in group rg/8
    int off[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = rg * 8 + r;
      off[r] = (m < M ? row_of(lk[m], U) : U) * kLdg;
    }
    const char* wb = reinterpret_cast<const char*>(w_b) +
                     (cg >> 3) * (CI_T * kBox);
#pragma unroll 4
    for (int ci = 0; ci < CI_T; ++ci) {
      const float4 b =
          *reinterpret_cast<const float4*>(wb + swz(ci, cg & 7));
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float a = gin_s[off[r] + ci];
        acc[r][0] = fmaf(a, b.x, acc[r][0]);
        acc[r][1] = fmaf(a, b.y, acc[r][1]);
        acc[r][2] = fmaf(a, b.z, acc[r][2]);
        acc[r][3] = fmaf(a, b.w, acc[r][3]);
      }
    }
  }

  // out and part are both f32 here: write whichever is given.
  __device__ void store(float* out, float* part, int cout, size_t rbase,
                        int M, int co0, int ncols) const {
    float* dst = part ? part : out;
    const int c = cg * 4;
    if (c >= ncols) return;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = rg * 8 + r;
      if (m >= M) break;
      *reinterpret_cast<float4*>(dst + (rbase + m) * cout + co0 + c) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
};

template <typename T, int CI_T, int NT>
using TileOf = typename std::conditional<sizeof(T) == 2, WgTile<CI_T, NT>,
                                         FmaTile<CI_T, NT>>::type;

template <typename T, int CI_T, int NT>
__global__ void __launch_bounds__(kThreads, 2)
chunk_conv_kernel(const __grid_constant__ CUtensorMap wmap,
                  const FwdArgs a) {
  using L = FwdLayout<T, CI_T, NT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const L lay(a.U, a.K);
  unsigned char* w_s = smem;  // kStages W tiles, each kBoxes swizzled boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + kStages;
  int32_t* in_s = reinterpret_cast<int32_t*>(smem + lay.in_off);
  int32_t* lidx_s = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  uint8_t* live_s = smem + lay.live_off;
  T* gin_s = reinterpret_cast<T*>(smem + lay.gin_off);

  const int U = a.U, K = a.K, M = a.M;
  const int c = blockIdx.x, co0 = blockIdx.y * NT, split = blockIdx.z;
  const int ncols = min(NT, a.cout - co0);
  const int n_steps = (a.cin / CI_T) * K;
  const int s0 = static_cast<int>(static_cast<long long>(n_steps) * split /
                                  a.splits);
  const int s1 = static_cast<int>(static_cast<long long>(n_steps) *
                                  (split + 1) / a.splits);
  const int32_t* in_c = a.in_idx + static_cast<size_t>(c) * U;
  const size_t rbase = static_cast<size_t>(c) * M;
  T* out = static_cast<T*>(a.out);
  float* part = a.splits > 1 ? a.part + static_cast<size_t>(split) *
                                            a.C * M * a.cout
                             : nullptr;
  const int t = threadIdx.x;

  if (in_c[0] < 0) {  // no referenced row: pure cap padding
    const int esz = part ? 4 : sizeof(T);
    char* base = part ? reinterpret_cast<char*>(part)
                      : reinterpret_cast<char*>(out);
    const int vpr = ncols * esz / 16;
    for (int i = t; i < M * vpr; i += kThreads)
      reinterpret_cast<uint4*>(
          base + ((rbase + i / vpr) * a.cout + co0) * esz)[i % vpr] =
          make_uint4(0, 0, 0, 0);
    return;
  }
  const int warp = t / 32, lane = t % 32;
  const int n = s1 - s0;  // this block's (Cin tile, offset) steps
  // W[k][ci0..ci0+CI_T][co0..) of step i into its ring stage, as the boxes
  // that start inside W (the last may run past Cout: zeros); thread 0
  // starts every load
  const int nbox =
      min(L::kBoxes, (a.cout - co0 + L::kBoxCols - 1) / L::kBoxCols);
  auto load_w = [&](int i) {
    const int stage = i % kStages, s = s0 + i;
    mbar_arrive_expect_tx(full + stage, nbox * L::kBoxBytes);
    const int row = (s % K) * a.cin + (s / K) * CI_T;
    for (int b = 0; b < nbox; ++b)
      tma_load_2d(w_s + stage * L::kStageBytes + b * L::kBoxBytes, &wmap,
                  co0 + b * L::kBoxCols, row, full + stage);
  };
  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
    mbar_fence_init();
    for (int i = 0; i < min(kStages, n); ++i) load_w(i);
  }

  // the chunk's in_idx and lidx rows into shared memory, then per Cin tile
  // its rows
  copy_ints(in_s, in_c, U, t, kThreads);
  copy_ints(lidx_s, a.lidx + static_cast<size_t>(c) * K * M, K * M, t,
            kThreads);
  cp_async_wait_all();
  zero_bytes(gin_s + static_cast<size_t>(U) * L::kLdg, L::kLdg * sizeof(T), t,
             kThreads);
  __syncthreads();
  // liveness of each (offset, 64-row group), one warp per pair (made
  // visible by the first staging's barrier): a group with no valid
  // reference at an offset skips it
  for (int p = warp; p < 2 * K; p += kWarps) {
    const int k = p >> 1, m0 = (p & 1) * 64;
    bool any = false;
    for (int m = m0 + lane; m < min(M, m0 + 64); m += 32)
      any |= lidx_s[k * M + m] >= 0;
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) live_s[p] = any;
  }
  TileOf<T, CI_T, NT> tile(t);
  const T* feats = static_cast<const T*>(a.feats);
  int staged = -1;
  for (int i = 0; i < n; ++i) {
    const int s = s0 + i, k = s % K, cit = s / K;
    if (cit != staged) {
      __syncthreads();  // earlier readers of gin_s are done
      stage_rows<T, CI_T>(gin_s, L::kLdg, feats, a.n_rows, a.cin, a.cin, in_s,
                          U, cit * CI_T, t, kThreads);
      cp_async_wait_all();
      __syncthreads();
      staged = cit;
    }
    const int stage = i % kStages;
    mbar_wait(full + stage, (i / kStages) & 1);
    __syncwarp();  // wgmma wants the warp converged
    tile.step(gin_s, reinterpret_cast<const T*>(w_s + stage * L::kStageBytes),
              lidx_s + k * M, live_s + 2 * k, M, U);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);
    // refill the stage once every warp is done with it
    if (t == 0 && i + kStages < n) {
      mbar_wait(empty + stage, (i / kStages) & 1);
      load_w(i + kStages);
    }
  }
  tile.store(out, part, a.cout, rbase, M, co0, ncols);
}

// out[i] = (feature dtype) sum over s in order of part[s][i].
template <typename T>
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float4* __restrict__ part, int S, size_t n4,
                  T* __restrict__ out) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * 256) {
    float4 v = part[i];
    for (int s = 1; s < S; ++s) {
      const float4 p = part[static_cast<size_t>(s) * n4 + i];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      reinterpret_cast<uint2*>(out)[i] = packed;
    } else {
      reinterpret_cast<float4*>(out)[i] = v;
    }
  }
}

template <typename T, int CI_T, int NT>
int launch(const void* w, const FwdArgs& a, cudaStream_t stream) {
  using L = FwdLayout<T, CI_T, NT>;
  // W [K, cin, cout] as a 2D tensor [K*cin rows, cout columns]; one box is
  // CI_T rows of 128 bytes, swizzled
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.cout),
                              static_cast<cuuint64_t>(a.K) * a.cin};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.cout) * sizeof(T)};
  const cuuint32_t box[2] = {L::kBoxCols, CI_T};
  const cuuint32_t estr[2] = {1, 1};
  const EncodeTiled encode = encoder();
  if (encode == nullptr ||
      encode(&wmap,
             sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(w), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -4;
  const L lay(a.U, a.K);
  const int smem = static_cast<int>(lay.total);
  auto kernel = chunk_conv_kernel<T, CI_T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.C, (a.cout + NT - 1) / NT, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(wmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(a.C) * a.M * a.cout / 4;
  const size_t want = (n4 + 255) / 256;
  sum_splits_kernel<T><<<static_cast<int>(want < 4096 ? want : 4096), 256, 0,
                         stream>>>(reinterpret_cast<const float4*>(a.part),
                                   a.splits, n4, static_cast<T*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
int launch_fitting(const void* w, const FwdArgs& a, cudaStream_t s) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  if (a.cin % 64 == 0 && FwdLayout<T, 64, NT>(a.U, a.K).total <= limit)
    return launch<T, 64, NT>(w, a, s);
  if (a.cin % 32 == 0 && FwdLayout<T, 32, NT>(a.U, a.K).total <= limit)
    return launch<T, 32, NT>(w, a, s);
  if (a.cin % 16 == 0 && FwdLayout<T, 16, NT>(a.U, a.K).total <= limit)
    return launch<T, 16, NT>(w, a, s);
  return -2;
}

}  // namespace

extern "C" {

// out [C*M, cout] = chunk conv of feats [n_rows, cin] (see the header), in
// column tiles of nt (bf16: 64, 96, 128; f32: 64) and `splits` ranges of
// (Cin tile, k) steps per block; with splits > 1, part is caller-owned f32
// scratch [splits, C*M, cout]. Returns a cudaError_t, -2 when no Cin tile
// fits in shared memory, -3 for an unsupported nt, -4 when the
// tensor-map encoder is missing or refuses W.
int occ_chunk_conv_fwd(const void* feats, int n_rows, int cin,
                       const void* in_idx, int C, int U, const void* lidx,
                       int K, int M, const void* w, int cout, int nt,
                       int splits, void* part, void* out, int is_bf16,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{feats, static_cast<const int32_t*>(in_idx),
                  static_cast<const int32_t*>(lidx), out,
                  static_cast<float*>(part), n_rows, cin, C, U, K, M, cout,
                  splits};
  if (is_bf16) {
    switch (nt) {
      case 64: return launch_fitting<bf16, 64>(w, a, s);
      case 96: return launch_fitting<bf16, 96>(w, a, s);
      case 128: return launch_fitting<bf16, 128>(w, a, s);
    }
    return -3;
  }
  return nt == 64 ? launch_fitting<float, 64>(w, a, s) : -3;
}

}  // extern "C"
