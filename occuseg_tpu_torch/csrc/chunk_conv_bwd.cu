// Chunk convolution backward for Hopper (sm_90a).
//
// 1. Fused backward (the wrapper `chunk_conv_bwd_fused`).
//    Replaces: `_pallas_bwd_fused` (kernel `_make_bwd_fused_kernel`) and
//    `_pallas_bwd_fused_v2` (kernel `_make_bwd_fused_v2_kernel`, the same
//    contract with K split into groups to fit the TPU's VMEM) of
//    occuseg_tpu/ops/pallas/chunk_conv.py. Over the TRANSPOSE chunk plan
//    (t_in_idx [C, U], t_lidx [C, K, M]) of a convolution, with the
//    cotangent ct [N_ct, Ct], the transposed weights W' [K, Ct, Cin] and the
//    forward input feats [C*M, Cin], all in the feature dtype:
//
//      Gct_k[m]    = t_lidx[c,k,m] >= 0 ? ct[t_in_idx[c, t_lidx[c,k,m]]] : 0
//      d_feats_c   = sum_k Gct_k @ W'_k                  (feature dtype)
//      dWt[k]      = sum_c feats_c^T @ Gct_k             (f32, [K, Cin, Ct])
//
//    d_feats is the forward contract over the transpose plan: the wrapper
//    runs the forward kernel of chunk_conv.cu for it. dWt is the kernel
//    below (occ_chunk_conv_dwt). The caller maps dWt to dW (offset reversal
//    for submanifold maps, none for the strided/deconvolution pairs).
//
//    What bounded the first version (one kernel for both products):
//    every block added its [64, Ct] slice of every offset's dWt into device
//    memory with f32 atomics, C*K*Cin*Ct adds per call (7.05e9 per bf16
//    bench step), serialised in L2 on one small tensor. The TPU kernel never
//    paid this: its dW block stays in VMEM across the sequential chunk grid.
//    Shared memory cannot hold dWt for all 27 offsets (27 x 64 x 64 f32 is
//    442 KB), so here dWt stays in registers across a RUN of chunks
//    instead: one block per (64 Cin rows, a Ct tile, 4 offsets, run of
//    consecutive chunks), two warpgroups of two offsets each. Per chunk it
//    stages the chunk's referenced ct rows (one Ct tile, pad slots skipped,
//    zero row at U) and its 64 feats columns (the next chunk's in_idx and
//    t_lidx rows load meanwhile). bf16 runs on wgmma as dWt[k]^T = Gct_k^T
//    @ feats_c: per 16-row slice each warp gathers its 16 Ct rows of A =
//    Gct_k^T with ldmatrix.trans from the staged ct rows, every lane's row
//    address read from t_lidx, and B is the feats tile, staged in the
//    128-byte swizzle, through a descriptor; a slice with no valid
//    reference is skipped. At the end of the run the block writes its f32
//    partial once with plain stores ([runs, K, Cin, Ct]); a second launch
//    sums the partials in run order. dWt is deterministic and the values
//    written per bench step fall from 7.05e9 to 2.43e8 (the wrapper's
//    `dwt_values`). f32 (training CLI, parity): the same blocks with exact
//    FMA products, each thread an 8 x (CT/8) register tile, rows with no
//    valid reference skipped.
//    What bounds it: latency per chunk. A block stages a chunk, waits, and
//    then runs ~4 MFLOP; only the other resident block overlaps that. On
//    the H100, per bench step: mma.sync in place of wgmma measured 9.9 ms
//    against 9.0; 8 offsets per block (16 warps, half the restaging) with
//    the next chunk's rows loaded during this one's products measured
//    10.3-10.8 ms against 9.8-10.0 for mma.sync at 4 offsets (one block per
//    SM fitted); without the dW atomics the first fused kernel measured 7%
//    faster. Neither the adds, nor the staged bytes, nor the MMA
//    instructions set the pace.
//
// 2. dW over the forward plan (occ_chunk_conv_dw).
//    Replaces: `_pallas_dw` (kernel `_make_dw_kernel`), the route the JAX
//    package takes where the fused kernel does not fit its VMEM budget:
//
//      dW[k] = sum_c G_k^T @ ct_c,  G_k[m] = feats[in_idx[c, lidx[c,k,m]]]
//
//    in f32, [K, Cin, Cout]. The d_feats half of that route is the forward
//    kernel (chunk_conv.cu) on the transpose plan.
//    It is bound by its gathers: each block reads the M rows of one offset
//    straight from device memory (no staging), two 16 KB tiles per chunk,
//    with few blocks' worth of independent work at the coarse levels where
//    it runs. One block per (64x64 tile of dW[k], offset k, range of
//    chunks): per chunk the M gathered feats rows and the M ct rows of the
//    tile are loaded with cp.async (missing references read as zeros) and
//    accumulated in registers (WMMA bf16 -> f32, or FMA in f32). With one
//    range per tile the block writes dW directly; with several (small
//    shapes that would not fill the card) each writes its partial and a
//    second launch sums the partials in range order. Either way dW is
//    deterministic. wgmma, TMA and double-buffered chunk loads are left for
//    later work.

#include <mma.h>

#include <type_traits>

#include "chunk_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// dWt over the transpose plan, in run partials
// ---------------------------------------------------------------------------

constexpr int kDwtThreads = 256;  // 8 warps
constexpr int kDwtOffsets = 4;    // offsets per block
constexpr int kDwtRows = 64;      // Cin rows (dWt rows) per block

struct DwtArgs {
  const void* ct;
  const int32_t* in_idx;
  const int32_t* lidx;
  const void* feats;
  float* out;  // dWt [K, cin, Ct] (runs == 1) or partials [runs, K, cin, Ct]
  int n_ct, Ct, C, U, K, M, cin, runs;
};

// Shared memory plan, from a 1024-byte aligned base: the feats tile first
// (bf16: kMaxM rows of 64 columns, 128 bytes each, in the 128-byte swizzle
// that wgmma reads through a descriptor; f32: rows padded against bank
// conflicts), two buffers of the chunk's lidx rows and in_idx row (the
// next chunk's are loaded while this one computes), then one set of staged
// ct rows.
template <typename T, int CT>
struct DwtLayout {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr bool kSwizzled = sizeof(T) == 2;
  static constexpr int kLdf = kDwtRows + kVec;  // f32 feats tile stride
  // staged ct row stride: bf16 rows are read by ldmatrix at 8 different
  // rows per instruction and are padded against bank conflicts; a warp of
  // the f32 tile reads one row, 128 contiguous bytes, and needs no padding
  // (which lets tier 1.7's U=1312 fit at CT=32)
  static constexpr int kLdg = CT + (kSwizzled ? kVec : 0);
  static constexpr size_t kLidx = static_cast<size_t>(kDwtOffsets) * kMaxM;
  size_t lidx_off, in_off, g_off, total;
  __host__ __device__ DwtLayout(int U) {
    size_t off = align128(static_cast<size_t>(kMaxM) *
                          (kSwizzled ? 128 : kLdf * sizeof(T)));
    lidx_off = off;
    off += align128(2 * kLidx * sizeof(int32_t));
    in_off = off;
    off += 2 * align128(static_cast<size_t>(U) * sizeof(int32_t));
    g_off = off;
    off += align128(static_cast<size_t>(U + 1) * kLdg * sizeof(T));
    total = off + 1024;  // room to align the base
  }
  __host__ __device__ size_t in_stride(int U) const {
    return align128(static_cast<size_t>(U) * sizeof(int32_t)) /
           sizeof(int32_t);
  }
};

// bf16: dWt[k]^T = Gct_k^T @ feats_c on wgmma. Warpgroup g holds, for
// offsets k0 + 2g and k0 + 2g + 1, the [64 Ct, 64 Cin] tile of dWt^T as
// m64n64 accumulators; per 16-row slice of the chunk its warps gather A =
// Gct_k^T (Ct rows 16w..+16 of the group's 64) with ldmatrix.trans from the
// staged ct rows, every lane's row address read from t_lidx, and B is the
// swizzled feats tile through a descriptor. A slice with no valid
// reference at the offset is skipped (uniform over the group).
template <int CT>
struct DwtWgTile {
  static_assert(CT == 64, "wgmma takes 64 Ct rows");
  static constexpr int kLdg = CT + 8;
  float acc[2][32];
  int g, w, lane;
  int j;  // the block's first offset of this thread's warpgroup

  __device__ DwtWgTile(int t) {
    const int warp = t / 32;
    lane = t % 32;
    g = warp >> 2;
    w = warp & 3;
    j = 2 * g;
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[o][i] = 0.0f;
  }

  __device__ void chunk(const bf16* f_s, const bf16* g_s,
                        const int32_t* lidx_s, int M, int U, int nk,
                        int ncols) {
    const uint32_t f0 = smem_u32(f_s);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      if (j + o >= nk) continue;  // uniform over the warpgroup
      const int32_t* lk = lidx_s + (j + o) * M;
      uint32_t af[kMaxM / 16][4];
      bool live[kMaxM / 16];
#pragma unroll
      for (int sl = 0; sl < kMaxM / 16; ++sl) {
        live[sl] = false;
        if (sl * 16 >= M) continue;
        const int m = sl * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int l = row_of(lk[m], U);
        live[sl] = __any_sync(0xffffffffu, l != U);
        if (live[sl])
          ldmatrix_x4_trans(af[sl], smem_u32(g_s + l * kLdg + w * 16 +
                                             ((lane >> 3) & 1) * 8));
      }
      fence_regs(acc[o]);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < kMaxM / 16; ++sl)
        if (live[sl])
          wgmma_bf16<64>(acc[o], af[sl],
                         wgmma_desc_b128(f0 + sl * 16 * 128, kMaxM * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(af);
      fence_regs(acc[o]);
    }
  }

  // dst = this block's [cin, Ct] slice of offset k0 (row k0 of dWt);
  // element (ct row r, cin column c) of the accumulator goes to
  // dst[o][ci0 + c][ct0 + r].
  __device__ void store(float* dst, int cin, int Ct, int ci0, int ct0,
                        int nk, int ncols) const {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      if (j + o >= nk) continue;
      float* d = dst + static_cast<size_t>(j + o) * cin * Ct;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = w * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
        const int c = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        if (r < ncols && ci0 + c < cin)
          d[static_cast<size_t>(ci0 + c) * Ct + ct0 + r] = acc[o][i];
      }
    }
  }
};

// f32: thread t holds dWt[k0 + t/64] rows ci0 + rg*8..+8, columns
// ct0 + q*32 + cg*4..+4 (q < CT/32); exact FMA products.
template <int CT>
struct DwtFmaTile {
  static constexpr int kLdf = kDwtRows + 4, kLdg = CT, kNQ = CT / 32;
  float acc[8][kNQ][4];
  int j, rg, cg;

  __device__ DwtFmaTile(int t) : j(t / 64), rg((t % 64) / 8), cg(t % 8) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][q][e] = 0.0f;
  }

  __device__ void chunk(const float* f_s, const float* g_s,
                        const int32_t* lidx_s, int M, int U, int nk,
                        int ncols) {
    if (j >= nk) return;
    const int32_t* lk = lidx_s + j * M;  // offsets packed at stride M
    for (int m = 0; m < M; ++m) {
      const int l = row_of(lk[m], U);
      if (l == U) continue;  // uniform over the warp (one offset per warp)
      float4 g[kNQ];
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
        g[q] = *reinterpret_cast<const float4*>(g_s + l * kLdg + q * 32 +
                                                cg * 4);
      const float4 a0 = *reinterpret_cast<const float4*>(f_s + m * kLdf +
                                                         rg * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(f_s + m * kLdf +
                                                         rg * 8 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          acc[r][q][0] = fmaf(a[r], g[q].x, acc[r][q][0]);
          acc[r][q][1] = fmaf(a[r], g[q].y, acc[r][q][1]);
          acc[r][q][2] = fmaf(a[r], g[q].z, acc[r][q][2]);
          acc[r][q][3] = fmaf(a[r], g[q].w, acc[r][q][3]);
        }
    }
  }

  // dst = the block's offset k0 of dWt (or of its run's partial).
  __device__ void store(float* dst, int cin, int Ct, int ci0, int ct0,
                        int nk, int ncols) const {
    if (j >= nk) return;
    dst += static_cast<size_t>(j) * cin * Ct;
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      const int c = q * 32 + cg * 4;
      if (c >= ncols) continue;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = ci0 + rg * 8 + r;
        if (row >= cin) break;
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * Ct + ct0 +
                                   c) =
            make_float4(acc[r][q][0], acc[r][q][1], acc[r][q][2],
                        acc[r][q][3]);
      }
    }
  }
};

template <typename T, int CT>
using DwtTileOf = typename std::conditional<sizeof(T) == 2, DwtWgTile<CT>,
                                            DwtFmaTile<CT>>::type;

// blockIdx: x = (64-row Cin tile, CT-column Ct tile), y = group of 4
// offsets, z = run of consecutive chunks.
template <typename T, int CT>
__global__ void __launch_bounds__(kDwtThreads, 2)
dwt_kernel(const DwtArgs a) {
  using L = DwtLayout<T, CT>;
  constexpr int kVec = L::kVec;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const L lay(a.U);
  T* f_s = reinterpret_cast<T*>(smem);
  int32_t* lidx_b = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  int32_t* in_b = reinterpret_cast<int32_t*>(smem + lay.in_off);
  T* g_s = reinterpret_cast<T*>(smem + lay.g_off);

  const int U = a.U, K = a.K, M = a.M;
  const int tiles_ct = (a.Ct + CT - 1) / CT;
  const int ci0 = (blockIdx.x / tiles_ct) * kDwtRows;
  const int ct0 = (blockIdx.x % tiles_ct) * CT;
  const int ncols = min(CT, a.Ct - ct0);
  const int k0 = blockIdx.y * kDwtOffsets, run = blockIdx.z;
  const int nk = min(kDwtOffsets, K - k0);
  const int c_begin =
      static_cast<int>(static_cast<long long>(a.C) * run / a.runs);
  const int c_end =
      static_cast<int>(static_cast<long long>(a.C) * (run + 1) / a.runs);
  const int t = threadIdx.x;
  const T* ct = static_cast<const T*>(a.ct);
  const T* feats = static_cast<const T*>(a.feats);
  const size_t in_stride = lay.in_stride(U);

  // chunk c's in_idx row and the lidx rows of offsets k0.. into buffer b
  auto load_meta = [&](int c, int b) {
    copy_ints(in_b + b * in_stride, a.in_idx + static_cast<size_t>(c) * U, U,
              t, kDwtThreads);
    copy_ints(lidx_b + b * L::kLidx,
              a.lidx + (static_cast<size_t>(c) * K + k0) * M, nk * M, t,
              kDwtThreads);
  };

  DwtTileOf<T, CT> tile(t);
  zero_bytes(g_s + static_cast<size_t>(U) * L::kLdg, L::kLdg * sizeof(T), t,
             kDwtThreads);
  if (c_begin < c_end) load_meta(c_begin, 0);
  for (int c = c_begin; c < c_end; ++c) {
    const int b = (c - c_begin) & 1;
    const int32_t* in_s = in_b + b * in_stride;
    // chunk c's meta is in; the previous chunk's readers are done
    cp_async_wait_all();
    __syncthreads();
    const bool live = in_s[0] >= 0;  // uniform: all-pad chunks add nothing
    if (live) {
      // feats rows c*M.., columns ci0..ci0+64 (zero past cin); bf16 rows
      // are 128 bytes, their 16-byte pieces swizzled by the row's low bits
      constexpr int kVpr = kDwtRows / kVec;
      for (int i = t; i < M * kVpr; i += kDwtThreads) {
        const int m = i / kVpr, v = i % kVpr, col = ci0 + v * kVec;
        T* d = L::kSwizzled ? f_s + m * kDwtRows + ((v ^ (m & 7)) * kVec)
                            : f_s + m * L::kLdf + v * kVec;
        if (col < a.cin)
          cp_async16(d,
                     feats + (static_cast<size_t>(c) * M + m) * a.cin + col);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
      stage_rows<T, CT>(g_s, L::kLdg, ct, a.n_ct, a.Ct, a.Ct, in_s, U, ct0,
                        t, kDwtThreads);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (c + 1 < c_end) load_meta(c + 1, b ^ 1);
    // this chunk's rows are in (the next chunk's meta may still fly)
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::);
    if (!live) continue;
    if constexpr (L::kSwizzled) fence_proxy_async();  // wgmma reads f_s
    __syncthreads();
    tile.chunk(f_s, g_s, lidx_b + b * L::kLidx, M, U, nk, ncols);
  }
  cp_async_wait_all();
  float* dst =
      a.out + (static_cast<size_t>(run) * K + k0) * a.cin * a.Ct;
  tile.store(dst, a.cin, a.Ct, ci0, ct0, nk, ncols);
}

template <typename T, int CT>
int launch_dwt(const DwtArgs& a, cudaStream_t stream) {
  const DwtLayout<T, CT> lay(a.U);
  const int smem = static_cast<int>(lay.total);
  auto kernel = dwt_kernel<T, CT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((a.cin + kDwtRows - 1) / kDwtRows) * ((a.Ct + CT - 1) / CT),
                  (a.K + kDwtOffsets - 1) / kDwtOffsets, a.runs);
  kernel<<<grid, kDwtThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 takes 64 Ct columns (wgmma's 64 rows), f32 the widest tile that
// fits.
template <typename T>
int launch_dwt_fitting(const DwtArgs& a, cudaStream_t s) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  if (DwtLayout<T, 64>(a.U).total <= limit) return launch_dwt<T, 64>(a, s);
  if constexpr (sizeof(T) == 4)
    if (DwtLayout<T, 32>(a.U).total <= limit) return launch_dwt<T, 32>(a, s);
  return -2;
}

// ---------------------------------------------------------------------------
// dW over the forward plan
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kCoT = 64;  // dW tile edge

template <typename T>
struct DwLayout {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLd = kCoT + kVec;   // gathered-row / ct-row stride
  static constexpr int kLdd = kCoT + 4;     // f32 epilogue staging stride
  static constexpr size_t kA = 0;
  static constexpr size_t kB = align128(static_cast<size_t>(kMaxM) * kLd * sizeof(T));
  static constexpr size_t kD = kB + kB;
  static constexpr size_t kTotal =
      kD + (sizeof(T) == 2 ? align128(static_cast<size_t>(kCoT) * kLdd * sizeof(float)) : 0);
};

// Load chunk c's M gathered feats rows (offset k, columns ci0..) into a_s
// and its M ct rows (columns co0..) into b_s; missing references are zero.
template <typename T>
__device__ void load_dw_chunk(T* a_s, T* b_s, const T* __restrict__ feats,
                              int n_rows, int cin,
                              const int32_t* __restrict__ in_c, int U,
                              const int32_t* __restrict__ l_ck, int M,
                              const T* __restrict__ ct_c, int cout, int ci0,
                              int co0) {
  using D = DwLayout<T>;
  constexpr int kVpr = kCoT / D::kVec;
  for (int i = threadIdx.x; i < M * kVpr; i += kThreads) {
    const int m = i / kVpr, v = i % kVpr;
    const int l = l_ck[m];
    const int row = (l >= 0 && l < U) ? in_c[l] : -1;
    const int ca = ci0 + v * D::kVec, cb = co0 + v * D::kVec;
    T* da = a_s + m * D::kLd + v * D::kVec;
    T* db = b_s + m * D::kLd + v * D::kVec;
    if (row >= 0 && row < n_rows && ca < cin)
      cp_async16(da, feats + static_cast<size_t>(row) * cin + ca);
    else
      *reinterpret_cast<uint4*>(da) = make_uint4(0, 0, 0, 0);
    if (cb < cout)
      cp_async16(db, ct_c + static_cast<size_t>(m) * cout + cb);
    else
      *reinterpret_cast<uint4*>(db) = make_uint4(0, 0, 0, 0);
  }
  cp_async_wait_all();
}

// blockIdx: x = 64x64 tile of dW[k] (ci-major), y = offset k, z = chunk
// range. out is dW [K, cin, cout] when gridDim.z == 1, else the partials
// [gridDim.z, K, cin, cout].
__global__ void __launch_bounds__(kThreads)
dw_bf16_kernel(const bf16* __restrict__ feats, int n_rows, int cin,
               const int32_t* __restrict__ in_idx, int C, int U,
               const int32_t* __restrict__ lidx, int K, int M,
               const bf16* __restrict__ ct, int cout,
               float* __restrict__ out) {
  using T = bf16;
  using D = DwLayout<T>;
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem + D::kA);
  T* b_s = reinterpret_cast<T*>(smem + D::kB);
  float* d_s = reinterpret_cast<float*>(smem + D::kD);

  const int tiles_co = (cout + kCoT - 1) / kCoT;
  const int ci0 = (blockIdx.x / tiles_co) * kCoT;
  const int co0 = (blockIdx.x % tiles_co) * kCoT;
  const int k = blockIdx.y, r = blockIdx.z, R = gridDim.z;
  const int c_begin = static_cast<int>(static_cast<long long>(C) * r / R);
  const int c_end = static_cast<int>(static_cast<long long>(C) * (r + 1) / R);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int drow = (warp >> 1) * 16, dcol = (warp & 1) * 32;
  const bool drow_live = ci0 + drow < cin;
  bool dcol_live[2];
  for (int j = 0; j < 2; ++j) dcol_live[j] = co0 + dcol + j * 16 < cout;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int c = c_begin; c < c_end; ++c) {
    const int32_t* in_c = in_idx + static_cast<size_t>(c) * U;
    if (in_c[0] < 0) continue;  // all-pad chunk (uniform across the block)
    __syncthreads();  // the previous chunk's readers are done
    load_dw_chunk<T>(a_s, b_s, feats, n_rows, cin, in_c, U,
                     lidx + (static_cast<size_t>(c) * K + k) * M, M,
                     ct + static_cast<size_t>(c) * M * cout, cout, ci0, co0);
    __syncthreads();
    if (!drow_live) continue;
    for (int mm = 0; mm < M; mm += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, a_s + mm * D::kLd + drow, D::kLd);
      for (int j = 0; j < 2; ++j) {
        if (!dcol_live[j]) continue;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b_s + mm * D::kLd + dcol + j * 16, D::kLd);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }

  if (!drow_live) return;
  const int ncol = dcol_live[1] ? 32 : (dcol_live[0] ? 16 : 0);
  if (ncol == 0) return;
  float* d_w = d_s + drow * D::kLdd + dcol;
  for (int j = 0; j < 2; ++j)
    if (dcol_live[j])
      wmma::store_matrix_sync(d_w + j * 16, acc[j], D::kLdd,
                              wmma::mem_row_major);
  __syncwarp();
  const int vpr = ncol / 4;
  float* o = out + ((static_cast<size_t>(r) * K + k) * cin + ci0 + drow) * cout +
             co0 + dcol;
  for (int i = lane; i < 16 * vpr; i += 32) {
    const int rr = i / vpr, q = i % vpr;
    *reinterpret_cast<float4*>(o + static_cast<size_t>(rr) * cout + q * 4) =
        *reinterpret_cast<const float4*>(d_w + rr * D::kLdd + q * 4);
  }
}

__global__ void __launch_bounds__(kThreads)
dw_f32_kernel(const float* __restrict__ feats, int n_rows, int cin,
              const int32_t* __restrict__ in_idx, int C, int U,
              const int32_t* __restrict__ lidx, int K, int M,
              const float* __restrict__ ct, int cout,
              float* __restrict__ out) {
  using T = float;
  using D = DwLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem + D::kA);
  T* b_s = reinterpret_cast<T*>(smem + D::kB);

  const int tiles_co = (cout + kCoT - 1) / kCoT;
  const int ci0 = (blockIdx.x / tiles_co) * kCoT;
  const int co0 = (blockIdx.x % tiles_co) * kCoT;
  const int k = blockIdx.y, r = blockIdx.z, R = gridDim.z;
  const int c_begin = static_cast<int>(static_cast<long long>(C) * r / R);
  const int c_end = static_cast<int>(static_cast<long long>(C) * (r + 1) / R);

  // thread tile: rows (Cin) rg*4..+4, columns (Cout) cg*4..+4 of 64 x 64
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int c = c_begin; c < c_end; ++c) {
    const int32_t* in_c = in_idx + static_cast<size_t>(c) * U;
    if (in_c[0] < 0) continue;
    __syncthreads();
    load_dw_chunk<T>(a_s, b_s, feats, n_rows, cin, in_c, U,
                     lidx + (static_cast<size_t>(c) * K + k) * M, M,
                     ct + static_cast<size_t>(c) * M * cout, cout, ci0, co0);
    __syncthreads();
    for (int m = 0; m < M; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(a_s + m * D::kLd + rg * 4);
      const float4 b = *reinterpret_cast<const float4*>(b_s + m * D::kLd + cg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
  }
  const int col = co0 + cg * 4;
  if (col >= cout) return;
  for (int i = 0; i < 4; ++i) {
    const int row = ci0 + rg * 4 + i;
    if (row >= cin) break;
    *reinterpret_cast<float4*>(
        out + ((static_cast<size_t>(r) * K + k) * cin + row) * cout + col) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// out[i] = sum over r in order of part[r][i] (n4 float4s per partial).
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float4* __restrict__ part, int R, size_t n4,
                    float4* __restrict__ out) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * kThreads) {
    float4 s = part[i];
    for (int r = 1; r < R; ++r) {
      const float4 p = part[static_cast<size_t>(r) * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    out[i] = s;
  }
}

template <typename T, typename Kernel>
int launch_dw(Kernel kernel, const void* feats, int n_rows, int cin,
              const void* in_idx, int C, int U, const void* lidx, int K, int M,
              const void* ct, int cout, int n_ranges, void* partial, void* out,
              cudaStream_t stream) {
  const int smem = static_cast<int>(DwLayout<T>::kTotal);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((cin + kCoT - 1) / kCoT) * ((cout + kCoT - 1) / kCoT);
  const dim3 grid(tiles, K, n_ranges);
  float* dst = static_cast<float*>(n_ranges > 1 ? partial : out);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), n_rows, cin,
      static_cast<const int32_t*>(in_idx), C, U,
      static_cast<const int32_t*>(lidx), K, M, static_cast<const T*>(ct),
      cout, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_ranges == 1) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(K) * cin * cout / 4;
  const size_t want = (n4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(partial), n_ranges, n4,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dwt [K, cin, Ct] f32 = sum over the chunks of the transpose plan of
// feats_c^T @ Gct_k (see the header), in `runs` runs of consecutive chunks;
// with runs > 1, partial is caller-owned f32 scratch [runs, K, cin, Ct]
// whose runs are then summed in order. Returns a cudaError_t, or -2 when
// no Ct tile fits in shared memory.
int occ_chunk_conv_dwt(const void* ct, int n_ct, int Ct, const void* t_in_idx,
                       int C, int U, const void* t_lidx, int K, int M,
                       const void* feats, int cin, int runs, void* partial,
                       void* dwt, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(runs > 1 ? partial : dwt);
  const DwtArgs a{ct, static_cast<const int32_t*>(t_in_idx),
                  static_cast<const int32_t*>(t_lidx), feats, dst, n_ct, Ct,
                  C, U, K, M, cin, runs};
  const int rc = is_bf16 ? launch_dwt_fitting<bf16>(a, s)
                         : launch_dwt_fitting<float>(a, s);
  if (rc != 0 || runs == 1) return rc;
  const size_t n4 = static_cast<size_t>(K) * cin * Ct / 4;
  const size_t want = (n4 + kThreads - 1) / kThreads;
  sum_partials_kernel<<<static_cast<int>(want < 4096 ? want : 4096), kThreads,
                        0, s>>>(static_cast<const float4*>(partial), runs, n4,
                                static_cast<float4*>(dwt));
  return static_cast<int>(cudaGetLastError());
}

// dw [K, cin, cout] f32 = sum over chunks of G_k^T @ ct_c over the forward
// plan (see the header). n_ranges > 1 splits the chunks into that many
// ranges whose partials ([n_ranges, K, cin, cout] f32, caller-allocated)
// are then summed in order. Returns a cudaError_t.
int occ_chunk_conv_dw(const void* feats, int n_rows, int cin,
                      const void* in_idx, int C, int U, const void* lidx,
                      int K, int M, const void* ct, int cout, int n_ranges,
                      void* partial, void* dw, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dw<bf16>(dw_bf16_kernel, feats, n_rows, cin, in_idx, C, U,
                           lidx, K, M, ct, cout, n_ranges, partial, dw, s);
  return launch_dw<float>(dw_f32_kernel, feats, n_rows, cin, in_idx, C, U,
                          lidx, K, M, ct, cout, n_ranges, partial, dw, s);
}

}  // extern "C"
