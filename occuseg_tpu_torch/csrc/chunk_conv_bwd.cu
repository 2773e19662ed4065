// Chunk convolution backward for Hopper (sm_90a): two kernels.
//
// 1. Fused backward (occ_chunk_conv_bwd_fused).
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
//      dWt[k]     += feats_c^T @ Gct_k   over all chunks (f32, [K, Cin, Ct])
//
//    One staging of each chunk's U rows of ct serves both products. The
//    caller maps dWt to dW (offset reversal for submanifold maps, none for
//    the strided/deconvolution pairs).
//
// 2. dW over the forward plan (occ_chunk_conv_dw).
//    Replaces: `_pallas_dw` (kernel `_make_dw_kernel`), the route the JAX
//    package takes where the fused kernel does not fit its VMEM budget:
//
//      dW[k] = sum_c G_k^T @ ct_c,  G_k[m] = feats[in_idx[c, lidx[c,k,m]]]
//
//    in f32, [K, Cin, Cout]. The d_feats half of that route is the forward
//    kernel (chunk_conv.cu) on the transpose plan.
//
// What bounds them on the H100: the fused kernel does 4*Ct*Cin FLOP per
// valid (row, offset) reference against ~U*Ct staged elements per chunk, the
// forward's arithmetic intensity twice over, so a good kernel is
// tensor-core bound. This first version is bound, like the forward, by the
// per-offset A-tile copy in shared memory and one barrier per offset, and
// in addition by the f32 atomics of dW: every block adds its [64, Ct] slice
// of every offset's dW into device memory, C*K*Cin*Ct additions per call,
// resolved in L2. The dW kernel is bound by its gathers: each block reads
// the M rows of one offset straight from device memory (no staging), two
// 16 KB tiles per chunk, with few blocks' worth of independent work at the
// coarse levels where it runs.
//
// Design:
//  * fused: one block (8 warps) per (chunk, 64-column tile of d_feats). Per
//    Ct tile of CT_T columns the chunk's U referenced ct rows are staged
//    (cp.async), with the zero row at U for every -1; per offset the A tile
//    is gathered through t_lidx (bf16) and serves two products: d_feats
//    (4x2 warps of 32x32, WMMA bf16 -> f32, accumulated over every offset
//    and Ct tile) and the block's [64 Cin rows, CT_T] slice of dWt[k]
//    (4x2 warps of 16x32 over the chunk's M rows, with feats_c^T read from a
//    tile staged once per block). The dW slice is added with f32 atomics
//    into a zeroed dWt: blocks run in no order, so dWt is NOT deterministic
//    (summation order varies from run to run at f32 rounding); d_feats is.
//    CT_T is the largest of 64/32/16 that divides Ct and fits the opt-in
//    shared memory (the deconvolution backward stages up to 1312 rows of
//    up to 320 columns); no fitting tile -> the call fails, no other path.
//    f32 (parity checks): FMA register tiles, exact products, atomics as
//    above. An all-pad chunk writes zero d_feats and adds nothing.
//  * dW: one block per (64x64 tile of dW[k], offset k, range of chunks).
//    Per chunk the M gathered feats rows and the M ct rows of the tile are
//    loaded with cp.async (missing references read as zeros) and
//    accumulated in registers (WMMA bf16 -> f32, or FMA in f32). With one
//    range per tile the block writes dW directly; with several (small
//    shapes that would not fill the card) each writes its partial and a
//    second launch sums the partials in range order. Either way dW is
//    deterministic.
// wgmma, TMA, double-buffered chunk loads and per-block dW partials that
// avoid the atomics are left for later work.

#include <mma.h>

#include "chunk_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Shared memory plan of the fused kernel, shared by host and device.
template <typename T, int CT_T>
struct BwdLayout : Strides<T, CT_T> {
  using S = Strides<T, CT_T>;
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int kLdf = kCoT + S::kVec;  // staged feats tile stride
  static constexpr int kLdd = CT_T + 4;        // f32 dW staging stride
  size_t lidx_off, gin_off, a_off, w_off, f_off, d_off, o_off, total;
  __host__ __device__ BwdLayout(int U, int K) {
    size_t off = 0;
    lidx_off = off;
    off += align128(static_cast<size_t>(K) * kMaxM * sizeof(int32_t));
    gin_off = off;
    off += align128(static_cast<size_t>(U + 1) * S::kLdg * sizeof(T));
    a_off = off;
    if (kMma) off += align128(2 * static_cast<size_t>(kMaxM) * S::kLdg * sizeof(T));
    w_off = off;
    off += align128(2 * static_cast<size_t>(CT_T) * S::kLdw * sizeof(T));
    f_off = off;
    off += align128(static_cast<size_t>(kMaxM) * kLdf * sizeof(T));
    d_off = off;
    if (kMma) off += align128(static_cast<size_t>(kCoT) * kLdd * sizeof(float));
    o_off = off;
    if (kMma) off += align128(8 * 256 * sizeof(float));
    total = off;
  }
};

// f32 atomic add of four consecutive floats (16-byte aligned).
__device__ __forceinline__ void red_add4(float* dst, float4 v) {
#if (__CUDACC_VER_MAJOR__ > 12) || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

// feats rows c*M .. c*M+M, columns co0 .. co0+kCoT -> f_s (zero past cin).
template <typename T>
__device__ void stage_feats_tile(T* f_s, const T* __restrict__ feats, int c,
                                 int M, int cin, int co0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = kCoT / kVec;
  constexpr int kLdf = kCoT + kVec;
  for (int i = threadIdx.x; i < M * kVpr; i += kThreads) {
    const int m = i / kVpr, v = i % kVpr, col = co0 + v * kVec;
    T* dst = f_s + m * kLdf + v * kVec;
    if (col < cin)
      cp_async16(dst, feats + (static_cast<size_t>(c) * M + m) * cin + col);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

template <int CT_T>
__global__ void __launch_bounds__(kThreads)
bwd_fused_bf16_kernel(const bf16* __restrict__ ct, int n_ct, int Ct,
                      const int32_t* __restrict__ t_in_idx, int U,
                      const int32_t* __restrict__ t_lidx, int K, int M,
                      const bf16* __restrict__ wt,
                      const bf16* __restrict__ feats, int cin,
                      bf16* __restrict__ d_feats, float* __restrict__ dwt) {
  using T = bf16;
  using L = BwdLayout<T, CT_T>;
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(U, K);
  int32_t* lidx_s = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  T* gin_s = reinterpret_cast<T*>(smem + lay.gin_off);
  T* a_s = reinterpret_cast<T*>(smem + lay.a_off);
  T* w_s = reinterpret_cast<T*>(smem + lay.w_off);
  T* f_s = reinterpret_cast<T*>(smem + lay.f_off);
  float* d_s = reinterpret_cast<float*>(smem + lay.d_off);
  float* o_s = reinterpret_cast<float*>(smem + lay.o_off);

  const int c = blockIdx.x;
  const int co0 = blockIdx.y * kCoT;  // d_feats columns = dWt rows
  const int32_t* in_c = t_in_idx + static_cast<size_t>(c) * U;
  if (in_c[0] < 0) {  // no referenced row: zero d_feats, nothing to dW
    write_zero_tile(d_feats, c, M, co0, cin);
    return;
  }
  load_lidx(lidx_s, t_lidx + static_cast<size_t>(c) * K * M, K, M, U);
  zero_row<T, CT_T>(gin_s, U);
  stage_feats_tile<T>(f_s, feats, c, M, cin, co0);  // waited on below

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // d_feats: 4 warp rows x 32, 2 warp cols x 32 of the [M, 64] tile
  const int row0 = (warp >> 1) * 32;
  const int wcol = (warp & 1) * 32;
  const bool rows_live = row0 < M;
  bool col_live[2];
  for (int j = 0; j < 2; ++j) col_live[j] = co0 + wcol + j * 16 < cin;
  // dWt slice: 4 warp rows x 16 (Cin), 2 warp cols x 32 (Ct) of [64, CT_T]
  const int drow = (warp >> 1) * 16;
  const int dcol = (warp & 1) * 32;
  const bool drow_live = co0 + drow < cin;
  bool dcol_live[2];
  for (int j = 0; j < 2; ++j) dcol_live[j] = dcol + j * 16 < CT_T;
  const int ncol = dcol_live[1] ? 32 : (dcol_live[0] ? 16 : 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int ct0 = 0; ct0 < Ct; ct0 += CT_T) {
    __syncthreads();  // previous tile's readers of gin_s / a_s are done
    stage_rows<T, CT_T>(gin_s, ct, n_ct, Ct, in_c, U, ct0);
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      T* a_b = a_s + (k & 1) * kMaxM * L::kLdg;
      T* w_b = w_s + (k & 1) * CT_T * L::kLdw;
      gather_a_tile<T, CT_T>(a_b, gin_s, lidx_s + k * M, M);
      // W'[k] is [Ct, Cin]: rows ct0.., columns co0..
      load_w_tile<T, CT_T>(w_b, wt, k, Ct, cin, ct0, co0);
      // one barrier per k: the other buffer's readers finished before the
      // previous barrier (double buffering)
      __syncthreads();
      if (rows_live) {
        for (int kk = 0; kk < CT_T; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], a_b + (row0 + i * 16) * L::kLdg + kk,
                                   L::kLdg);
          for (int j = 0; j < 2; ++j) {
            if (!col_live[j]) continue;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, w_b + kk * L::kLdw + wcol + j * 16,
                                   L::kLdw);
            for (int i = 0; i < 2; ++i)
              wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          }
        }
      }
      if (drow_live && ncol > 0) {
        // dWt[k][co0+drow.., ct0+dcol..] += feats_c^T @ A over the M rows
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc[2];
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(dacc[j], 0.0f);
        for (int mm = 0; mm < M; mm += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> fa;
          wmma::load_matrix_sync(fa, f_s + mm * L::kLdf + drow, L::kLdf);
          for (int j = 0; j < 2; ++j) {
            if (!dcol_live[j]) continue;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, a_b + mm * L::kLdg + dcol + j * 16,
                                   L::kLdg);
            wmma::mma_sync(dacc[j], fa, fb, dacc[j]);
          }
        }
        float* d_w = d_s + drow * L::kLdd + dcol;  // this warp's region
        for (int j = 0; j < 2; ++j)
          if (dcol_live[j])
            wmma::store_matrix_sync(d_w + j * 16, dacc[j], L::kLdd,
                                    wmma::mem_row_major);
        __syncwarp();
        const int vpr = ncol / 4;
        float* g = dwt + (static_cast<size_t>(k) * cin + co0 + drow) * Ct +
                   ct0 + dcol;
        for (int i = lane; i < 16 * vpr; i += 32) {
          const int r = i / vpr, q = i % vpr;
          red_add4(g + static_cast<size_t>(r) * Ct + q * 4,
                   *reinterpret_cast<const float4*>(d_w + r * L::kLdd + q * 4));
        }
        __syncwarp();
      }
    }
  }

  if (!rows_live) return;
  float* o_w = o_s + warp * 256;
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 2; ++j) {
      if (!col_live[j]) continue;
      wmma::store_matrix_sync(o_w, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c8 = (lane % 2) * 8;
      __align__(16) T vals[8];
      for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(o_w[r * 16 + c8 + e]);
      const size_t orow = static_cast<size_t>(c) * M + row0 + i * 16 + r;
      *reinterpret_cast<uint4*>(d_feats + orow * cin + co0 + wcol + j * 16 +
                                c8) = *reinterpret_cast<const uint4*>(vals);
      __syncwarp();
    }
  }
}

template <int CT_T>
__global__ void __launch_bounds__(kThreads)
bwd_fused_f32_kernel(const float* __restrict__ ct, int n_ct, int Ct,
                     const int32_t* __restrict__ t_in_idx, int U,
                     const int32_t* __restrict__ t_lidx, int K, int M,
                     const float* __restrict__ wt,
                     const float* __restrict__ feats, int cin,
                     float* __restrict__ d_feats, float* __restrict__ dwt) {
  using T = float;
  using L = BwdLayout<T, CT_T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(U, K);
  int32_t* lidx_s = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  T* gin_s = reinterpret_cast<T*>(smem + lay.gin_off);
  T* w_s = reinterpret_cast<T*>(smem + lay.w_off);
  T* f_s = reinterpret_cast<T*>(smem + lay.f_off);

  const int c = blockIdx.x;
  const int co0 = blockIdx.y * kCoT;
  const int32_t* in_c = t_in_idx + static_cast<size_t>(c) * U;
  if (in_c[0] < 0) {
    write_zero_tile(d_feats, c, M, co0, cin);
    return;
  }
  load_lidx(lidx_s, t_lidx + static_cast<size_t>(c) * K * M, K, M, U);
  zero_row<T, CT_T>(gin_s, U);
  stage_feats_tile<T>(f_s, feats, c, M, cin, co0);

  // d_feats thread tile: rows rg*8..+8, columns cg*4..+4 of [128, 64]
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float acc[8][4];
  for (int r = 0; r < 8; ++r)
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  // dWt thread tile: kRpt rows x 4 columns of the block's [64, CT_T] slice
  constexpr int kCg = CT_T / 4, kRpt = CT_T / 16;
  const int dcg = threadIdx.x % kCg, drg = threadIdx.x / kCg;

  for (int ct0 = 0; ct0 < Ct; ct0 += CT_T) {
    __syncthreads();
    stage_rows<T, CT_T>(gin_s, ct, n_ct, Ct, in_c, U, ct0);
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      T* w_b = w_s + (k & 1) * CT_T * L::kLdw;
      load_w_tile<T, CT_T>(w_b, wt, k, Ct, cin, ct0, co0);
      __syncthreads();
      const int32_t* lk = lidx_s + k * M;
      const T* src[8];
      for (int r = 0; r < 8; ++r) {
        const int m = rg * 8 + r;
        src[r] = gin_s + static_cast<size_t>(m < M ? lk[m] : U) * L::kLdg;
      }
      for (int cc = 0; cc < CT_T; ++cc) {
        const float4 b = *reinterpret_cast<const float4*>(w_b + cc * L::kLdw +
                                                          cg * 4);
        for (int r = 0; r < 8; ++r) {
          const float a = src[r][cc];
          acc[r][0] = fmaf(a, b.x, acc[r][0]);
          acc[r][1] = fmaf(a, b.y, acc[r][1]);
          acc[r][2] = fmaf(a, b.z, acc[r][2]);
          acc[r][3] = fmaf(a, b.w, acc[r][3]);
        }
      }
      float dacc[kRpt][4];
      for (int r = 0; r < kRpt; ++r)
        for (int q = 0; q < 4; ++q) dacc[r][q] = 0.0f;
      for (int m = 0; m < M; ++m) {
        const float4 g = *reinterpret_cast<const float4*>(
            gin_s + static_cast<size_t>(lk[m]) * L::kLdg + dcg * 4);
        for (int r = 0; r < kRpt; ++r) {
          const float a = f_s[m * L::kLdf + drg * kRpt + r];
          dacc[r][0] = fmaf(a, g.x, dacc[r][0]);
          dacc[r][1] = fmaf(a, g.y, dacc[r][1]);
          dacc[r][2] = fmaf(a, g.z, dacc[r][2]);
          dacc[r][3] = fmaf(a, g.w, dacc[r][3]);
        }
      }
      for (int r = 0; r < kRpt; ++r) {
        const int row = co0 + drg * kRpt + r;
        if (row < cin)
          red_add4(dwt + (static_cast<size_t>(k) * cin + row) * Ct + ct0 +
                       dcg * 4,
                   make_float4(dacc[r][0], dacc[r][1], dacc[r][2], dacc[r][3]));
      }
    }
  }
  const int col = co0 + cg * 4;
  if (col >= cin) return;
  for (int r = 0; r < 8; ++r) {
    const int m = rg * 8 + r;
    if (m >= M) break;
    *reinterpret_cast<float4*>(d_feats + (static_cast<size_t>(c) * M + m) * cin +
                               col) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <typename T, int CT_T, typename Kernel>
int launch_fused(Kernel kernel, const void* ct, int n_ct, int Ct,
                 const void* t_in_idx, int C, int U, const void* t_lidx, int K,
                 int M, const void* wt, const void* feats, int cin,
                 void* d_feats, void* dwt, cudaStream_t stream) {
  const BwdLayout<T, CT_T> lay(U, K);
  const int smem = static_cast<int>(lay.total);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(C, (cin + kCoT - 1) / kCoT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(ct), n_ct, Ct,
      static_cast<const int32_t*>(t_in_idx), U,
      static_cast<const int32_t*>(t_lidx), K, M, static_cast<const T*>(wt),
      static_cast<const T*>(feats), cin, static_cast<T*>(d_feats),
      static_cast<float*>(dwt));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pick_ct_tile(int Ct, int U, int K) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  if (Ct % 64 == 0 && BwdLayout<T, 64>(U, K).total <= limit) return 64;
  if (Ct % 32 == 0 && BwdLayout<T, 32>(U, K).total <= limit) return 32;
  if (Ct % 16 == 0 && BwdLayout<T, 16>(U, K).total <= limit) return 16;
  return 0;
}

// ---------------------------------------------------------------------------
// dW over the forward plan
// ---------------------------------------------------------------------------

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

// d_feats [C*M, cin] (feature dtype) and dwt [K, cin, Ct] (f32, zeroed by
// the caller, accumulated) from ct [n_ct, Ct], the transpose plan, wt
// [K, Ct, cin] and feats [C*M, cin] (see the header). Returns a
// cudaError_t, or -2 when no Ct tile fits in shared memory.
int occ_chunk_conv_bwd_fused(const void* ct, int n_ct, int Ct,
                             const void* t_in_idx, int C, int U,
                             const void* t_lidx, int K, int M, const void* wt,
                             const void* feats, int cin, void* d_feats,
                             void* dwt, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (pick_ct_tile<bf16>(Ct, U, K)) {
      case 64: return launch_fused<bf16, 64>(bwd_fused_bf16_kernel<64>, ct, n_ct, Ct, t_in_idx, C, U, t_lidx, K, M, wt, feats, cin, d_feats, dwt, s);
      case 32: return launch_fused<bf16, 32>(bwd_fused_bf16_kernel<32>, ct, n_ct, Ct, t_in_idx, C, U, t_lidx, K, M, wt, feats, cin, d_feats, dwt, s);
      case 16: return launch_fused<bf16, 16>(bwd_fused_bf16_kernel<16>, ct, n_ct, Ct, t_in_idx, C, U, t_lidx, K, M, wt, feats, cin, d_feats, dwt, s);
    }
    return -2;
  }
  switch (pick_ct_tile<float>(Ct, U, K)) {
    case 64: return launch_fused<float, 64>(bwd_fused_f32_kernel<64>, ct, n_ct, Ct, t_in_idx, C, U, t_lidx, K, M, wt, feats, cin, d_feats, dwt, s);
    case 32: return launch_fused<float, 32>(bwd_fused_f32_kernel<32>, ct, n_ct, Ct, t_in_idx, C, U, t_lidx, K, M, wt, feats, cin, d_feats, dwt, s);
    case 16: return launch_fused<float, 16>(bwd_fused_f32_kernel<16>, ct, n_ct, Ct, t_in_idx, C, U, t_lidx, K, M, wt, feats, cin, d_feats, dwt, s);
  }
  return -2;
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
