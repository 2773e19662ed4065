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
// with f32 accumulation and the output in the feature dtype. The TPU kernel
// permutes the staged rows with one-hot MXU products because Mosaic cannot
// gather rows; that formulation is not carried over. Here the rows are
// gathered from shared memory directly, as the reference CUDA chunk kernel
// did (SparseConvNet Convolution.cu, chunk-based kernel).
//
// What bounds it on the H100: per chunk the work is M*K*Cin*Cout*2 FLOP
// against ~U*Cin (staged input rows) + M*Cout (output) elements of device
// memory traffic. At the bench L0 shape (M=128, K=27, Cin=Cout=64, U~330)
// that is ~28 MFLOP per ~60 KB, ~470 FLOP/byte: above the bf16 ridge
// (~295 FLOP/byte), so a good kernel is tensor-core bound. This first
// version is bound instead by shared memory traffic and synchronisation:
// every offset k re-gathers an [M, CI_T] A tile inside shared memory and
// synchronises the block once, and the large staged tile keeps one or two
// blocks per SM.
//
// Design:
//  * one block (8 warps) per (chunk, 64-column Cout tile);
//  * per Cin tile of CI_T columns, the chunk's U referenced rows are staged
//    into shared memory with cp.async (16 B per thread); row U is a zero
//    row, and every missing neighbour (lidx = -1) points at it, so pad
//    rows and missing neighbours contribute exact zeros without branches;
//  * bf16: per k the A tile is gathered from the staged rows through lidx
//    into a double-buffered shared tile, W[k]'s tile beside it, and the
//    warps (4 x 2, 32x32 outputs each) run WMMA 16x16x16 bf16 -> f32;
//  * f32 (parity checks): each thread keeps an 8x4 register tile and reads
//    the staged rows through lidx directly (FMA, exact f32);
//  * CI_T is the largest of 64/32/16 that divides Cin and whose shared
//    memory fits the device's opt-in limit; beyond it the call fails (the
//    wrapper raises) -- there is no other path;
//  * a chunk with no referenced row (all cap padding) writes zeros and
//    returns.
// wgmma, TMA, int16 lidx and the occupancy of the coarse levels are left
// for later work.

#include <mma.h>

#include "chunk_conv.cuh"

namespace {

// Shared memory plan shared by host and device.
template <typename T, int CI_T>
struct Layout : Strides<T, CI_T> {
  using S = Strides<T, CI_T>;
  static constexpr bool kMma = sizeof(T) == 2;
  size_t lidx_off, gin_off, a_off, w_off, o_off, total;
  __host__ __device__ Layout(int U, int K) {
    size_t off = 0;
    lidx_off = off;
    off += align128(static_cast<size_t>(K) * kMaxM * sizeof(int32_t));
    gin_off = off;
    off += align128(static_cast<size_t>(U + 1) * S::kLdg * sizeof(T));
    a_off = off;
    if (kMma) off += align128(2 * static_cast<size_t>(kMaxM) * S::kLdg * sizeof(T));
    w_off = off;
    off += align128(2 * static_cast<size_t>(CI_T) * S::kLdw * sizeof(T));
    o_off = off;
    if (kMma) off += align128(8 * 256 * sizeof(float));
    total = off;
  }
};

template <int CI_T>
__global__ void __launch_bounds__(kThreads)
chunk_conv_bf16_kernel(const __nv_bfloat16* __restrict__ feats, int n_rows,
                       int cin, const int32_t* __restrict__ in_idx, int U,
                       const int32_t* __restrict__ lidx, int K, int M,
                       const __nv_bfloat16* __restrict__ w, int cout,
                       __nv_bfloat16* __restrict__ out) {
  using T = __nv_bfloat16;
  using L = Layout<T, CI_T>;
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(U, K);
  int32_t* lidx_s = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  T* gin_s = reinterpret_cast<T*>(smem + lay.gin_off);
  T* a_s = reinterpret_cast<T*>(smem + lay.a_off);
  T* w_s = reinterpret_cast<T*>(smem + lay.w_off);
  float* o_s = reinterpret_cast<float*>(smem + lay.o_off);

  const int c = blockIdx.x;
  const int co0 = blockIdx.y * kCoT;
  const int32_t* in_c = in_idx + static_cast<size_t>(c) * U;
  if (in_c[0] < 0) {  // no referenced row: pure cap padding
    write_zero_tile(out, c, M, co0, cout);
    return;
  }
  load_lidx(lidx_s, lidx + static_cast<size_t>(c) * K * M, K, M, U);
  zero_row<T, CI_T>(gin_s, U);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp >> 1) * 32;             // 4 warp rows x 32
  const int wcol = (warp & 1) * 32;              // 2 warp cols x 32
  const bool rows_live = row0 < M;
  bool col_live[2];
  for (int j = 0; j < 2; ++j) col_live[j] = co0 + wcol + j * 16 < cout;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int ci0 = 0; ci0 < cin; ci0 += CI_T) {
    __syncthreads();  // previous tile's readers of gin_s / a_s are done
    stage_rows<T, CI_T>(gin_s, feats, n_rows, cin, in_c, U, ci0);
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      T* a_b = a_s + (k & 1) * kMaxM * L::kLdg;
      T* w_b = w_s + (k & 1) * CI_T * L::kLdw;
      // gather the A tile through lidx (the zero row serves -1)
      gather_a_tile<T, CI_T>(a_b, gin_s, lidx_s + k * M, M);
      load_w_tile<T, CI_T>(w_b, w, k, cin, cout, ci0, co0);
      // one barrier per k: the other buffer's readers finished before the
      // previous barrier, so double buffering makes a second one needless
      __syncthreads();
      if (rows_live) {
        for (int kk = 0; kk < CI_T; kk += 16) {
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
      *reinterpret_cast<uint4*>(out + orow * cout + co0 + wcol + j * 16 + c8) =
          *reinterpret_cast<const uint4*>(vals);
      __syncwarp();
    }
  }
}

template <int CI_T>
__global__ void __launch_bounds__(kThreads)
chunk_conv_f32_kernel(const float* __restrict__ feats, int n_rows, int cin,
                      const int32_t* __restrict__ in_idx, int U,
                      const int32_t* __restrict__ lidx, int K, int M,
                      const float* __restrict__ w, int cout,
                      float* __restrict__ out) {
  using T = float;
  using L = Layout<T, CI_T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(U, K);
  int32_t* lidx_s = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  T* gin_s = reinterpret_cast<T*>(smem + lay.gin_off);
  T* w_s = reinterpret_cast<T*>(smem + lay.w_off);

  const int c = blockIdx.x;
  const int co0 = blockIdx.y * kCoT;
  const int32_t* in_c = in_idx + static_cast<size_t>(c) * U;
  if (in_c[0] < 0) {
    write_zero_tile(out, c, M, co0, cout);
    return;
  }
  load_lidx(lidx_s, lidx + static_cast<size_t>(c) * K * M, K, M, U);
  zero_row<T, CI_T>(gin_s, U);

  // thread tile: rows rg*8..+8, columns cg*4..+4 of the 128 x 64 block
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float acc[8][4];
  for (int r = 0; r < 8; ++r)
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;

  for (int ci0 = 0; ci0 < cin; ci0 += CI_T) {
    __syncthreads();
    stage_rows<T, CI_T>(gin_s, feats, n_rows, cin, in_c, U, ci0);
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      T* w_b = w_s + (k & 1) * CI_T * L::kLdw;
      load_w_tile<T, CI_T>(w_b, w, k, cin, cout, ci0, co0);
      __syncthreads();
      const T* src[8];
      for (int r = 0; r < 8; ++r) {
        const int m = rg * 8 + r;
        src[r] = gin_s + static_cast<size_t>(m < M ? lidx_s[k * M + m] : U) *
                             L::kLdg;
      }
      for (int ci = 0; ci < CI_T; ++ci) {
        const float4 b = *reinterpret_cast<const float4*>(w_b + ci * L::kLdw +
                                                          cg * 4);
        for (int r = 0; r < 8; ++r) {
          const float a = src[r][ci];
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
  for (int r = 0; r < 8; ++r) {
    const int m = rg * 8 + r;
    if (m >= M) break;
    *reinterpret_cast<float4*>(out + (static_cast<size_t>(c) * M + m) * cout +
                               col) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <typename T, int CI_T, typename Kernel>
int launch(Kernel kernel, const void* feats, int n_rows, int cin,
           const void* in_idx, int C, int U, const void* lidx, int K, int M,
           const void* w, int cout, void* out, cudaStream_t stream) {
  const Layout<T, CI_T> lay(U, K);
  const int smem = static_cast<int>(lay.total);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(C, (cout + kCoT - 1) / kCoT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), n_rows, cin,
      static_cast<const int32_t*>(in_idx), U,
      static_cast<const int32_t*>(lidx), K, M, static_cast<const T*>(w), cout,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pick_ci_tile(int cin, int U, int K) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  if (cin % 64 == 0 && Layout<T, 64>(U, K).total <= limit) return 64;
  if (cin % 32 == 0 && Layout<T, 32>(U, K).total <= limit) return 32;
  if (cin % 16 == 0 && Layout<T, 16>(U, K).total <= limit) return 16;
  return 0;
}

}  // namespace

extern "C" {

// out [C*M, cout] = chunk conv of feats [n_rows, cin] (see the header).
// Returns a cudaError_t, or -2 when no Cin tile fits in shared memory.
int occ_chunk_conv_fwd(const void* feats, int n_rows, int cin,
                       const void* in_idx, int C, int U, const void* lidx,
                       int K, int M, const void* w, int cout, void* out,
                       int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (pick_ci_tile<__nv_bfloat16>(cin, U, K)) {
      case 64: return launch<__nv_bfloat16, 64>(chunk_conv_bf16_kernel<64>, feats, n_rows, cin, in_idx, C, U, lidx, K, M, w, cout, out, s);
      case 32: return launch<__nv_bfloat16, 32>(chunk_conv_bf16_kernel<32>, feats, n_rows, cin, in_idx, C, U, lidx, K, M, w, cout, out, s);
      case 16: return launch<__nv_bfloat16, 16>(chunk_conv_bf16_kernel<16>, feats, n_rows, cin, in_idx, C, U, lidx, K, M, w, cout, out, s);
    }
    return -2;
  }
  switch (pick_ci_tile<float>(cin, U, K)) {
    case 64: return launch<float, 64>(chunk_conv_f32_kernel<64>, feats, n_rows, cin, in_idx, C, U, lidx, K, M, w, cout, out, s);
    case 32: return launch<float, 32>(chunk_conv_f32_kernel<32>, feats, n_rows, cin, in_idx, C, U, lidx, K, M, w, cout, out, s);
    case 16: return launch<float, 16>(chunk_conv_f32_kernel<16>, feats, n_rows, cin, in_idx, C, U, lidx, K, M, w, cout, out, s);
  }
  return -2;
}

}  // extern "C"
