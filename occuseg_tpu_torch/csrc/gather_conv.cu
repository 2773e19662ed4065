// Gather convolution over a neighbour map for Hopper (sm_90a).
//
// Replaces: the Pallas kernel of occuseg_tpu/ops/pallas/gather_conv.py
// (`gather_conv_pallas` -> `_pallas_conv` -> `_kernel`), which computes
//
//   out[n] = sum_k (nbr_kn[k, n] >= 0 ? feats[nbr_kn[k, n]] : 0) @ W[k]
//
// for feats [N, Cin], the transposed neighbour map nbr_kn [K, N] int32 and
// W [K, Cin, Cout], with f32 accumulation and the output in the feature
// dtype. The TPU kernel keeps a whole level's features resident in VMEM and
// permutes them per offset (the one gather Mosaic lowers), which limits it
// to Cin % 128 == 0 and small levels. Here each block gathers its rows
// straight from device memory, so any Cin and Cout that are multiples of 8
// are taken.
//
// What bounds it on the H100: 2*Cin*Cout FLOP per valid (row, offset) pair
// against one gathered row of Cin elements per pair; at Cin = Cout = 256 in
// bf16 that is 256 FLOP per byte gathered, near the ridge, and the gathered
// rows of a coarse level fit in L2. This first version is bound by the
// per-offset tile loads and two barriers per (offset, Cin tile), not by
// the tensor cores.
//
// Design: one block (8 warps) per (64 output rows, 64 output columns). For
// each offset k and each Cin tile of 32 columns the block gathers the
// [64, 32] A tile through nbr_kn (16 B per thread; a -1 neighbour, a row
// past N and columns past Cin read as zeros) and the [32, 64] tile of W[k],
// then bf16: the 4 x 2 warps run WMMA 16x16x16 bf16 -> f32 on 16 x 32
// outputs each; f32: each thread keeps a 4 x 4 register tile (FMA, exact
// products). The output is written once, in the feature dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

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

// A tile: rows r0.., columns ci0.. of feats gathered through nbr_kn[k].
template <typename T>
__device__ void load_a(T* a_s, const T* __restrict__ feats, int N, int cin,
                       const int32_t* __restrict__ nbr_k, int r0, int ci0) {
  using S = Tiles<T>;
  constexpr int kVpr = kCiT / S::kVec;
  for (int i = threadIdx.x; i < kRows * kVpr; i += kThreads) {
    const int m = i / kVpr, col = ci0 + (i % kVpr) * S::kVec;
    const int r = r0 + m;
    const int src = r < N ? nbr_k[r] : -1;
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
gather_conv_bf16_kernel(const __nv_bfloat16* __restrict__ feats, int N,
                        int cin, const int32_t* __restrict__ nbr_kn, int K,
                        const __nv_bfloat16* __restrict__ w, int cout,
                        __nv_bfloat16* __restrict__ out) {
  using T = __nv_bfloat16;
  using S = Tiles<T>;
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(128) T a_s[kRows * S::kLda];
  __shared__ __align__(128) T b_s[kCiT * S::kLdb];
  __shared__ __align__(128) float o_s[8 * 256];
  const int r0 = blockIdx.x * kRows, co0 = blockIdx.y * kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k = 0; k < K; ++k) {
    const int32_t* nbr_k = nbr_kn + static_cast<size_t>(k) * N;
    for (int ci0 = 0; ci0 < cin; ci0 += kCiT) {
      __syncthreads();  // the previous tile's readers are done
      load_a<T>(a_s, feats, N, cin, nbr_k, r0, ci0);
      load_b<T>(b_s, w, k, cin, cout, ci0, co0);
      __syncthreads();
      for (int kk = 0; kk < kCiT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a_s + wr * S::kLda + kk, S::kLda);
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, b_s + kk * S::kLdb + wc + j * 16,
                                 S::kLdb);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  float* o_w = o_s + warp * 256;
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(o_w, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int r = lane / 2, c8 = (lane % 2) * 8;
    const int row = r0 + wr + r, col = co0 + wc + j * 16 + c8;
    if (row < N && col < cout) {
      __align__(16) T vals[8];
      for (int q = 0; q < 8; ++q) vals[q] = __float2bfloat16(o_w[r * 16 + c8 + q]);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * cout + col) =
          *reinterpret_cast<const uint4*>(vals);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
gather_conv_f32_kernel(const float* __restrict__ feats, int N, int cin,
                       const int32_t* __restrict__ nbr_kn, int K,
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
    const int32_t* nbr_k = nbr_kn + static_cast<size_t>(k) * N;
    for (int ci0 = 0; ci0 < cin; ci0 += kCiT) {
      __syncthreads();
      load_a<float>(a_s, feats, N, cin, nbr_k, r0, ci0);
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
    if (row >= N) break;
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * cout + col) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

}  // namespace

extern "C" {

// out [N, cout] = sum_k feats[nbr_kn[k]] @ w[k] (see the header); feats
// [N, cin], w [K, cin, cout] in one dtype, cin and cout multiples of 8.
// Returns a cudaError_t, or -2 when cin or cout is not a multiple of 8.
int occ_gather_conv(const void* feats, int N, int cin, const void* nbr_kn,
                    int K, const void* w, int cout, void* out, int is_bf16,
                    void* stream) {
  if (cin % 8 || cout % 8) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kRows - 1) / kRows, (cout + kCols - 1) / kCols);
  if (is_bf16)
    gather_conv_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), N, cin,
        static_cast<const int32_t*>(nbr_kn), K,
        static_cast<const __nv_bfloat16*>(w), cout,
        static_cast<__nv_bfloat16*>(out));
  else
    gather_conv_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feats), N, cin,
        static_cast<const int32_t*>(nbr_kn), K, static_cast<const float*>(w),
        cout, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
