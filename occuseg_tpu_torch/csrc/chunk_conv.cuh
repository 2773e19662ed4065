// Device helpers shared by the chunk-convolution kernels (chunk_conv.cu, the
// forward; chunk_conv_bwd.cu, the backward). Everything is in an anonymous
// namespace: each translation unit gets its own copy.
//
// A chunk is M <= 128 consecutive output rows. Its rulebook is in_idx[c, :U]
// (the sorted distinct input rows it references, -1 pad) and
// lidx[c, k, m] (the position of row m's neighbour at offset k in that
// list, -1 missing). The kernels stage the U referenced rows of one column
// tile in shared memory, with one zero row at index U that every -1 points
// at, so missing neighbours contribute exact zeros without branches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 128;   // output rows per chunk (planner M <= 128)
constexpr int kCoT = 64;     // output columns per block
constexpr int kThreads = 256;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Row strides of the staged rows (CI_T columns) and of a W tile (kCoT
// columns), padded by 16 B against bank conflicts.
template <typename T, int CI_T>
struct Strides {
  static constexpr int kVec = 16 / sizeof(T);            // elements per 16 B
  static constexpr int kLdg = CI_T + kVec;               // staged row stride
  static constexpr int kLdw = kCoT + kVec;               // W tile row stride
};

// Zero the block's [M, kCoT] output tile (all-pad chunk).
template <typename T>
__device__ void write_zero_tile(T* out, int c, int M, int co0, int cout) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = kCoT / kVec;
  for (int i = threadIdx.x; i < M * kVpr; i += kThreads) {
    const int m = i / kVpr, col = co0 + (i % kVpr) * kVec;
    if (col < cout)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(c) * M + m) * cout +
                                col) = make_uint4(0, 0, 0, 0);
  }
}

// Stage rows in_c[0..U) (columns ci0..ci0+CI_T) into gin_s.
template <typename T, int CI_T>
__device__ void stage_rows(T* gin_s, const T* __restrict__ feats, int n_rows,
                           int cin, const int32_t* __restrict__ in_c, int U,
                           int ci0) {
  using S = Strides<T, CI_T>;
  constexpr int kVpr = CI_T / S::kVec;
  for (int i = threadIdx.x; i < U * kVpr; i += kThreads) {
    const int u = i / kVpr, v = i % kVpr;
    const int row = in_c[u];
    T* dst = gin_s + static_cast<size_t>(u) * S::kLdg + v * S::kVec;
    if (row >= 0 && row < n_rows)
      cp_async16(dst, feats + static_cast<size_t>(row) * cin + ci0 +
                          v * S::kVec);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_wait_all();
}

// Zero staged row U (the row every missing neighbour reads).
template <typename T, int CI_T>
__device__ void zero_row(T* gin_s, int U) {
  using S = Strides<T, CI_T>;
  for (int i = threadIdx.x; i < S::kLdg / S::kVec; i += kThreads)
    reinterpret_cast<uint4*>(gin_s + static_cast<size_t>(U) * S::kLdg)[i] =
        make_uint4(0, 0, 0, 0);
}

// W[k][ci0..ci0+CI_T][co0..co0+kCoT] -> w_s (columns past cout are zero).
template <typename T, int CI_T>
__device__ void load_w_tile(T* w_s, const T* __restrict__ w, int k, int cin,
                            int cout, int ci0, int co0) {
  using S = Strides<T, CI_T>;
  constexpr int kVpr = kCoT / S::kVec;
  for (int i = threadIdx.x; i < CI_T * kVpr; i += kThreads) {
    const int ci = i / kVpr, col = co0 + (i % kVpr) * S::kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (col < cout)
      val = *reinterpret_cast<const uint4*>(
          w + (static_cast<size_t>(k) * cin + ci0 + ci) * cout + col);
    *reinterpret_cast<uint4*>(w_s + ci * S::kLdw + (i % kVpr) * S::kVec) = val;
  }
}

// lidx[c] -> lidx_s, with -1 (and anything out of range) mapped to the zero
// row U.
__device__ void load_lidx(int32_t* lidx_s, const int32_t* __restrict__ l_c,
                          int K, int M, int U) {
  for (int i = threadIdx.x; i < K * M; i += kThreads) {
    const int l = l_c[i];
    lidx_s[i] = (l >= 0 && l < U) ? l : U;
  }
}

// Gather the [M, CI_T] A tile of offset k from the staged rows through
// lidx_s (bf16 path: the tensor cores read A from shared memory).
template <typename T, int CI_T>
__device__ void gather_a_tile(T* a_s, const T* gin_s,
                              const int32_t* lidx_k, int M) {
  using S = Strides<T, CI_T>;
  constexpr int kVpr = CI_T / S::kVec;
  for (int i = threadIdx.x; i < M * kVpr; i += kThreads) {
    const int m = i / kVpr, v = i % kVpr;
    *reinterpret_cast<uint4*>(a_s + m * S::kLdg + v * S::kVec) =
        *reinterpret_cast<const uint4*>(
            gin_s + static_cast<size_t>(lidx_k[m]) * S::kLdg + v * S::kVec);
  }
}

int max_dynamic_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

}  // namespace
