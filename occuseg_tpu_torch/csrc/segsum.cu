// Blocked segment sum for Hopper (sm_90a): the points -> voxels reduction
// of the InputLayer under the sorted point layout.
//
// Replaces: the Pallas kernel of occuseg_tpu/ops/pallas/segsum.py
// (`blocked_segment_sum` -> `_call` -> `_kernel`), which computes
//
//   out[b*W + w] = sum over r < R with vox_seg[b, 0, r] == w of x[b*R + r]
//
// in f32 as a one-hot [W, R] @ [R, C] MXU product per block (a TPU scatter
// serialises on duplicate indices). Rows past B*R (the overflow tail) are
// not read; the caller adds them separately.
//
// What bounds it on the H100: it reads B*R*C f32 and writes B*W*C f32
// (bench shape: 3.1 MB read and 2.4 MB written at C=3, ~2 us at HBM
// bandwidth; 65 MB and 50 MB at C=64, ~35 us). The first kernel (one
// 256-thread block per voxel block, one global load per point in a
// dependent walk) took 0.0565 ms at C=64 inside a CUDA graph on the H100:
// each thread walked ~48 runs with one load in flight. At C=3 it took
// 0.0054 ms, about the cost of launching one wave of small blocks.
//
// Design: the point layout sorts a block's slots by voxel id, with pad
// slots (-1) at the end (core/point_layout.py), so each output row's
// points form one contiguous run. One CTA per voxel block stages the
// block's slot ids and its slab of x (rows b*R ... b*R + R - 1,
// contiguous) into shared memory by cp.async, 16 bytes a copy where the
// slab is 16-byte aligned, so the whole slab is in flight at once; one
// pass over the slots records each run's [start, end); then one thread per
// (voxel, channel), or per (voxel, 4 channels), sums its run from shared
// memory in slot order (the first kernel's order, so the result is the
// same bits) and stores it coalesced. Deterministic, no atomics; voxels
// with no point get 0; pad slots and ids >= W are skipped. The host's plan
// (`segsum.geometry`) picks 128 threads for a small slab and 256 for a
// large one (inside CUDA graphs on the H100: at C=3, 256 threads took
// ~10% longer and one warp per voxel block 1.6x; at C=64, 128 threads
// ~7%), and stages a slab of more than 64 KiB in chunks of `cc` columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy n 4-byte words from src to dst by threads t, t + nt, ...: 16 bytes
// a copy when `vec` (both 16-byte aligned, n a multiple of 4).
__device__ __forceinline__ void stage(void* dst, const void* src, int n,
                                      bool vec, int t, int nt) {
  if (vec) {
    for (int j = t; j < n / 4; j += nt)
      cp_async16(static_cast<float*>(dst) + 4 * j,
                 static_cast<const float*>(src) + 4 * j);
  } else {
    for (int j = t; j < n; j += nt)
      cp_async4(static_cast<float*>(dst) + j,
                static_cast<const float*>(src) + j);
  }
}

// [start, end) of each voxel's run (start and end zeroed before).
__device__ __forceinline__ void run_bounds(const int32_t* seg, int R, int W,
                                           int* start, int* end, int t,
                                           int nt) {
  for (int r = t; r < R; r += nt) {
    const int s = seg[r];
    if (s < 0 || s >= W) continue;
    if (r == 0 || seg[r - 1] != s) start[s] = r;
    if (r == R - 1 || seg[r + 1] != s) end[s] = r + 1;
  }
}

// out rows [W, ld_out] (column offset applied by the caller) from the
// staged slab [R, n]: thread t of nt sums (voxel, channel) outputs, four
// channels at a time when `vec4`.
__device__ __forceinline__ void sum_runs(const float* slab, int n,
                                         const int* start, const int* end,
                                         int W, float* out, int ld_out,
                                         bool vec4, int t, int nt) {
  if (vec4) {
    const int n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(slab);
    for (int i = t; i < W * n4; i += nt) {
      const int w = i / n4, q = i - w * n4;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int r = start[w]; r < end[w]; ++r) {
        const float4 v = s4[r * n4 + q];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(out + static_cast<size_t>(w) * ld_out +
                                 4 * q) = acc;
    }
  } else {
    for (int i = t; i < W * n; i += nt) {
      const int w = i / n, ch = i - w * n;
      float acc = 0.0f;
      for (int r = start[w]; r < end[w]; ++r) acc += slab[r * n + ch];
      out[static_cast<size_t>(w) * ld_out + ch] = acc;
    }
  }
}

// Shared memory of one voxel block (4-byte words): the slab [R, cc]
// (16-byte aligned), the slot ids [R] and the runs' starts and ends [W].
__host__ __device__ __forceinline__ int slab_words(int R, int cc) {
  return (R * cc + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ int unit_words(int R, int W, int cc) {
  return slab_words(R, cc) + (R + 2 * W + 3) / 4 * 4;
}

// CTA b sums voxel block b, in column chunks of cc.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ x, int C,
              const int32_t* __restrict__ vox_seg, int R, int W, int cc,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x, t = threadIdx.x;
  float* slab = sm;
  int* seg = reinterpret_cast<int*>(sm + slab_words(R, cc));
  int* start = seg + R;
  int* end = start + W;
  const float* xb = x + static_cast<size_t>(b) * R * C;
  float* ob = out + static_cast<size_t>(b) * W * C;
  stage(seg, vox_seg + static_cast<size_t>(b) * R, R, R % 4 == 0, t,
        kThreads);
  cp_async_commit();
  for (int w = t; w < W; w += kThreads) start[w] = end[w] = 0;
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int n = min(cc, C - c0);
    if (c0 > 0) __syncthreads();  // the previous chunk's readers are done
    if (n == C) {  // the whole slab, contiguous
      stage(slab, xb, R * C, (R * C) % 4 == 0, t, kThreads);
    } else if (C % 4 == 0 && n % 4 == 0) {  // rows of n columns, 16 B
      const int n4 = n / 4;
      for (int j = t; j < R * n4; j += kThreads) {
        const int r = j / n4, q = j - r * n4;
        cp_async16(slab + r * n + 4 * q, xb + static_cast<size_t>(r) * C +
                                             c0 + 4 * q);
      }
    } else {
      for (int j = t; j < R * n; j += kThreads) {
        const int r = j / n, ch = j - r * n;
        cp_async4(slab + j, xb + static_cast<size_t>(r) * C + c0 + ch);
      }
    }
    cp_async_commit();
    if (c0 == 0) {
      cp_async_wait<1>();  // the slot ids
      __syncthreads();
      run_bounds(seg, R, W, start, end, t, kThreads);
    }
    cp_async_wait<0>();
    __syncthreads();
    sum_runs(slab, n, start, end, W, ob + c0, C, C % 4 == 0 && n % 4 == 0, t,
             kThreads);
  }
}

template <int kThreads>
int launch(const float* x, int C, const int32_t* vox_seg, int B, int R,
           int W, int cc, float* out, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(unit_words(R, W, cc)) * 4;
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > static_cast<size_t>(limit)) return -2;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      segsum_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc) return rc;
  segsum_kernel<kThreads><<<B, kThreads, smem, s>>>(x, C, vox_seg, R, W, cc,
                                                    out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [B*W, C] f32 from x [>= B*R, C] f32 and vox_seg [B, 1, R] int32 (both
// 16-byte aligned), by CTAs of `threads` (128 or 256) staging column chunks
// of cc (`segsum.geometry`). Returns a cudaError_t, -2 when the shared
// memory does not fit, or -5 for another thread count.
int occ_blocked_segment_sum(const void* x, int C, const void* vox_seg, int B,
                            int R, int W, int threads, int cc, void* out,
                            void* stream) {
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* seg = static_cast<const int32_t*>(vox_seg);
  float* of = static_cast<float*>(out);
  if (threads == 128) return launch<128>(xf, C, seg, B, R, W, cc, of, s);
  if (threads == 256) return launch<256>(xf, C, seg, B, R, W, cc, of, s);
  return -5;
}

}  // extern "C"
