// Fused soft-membership BCE of the classification loss for Hopper (sm_90a):
// three kernels and one ordered reduction.
//
// Replaces the three Pallas kernels of occuseg_tpu/ops/pallas/bce_loss.py:
//  * `radius_sq` (`_radius_kernel`): r_sq[i] = max over the points p of
//    instance i of |x_p - mp_i|^2, the squared radius of the GT sample ball;
//  * `_bce_sums` (`_fwd_kernel`): over every (point p, instance i) pair,
//      sample  = |x_p - mp_i|^2 < 16 r_sq[i] & scene_p == scene_i & use_i
//      s_raw   = (|e_p - mu_i|^2 + 1e-12) sig0_i^2
//                + (|rx_p - mp_i|^2 + 1e-12) sig1_i^2
//      s       = clip(s_raw, S_LO, S_HI)
//      bce     = member ? s : -log(max(1 - exp(-s), 1e-16))
//    and per instance the five sums bce_sum, n_samp, tp, fp, tot
//    (pred = s < log 2, gt = member, both over sampled pairs);
//  * `_bce_sums_bwd` (`_bwd_kernel`): the VJP of bce_sum with cotangent
//    g[i]: de [P, E], drx [P, 4], dmu [I, E] and the two d(sig^2) rows.
// Every squared distance is |a|^2 + |b|^2 - 2 a.b clamped at 0, the TPU
// kernels' (and the XLA chain's) formulation; x, rx and mp come padded to 4
// columns. Nothing [P, I]-sized is stored: each kernel recomputes the pair
// terms from the point rows and the [I, E] centroids.
//
// What bounds them on the H100: the pair test is ~8 FLOP for each of the
// P*I pairs, and a sampled pair costs 2E FLOP more (the e.mu dot); the
// backward three such products. At the CLI shape (P=262144, I=128, E=64)
// the reads are ~80 MB (e, x, rx, the ids) against a few GFLOP of f32 FMA
// if every pair were sampled: bytes and operations are of the same order.
// These first kernels are bound instead by the divergent pair loop (one
// thread per instance, only the sampled pairs run the dot) and by the
// f32 FMA issue rate of the shared-memory dot products.
//
// Design:
//  * radius: grid-stride over points; each point meets only its own
//    instance; the max is taken with atomicMax on the float's bits (the
//    values are non-negative, so the bit order is the value order), first in
//    shared memory, then once per block and instance in device memory:
//    exact and deterministic.
//  * forward and backward: one block per range of points (ranges are fixed
//    by P and the SM count, so a card always sums in the same order), 256
//    threads; thread t owns instance t % 128 and every other point of each
//    tile of 32 points staged in shared memory, with the centroids mu
//    resident and transposed ([E][I+1], conflict-free for both thread
//    layouts below). A thread keeps its instance's sums in registers; the
//    block writes its partial row per instance and a second launch sums the
//    partials over the blocks in block order. No float is added with
//    atomics, so every output is deterministic.
//  * backward: per tile the pair pass writes g*sig0^2 and g*sig1^2 of every
//    pair to shared memory; then the threads switch to (row, column) layouts
//    for the three products over that tile: de rows (sum over instances),
//    drx rows, and the block's partial of sum_p g0 e_p per (instance,
//    column), kept in registers. Blocks cover E in slices of 64 columns
//    (grid.y), each recomputing the pair terms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxI = 128;        // instances (one thread each, two halves)
constexpr int kPt = 32;           // points per staged tile
constexpr int kEc = 64;           // E columns per backward block
constexpr float kSLo = 1.0000001e-7f;
constexpr float kSHi = 16.11809565095832f;
constexpr float kSPred = 0.6931471805599453f;

// rows of the [8, I] constants block (as in the TPU kernels)
enum { kMuSq = 0, kMpSq = 1, kSig0 = 2, kSig1 = 3, kR16 = 4, kScene = 5,
       kUse = 6 };

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Shared memory of the forward and backward kernels (floats).
struct Smem {
  int ldmu;                      // I + 1
  size_t mu, mp, cons, e, x, rx, xsq, rxsq, esq, seg, scene, g0, g1, red,
      total;
  __host__ __device__ Smem(int I, int E, bool bwd) {
    ldmu = I + 1;
    size_t o = 0;
    mu = o;    o += static_cast<size_t>(E) * ldmu;
    o = (o + 3) / 4 * 4;
    mp = o;    o += 4 * static_cast<size_t>(I);
    cons = o;  o += 7 * static_cast<size_t>(I);
    o = (o + 3) / 4 * 4;
    e = o;     o += static_cast<size_t>(kPt) * E;
    x = o;     o += 4 * kPt;
    rx = o;    o += 4 * kPt;
    xsq = o;   o += kPt;
    rxsq = o;  o += kPt;
    esq = o;   o += kPt;
    seg = o;   o += kPt;
    scene = o; o += kPt;
    g0 = o;    if (bwd) o += static_cast<size_t>(kPt) * I;
    g1 = o;    if (bwd) o += static_cast<size_t>(kPt) * I;
    red = o;   o += 2 * 5 * kMaxI;
    total = o * sizeof(float);
  }
};

// Stage the resident operands: mu transposed into [E][I+1], mp, cons rows.
__device__ void stage_resident(float* sm, const Smem& L,
                               const float* __restrict__ mu,
                               const float4* __restrict__ mp4,
                               const float* __restrict__ cons, int I, int E) {
  float* mu_s = sm + L.mu;
  for (int j = threadIdx.x; j < I * E; j += kThreads) {
    const int i = j / E, d = j % E;
    mu_s[d * L.ldmu + i] = mu[j];
  }
  float4* mp_s = reinterpret_cast<float4*>(sm + L.mp);
  for (int i = threadIdx.x; i < I; i += kThreads) mp_s[i] = mp4[i];
  for (int j = threadIdx.x; j < 7 * I; j += kThreads) sm[L.cons + j] = cons[j];
}

// Stage points [p0, p0 + n) of e, x, rx, ids; with the three |.|^2.
__device__ void stage_tile(float* sm, const Smem& L,
                           const float* __restrict__ e, int E,
                           const float4* __restrict__ x4,
                           const float4* __restrict__ rx4,
                           const int32_t* __restrict__ seg,
                           const int32_t* __restrict__ scene, int p0, int n) {
  float* e_s = sm + L.e;
  for (int j = threadIdx.x; j < n * E; j += kThreads)
    e_s[j] = e[static_cast<size_t>(p0) * E + j];
  float4* x_s = reinterpret_cast<float4*>(sm + L.x);
  float4* rx_s = reinterpret_cast<float4*>(sm + L.rx);
  int* seg_s = reinterpret_cast<int*>(sm + L.seg);
  int* scene_s = reinterpret_cast<int*>(sm + L.scene);
  if (threadIdx.x < n) {
    const int p = p0 + threadIdx.x;
    const float4 x = x4[p], rx = rx4[p];
    x_s[threadIdx.x] = x;
    rx_s[threadIdx.x] = rx;
    sm[L.xsq + threadIdx.x] = dot4(x, x);
    sm[L.rxsq + threadIdx.x] = dot4(rx, rx);
    seg_s[threadIdx.x] = seg[p];
    scene_s[threadIdx.x] = scene[p];
  }
  __syncthreads();
  // |e|^2 per row: one warp per row, lanes over columns, fixed order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kThreads / 32) {
    float v = 0.0f;
    for (int d = lane; d < E; d += 32) v += e_s[r * E + d] * e_s[r * E + d];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sm[L.esq + r] = v;
  }
}

// Pair terms of staged point r and instance i; false when not sampled.
__device__ __forceinline__ bool pair_terms(const float* sm, const Smem& L,
                                           int r, int i, int I, int E,
                                           float& s_raw, float& sq_emb,
                                           float& sq_r, bool& member) {
  const float* cons = sm + L.cons;
  const float4 mp = reinterpret_cast<const float4*>(sm + L.mp)[i];
  const float4 x = reinterpret_cast<const float4*>(sm + L.x)[r];
  const float sq_x =
      fmaxf(sm[L.xsq + r] + cons[kMpSq * I + i] - 2.0f * dot4(x, mp), 0.0f);
  const int scene = reinterpret_cast<const int*>(sm + L.scene)[r];
  if (!(sq_x < cons[kR16 * I + i] &&
        static_cast<float>(scene) == cons[kScene * I + i] &&
        cons[kUse * I + i] > 0.0f))
    return false;
  const float* e_r = sm + L.e + r * E;
  const float* mu_s = sm + L.mu + i;
  float dot = 0.0f;
  for (int d = 0; d < E; ++d) dot = fmaf(e_r[d], mu_s[d * L.ldmu], dot);
  sq_emb = fmaxf(sm[L.esq + r] + cons[kMuSq * I + i] - 2.0f * dot, 0.0f);
  const float4 rx = reinterpret_cast<const float4*>(sm + L.rx)[r];
  sq_r = fmaxf(sm[L.rxsq + r] + cons[kMpSq * I + i] - 2.0f * dot4(rx, mp),
               0.0f);
  s_raw = (sq_emb + 1e-12f) * cons[kSig0 * I + i] +
          (sq_r + 1e-12f) * cons[kSig1 * I + i];
  member = reinterpret_cast<const int*>(sm + L.seg)[r] == i;
  return true;
}

__global__ void __launch_bounds__(kThreads)
radius_kernel(const float4* __restrict__ x4, const int32_t* __restrict__ seg,
              int P, const float4* __restrict__ mp4,
              const float* __restrict__ mp_sq, int I,
              unsigned* __restrict__ r_bits) {
  __shared__ unsigned r_s[kMaxI];
  for (int i = threadIdx.x; i < I; i += kThreads) r_s[i] = 0u;
  __syncthreads();
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < P;
       p += gridDim.x * kThreads) {
    const int i = seg[p];
    if (i < 0 || i >= I) continue;
    const float4 x = x4[p];
    const float sq =
        fmaxf(dot4(x, x) + mp_sq[i] - 2.0f * dot4(x, mp4[i]), 0.0f);
    atomicMax(&r_s[i], __float_as_uint(sq));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < I; i += kThreads)
    if (r_s[i]) atomicMax(&r_bits[i], r_s[i]);
}

__global__ void __launch_bounds__(kThreads)
bce_fwd_kernel(const float* __restrict__ e, int P, int E,
               const float4* __restrict__ rx4, const float4* __restrict__ x4,
               const int32_t* __restrict__ seg,
               const int32_t* __restrict__ scene,
               const float* __restrict__ mu, const float4* __restrict__ mp4,
               const float* __restrict__ cons, int I, int range,
               float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  const Smem L(I, E, false);
  stage_resident(sm, L, mu, mp4, cons, I, E);
  const int i = threadIdx.x % kMaxI, half = threadIdx.x / kMaxI;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int p_begin = blockIdx.x * range;
  const int p_end = min(P, p_begin + range);
  for (int p0 = p_begin; p0 < p_end; p0 += kPt) {
    const int n = min(kPt, p_end - p0);
    __syncthreads();  // the previous tile's readers are done
    stage_tile(sm, L, e, E, x4, rx4, seg, scene, p0, n);
    __syncthreads();
    if (i >= I) continue;
    for (int r = half; r < n; r += 2) {
      float s_raw, sq_emb, sq_r;
      bool member;
      if (!pair_terms(sm, L, r, i, I, E, s_raw, sq_emb, sq_r, member))
        continue;
      const float s = fminf(fmaxf(s_raw, kSLo), kSHi);
      const float not_mem = -logf(fmaxf(1.0f - expf(-s), 1e-16f));
      const bool pred = s < kSPred;
      acc[0] += member ? s : not_mem;
      acc[1] += 1.0f;
      acc[2] += (pred && member) ? 1.0f : 0.0f;
      acc[3] += (pred && !member) ? 1.0f : 0.0f;
      acc[4] += member ? 1.0f : 0.0f;
    }
  }
  float* red = sm + L.red;
  __syncthreads();
  for (int q = 0; q < 5; ++q) red[(half * 5 + q) * kMaxI + i] = acc[q];
  __syncthreads();
  if (half == 0 && i < I)
    for (int q = 0; q < 5; ++q)
      part[(static_cast<size_t>(blockIdx.x) * 5 + q) * I + i] =
          red[q * kMaxI + i] + red[(5 + q) * kMaxI + i];
}

__global__ void __launch_bounds__(kThreads)
bce_bwd_kernel(const float* __restrict__ e, int P, int E,
               const float4* __restrict__ rx4, const float4* __restrict__ x4,
               const int32_t* __restrict__ seg,
               const int32_t* __restrict__ scene,
               const float* __restrict__ mu, const float4* __restrict__ mp4,
               const float* __restrict__ cons, int I,
               const float* __restrict__ gvec, int range,
               float* __restrict__ de, float4* __restrict__ drx,
               float* __restrict__ dmu_part, float* __restrict__ scal_part) {
  extern __shared__ __align__(16) float sm[];
  const Smem L(I, E, true);
  stage_resident(sm, L, mu, mp4, cons, I, E);
  const int i = threadIdx.x % kMaxI, half = threadIdx.x / kMaxI;
  const int d0 = blockIdx.y * kEc;
  const int dn = min(kEc, E - d0);
  const bool first_slice = blockIdx.y == 0;
  const float gi = i < I ? gvec[i] : 0.0f;
  float* g0_s = sm + L.g0;
  float* g1_s = sm + L.g1;
  const float* mu_s = sm + L.mu;
  const float4* mp_s = reinterpret_cast<const float4*>(sm + L.mp);
  // instance scalars: sum g0, sum g (sq_emb + eps), sum g (sq_r + eps)
  float scal[3] = {0.0f, 0.0f, 0.0f};
  // (instance, column) partials of sum_p g0 e_p: column tc = t % 64,
  // instances t / 64 + 4 j
  const int tc = threadIdx.x % kEc, ti = threadIdx.x / kEc;
  float acc_mu[kMaxI / 4];
#pragma unroll
  for (int j = 0; j < kMaxI / 4; ++j) acc_mu[j] = 0.0f;

  const int p_begin = blockIdx.x * range;
  const int p_end = min(P, p_begin + range);
  for (int p0 = p_begin; p0 < p_end; p0 += kPt) {
    const int n = min(kPt, p_end - p0);
    __syncthreads();
    stage_tile(sm, L, e, E, x4, rx4, seg, scene, p0, n);
    __syncthreads();
    // pair pass: g0 = g sig0^2 and g1 = g sig1^2 of every pair
    if (i < I) {
      for (int r = half; r < n; r += 2) {
        float s_raw, sq_emb, sq_r, g = 0.0f;
        bool member;
        if (pair_terms(sm, L, r, i, I, E, s_raw, sq_emb, sq_r, member) &&
            s_raw > kSLo && s_raw < kSHi) {
          const float p_ = expf(-s_raw);
          const float dbce = member ? 1.0f : -p_ / fmaxf(1.0f - p_, 1e-16f);
          g = gi * dbce;
          scal[1] += g * (sq_emb + 1e-12f);
          scal[2] += g * (sq_r + 1e-12f);
        }
        const float g0 = g * sm[L.cons + kSig0 * I + i];
        g0_s[r * I + i] = g0;
        g1_s[r * I + i] = g * sm[L.cons + kSig1 * I + i];
        scal[0] += g0;
      }
    }
    __syncthreads();
    // the block's partial of sum_p g0[p, i] e[p, d0 + tc]
    if (tc < dn) {
#pragma unroll
      for (int j = 0; j < kMaxI / 4; ++j) {
        const int ii = ti + 4 * j;
        if (ii < I) {
          float v = acc_mu[j];
          for (int r = 0; r < n; ++r)
            v = fmaf(g0_s[r * I + ii], sm[L.e + r * E + d0 + tc], v);
          acc_mu[j] = v;
        }
      }
    }
    // de rows: 2 (sum_i g0 * e - sum_i g0 mu_i), columns d0 + tc
    if (tc < dn) {
      for (int r = ti; r < n; r += kThreads / kEc) {
        float G0 = 0.0f, v = 0.0f;
        for (int ii = 0; ii < I; ++ii) {
          const float g0 = g0_s[r * I + ii];
          G0 += g0;
          v = fmaf(g0, mu_s[(d0 + tc) * L.ldmu + ii], v);
        }
        de[static_cast<size_t>(p0 + r) * E + d0 + tc] =
            2.0f * (G0 * sm[L.e + r * E + d0 + tc] - v);
      }
    }
    // drx rows (first slice): 2 (sum_i g1 * rx - sum_i g1 mp_i)
    if (first_slice && threadIdx.x < n) {
      const int r = threadIdx.x;
      float G1 = 0.0f;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int ii = 0; ii < I; ++ii) {
        const float g1 = g1_s[r * I + ii];
        const float4 m = mp_s[ii];
        G1 += g1;
        v.x = fmaf(g1, m.x, v.x);
        v.y = fmaf(g1, m.y, v.y);
        v.z = fmaf(g1, m.z, v.z);
        v.w = fmaf(g1, m.w, v.w);
      }
      const float4 rx = reinterpret_cast<const float4*>(sm + L.rx)[r];
      drx[p0 + r] = make_float4(2.0f * (G1 * rx.x - v.x), 2.0f * (G1 * rx.y - v.y),
                                2.0f * (G1 * rx.z - v.z), 2.0f * (G1 * rx.w - v.w));
    }
  }
  if (tc < dn) {
#pragma unroll
    for (int j = 0; j < kMaxI / 4; ++j) {
      const int ii = ti + 4 * j;
      if (ii < I)
        dmu_part[(static_cast<size_t>(blockIdx.x) * I + ii) * E + d0 + tc] =
            acc_mu[j];
    }
  }
  if (!first_slice) return;
  float* red = sm + L.red;
  __syncthreads();
  for (int q = 0; q < 3; ++q) red[(half * 3 + q) * kMaxI + i] = scal[q];
  __syncthreads();
  if (half == 0 && i < I)
    for (int q = 0; q < 3; ++q)
      scal_part[(static_cast<size_t>(blockIdx.x) * 3 + q) * I + i] =
          red[q * kMaxI + i] + red[(3 + q) * kMaxI + i];
}

// out[j] = sum over b < n_blocks of part[b * n + j], in block order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ part, int n_blocks, int n,
                    float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  float v = 0.0f;
  for (int b = 0; b < n_blocks; ++b) v += part[static_cast<size_t>(b) * n + j];
  out[j] = v;
}

int sum_partials(const float* part, int n_blocks, int n, float* out,
                 cudaStream_t s) {
  sum_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, n_blocks, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// r_bits [I] (zeroed by the caller; read back as f32) = per-instance max
// squared distance of its own points (seg == i) to mp_i. x4 [P, 4],
// mp4 [I, 4], mp_sq [I] f32, seg [P] int32. Returns a cudaError_t.
int occ_bce_radius(const void* x4, const void* seg, int P, const void* mp4,
                   const void* mp_sq, int I, void* r_bits, int n_blocks,
                   void* stream) {
  if (I > kMaxI) return -3;
  radius_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x4), static_cast<const int32_t*>(seg), P,
      static_cast<const float4*>(mp4), static_cast<const float*>(mp_sq), I,
      static_cast<unsigned*>(r_bits));
  return static_cast<int>(cudaGetLastError());
}

// out [5, I] = the five per-instance sums over P points (see the header),
// through part [n_blocks, 5, I] (caller-allocated scratch); blocks cover
// `range` points each (a multiple of 32). Returns a cudaError_t, or -3
// when I exceeds 128.
int occ_bce_fwd(const void* e, int P, int E, const void* rx4, const void* x4,
                const void* seg, const void* scene, const void* mu,
                const void* mp4, const void* cons, int I, int range,
                int n_blocks, void* part, void* out, void* stream) {
  if (I > kMaxI) return -3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Smem L(I, E, false);
  int rc = set_smem(bce_fwd_kernel, L.total);
  if (rc) return rc;
  bce_fwd_kernel<<<n_blocks, kThreads, L.total, s>>>(
      static_cast<const float*>(e), P, E, static_cast<const float4*>(rx4),
      static_cast<const float4*>(x4), static_cast<const int32_t*>(seg),
      static_cast<const int32_t*>(scene), static_cast<const float*>(mu),
      static_cast<const float4*>(mp4), static_cast<const float*>(cons), I,
      range, static_cast<float*>(part));
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  return sum_partials(static_cast<const float*>(part), n_blocks, 5 * I,
                      static_cast<float*>(out), s);
}

// The VJP of bce_sum with cotangent gvec [I]: de [P, E], drx [P, 4], and,
// through the scratch dmu_part [n_blocks, I, E] and scal_part
// [n_blocks, 3, I], gte [I, E] = sum_p g0[p, i] e_p and scal [3, I] = (sum_p
// g0, d sig0^2, d sig1^2). Returns a cudaError_t, or -3 when I exceeds 128.
int occ_bce_bwd(const void* e, int P, int E, const void* rx4, const void* x4,
                const void* seg, const void* scene, const void* mu,
                const void* mp4, const void* cons, int I, const void* gvec,
                int range, int n_blocks, void* de, void* drx, void* dmu_part,
                void* scal_part, void* gte, void* scal, void* stream) {
  if (I > kMaxI) return -3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Smem L(I, E, true);
  int rc = set_smem(bce_bwd_kernel, L.total);
  if (rc) return rc;
  const dim3 grid(n_blocks, (E + kEc - 1) / kEc);
  bce_bwd_kernel<<<grid, kThreads, L.total, s>>>(
      static_cast<const float*>(e), P, E, static_cast<const float4*>(rx4),
      static_cast<const float4*>(x4), static_cast<const int32_t*>(seg),
      static_cast<const int32_t*>(scene), static_cast<const float*>(mu),
      static_cast<const float4*>(mp4), static_cast<const float*>(cons), I,
      static_cast<const float*>(gvec), range, static_cast<float*>(de),
      static_cast<float4*>(drx), static_cast<float*>(dmu_part),
      static_cast<float*>(scal_part));
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  rc = sum_partials(static_cast<const float*>(dmu_part), n_blocks, I * E,
                    static_cast<float*>(gte), s);
  if (rc) return rc;
  return sum_partials(static_cast<const float*>(scal_part), n_blocks, 3 * I,
                      static_cast<float*>(scal), s);
}

}  // extern "C"
