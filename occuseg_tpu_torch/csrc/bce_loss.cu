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
// But only ~7% of the pairs are sampled (2.3M of 33.6M at that shape).
// The forward is bound by its divergent pair loop (one thread per
// instance, only the sampled pairs run the dot) and the f32 FMA issue
// rate of its shared-memory dots. The backward's first kernel wrote g0/g1
// of every (point, instance) pair of a 32-point tile into shared memory
// and ran its three products over all I instances: ~93% of its FMAs and
// shared-memory reads multiplied zeros, behind two barriers per 32
// points (2.16 ms at the CLI shape on the H100).
//
// Design:
//  * radius: grid-stride over points; each point meets only its own
//    instance; the max is taken with atomicMax on the float's bits (the
//    values are non-negative, so the bit order is the value order), first in
//    shared memory, then once per block and instance in device memory:
//    exact and deterministic.
//  * forward: one block per range of points (ranges are fixed by P and
//    the SM count, so a card always sums in the same order), 256 threads;
//    thread t owns instance t % 128 and every other point of each tile of
//    32 points staged in shared memory, with the centroids mu resident and
//    transposed ([E][I+1]). A thread keeps its instance's sums in
//    registers; the block writes its partial row per instance and a second
//    launch sums the partials over the blocks in block order. No float is
//    added with atomics, so every output is deterministic.
//  * backward (`bce_bwd_kernel`): the same ranges in larger tiles (64 or
//    128 points, `bce_loss.bwd_geometry`), and the products only over the
//    pairs that carry a gradient: per tile the sampled pairs are compacted
//    into a list (warp ballots, a scan of the per-point counts; point-major,
//    instances ascending; only the instances of the tile's scene are
//    tested where its points share one), one thread per entry computes
//    its dot and g, and then one warp per point walks its entries (de, drx)
//    and one warp per instance walks its points (the block's dmu partial
//    in registers, the d(sig^2) sums). The decisions are the forward's:
//    the same sample test, the same |a|^2 + |b|^2 - 2ab terms and clip
//    tests. Blocks cover E in slices of 64 columns (grid.y), each
//    recomputing the pair terms; block partials are summed in block
//    order. What bounds it is latency: 512-thread blocks, two an SM at
//    64 registers, measured 0.54 ms at the CLI shape on the H100 where
//    one block an SM without spills took 0.72 and 256-thread blocks 0.63;
//    the per-instance walk then took ~0.19 ms of it and the staging,
//    tests and barriers ~0.26.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxI = 128;        // instances (one thread each, two halves)
constexpr int kPt = 32;           // points per forward tile
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

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst))),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Shared memory of the forward kernel (floats).
struct Smem {
  int ldmu;                      // I + 1
  size_t mu, mp, cons, e, x, rx, xsq, rxsq, esq, seg, scene, red, total;
  __host__ __device__ Smem(int I, int E) {
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
  const Smem L(I, E);
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

// ---- the backward: the pair-list walk ----

constexpr int kBwdThreads = 512;                // 16 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxPt = 128;                     // points per tile, at most
constexpr int kMaskWords = kMaxI / 32;          // candidate bits per point
constexpr int kWords = kMaxPt / 32;             // point bits per instance
constexpr int kSlots = kMaxI / kBwdWarps;       // instances per warp

// Shared memory of the backward kernel (4-byte words), for tiles of `pt`
// points and a pair list of `lcap` entries. The host's copy of this plan
// is `bce_loss.bwd_smem_bytes`.
struct BwdSmem {
  // I + 1; E + 4 (E a multiple of 4: rows 16-byte aligned for cp.async,
  // and rows 8 apart on other banks)
  int ldmu, lde;
  size_t mu, mp, cons, gv, e, x, rx, xsq, rxsq, esq, seg, scene, cand, rmask,
      rstart, imask, eidx, ent, ent_ri, total;
  __host__ __device__ BwdSmem(int I, int E, int pt, int lcap) {
    ldmu = I + 1;
    lde = E + 4;
    size_t o = 0;
    mu = o;     o += static_cast<size_t>(E) * ldmu;
    o = (o + 3) / 4 * 4;
    mp = o;     o += 4 * static_cast<size_t>(I);
    x = o;      o += 4 * static_cast<size_t>(pt);
    rx = o;     o += 4 * static_cast<size_t>(pt);
    cons = o;   o += 7 * static_cast<size_t>(I);
    gv = o;     o += I;
    e = o;      o += static_cast<size_t>(pt) * lde;
    xsq = o;    o += pt;
    rxsq = o;   o += pt;
    esq = o;    o += pt;
    seg = o;    o += pt;
    scene = o;  o += pt;
    cand = o;   o += kMaxI + 1;  // the list, then its length
    rmask = o;  o += static_cast<size_t>(pt) * kMaskWords;
    rstart = o; o += pt + 1;
    imask = o;  o += static_cast<size_t>(kMaxI) * kWords;
    eidx = o;   o += (static_cast<size_t>(pt) * I + 1) / 2;  // int16
    o = (o + 3) / 4 * 4;
    ent = o;    o += 4 * static_cast<size_t>(lcap);  // float4 per entry
    ent_ri = o; o += lcap;
    total = o * sizeof(float);
  }
};

// The VJP of bce_sum over the pairs that carry a gradient. blockIdx.x
// covers points [x * range, (x + 1) * range) in tiles of `pt`, blockIdx.y
// the E columns [64 y, 64 y + 64) of de and dmu (the pair terms are
// recomputed per slice). Per tile:
//  1. stage the tile's rows (e by cp.async); list the candidate instances
//     in ascending order (use > 0 and, where every point of the tile has
//     one scene, that scene);
//  2. one warp per point tests its candidates (the forward's sample test)
//     with ballots: a bit mask and a count per point; one warp scans the
//     counts into each point's first list slot;
//  3. in windows of whole points whose pairs fit in `lcap` entries (one
//     window unless the tile is dense), write the sampled pairs as a list,
//     point-major with instances ascending, and then, one thread per
//     entry, its e.mu dot (in the forward's order), s_raw, the clip test,
//     g and the entry's four terms (g sig0^2, g sig1^2, g (sq_emb + eps),
//     g (sq_r + eps)); g != 0 sets the pair's bit in its instance's point
//     mask;
//  4. one warp per point walks its entries in list order (de = 2 (G0 e -
//     sum g0 mu_i), one coalesced row store, zero for a point without
//     pairs; drx); one warp per instance walks its points in order, two
//     at a time, and adds the window's sums to the block's dmu partial
//     (sum g0 e_p, in registers) and, in the lane of its slot, to the
//     instance's three d(sig^2) sums.
// No float is added with atomics: every sum has a fixed order, and the
// block partials are summed in block order by a second launch.
__global__ void __launch_bounds__(kBwdThreads, 2)
bce_bwd_kernel(const float* __restrict__ e, int P, int E,
               const float4* __restrict__ rx4, const float4* __restrict__ x4,
               const int32_t* __restrict__ seg,
               const int32_t* __restrict__ scene,
               const float* __restrict__ mu, const float4* __restrict__ mp4,
               const float* __restrict__ cons, int I,
               const float* __restrict__ gvec, int range, int pt, int lcap,
               float* __restrict__ de, float4* __restrict__ drx,
               float* __restrict__ dmu_part, float* __restrict__ scal_part) {
  extern __shared__ __align__(16) float sm[];
  const BwdSmem L(I, E, pt, lcap);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const unsigned lt = (1u << lane) - 1u;
  const int d0 = blockIdx.y * kEc;
  const int dn = min(kEc, E - d0);
  const bool first_slice = blockIdx.y == 0;
  float* mu_s = sm + L.mu;
  const float4* mp_s = reinterpret_cast<const float4*>(sm + L.mp);
  const float4* x_s = reinterpret_cast<const float4*>(sm + L.x);
  const float4* rx_s = reinterpret_cast<const float4*>(sm + L.rx);
  const float* cn = sm + L.cons;
  float* e_s = sm + L.e;
  int* seg_s = reinterpret_cast<int*>(sm + L.seg);
  int* scene_s = reinterpret_cast<int*>(sm + L.scene);
  int* cand = reinterpret_cast<int*>(sm + L.cand);
  unsigned* rmask = reinterpret_cast<unsigned*>(sm + L.rmask);
  int* rstart = reinterpret_cast<int*>(sm + L.rstart);
  unsigned* imask = reinterpret_cast<unsigned*>(sm + L.imask);
  int16_t* eidx = reinterpret_cast<int16_t*>(sm + L.eidx);
  float4* ent = reinterpret_cast<float4*>(sm + L.ent);
  int* ent_ri = reinterpret_cast<int*>(sm + L.ent_ri);

  // resident: mu transposed into [E][I+1], mp, the constants, g
  for (int j = t; j < I * E; j += kBwdThreads)
    mu_s[(j % E) * L.ldmu + j / E] = mu[j];
  for (int i = t; i < I; i += kBwdThreads) {
    reinterpret_cast<float4*>(sm + L.mp)[i] = mp4[i];
    sm[L.gv + i] = gvec[i];
  }
  for (int j = t; j < 7 * I; j += kBwdThreads) sm[L.cons + j] = cons[j];

  // the block's dmu partial: warp w, slot s holds instance w + 16 s at
  // columns d0 + lane and d0 + lane + 32; lane s of the warp holds the
  // slot's sums of g0, g (sq_emb + eps) and g (sq_r + eps)
  float acc[kSlots][2];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s][0] = acc[s][1] = 0.0f;
  float scal[3] = {0.0f, 0.0f, 0.0f};

  const int p_begin = blockIdx.x * range;
  const int p_end = min(P, p_begin + range);
  for (int p0 = p_begin; p0 < p_end; p0 += pt) {
    const int n = min(pt, p_end - p0);
    // 1. stage (the previous tile's walks ended at a barrier)
    for (int j = t; j < n * (E / 4); j += kBwdThreads)
      cp_async16(e_s + (j / (E / 4)) * L.lde + (j % (E / 4)) * 4,
                 e + static_cast<size_t>(p0) * E + j * 4);
    for (int r = t; r < n; r += kBwdThreads) {
      const int p = p0 + r;
      const float4 x = x4[p], rx = rx4[p];
      reinterpret_cast<float4*>(sm + L.x)[r] = x;
      reinterpret_cast<float4*>(sm + L.rx)[r] = rx;
      sm[L.xsq + r] = dot4(x, x);
      sm[L.rxsq + r] = dot4(rx, rx);
      seg_s[r] = seg[p];
      scene_s[r] = scene[p];
    }
    cp_async_wait_all();
    __syncthreads();
    // |e|^2 per row: one warp per row, lanes over columns, fixed order
    for (int r = warp; r < n; r += kBwdWarps) {
      float v = 0.0f;
      for (int d = lane; d < E; d += 32)
        v += e_s[r * L.lde + d] * e_s[r * L.lde + d];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) sm[L.esq + r] = v;
    }
    if (warp == kBwdWarps - 1) {
      const int s0 = scene_s[0];
      bool one = true;
      for (int r = lane; r < n; r += 32) one = one && scene_s[r] == s0;
      one = __all_sync(0xffffffffu, one);
      int nc = 0;
      for (int i0 = 0; i0 < I; i0 += 32) {
        const int i = i0 + lane;
        const bool ok = i < I && cn[kUse * I + i] > 0.0f &&
                        (!one || cn[kScene * I + i] == static_cast<float>(s0));
        const unsigned b = __ballot_sync(0xffffffffu, ok);
        if (ok) cand[nc + __popc(b & lt)] = i;
        nc += __popc(b);
      }
      if (lane == 0) cand[kMaxI] = nc;
    }
    __syncthreads();
    const int nc = cand[kMaxI];
    // 2. the sample test of every (point, candidate) pair
    for (int r = warp; r < n; r += kBwdWarps) {
      const float4 x = x_s[r];
      const float xsq = sm[L.xsq + r];
      const float sc = static_cast<float>(scene_s[r]);
      int cnt = 0;
      for (int j0 = 0; j0 < nc; j0 += 32) {
        bool s = false;
        if (j0 + lane < nc) {
          const int i = cand[j0 + lane];
          const float sq_x =
              fmaxf(xsq + cn[kMpSq * I + i] - 2.0f * dot4(x, mp_s[i]), 0.0f);
          s = sq_x < cn[kR16 * I + i] && sc == cn[kScene * I + i] &&
              cn[kUse * I + i] > 0.0f;
        }
        const unsigned b = __ballot_sync(0xffffffffu, s);
        if (lane == 0) rmask[r * kMaskWords + j0 / 32] = b;
        cnt += __popc(b);
      }
      if (lane == 0) rstart[r + 1] = cnt;
    }
    __syncthreads();
    if (warp == 0) {  // counts -> first slots (inclusive scan, 4 per lane)
      int v[4], run = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = lane * 4 + k;
        run += r < n ? rstart[r + 1] : 0;
        v[k] = run;
      }
      int inc = run;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      const int before = inc - run;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (lane * 4 + k < n) rstart[lane * 4 + k + 1] = before + v[k];
      if (lane == 0) rstart[0] = 0;
    }
    __syncthreads();

    // 3. windows of whole points whose pairs fit in the list
    for (int r0 = 0; r0 < n;) {
      int r1 = n;
      if (rstart[n] - rstart[r0] > lcap) {
        r1 = r0 + 1;
        while (r1 < n && rstart[r1 + 1] - rstart[r0] <= lcap) ++r1;
      }
      const int base = rstart[r0], nw = rstart[r1] - base;
      for (int j = t; j < I * kWords; j += kBwdThreads) imask[j] = 0u;
      for (int r = r0 + warp; r < r1; r += kBwdWarps) {
        int off = rstart[r] - base;
        for (int j0 = 0; j0 < nc; j0 += 32) {
          const unsigned b = rmask[r * kMaskWords + j0 / 32];
          if ((b >> lane) & 1u)
            ent_ri[off + __popc(b & lt)] = (r << 8) | cand[j0 + lane];
          off += __popc(b);
        }
      }
      __syncthreads();
      for (int q = t; q < nw; q += kBwdThreads) {
        const int r = ent_ri[q] >> 8, i = ent_ri[q] & 255;
        const float* e_r = e_s + r * L.lde;
        float dot = 0.0f;  // in the forward's order: d ascending
#pragma unroll 8
        for (int d = 0; d < E; ++d) dot = fmaf(e_r[d], mu_s[d * L.ldmu + i], dot);
        const float sq_emb =
            fmaxf(sm[L.esq + r] + cn[kMuSq * I + i] - 2.0f * dot, 0.0f);
        const float sq_r = fmaxf(
            sm[L.rxsq + r] + cn[kMpSq * I + i] - 2.0f * dot4(rx_s[r], mp_s[i]),
            0.0f);
        const float s_raw = (sq_emb + 1e-12f) * cn[kSig0 * I + i] +
                            (sq_r + 1e-12f) * cn[kSig1 * I + i];
        float g = 0.0f;
        if (s_raw > kSLo && s_raw < kSHi) {
          const float p_ = expf(-s_raw);
          const float dbce =
              seg_s[r] == i ? 1.0f : -p_ / fmaxf(1.0f - p_, 1e-16f);
          g = sm[L.gv + i] * dbce;
        }
        ent[q] = make_float4(g * cn[kSig0 * I + i], g * cn[kSig1 * I + i],
                             g * (sq_emb + 1e-12f), g * (sq_r + 1e-12f));
        eidx[r * I + i] = static_cast<int16_t>(q);
        if (g != 0.0f) atomicOr(imask + i * kWords + r / 32, 1u << (r % 32));
      }
      __syncthreads();
      // 4a. de and drx: one warp per point, its entries in list order (an
      // entry without a gradient adds exact zeros)
      for (int r = r0 + warp; r < r1; r += kBwdWarps) {
        float G0 = 0.0f, G1 = 0.0f, v[2] = {0.0f, 0.0f};
        float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int q1 = rstart[r + 1] - base;
#pragma unroll 4
        for (int q = rstart[r] - base; q < q1; ++q) {
          const float4 en = ent[q];
          const int i = ent_ri[q] & 255;
          G0 += en.x;
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (lane + 32 * c < dn)
              v[c] = fmaf(en.x, mu_s[(d0 + lane + 32 * c) * L.ldmu + i], v[c]);
          if (first_slice) {
            const float4 m = mp_s[i];
            G1 += en.y;
            w.x = fmaf(en.y, m.x, w.x);
            w.y = fmaf(en.y, m.y, w.y);
            w.z = fmaf(en.y, m.z, w.z);
            w.w = fmaf(en.y, m.w, w.w);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = d0 + lane + 32 * c;
          if (lane + 32 * c < dn)
            de[static_cast<size_t>(p0 + r) * E + d] =
                2.0f * (G0 * e_s[r * L.lde + d] - v[c]);
        }
        if (first_slice && lane == 0) {
          const float4 rx = rx_s[r];
          drx[p0 + r] = make_float4(
              2.0f * (G1 * rx.x - w.x), 2.0f * (G1 * rx.y - w.y),
              2.0f * (G1 * rx.z - w.z), 2.0f * (G1 * rx.w - w.w));
        }
      }
      // 4b. dmu and d(sig^2): one warp per instance, its points in order,
      // two at a time (their loads in flight together), summed over the
      // window and then added to the block's sums. The slot loop is not
      // unrolled, so its loops are compiled once; the registers of slot s
      // are updated by predicated adds.
      for (int s = 0; s < kSlots; ++s) {
        const int i = warp + kBwdWarps * s;
        if (i >= I) break;
        float a[2] = {0.0f, 0.0f}, t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
        for (int wd = 0; wd * 32 < r1; ++wd) {
          unsigned bits = imask[i * kWords + wd];
          while (bits) {
            int rr[2];
            float4 en[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              rr[u] = -1;
              if (bits) {
                rr[u] = wd * 32 + __ffs(bits) - 1;
                bits &= bits - 1u;
                en[u] = ent[eidx[rr[u] * I + i]];
              }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (rr[u] < 0) break;
#pragma unroll
              for (int c = 0; c < 2; ++c)
                if (lane + 32 * c < dn)
                  a[c] = fmaf(en[u].x, e_s[rr[u] * L.lde + d0 + lane + 32 * c],
                              a[c]);
              t0 += en[u].x;
              t1 += en[u].z;
              t2 += en[u].w;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k)
          if (k == s) {
            acc[k][0] += a[0];
            acc[k][1] += a[1];
          }
        if (lane == s) {
          scal[0] += t0;
          scal[1] += t1;
          scal[2] += t2;
        }
      }
      __syncthreads();  // the next window or tile overwrites the list
      r0 = r1;
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = warp + kBwdWarps * s;
    if (i >= I) break;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (lane + 32 * c < dn)
        dmu_part[(static_cast<size_t>(blockIdx.x) * I + i) * E + d0 + lane +
                 32 * c] = acc[s][c];
  }
  if (first_slice && lane < kSlots && warp + kBwdWarps * lane < I)
    for (int k = 0; k < 3; ++k)
      scal_part[(static_cast<size_t>(blockIdx.x) * 3 + k) * I + warp +
                kBwdWarps * lane] = scal[k];
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
  const Smem L(I, E);
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
// g0, d sig0^2, d sig1^2). Blocks cover `range` points each in tiles of
// `pt` (<= 128) with a pair list of `lcap` (>= 128) entries; E is a
// multiple of 4. Returns a cudaError_t, -3 when I exceeds 128, or -2 when
// E, the tile or the list does not fit.
int occ_bce_bwd(const void* e, int P, int E, const void* rx4, const void* x4,
                const void* seg, const void* scene, const void* mu,
                const void* mp4, const void* cons, int I, const void* gvec,
                int range, int n_blocks, int pt, int lcap, void* de,
                void* drx, void* dmu_part, void* scal_part, void* gte,
                void* scal, void* stream) {
  if (I > kMaxI) return -3;
  if (E % 4 || pt < 1 || pt > kMaxPt || lcap < kMaxI || lcap > 32767)
    return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdSmem L(I, E, pt, lcap);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (L.total > static_cast<size_t>(limit)) return -2;
  int rc = set_smem(bce_bwd_kernel, L.total);
  if (rc) return rc;
  const dim3 grid(n_blocks, (E + kEc - 1) / kEc);
  bce_bwd_kernel<<<grid, kBwdThreads, L.total, s>>>(
      static_cast<const float*>(e), P, E, static_cast<const float4*>(rx4),
      static_cast<const float4*>(x4), static_cast<const int32_t*>(seg),
      static_cast<const int32_t*>(scene), static_cast<const float*>(mu),
      static_cast<const float4*>(mp4), static_cast<const float*>(cons), I,
      static_cast<const float*>(gvec), range, pt, lcap,
      static_cast<float*>(de),
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
