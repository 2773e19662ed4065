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
// But only ~7% of the pairs are sampled (2.3M of 33.6M at that shape), so
// a kernel that runs a per-pair loop over all pairs leaves most of its
// lanes idle: the first forward (one thread per instance, only the
// sampled pairs running the dot; 0.85 ms at the CLI shape on the H100)
// and the first backward (products over all I instances of 32-point
// tiles, ~93% of them on zeros; 2.16 ms) were latency-bound that way.
//
// Design:
//  * radius: the max is taken on the float's bits (the values are
//    non-negative, so the bit order is the value order): exact in any
//    order. One launch writes every output word (0 for an instance with no
//    point), so the wrapper allocates with torch.empty and no memset runs.
//    A thread reads four points (one int4 of ids, four float4 of x, its
//    next four already in flight) and folds equal neighbouring ids; each
//    of its four slots then takes one warp-wide round in which every run
//    of one id over consecutive lanes reaches shared memory with one
//    atomicMax (a segmented max by shuffles; one reduction where the warp
//    holds one id). The CLI's points come as runs of one instance, so most
//    of its warps take one atomic per 128 points. Grouping the lanes with
//    __match_any_sync instead measured 1.9x slower on random ids, where a
//    warp holds ~28 ids (`tools/conv_variants.py` radius_match_any). The
//    P % 4 last points take one more round in warp 0 of block 0. Across
//    blocks, the blocks take their maxima into a device scratch [I] with
//    global atomics and count themselves on a device counter: the last to
//    finish moves the scratch into the output, zeroing it, and sets the
//    counter back to 0 for the next launch. (One thread-block cluster of
//    16 blocks combining its shared words through distributed shared
//    memory measured 2.3-2.7x slower: it reads the points with 16 SMs.)
//    What bounds it on the H100 is latency: the points' 5 MB take ~1.5 us
//    at full bandwidth, and the last block's fence, count and exchange
//    add ~1.2 us (`tools/conv_variants.py` radius_no_chain) to ~3.6 us.
//  * the pair list, shared by the forward and the backward: one block per
//    range of points (ranges are fixed by P and the SM count, so a card
//    always sums in the same order), 512 threads, in tiles of 32-128
//    points (`bce_loss.fwd_geometry` / `bwd_geometry`). Per tile the
//    sampled pairs are compacted into a list (warp ballots, a scan of the
//    per-point counts; point-major, instances ascending; only the
//    instances of the tile's scene are tested where its points share one)
//    and walked in windows of whole points that fit the list. The
//    decisions are the same in both: the same sample test, the same
//    |a|^2 + |b|^2 - 2ab terms, the same e.mu dot (d ascending).
//  * forward (`bce_fwd_kernel`): one thread per entry computes its dot,
//    s, the bce term and the prediction; then one warp per instance, its
//    lanes over the window's points, reads the instance's entries (found
//    from the point's candidate mask, no map) and adds the bce terms in
//    per-lane sums, summed over the lanes by a fixed tree at the end; the
//    counts are ballots of the sampled, predicted and member bits. What
//    bounds it is latency, phase after phase between barriers: 0.26 ms at
//    the CLI shape on the H100 in 128-point tiles, of which (timing
//    variants with a phase left out, `tools/conv_variants.py`) staging,
//    candidates, sample tests and scan took ~0.115, the entries' terms
//    ~0.063 and the per-instance walk ~0.060. Smaller tiles at three
//    blocks an SM (40 registers, with spills) were not faster in a trial.
//  * backward (`bce_bwd_kernel`): one thread per entry computes its dot
//    and g, then one warp per point walks its entries (de, drx) and one
//    warp per instance walks its points (the block's dmu partial in
//    registers, the d(sig^2) sums). Blocks cover E in slices of 64
//    columns (grid.y), each recomputing the pair terms. What bounds it is
//    latency: 512-thread blocks, two an SM at 64 registers, measured 0.54
//    ms at the CLI shape on the H100 where one block an SM without spills
//    took 0.72 and 256-thread blocks 0.63; the per-instance walk then
//    took ~0.19 ms of it and the staging, tests and barriers ~0.26.
// No float is added with atomics: every sum has a fixed order, and the
// block partials are summed in block order by a second launch, so every
// output is deterministic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // partial sums
constexpr int kRadiusThreads = 256;  // the radius kernel's blocks
constexpr int kMaxI = 128;        // instances
constexpr int kListThreads = 512; // the pair-list kernels: 16 warps
constexpr int kListWarps = kListThreads / 32;
constexpr int kMaxPt = 128;                     // points per tile, at most
constexpr int kMaskWords = kMaxI / 32;          // candidate bits per point
constexpr int kWords = kMaxPt / 32;             // point bits per instance
constexpr int kSlots = kMaxI / kListWarps;      // instances per warp
constexpr int kEc = 64;           // E columns per backward block
constexpr float kSLo = 1.0000001e-7f;
constexpr float kSHi = 16.11809565095832f;
constexpr float kSPred = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

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

// One warp-wide round of the radius max: each run of one valid id over
// consecutive lanes takes its max of `bits` (a segmented scan by
// shuffles) and puts it into r_s[id] with one shared atomicMax from its
// last lane. A warp of one id reduces with one instruction; a warp whose
// lanes all differ from their neighbours takes one atomic a lane.
__device__ __forceinline__ void radius_round(unsigned* r_s, int id,
                                             unsigned bits, int lane) {
  if (!__any_sync(kFull, id >= 0)) return;  // uniform over the warp
  const int prev = __shfl_up_sync(kFull, id, 1);
  const unsigned starts = __ballot_sync(kFull, lane == 0 || prev != id);
  if (starts == 1u) {  // one run: every lane holds the same valid id
    const unsigned m = __reduce_max_sync(kFull, bits);
    if (lane == 0) atomicMax(r_s + id, m);
    return;
  }
  if (starts != kFull) {
    const int head = 31 - __clz(starts & (kFull >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned up = __shfl_up_sync(kFull, bits, d);
      if (lane - d >= head) bits = max(bits, up);
    }
  }
  const int next = __shfl_down_sync(kFull, id, 1);
  if (id >= 0 && (lane == 31 || next != id)) atomicMax(r_s + id, bits);
}

// A thread's 4 consecutive points (one int4 of ids, four float4 of x);
// ids out of range, and every id of a vector past P / 4, are -1.
struct Quad {
  int id[4];
  float4 x[4];
};

__device__ __forceinline__ Quad radius_load(const float4* __restrict__ x4,
                                            const int32_t* __restrict__ seg,
                                            int v, int P4, int I) {
  Quad q;
  int4 s4 = make_int4(-1, -1, -1, -1);
  if (v < P4) s4 = reinterpret_cast<const int4*>(seg)[v];
  q.id[0] = s4.x;
  q.id[1] = s4.y;
  q.id[2] = s4.z;
  q.id[3] = s4.w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (static_cast<unsigned>(q.id[j]) >= static_cast<unsigned>(I))
      q.id[j] = -1;
    q.x[j] = v < P4 ? x4[4 * v + j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return q;
}

// |x|^2 + |mp_i|^2 - 2 x.mp_i clamped at 0 (the plain version's
// formulation), as bits.
__device__ __forceinline__ unsigned radius_bits(float4 x, const float4* mp_s,
                                                const float* mp_sq_s, int i) {
  return __float_as_uint(
      fmaxf(dot4(x, x) + mp_sq_s[i] - 2.0f * dot4(x, mp_s[i]), 0.0f));
}

// The quad into r_s: a run inside the thread reaches the warp once, from
// its last slot; then one round a slot.
__device__ __forceinline__ void radius_take(const Quad& q, const float4* mp_s,
                                            const float* mp_sq_s,
                                            unsigned* r_s, int lane) {
  int id[4];
  unsigned bits[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    id[j] = q.id[j];
    bits[j] = id[j] >= 0 ? radius_bits(q.x[j], mp_s, mp_sq_s, id[j]) : 0u;
  }
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (id[j] == id[j - 1]) {
      bits[j] = max(bits[j], bits[j - 1]);
      id[j - 1] = -1;
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) radius_round(r_s, id[j], bits[j], lane);
}

// The P / 4 vectors are dealt to warps grid-stride, 32 consecutive vectors
// a warp, so every lane of a warp runs the same iterations; each thread's
// next vector is loaded while it takes the current one, and its first
// before the block stages mp and mp_sq in shared memory. The P % 4 last
// points take one more round in warp 0 of block 0. The block's maxima
// (r_s) then go into scratch [I] with global atomics, and the block counts
// itself on `counter`; the last block moves scratch into the output,
// zeroing it, and resets the counter. Both are 0 before a launch and
// after it.
__global__ void __launch_bounds__(kRadiusThreads)
radius_kernel(const float4* __restrict__ x4, const int32_t* __restrict__ seg,
              int P, const float4* __restrict__ mp4,
              const float* __restrict__ mp_sq, int I, unsigned* scratch,
              unsigned* counter, unsigned* __restrict__ r_bits) {
  __shared__ float4 mp_s[kMaxI];
  __shared__ float mp_sq_s[kMaxI];
  __shared__ unsigned r_s[kMaxI];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t % 32;
  const int warps = kRadiusThreads / 32;
  const int stride = gridDim.x * warps * 32;
  const int P4 = P / 4;
  int base = (blockIdx.x * warps + t / 32) * 32;
  Quad q = radius_load(x4, seg, base + lane, P4, I);
  for (int i = t; i < I; i += kRadiusThreads) {
    mp_s[i] = mp4[i];
    mp_sq_s[i] = mp_sq[i];
    r_s[i] = 0u;
  }
  __syncthreads();
  for (; base < P4; base += stride) {
    const Quad next = radius_load(x4, seg, base + stride + lane, P4, I);
    radius_take(q, mp_s, mp_sq_s, r_s, lane);
    q = next;
  }
  if (blockIdx.x == 0 && t < 32) {  // the last P % 4 points
    const int p = 4 * P4 + lane;
    int id = p < P ? seg[p] : -1;
    unsigned bits = 0u;
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(I))
      id = -1;
    else
      bits = radius_bits(x4[p], mp_s, mp_sq_s, id);
    radius_round(r_s, id, bits, lane);
  }
  __syncthreads();
  for (int i = t; i < I; i += kRadiusThreads)
    if (r_s[i]) atomicMax(scratch + i, r_s[i]);
  __threadfence();  // this block's maxima land before its count
  __syncthreads();
  if (t == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = t; i < I; i += kRadiusThreads)
    r_bits[i] = atomicExch(scratch + i, 0u);
  if (t == 0) *counter = 0u;
}

// ---- the pair list, shared by the forward and the backward ----

// Shared memory of the pair-list kernels (4-byte words), for tiles of `pt`
// points and a pair list of `lcap` entries; `bwd` adds the backward's
// cotangent, per-instance point masks and (point, instance) -> entry map,
// and widens an entry from two floats to four. The host's copy of this
// plan is `bce_loss.list_smem_bytes`.
struct ListSmem {
  // E + 4, the row stride of mu and e (E a multiple of 4: rows 16-byte
  // aligned for cp.async and float4 reads, and rows 4 banks apart)
  int lde;
  size_t mu, mp, x, rx, cons, gv, e, xsq, rxsq, esq, seg, scene, cand, cpos,
      rmask, rstart, imask, eidx, ent, ent_ri, total;
  __host__ __device__ ListSmem(int I, int E, int pt, int lcap, bool bwd) {
    lde = E + 4;
    size_t o = 0;
    mu = o;     o += static_cast<size_t>(I) * lde;
    mp = o;     o += 4 * static_cast<size_t>(I);
    x = o;      o += 4 * static_cast<size_t>(pt);
    rx = o;     o += 4 * static_cast<size_t>(pt);
    cons = o;   o += 7 * static_cast<size_t>(I);
    gv = o;     o += bwd ? I : 0;
    o = (o + 3) / 4 * 4;
    e = o;      o += static_cast<size_t>(pt) * lde;
    xsq = o;    o += pt;
    rxsq = o;   o += pt;
    esq = o;    o += pt;
    seg = o;    o += pt;
    scene = o;  o += pt;
    cand = o;   o += kMaxI + 1;  // the list, then its length
    cpos = o;   o += kMaxI;      // instance -> its slot in the list, or -1
    rmask = o;  o += static_cast<size_t>(kMaskWords) * pt;  // [word][pt]
    rstart = o; o += pt + 1;
    imask = o;  o += bwd ? static_cast<size_t>(kMaxI) * kWords : 0;
    eidx = o;   o += bwd ? (static_cast<size_t>(pt) * I + 1) / 2 : 0;  // int16
    o = (o + 3) / 4 * 4;
    ent = o;    o += (bwd ? 4 : 2) * static_cast<size_t>(lcap);
    ent_ri = o; o += lcap;
    total = o * sizeof(float);
  }
};

// The shared memory of ListSmem as typed arrays.
struct Tile {
  float* mu;
  float4* mp;
  float4* x;
  float4* rx;
  float* cn;
  float* e;
  float *xsq, *rxsq, *esq;
  int *seg, *scene, *cand, *cpos, *rstart, *ent_ri;
  unsigned* rmask;
  int lde, pt;
  __device__ Tile(float* sm, const ListSmem& L, int pt_)
      : mu(sm + L.mu), mp(reinterpret_cast<float4*>(sm + L.mp)),
        x(reinterpret_cast<float4*>(sm + L.x)),
        rx(reinterpret_cast<float4*>(sm + L.rx)), cn(sm + L.cons),
        e(sm + L.e), xsq(sm + L.xsq), rxsq(sm + L.rxsq), esq(sm + L.esq),
        seg(reinterpret_cast<int*>(sm + L.seg)),
        scene(reinterpret_cast<int*>(sm + L.scene)),
        cand(reinterpret_cast<int*>(sm + L.cand)),
        cpos(reinterpret_cast<int*>(sm + L.cpos)),
        rstart(reinterpret_cast<int*>(sm + L.rstart)),
        ent_ri(reinterpret_cast<int*>(sm + L.ent_ri)),
        rmask(reinterpret_cast<unsigned*>(sm + L.rmask)), lde(L.lde),
        pt(pt_) {}
};

// The block's resident operands: mu [I][E + 4] (by cp.async, waited for
// with the first tile's rows), mp, the constants.
__device__ void stage_resident(const Tile& T, const float* __restrict__ mu,
                               const float4* __restrict__ mp4,
                               const float* __restrict__ cons, int I, int E) {
  const int t = threadIdx.x;
  for (int j = t; j < I * (E / 4); j += kListThreads)
    cp_async16(T.mu + (j / (E / 4)) * T.lde + (j % (E / 4)) * 4, mu + j * 4);
  for (int i = t; i < I; i += kListThreads) T.mp[i] = mp4[i];
  for (int j = t; j < 7 * I; j += kListThreads) T.cn[j] = cons[j];
}

// Steps 1-2 of a tile of points [p0, p0 + n): stage its rows (e by
// cp.async) with |x|^2, |rx|^2 and |e|^2; list the candidate instances in
// ascending order (use > 0 and, where every point of the tile has one
// scene, that scene) with each instance's slot (cpos, -1 for none); then
// one warp per point tests its candidates (the sample test) with ballots:
// a bit mask per point and 32 candidates (rmask[word][point]) and, after
// a scan of the counts, each point's first list slot (rstart, with the
// total at rstart[n]). Returns the number of candidates. Starts after and
// ends at a barrier.
__device__ int build_list(const Tile& T, const float* __restrict__ e,
                          int E, const float4* __restrict__ x4,
                          const float4* __restrict__ rx4,
                          const int32_t* __restrict__ seg,
                          const int32_t* __restrict__ scene, int I, int p0,
                          int n) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const unsigned lt = (1u << lane) - 1u;
  for (int j = t; j < n * (E / 4); j += kListThreads)
    cp_async16(T.e + (j / (E / 4)) * T.lde + (j % (E / 4)) * 4,
               e + static_cast<size_t>(p0) * E + j * 4);
  for (int r = t; r < n; r += kListThreads) {
    const int p = p0 + r;
    const float4 x = x4[p], rx = rx4[p];
    T.x[r] = x;
    T.rx[r] = rx;
    T.xsq[r] = dot4(x, x);
    T.rxsq[r] = dot4(rx, rx);
    T.seg[r] = seg[p];
    T.scene[r] = scene[p];
  }
  cp_async_wait_all();
  __syncthreads();
  // |e|^2 per row: one warp per row, lanes over columns, fixed order
  for (int r = warp; r < n; r += kListWarps) {
    float v = 0.0f;
    for (int d = lane; d < E; d += 32)
      v += T.e[r * T.lde + d] * T.e[r * T.lde + d];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (lane == 0) T.esq[r] = v;
  }
  if (warp == kListWarps - 1) {
    const int s0 = T.scene[0];
    bool one = true;
    for (int r = lane; r < n; r += 32) one = one && T.scene[r] == s0;
    one = __all_sync(kFull, one);
    int nc = 0;
    for (int i0 = 0; i0 < I; i0 += 32) {
      const int i = i0 + lane;
      const bool ok = i < I && T.cn[kUse * I + i] > 0.0f &&
                      (!one || T.cn[kScene * I + i] == static_cast<float>(s0));
      const unsigned b = __ballot_sync(kFull, ok);
      if (ok) T.cand[nc + __popc(b & lt)] = i;
      if (i < I) T.cpos[i] = ok ? nc + __popc(b & lt) : -1;
      nc += __popc(b);
    }
    if (lane == 0) T.cand[kMaxI] = nc;
  }
  __syncthreads();
  const int nc = T.cand[kMaxI];
  // the sample test of every (point, candidate) pair
  for (int r = warp; r < n; r += kListWarps) {
    const float4 x = T.x[r];
    const float xsq = T.xsq[r];
    const float sc = static_cast<float>(T.scene[r]);
    int cnt = 0;
    for (int j0 = 0; j0 < nc; j0 += 32) {
      bool s = false;
      if (j0 + lane < nc) {
        const int i = T.cand[j0 + lane];
        const float sq_x =
            fmaxf(xsq + T.cn[kMpSq * I + i] - 2.0f * dot4(x, T.mp[i]), 0.0f);
        s = sq_x < T.cn[kR16 * I + i] && sc == T.cn[kScene * I + i] &&
            T.cn[kUse * I + i] > 0.0f;
      }
      const unsigned b = __ballot_sync(kFull, s);
      if (lane == 0) T.rmask[(j0 / 32) * T.pt + r] = b;
      cnt += __popc(b);
    }
    if (lane == 0) T.rstart[r + 1] = cnt;
  }
  __syncthreads();
  if (warp == 0) {  // counts -> first slots (inclusive scan, 4 per lane)
    int v[4], run = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k;
      run += r < n ? T.rstart[r + 1] : 0;
      v[k] = run;
    }
    int inc = run;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    const int before = inc - run;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane * 4 + k < n) T.rstart[lane * 4 + k + 1] = before + v[k];
    if (lane == 0) T.rstart[0] = 0;
  }
  __syncthreads();
  return nc;
}

// The end of the window of whole points that starts at point r0: all the
// tile's points when its pairs fit in `lcap` entries, else as many as fit
// (at least one: a point has at most kMaxI <= lcap pairs).
__device__ __forceinline__ int window_end(const int* rstart, int r0, int n,
                                          int lcap) {
  if (rstart[n] - rstart[r0] <= lcap) return n;
  int r1 = r0 + 1;
  while (r1 < n && rstart[r1 + 1] - rstart[r0] <= lcap) ++r1;
  return r1;
}

// Step 3: the sampled pairs of points [r0, r1) as the list, point-major
// with instances ascending: entry q holds (point << 8) | instance. No
// barrier.
__device__ __forceinline__ void list_window(const Tile& T, int r0, int r1,
                                            int nc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  const int base = T.rstart[r0];
  for (int r = r0 + warp; r < r1; r += kListWarps) {
    int off = T.rstart[r] - base;
    for (int j0 = 0; j0 < nc; j0 += 32) {
      const unsigned b = T.rmask[(j0 / 32) * T.pt + r];
      if ((b >> lane) & 1u)
        T.ent_ri[off + __popc(b & lt)] = (r << 8) | T.cand[j0 + lane];
      off += __popc(b);
    }
  }
}

// e_r . mu_i over d ascending (the order of every version of the kernels),
// both rows read as float4
__device__ __forceinline__ float emu_dot(const Tile& T, int r, int i, int E) {
  const float4* e4 = reinterpret_cast<const float4*>(T.e + r * T.lde);
  const float4* m4 = reinterpret_cast<const float4*>(T.mu + i * T.lde);
  float dot = 0.0f;
#pragma unroll 4
  for (int k = 0; k < E / 4; ++k) {
    const float4 a = e4[k], b = m4[k];
    dot = fmaf(a.x, b.x, dot);
    dot = fmaf(a.y, b.y, dot);
    dot = fmaf(a.z, b.z, dot);
    dot = fmaf(a.w, b.w, dot);
  }
  return dot;
}

// ---- the forward ----

// [5, I] partial sums of one range of points (blockIdx.x covers points
// [x * range, (x + 1) * range) in tiles of `pt`). Per window of the
// tile's pair list:
//  3. one thread per entry: its dot, s_raw, s = clip(s_raw), the bce term
//     (member ? s : -log(max(1 - exp(-s), 1e-16))) and pred = s < log 2,
//     stored as the entry's two floats;
//  4. one warp per instance (instance w + 16 k in slot k), lanes over the
//     window's points in 32-point words: a lane whose point sampled the
//     instance finds the entry from its candidate mask (the point's first
//     slot plus the set bits below the instance's) and adds the bce term
//     to its slot's sum; ballots of the sampled, predicted and member
//     bits give the counts, kept in lane k of the warp.
// At the end each slot's lane sums are added over the lanes by a fixed
// tree, and the block writes its partial row part[x][5][I].
__global__ void __launch_bounds__(kListThreads, 2)
bce_fwd_kernel(const float* __restrict__ e, int P, int E,
               const float4* __restrict__ rx4, const float4* __restrict__ x4,
               const int32_t* __restrict__ seg,
               const int32_t* __restrict__ scene,
               const float* __restrict__ mu, const float4* __restrict__ mp4,
               const float* __restrict__ cons, int I, int range, int pt,
               int lcap, float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  const ListSmem L(I, E, pt, lcap, false);
  const Tile T(sm, L, pt);
  float2* ent = reinterpret_cast<float2*>(sm + L.ent);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  stage_resident(T, mu, mp4, cons, I, E);

  float acc[kSlots];   // lane partial bce sums of slot k
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;
  int cnt[4] = {0, 0, 0, 0};  // lane k: n_samp, tp, fp, tot of slot k

  const int p_begin = blockIdx.x * range;
  const int p_end = min(P, p_begin + range);
  for (int p0 = p_begin; p0 < p_end; p0 += pt) {
    const int n = min(pt, p_end - p0);
    // 1-2. (the previous tile's walk ended at a barrier)
    const int nc = build_list(T, e, E, x4, rx4, seg, scene, I, p0, n);
    for (int r0 = 0; r0 < n;) {
      const int r1 = window_end(T.rstart, r0, n, lcap);
      const int base = T.rstart[r0], nw = T.rstart[r1] - base;
      list_window(T, r0, r1, nc);
      __syncthreads();
      // 3. the entries' terms
      for (int q = t; q < nw; q += kListThreads) {
        const int r = T.ent_ri[q] >> 8, i = T.ent_ri[q] & 255;
        const float dot = emu_dot(T, r, i, E);
        const float sq_emb =
            fmaxf(T.esq[r] + T.cn[kMuSq * I + i] - 2.0f * dot, 0.0f);
        const float sq_r = fmaxf(
            T.rxsq[r] + T.cn[kMpSq * I + i] - 2.0f * dot4(T.rx[r], T.mp[i]),
            0.0f);
        const float s_raw = (sq_emb + 1e-12f) * T.cn[kSig0 * I + i] +
                            (sq_r + 1e-12f) * T.cn[kSig1 * I + i];
        const float s = fminf(fmaxf(s_raw, kSLo), kSHi);
        const float bce =
            T.seg[r] == i ? s : -logf(fmaxf(1.0f - expf(-s), 1e-16f));
        ent[q] = make_float2(bce, s < kSPred ? 1.0f : 0.0f);
      }
      __syncthreads();
      // 4. the per-instance sums. The slot loop is not unrolled, so its
      // loop is compiled once; slot k's register is updated by a
      // predicated add.
      for (int k = 0; k < kSlots; ++k) {
        const int i = warp + kListWarps * k;
        if (i >= I) break;
        const int j = T.cpos[i];
        if (j < 0) continue;
        const int jw = j / 32, jb = j % 32;
        const unsigned below = (1u << jb) - 1u;
        float a = 0.0f;
        int c[4] = {0, 0, 0, 0};
        for (int wd = r0 / 32; wd * 32 < r1; ++wd) {
          const int r = wd * 32 + lane;
          bool smp = false, pred = false, mem = false;
          if (r >= r0 && r < r1) {
            const unsigned m = T.rmask[jw * pt + r];
            smp = (m >> jb) & 1u;
            if (smp) {
              int q = T.rstart[r] - base + __popc(m & below);
              for (int w2 = 0; w2 < jw; ++w2)
                q += __popc(T.rmask[w2 * pt + r]);
              const float2 en = ent[q];
              a += en.x;
              pred = en.y != 0.0f;
              mem = T.seg[r] == i;
            }
          }
          const unsigned bs = __ballot_sync(kFull, smp);
          const unsigned bp = __ballot_sync(kFull, pred);
          const unsigned bm = __ballot_sync(kFull, mem);
          c[0] += __popc(bs);
          c[1] += __popc(bp & bm);
          c[2] += __popc(bp & ~bm);
          c[3] += __popc(bm);
        }
#pragma unroll
        for (int k2 = 0; k2 < kSlots; ++k2)
          if (k2 == k) acc[k2] += a;
        if (lane == k)
          for (int u = 0; u < 4; ++u) cnt[u] += c[u];
      }
      __syncthreads();  // the next window or tile overwrites the list
      r0 = r1;
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int i = warp + kListWarps * k;
    float v = acc[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (i < I && lane == 0)
      part[(static_cast<size_t>(blockIdx.x) * 5) * I + i] = v;
    if (i < I && lane == k)
      for (int u = 0; u < 4; ++u)
        part[(static_cast<size_t>(blockIdx.x) * 5 + 1 + u) * I + i] =
            static_cast<float>(cnt[u]);
  }
}

// ---- the backward ----

// The VJP of bce_sum over the pairs that carry a gradient. blockIdx.x
// covers points [x * range, (x + 1) * range) in tiles of `pt`, blockIdx.y
// the E columns [64 y, 64 y + 64) of de and dmu (the pair terms are
// recomputed per slice). Per tile, after the shared steps 1-2
// (`build_list`) and per window of its list (`list_window`):
//  3. one thread per entry: its e.mu dot, s_raw, the clip test, g and the
//     entry's four terms (g sig0^2, g sig1^2, g (sq_emb + eps), g (sq_r +
//     eps)); g != 0 sets the pair's bit in its instance's point mask;
//  4. one warp per point walks its entries in list order (de = 2 (G0 e -
//     sum g0 mu_i), one coalesced row store, zero for a point without
//     pairs; drx); one warp per instance walks its points in order, two
//     at a time, and adds the window's sums to the block's dmu partial
//     (sum g0 e_p, in registers) and, in the lane of its slot, to the
//     instance's three d(sig^2) sums.
__global__ void __launch_bounds__(kListThreads, 2)
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
  const ListSmem L(I, E, pt, lcap, true);
  const Tile T(sm, L, pt);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int d0 = blockIdx.y * kEc;
  const int dn = min(kEc, E - d0);
  const bool first_slice = blockIdx.y == 0;
  float* gv = sm + L.gv;
  unsigned* imask = reinterpret_cast<unsigned*>(sm + L.imask);
  int16_t* eidx = reinterpret_cast<int16_t*>(sm + L.eidx);
  float4* ent = reinterpret_cast<float4*>(sm + L.ent);

  stage_resident(T, mu, mp4, cons, I, E);
  for (int i = t; i < I; i += kListThreads) gv[i] = gvec[i];

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
    // 1-2. (the previous tile's walks ended at a barrier)
    const int nc = build_list(T, e, E, x4, rx4, seg, scene, I, p0, n);
    for (int r0 = 0; r0 < n;) {
      const int r1 = window_end(T.rstart, r0, n, lcap);
      const int base = T.rstart[r0], nw = T.rstart[r1] - base;
      for (int j = t; j < I * kWords; j += kListThreads) imask[j] = 0u;
      list_window(T, r0, r1, nc);
      __syncthreads();
      for (int q = t; q < nw; q += kListThreads) {
        const int r = T.ent_ri[q] >> 8, i = T.ent_ri[q] & 255;
        const float dot = emu_dot(T, r, i, E);
        const float sq_emb =
            fmaxf(T.esq[r] + T.cn[kMuSq * I + i] - 2.0f * dot, 0.0f);
        const float sq_r = fmaxf(
            T.rxsq[r] + T.cn[kMpSq * I + i] - 2.0f * dot4(T.rx[r], T.mp[i]),
            0.0f);
        const float s_raw = (sq_emb + 1e-12f) * T.cn[kSig0 * I + i] +
                            (sq_r + 1e-12f) * T.cn[kSig1 * I + i];
        float g = 0.0f;
        if (s_raw > kSLo && s_raw < kSHi) {
          const float p_ = expf(-s_raw);
          const float dbce =
              T.seg[r] == i ? 1.0f : -p_ / fmaxf(1.0f - p_, 1e-16f);
          g = gv[i] * dbce;
        }
        ent[q] = make_float4(g * T.cn[kSig0 * I + i], g * T.cn[kSig1 * I + i],
                             g * (sq_emb + 1e-12f), g * (sq_r + 1e-12f));
        eidx[r * I + i] = static_cast<int16_t>(q);
        if (g != 0.0f) atomicOr(imask + i * kWords + r / 32, 1u << (r % 32));
      }
      __syncthreads();
      // 4a. de and drx: one warp per point, its entries in list order (an
      // entry without a gradient adds exact zeros)
      for (int r = r0 + warp; r < r1; r += kListWarps) {
        float G0 = 0.0f, G1 = 0.0f, v[2] = {0.0f, 0.0f};
        float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int q1 = T.rstart[r + 1] - base;
#pragma unroll 4
        for (int q = T.rstart[r] - base; q < q1; ++q) {
          const float4 en = ent[q];
          const int i = T.ent_ri[q] & 255;
          G0 += en.x;
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (lane + 32 * c < dn)
              v[c] = fmaf(en.x, T.mu[i * T.lde + d0 + lane + 32 * c], v[c]);
          if (first_slice) {
            const float4 m = T.mp[i];
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
                2.0f * (G0 * T.e[r * T.lde + d] - v[c]);
        }
        if (first_slice && lane == 0) {
          const float4 rx = T.rx[r];
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
        const int i = warp + kListWarps * s;
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
                  a[c] = fmaf(en[u].x,
                              T.e[rr[u] * T.lde + d0 + lane + 32 * c], a[c]);
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
    const int i = warp + kListWarps * s;
    if (i >= I) break;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (lane + 32 * c < dn)
        dmu_part[(static_cast<size_t>(blockIdx.x) * I + i) * E + d0 + lane +
                 32 * c] = acc[s][c];
  }
  if (first_slice && lane < kSlots && warp + kListWarps * lane < I)
    for (int k = 0; k < 3; ++k)
      scal_part[(static_cast<size_t>(blockIdx.x) * 3 + k) * I + warp +
                kListWarps * lane] = scal[k];
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

// 0 when a pair-list kernel takes E, the tile and the list and its shared
// memory fits one block, else -2.
int check_list(int E, int pt, int lcap, size_t smem) {
  if (E % 4 || pt < 1 || pt > kMaxPt || lcap < kMaxI || lcap > 32767)
    return -2;
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return smem > static_cast<size_t>(limit) ? -2 : 0;
}

}  // namespace

extern "C" {

// r_bits [I] (read back as f32) = per-instance max squared distance of
// its own points (seg == i) to mp_i, every word written. x4 [P, 4],
// mp4 [I, 4], mp_sq [I] f32, seg [P] int32; n_blocks blocks; scratch
// [>= I] and counter are zero before the launch and after it. Returns a
// cudaError_t, or -3 when I exceeds 128.
int occ_bce_radius(const void* x4, const void* seg, int P, const void* mp4,
                   const void* mp_sq, int I, void* r_bits, void* scratch,
                   void* counter, int n_blocks, void* stream) {
  if (I > kMaxI) return -3;
  if (I < 1) return 0;
  radius_kernel<<<n_blocks, kRadiusThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x4), static_cast<const int32_t*>(seg), P,
      static_cast<const float4*>(mp4), static_cast<const float*>(mp_sq), I,
      static_cast<unsigned*>(scratch), static_cast<unsigned*>(counter),
      static_cast<unsigned*>(r_bits));
  return static_cast<int>(cudaGetLastError());
}

// The shared memory of a pair-list kernel (`ListSmem`): the backward's
// with bwd != 0, else the forward's. The host plans it in
// `bce_loss.list_smem_bytes`; a test holds the two equal.
long long occ_bce_list_smem(int I, int E, int pt, int lcap, int bwd) {
  return static_cast<long long>(ListSmem(I, E, pt, lcap, bwd != 0).total);
}

// out [5, I] = the five per-instance sums over P points (see the header),
// through part [n_blocks, 5, I] (caller-allocated scratch). Blocks cover
// `range` points each in tiles of `pt` (<= 128) with a pair list of
// `lcap` (>= 128) entries; E is a multiple of 4. Returns a cudaError_t,
// -3 when I exceeds 128, or -2 when E, the tile or the list does not fit.
int occ_bce_fwd(const void* e, int P, int E, const void* rx4, const void* x4,
                const void* seg, const void* scene, const void* mu,
                const void* mp4, const void* cons, int I, int range,
                int n_blocks, int pt, int lcap, void* part, void* out,
                void* stream) {
  if (I > kMaxI) return -3;
  const ListSmem L(I, E, pt, lcap, false);
  int rc = check_list(E, pt, lcap, L.total);
  if (rc) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = set_smem(bce_fwd_kernel, L.total);
  if (rc) return rc;
  bce_fwd_kernel<<<n_blocks, kListThreads, L.total, s>>>(
      static_cast<const float*>(e), P, E, static_cast<const float4*>(rx4),
      static_cast<const float4*>(x4), static_cast<const int32_t*>(seg),
      static_cast<const int32_t*>(scene), static_cast<const float*>(mu),
      static_cast<const float4*>(mp4), static_cast<const float*>(cons), I,
      range, pt, lcap, static_cast<float*>(part));
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
  const ListSmem L(I, E, pt, lcap, true);
  int rc = check_list(E, pt, lcap, L.total);
  if (rc) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = set_smem(bce_bwd_kernel, L.total);
  if (rc) return rc;
  const dim3 grid(n_blocks, (E + kEc - 1) / kEc);
  bce_bwd_kernel<<<grid, kListThreads, L.total, s>>>(
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
