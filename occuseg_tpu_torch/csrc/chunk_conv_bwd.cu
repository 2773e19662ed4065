// Chunk convolution weight gradients for Hopper (sm_90a): one kernel
// template for both backward routes.
//
// Both routes need the same product. Over a chunk plan (in_idx [C, U],
// lidx [C, K, M]), a GATHERED operand X [N_x, Cx] (its rows reached through
// the plan) and a DENSE operand D [C*M, Cd] (chunk c's rows c*M..c*M+M):
//
//   GX_k[m] = lidx[c,k,m] >= 0 ? X[in_idx[c, lidx[c,k,m]]] : 0
//   P[k]    = sum_c GX_k^T @ D_c                 (f32, [K, Cx, Cd])
//
// 1. dWt of the fused backward (occ_chunk_conv_dwt).
//    Replaces the dW half of `_pallas_bwd_fused` (kernel
//    `_make_bwd_fused_kernel`) and `_pallas_bwd_fused_v2` (the same
//    contract with K split into groups to fit the TPU's VMEM) of
//    occuseg_tpu/ops/pallas/chunk_conv.py. Over the TRANSPOSE plan,
//    X = the cotangent ct [N_ct, Ct] and D = the forward input feats
//    [C*M, Cin]: dWt[k] = sum_c feats_c^T @ Gct_k = P[k]^T, written
//    [K, Cin, Ct]. The caller maps dWt to dW (offset reversal for
//    submanifold maps, none for the strided/deconvolution pairs). The
//    d_feats half is the forward kernel of chunk_conv.cu over the transpose
//    plan.
// 2. dW over the forward plan (occ_chunk_conv_dw).
//    Replaces `_pallas_dw` (kernel `_make_dw_kernel`), the route the JAX
//    package takes where the fused kernel does not fit its VMEM budget.
//    Over the FORWARD plan, X = feats [N, Cin] and D = ct [C*M, Cout]:
//    dW[k] = sum_c G_k^T @ ct_c = P[k], written [K, Cin, Cout] as it is
//    (no transpose pass). The d_feats half of that route is the forward
//    kernel on the transpose plan.
//
// The kernel (`dw_kernel<T, CT, kRowsGathered>`): one block per (64 of
// D's columns, a CT-column tile of X, 4 offsets, run of <= 64 consecutive
// chunks), two warpgroups of two offsets each. Per chunk it stages the
// chunk's referenced X rows (one CT-column tile, pad slots skipped, a zero
// row at U that every missing reference reads) and its 64 D columns (the
// next chunk's in_idx and lidx rows load meanwhile). bf16 runs on wgmma as
// P[k] = GX_k^T @ D_c: per 16-row slice each warp gathers its 16 rows of
// A = GX_k^T with ldmatrix.trans from the staged X rows, every lane's row
// address read from lidx, and B is the D tile, staged in the 128-byte
// swizzle by cp.async and read through a descriptor after
// fence.proxy.async; a slice with no valid reference is skipped. The
// accumulator's rows are X's columns and its columns D's, so the epilogue
// writes P[k] directly for dW and its transpose for dWt (kRowsGathered).
// At the end of the run the block writes its f32 partial once with plain
// stores ([runs, K, rows, cols]); a second launch sums the partials in run
// order. Both results are deterministic, and no accumulator sums more than
// 64 chunks (8192 rows) before the ordered sum. f32 (training CLI, parity,
// every benchmark cell) takes one of two tiles, chosen by the wrapper from
// shapes (`dw_route` in ops/kernels/chunk_conv.py):
//  * the 3xTF32 tensor-core tile (`DwTcTile`, `dw_tc_block`), wherever its
//    block fits the device's shared memory (on the H100 at every shape):
//    a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (`tf32_split`), the small
//    terms first, on wgmma m64n64k8 .tf32. TF32 wgmma reads B only
//    K-major from shared memory, so the chunk's D rows are split into hi
//    and lo and stored transposed in the register pass that stages them;
//    A = GX_k^T is gathered per lane from the staged X rows and split in
//    registers. A first launch (`dw_kernel_row_order`) writes, per chunk
//    and group of 4 offsets, the X rows the group references (at most
//    4 x 128, so the block's shared memory does not grow with U, and
//    fewer rows are staged) and an order of the chunk's rows in which the
//    references at an offset cluster (the Gray code of each row's mask
//    over the group's offsets), so a k8 step (8 rows) with no reference
//    at the offset is skipped. Four warpgroups, one an offset; each batch
//    of 4 live steps goes into a fresh partial that an f32 add takes into
//    the total (a tensor-core accumulator over more rows loses accuracy:
//    128 rows read up to 1.2x the FMA tile's float64 error, 32 at most
//    1.1x). One block an SM;
//  * the FMA tile (`DwFmaTile`): each thread an 8 x (CT/8) register tile,
//    exact FMA products, rows with no valid reference skipped; two blocks
//    an SM. It runs where the tensor-core block does not fit (a device
//    with less shared memory) and when a test or timing tool asks.
//
// What bounds it: the staging of each chunk, then the products. On the
// H100 over the bench scene's 33 convolutions (f32 dW on each backward's
// route), the tensor-core tile takes 29.7 ms where the FMA tile takes
// 50.3 ms, against 9.1 ms for the real products at the FMA peak and 3.7
// ms at a third of the TF32 peak; it runs 1.20x the real products and
// skips 66% of its k8 steps. Its blocks spend ~59% of their cycles
// staging (one block an SM: nothing overlaps it; the D rows cannot be
// read ahead, for want of shared memory). Measured on the way there, in
// separate calls: two warpgroups of two offsets each ~1.5x slower (the
// tensor cores idle between a warpgroup's short chains of m64n64k8
// products, and two chains a warpgroup did not help); the row order
// computed inside each block ~1.1x slower than the first launch.
// Earlier, for bf16: mma.sync in place of wgmma measured 9.9 ms per bench
// step against 9.0; 8 offsets per block measured 10.3-10.8 ms against
// 9.8-10.0 at 4 offsets. The dW route's first kernel (one block per
// 64x64 tile and ONE offset, nothing overlapped) read the ct tile again
// for every offset: 27x the ct traffic, 2.20 ms per bench step for its
// four convolutions.

#include <type_traits>

#include "chunk_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTcThreads = 512;  // the tensor-core tile: a warpgroup an offset
constexpr int kBatch = 4;        // the tensor-core tile's k8 steps a partial
constexpr int kOffsets = 4;    // offsets per block
constexpr int kRows = 64;      // D columns per block
// the tensor-core tile stages the rows its group of offsets references:
// at most one per (offset, chunk row)
constexpr int kGroupRows = kOffsets * kMaxM;

struct DwArgs {
  const void* x;          // gathered operand [n_x, cx]
  const int32_t* in_idx;  // [C, U]
  const int32_t* lidx;    // [C, K, M]
  const void* d;          // dense operand [C*M, cd]
  float* out;  // the result (runs == 1) or the runs' partials
  // the tensor-core tile's k8 steps run and skipped, thread 0's cycles
  // ordering the chunks' rows and in the block, summed over the blocks (4
  // slots, or null)
  unsigned long long* counts;
  // kTc: per chunk and group of kOffsets offsets, its record
  // (`dw_kernel_row_order`)
  unsigned char* order;
  int n_x, cx, C, U, K, M, cd, runs;
};

// Shared memory plan, from a 1024-byte aligned base: the D tile first
// (bf16: kMaxM rows of 64 columns, 128 bytes each, in the 128-byte swizzle
// that wgmma reads through a descriptor; f32: rows padded against bank
// conflicts; kTc: its hi and its lo halves, each four K-major boxes of 32
// rows, `DwTcTile`), two buffers of the chunk's lidx rows and in_idx row
// (kTc: of its record; the next chunk's are loaded while this one
// computes), then one set of staged X rows (kTc: kGroupRows + 1, whatever
// U is).
template <typename T, int CT, bool kTc = false>
struct DwLayout {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr bool kSwizzled = sizeof(T) == 2;
  static constexpr int kLdf = kRows + kVec;  // f32 D tile stride
  // staged X row stride: bf16 rows are read by ldmatrix at 8 different
  // rows per instruction and are padded against bank conflicts; a warp of
  // the f32 tile reads one row, 128 contiguous bytes, and needs no padding
  // (which lets tier 1.7's U=1312 fit at CT=32); a half-warp of the
  // tensor-core tile reads 32 bytes of each of four rows, padded so that
  // rows four apart in the list fall on other banks
  static constexpr int kLdg = kTc ? CT + 8 : CT + (kSwizzled ? kVec : 0);
  static constexpr size_t kLidx = static_cast<size_t>(kOffsets) * kMaxM;
  static constexpr size_t kDBytes =
      kTc ? 2 * kMaxM * kRows * sizeof(float)
          : static_cast<size_t>(kMaxM) * (kSwizzled ? 128 : kLdf * sizeof(T));
  // kTc: two buffers of a chunk's record (`dw_kernel_row_order`)
  static constexpr size_t kRec = 33 * kMaxM + 16;
  size_t lidx_off, in_off, g_off, total;
  __host__ __device__ DwLayout(int U) {
    size_t off = align128(kDBytes);
    lidx_off = off;
    if (kTc) {  // the X rows: the group's referenced rows and a zero row
      off += 2 * align128(kRec);
      in_off = off;
      g_off = off;
      off += align128(static_cast<size_t>(kGroupRows + 1) * kLdg * sizeof(T));
    } else {
      off += align128(2 * kLidx * sizeof(int32_t));
      in_off = off;
      off += 2 * align128(static_cast<size_t>(U) * sizeof(int32_t));
      g_off = off;
      off += align128(static_cast<size_t>(U + 1) * kLdg * sizeof(T));
    }
    total = off + 1024;  // room to align the base
  }
  __host__ __device__ size_t in_stride(int U) const {
    return align128(static_cast<size_t>(U) * sizeof(int32_t)) /
           sizeof(int32_t);
  }
};

// Where element (X column gx, D column dx) of offset j's product goes:
// dW [K, cx, cd] keeps it, dWt [K, cd, cx] transposes it.
template <bool kRowsGathered>
__device__ __forceinline__ size_t out_at(int j, int gx, int dx, int cx,
                                         int cd) {
  const size_t base = static_cast<size_t>(j) * cx * cd;
  return kRowsGathered ? base + static_cast<size_t>(gx) * cd + dx
                       : base + static_cast<size_t>(dx) * cx + gx;
}

// bf16: P[k] = GX_k^T @ D_c on wgmma. Warpgroup g holds, for offsets
// k0 + 2g and k0 + 2g + 1, the [64 X columns, 64 D columns] tile as
// m64n64 accumulators; per 16-row slice of the chunk its warps gather
// A = GX_k^T (X columns 16w..+16 of the group's 64) with ldmatrix.trans
// from the staged X rows, every lane's row address read from lidx, and B
// is the swizzled D tile through a descriptor. A slice with no valid
// reference at the offset is skipped (uniform over the group).
template <int CT, bool kRowsGathered>
struct DwWgTile {
  static_assert(CT == 64, "wgmma takes 64 rows of A");
  static constexpr int kLdg = CT + 8;
  float acc[2][32];
  int g, w, lane;
  int j;  // the block's first offset of this thread's warpgroup

  __device__ DwWgTile(int t) {
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
                        const int32_t* lidx_s, int M, int U, int nk) {
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

  // dst = the block's offset k0 of the result (or of its run's partial);
  // accumulator row r, column c of the tile at (x0, d0) is P[k] at
  // (x0 + r, d0 + c). Columns come in pairs (i, i + 1).
  __device__ void store(float* dst, int cx, int cd, int d0, int x0, int nk,
                        int ncols) const {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      if (j + o >= nk) continue;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = w * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
        const int c = (i >> 2) * 8 + (lane & 3) * 2;
        if (r >= ncols || d0 + c >= cd) continue;  // cd: a multiple of 16
        if constexpr (kRowsGathered) {
          *reinterpret_cast<float2*>(
              dst + out_at<true>(j + o, x0 + r, d0 + c, cx, cd)) =
              make_float2(acc[o][i], acc[o][i + 1]);
        } else {
          dst[out_at<false>(j + o, x0 + r, d0 + c, cx, cd)] = acc[o][i];
          dst[out_at<false>(j + o, x0 + r, d0 + c + 1, cx, cd)] =
              acc[o][i + 1];
        }
      }
    }
  }
};

// f32: thread t holds P[k0 + t/64] at D columns d0 + rg*8..+8 and X
// columns x0 + q*32 + cg*4..+4 (q < CT/32); exact FMA products.
template <int CT, bool kRowsGathered>
struct DwFmaTile {
  static constexpr int kLdf = kRows + 4, kLdg = CT, kNQ = CT / 32;
  float acc[8][kNQ][4];
  int j, rg, cg;

  __device__ DwFmaTile(int t) : j(t / 64), rg((t % 64) / 8), cg(t % 8) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][q][e] = 0.0f;
  }

  __device__ void chunk(const float* f_s, const float* g_s,
                        const int32_t* lidx_s, int M, int U, int nk) {
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

  // acc[r][q][e] is P[k] at (X column x0 + q*32 + cg*4 + e, D column
  // d0 + rg*8 + r); cx and cd are multiples of 16, so a thread's 8 D
  // columns and 4 X columns are in range together.
  __device__ void store(float* dst, int cx, int cd, int d0, int x0, int nk,
                        int ncols) const {
    const int dr = d0 + rg * 8;
    if (j >= nk || dr >= cd) return;
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      const int c = q * 32 + cg * 4;
      if (c >= ncols) continue;
      if constexpr (kRowsGathered) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* o = dst + out_at<true>(j, x0 + c + e, dr, cx, cd);
          *reinterpret_cast<float4*>(o) = make_float4(
              acc[0][q][e], acc[1][q][e], acc[2][q][e], acc[3][q][e]);
          *reinterpret_cast<float4*>(o + 4) = make_float4(
              acc[4][q][e], acc[5][q][e], acc[6][q][e], acc[7][q][e]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          *reinterpret_cast<float4*>(
              dst + out_at<false>(j, x0 + c, dr + r, cx, cd)) =
              make_float4(acc[r][q][0], acc[r][q][1], acc[r][q][2],
                          acc[r][q][3]);
      }
    }
  }
};

// f32 on the tensor cores (3xTF32; CT = 64): P[k] = GX_k^T @ D_c on wgmma
// m64n64k8 .tf32, the product split as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// (`tf32_split`), the two small terms issued first. Warpgroup j takes the
// block's offset k0 + j, a [64 X columns, 64 D columns] total in
// registers. B is the chunk's D tile in the chunk's row order (position p
// holds row ord[p]), split into hi and lo and stored K-major (four boxes
// of 32 positions, each D column a 128-byte row, 128-byte swizzle); A =
// GX_k^T is gathered per lane from the staged X rows through the lidx
// rows in that order (`lp`) and split in registers. Lane (r = lane/4, q =
// lane%4) of warp w holds accumulator rows r and r + 8, which are X
// columns 16w + 2r and 16w + 2r + 1: one 8-byte load a row gives both. A
// k8 step (8 positions) with no reference at the offset is skipped
// (uniform over the group: each warp reads the same lidx rows). Live steps
// go in batches of kBatch into a partial sum that starts at zero, which an
// f32 add then takes into the total: no tensor-core accumulator sums more
// than 32 rows.
template <bool kRowsGathered>
struct DwTcTile {
  static constexpr int kLdg = DwLayout<float, 64, true>::kLdg;
  float acc[32], part[32];
  int w, lane, j;
  uint32_t ran = 0;  // k8 steps run by the warpgroup

  __device__ DwTcTile(int t) : w((t / 32) & 3), lane(t % 32), j(t / 128) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  }

  // A k8 step's fragments (`hi`, `lo`: rows r, r + 8 at k q, q + 4) from
  // the staged X rows through the positions' lidx entries.
  __device__ __forceinline__ void gather(const float* xcol, const int32_t* lp,
                                         int s, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) const {
    const int q = lane & 3;
    const int la = row_of(lp[8 * s + q], kGroupRows);
    const int lb = row_of(lp[8 * s + q + 4], kGroupRows);
    const float2 va = *reinterpret_cast<const float2*>(xcol + la * kLdg);
    const float2 vb = *reinterpret_cast<const float2*>(xcol + lb * kLdg);
    tf32_split(va.x, hi[0], lo[0]);  // row r, k q
    tf32_split(va.y, hi[1], lo[1]);  // row r + 8, k q
    tf32_split(vb.x, hi[2], lo[2]);  // row r, k q + 4
    tf32_split(vb.y, hi[3], lo[3]);  // row r + 8, k q + 4
  }

  // g_s: the staged X rows; b_hi, b_lo: the D tile's halves; lp_s: the
  // block's offsets' references (positions in the staged rows) in the
  // chunk's row order, M apart.
  __device__ void chunk(const float* g_s, const unsigned char* b_hi,
                        const unsigned char* b_lo, const int32_t* lp_s, int M,
                        int nk) {
    if (j >= nk) return;  // uniform over the warpgroup
    const uint32_t bh = smem_u32(b_hi), bl = smem_u32(b_lo);
    const float* xcol = g_s + w * 16 + (lane >> 2) * 2;
    const int32_t* lp = lp_s + j * M;
    // the live k8 steps: lane l reads positions 4l..4l+4, half a step
    bool any = false;
    if (4 * lane < M) {
      const int4 v = *reinterpret_cast<const int4*>(lp + 4 * lane);
      any = (v.x >= 0) | (v.y >= 0) | (v.z >= 0) | (v.w >= 0);
    }
    const uint32_t halves = __ballot_sync(0xffffffffu, any);
    uint32_t live = 0;
#pragma unroll
    for (int s = 0; s < kMaxM / 8; ++s)
      live |= static_cast<uint32_t>((halves >> (2 * s) & 3u) != 0) << s;
    ran += __popc(live);
#pragma unroll 1
    while (live) {
      uint32_t hi[kBatch][4], lo[kBatch][4];
      int st[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        st[b] = live ? __ffs(live) - 1 : -1;
        live &= live - 1;
        if (st[b] >= 0) gather(xcol, lp, st[b], hi[b], lo[b]);
      }
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (st[b] < 0) continue;
        const uint32_t at = (st[b] >> 2) * (kRows * 128) + (st[b] & 3) * 32;
        wgmma_tf32<64>(part, lo[b], wgmma_desc_k128(bh + at), b > 0);
        wgmma_tf32<64>(part, hi[b], wgmma_desc_k128(bl + at), 1);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (st[b] < 0) continue;
        const uint32_t at = (st[b] >> 2) * (kRows * 128) + (st[b] & 3) * 32;
        wgmma_tf32<64>(part, hi[b], wgmma_desc_k128(bh + at), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
  }

  // acc[4c + 2h + e] is P[j] at (X column x0 + 16w + 2(lane/4) + h, D
  // column d0 + 8c + 2(lane%4) + e); cx and cd are multiples of 16, so a
  // thread's two X columns and two D columns are in range together.
  __device__ void store(float* dst, int cx, int cd, int d0, int x0, int nk,
                        int ncols) const {
    const int xr = w * 16 + (lane >> 2) * 2;
    if (j >= nk || xr >= ncols) return;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int c = d0 + (i >> 2) * 8 + (lane & 3) * 2;
      if (c >= cd) continue;
      const float* v = acc + i;
      if constexpr (kRowsGathered) {
        *reinterpret_cast<float2*>(dst + out_at<true>(j, x0 + xr, c, cx, cd)) =
            make_float2(v[0], v[1]);
        *reinterpret_cast<float2*>(
            dst + out_at<true>(j, x0 + xr + 1, c, cx, cd)) =
            make_float2(v[2], v[3]);
      } else {
        *reinterpret_cast<float2*>(
            dst + out_at<false>(j, x0 + xr, c, cx, cd)) =
            make_float2(v[0], v[2]);
        *reinterpret_cast<float2*>(
            dst + out_at<false>(j, x0 + xr, c + 1, cx, cd)) =
            make_float2(v[1], v[3]);
      }
    }
  }
};

// The position of a 4-bit neighbour mask in the reflected Gray code
// (0, 1, 3, 2, 6, 7, 5, 4, 12, ...): sorted so, the rows with a reference
// at the block's offset 3 form one range, at 2 one, at 1 two, at 0 four.
__device__ __forceinline__ int gray_rank(uint32_t g) {
  return static_cast<int>(g ^ (g >> 1) ^ (g >> 2) ^ (g >> 3));
}

template <typename T, int CT, bool kRowsGathered>
using DwTileOf =
    typename std::conditional<sizeof(T) == 2, DwWgTile<CT, kRowsGathered>,
                              DwFmaTile<CT, kRowsGathered>>::type;

// blockIdx: x = (64-column D tile, CT-column X tile), y = group of 4
// offsets, z = run of consecutive chunks.
struct DwBlock {
  int d0, x0, ncols, k0, nk, run, c_begin, c_end;
  __device__ DwBlock(const DwArgs& a, int CT) {
    const int tiles_x = (a.cx + CT - 1) / CT;
    d0 = (blockIdx.x / tiles_x) * kRows;
    x0 = (blockIdx.x % tiles_x) * CT;
    ncols = min(CT, a.cx - x0);
    k0 = blockIdx.y * kOffsets;
    nk = min(kOffsets, a.K - k0);
    run = blockIdx.z;
    c_begin = static_cast<int>(static_cast<long long>(a.C) * run / a.runs);
    c_end = static_cast<int>(static_cast<long long>(a.C) * (run + 1) / a.runs);
  }
};

// The record of the tensor-core tile for (group g of kOffsets offsets,
// chunk c), one block of kMaxM threads each: the rows of X that the
// group's offsets reference, as a list of row numbers (their order in the
// chunk's in_idx row), the group's lidx rows as positions in that list,
// the rows of the chunk in an order in which the references at an offset
// cluster, and the list's length. The order: each row's mask over the
// group's offsets, ranked by its Gray code and then by row (a counting sort
// over 16 classes: ranks within a warp by __match_any_sync, the counts of
// (class, warp) scanned by each warp), gives position p of row ord[p].
// Record layout (33 M + 16 bytes): lp [kOffsets][M] int32 (-1: none; in
// the row order), rows [kGroupRows] int32 (M = 128: kGroupRows = 4 M),
// ord [M] bytes, count int32. Dynamic shared memory: U int32.
__global__ void __launch_bounds__(kMaxM)
dw_kernel_row_order(const int32_t* __restrict__ in_idx,
                    const int32_t* __restrict__ lidx, int U, int K, int M,
                    int G, unsigned char* __restrict__ order) {
  extern __shared__ int32_t slot_s[];  // per in_idx slot: used, then index
  __shared__ int32_t cnt_s[64];        // [16 classes][4 warps]
  __shared__ int32_t part_s[kMaxM / 32];
  const int g = blockIdx.x, c = blockIdx.y, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, k0 = g * kOffsets;
  const int nk = min(kOffsets, K - k0);
  for (int u = t; u < U; u += kMaxM) slot_s[u] = 0;
  if (t < 64) cnt_s[t] = 0;
  __syncthreads();
  const int32_t* lc = lidx + (static_cast<size_t>(c) * K + k0) * M;
  int l[kOffsets];
  int cls = 0, rank = 0;
  if (t < M) {  // M is a multiple of 32: whole warps
    uint32_t mk = 0;
#pragma unroll
    for (int k = 0; k < kOffsets; ++k) {
      l[k] = k < nk ? lc[k * M + t] : -1;
      if (l[k] >= 0) slot_s[l[k]] = 1;
      mk |= static_cast<uint32_t>(l[k] >= 0) << k;
    }
    cls = gray_rank(mk);
    const uint32_t peers = __match_any_sync(0xffffffffu, cls);
    rank = __popc(peers & ((1u << lane) - 1u));
    if (rank == 0) cnt_s[cls * 4 + warp] = __popc(peers);
  }
  __syncthreads();
  // the used slots' positions in the list: thread t scans slots
  // [t*per, (t+1)*per), the block scans the threads' counts
  const int per = (U + kMaxM - 1) / kMaxM, u0 = min(U, t * per),
            u1 = min(U, u0 + per);
  int n = 0;
  for (int u = u0; u < u1; ++u) n += slot_s[u];
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) part_s[warp] = incl;
  __syncthreads();
  int base = incl - n;
  for (int w = 0; w < warp; ++w) base += part_s[w];
  unsigned char* rec =
      order + (static_cast<size_t>(c) * G + g) * (33 * static_cast<size_t>(M) + 16);
  int32_t* lp = reinterpret_cast<int32_t*>(rec);
  int32_t* rows = lp + kOffsets * M;
  const int32_t* in_c = in_idx + static_cast<size_t>(c) * U;
  for (int u = u0; u < u1; ++u) {
    const int used = slot_s[u];
    slot_s[u] = used ? base : -1;
    if (used) rows[base++] = in_c[u];
  }
  if (t == kMaxM - 1) {
    int total = 0;
    for (int w = 0; w < kMaxM / 32; ++w) total += part_s[w];
    *reinterpret_cast<int32_t*>(rec + 33 * M) = total;
  }
  __syncthreads();
  if (t >= M) return;
  // the exclusive prefix over (class, warp), each warp its own copy
  const int v0 = cnt_s[2 * lane], v1 = cnt_s[2 * lane + 1];
  int sum = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, sum, o);
    if (lane >= o) sum += v;
  }
  const int e = cls * 4 + warp;
  const int b0 = __shfl_sync(0xffffffffu, sum - v0 - v1, e >> 1);
  const int b1 = __shfl_sync(0xffffffffu, sum - v1, e >> 1);
  const int p = (e & 1 ? b1 : b0) + rank;
#pragma unroll
  for (int k = 0; k < kOffsets; ++k) lp[k * M + p] = l[k] >= 0 ? slot_s[l[k]] : -1;
  rec[32 * M + p] = static_cast<unsigned char>(t);
}

// The tensor-core f32 block (`DwTcTile`): per chunk, with its record in
// (`dw_kernel_row_order`, read during the previous chunk's products), the
// group's referenced X rows are staged (the list's length, not U, bounds
// them: the zero row is at kGroupRows) while the D rows are read in the
// chunk's row order, four columns a thread, split and stored K-major (a
// warp writes 32 consecutive positions of one column: no bank conflict).
template <bool kRowsGathered>
__device__ void dw_tc_block(const DwArgs& a, unsigned char* smem) {
  using L = DwLayout<float, 64, true>;
  constexpr int kLoads = kMaxM * (kRows / 4) / kTcThreads;
  const long long t_start = clock64();
  const L lay(a.U);
  unsigned char* b_hi = smem;
  unsigned char* b_lo = smem + L::kDBytes / 2;
  unsigned char* rec_b = smem + lay.lidx_off;
  float* g_s = reinterpret_cast<float*>(smem + lay.g_off);

  const int K = a.K, M = a.M;
  const int G = (K + kOffsets - 1) / kOffsets;
  const int rec_bytes = 33 * M + 16;  // a multiple of 16
  const DwBlock blk(a, 64);
  const int t = threadIdx.x;
  const float* xs = static_cast<const float*>(a.x);
  const float* ds = static_cast<const float*>(a.d);
  // chunk c's record into buffer b
  auto prefetch = [&](int c, int b) {
    const unsigned char* rec =
        a.order + (static_cast<size_t>(c) * G + blockIdx.y) * rec_bytes;
    for (int i = t; i < rec_bytes / 16; i += kTcThreads)
      cp_async16(rec_b + b * align128(L::kRec) + 16 * i, rec + 16 * i);
    cp_async_commit();
  };

  DwTcTile<kRowsGathered> tile(t);
  long long stage_cycles = 0;
  zero_bytes(g_s + static_cast<size_t>(kGroupRows) * L::kLdg,
             L::kLdg * sizeof(float), t, kTcThreads);
  if (blk.c_begin < blk.c_end) prefetch(blk.c_begin, 0);
  for (int c = blk.c_begin; c < blk.c_end; ++c) {
    const int b = (c - blk.c_begin) & 1;
    const unsigned char* rec = rec_b + b * align128(L::kRec);
    const int32_t* lp_s = reinterpret_cast<const int32_t*>(rec);
    const int32_t* rows_s = lp_s + kOffsets * M;
    const unsigned char* ord_s = rec + 32 * M;
    // chunk c's record is in; the previous chunk's readers are done
    cp_async_wait_all();
    __syncthreads();
    const long long t_chunk = clock64();
    const int n = *reinterpret_cast<const int32_t*>(rec + 33 * M);
    if (n > 0) {  // uniform: a group with no reference adds nothing
      stage_rows<float, 64>(g_s, L::kLdg, xs, a.n_x, a.cx, a.cx, rows_s, n,
                            blk.x0, t, kTcThreads);
      cp_async_commit();
      // D rows c*M + ord[p], columns d0.. (zero past cd): loaded together,
      // then split and stored at position p, K-major
      float4 xv[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = t + r * kTcThreads, p = i % M, col = blk.d0 + 4 * (i / M);
        xv[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < M * (kRows / 4) && col < a.cd)
          xv[r] = __ldg(reinterpret_cast<const float4*>(
              ds + (static_cast<size_t>(c) * M + ord_s[p]) * a.cd + col));
      }
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = t + r * kTcThreads, p = i % M, v = i / M;
        if (i >= M * (kRows / 4)) continue;
        const uint32_t at = (p >> 5) * (kRows * 128) + (p & 3) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 4 * v + e;
          const uint32_t byte =
              at + col * 128 + ((((p & 31) >> 2) ^ (col & 7)) << 4);
          uint32_t hi, lo;
          tf32_split(e == 0 ? xv[r].x : e == 1 ? xv[r].y
                     : e == 2 ? xv[r].z : xv[r].w, hi, lo);
          *reinterpret_cast<uint32_t*>(b_hi + byte) = hi;
          *reinterpret_cast<uint32_t*>(b_lo + byte) = lo;
        }
      }
      cp_async_wait<0>();   // this chunk's X rows
      fence_proxy_async();  // wgmma reads the D tile
    }
    // the D rows are split and the X rows in: the next chunk's record
    // loads while this one computes
    __syncthreads();
    stage_cycles += clock64() - t_chunk;
    if (c + 1 < blk.c_end) prefetch(c + 1, b ^ 1);
    if (n > 0) tile.chunk(g_s, b_hi, b_lo, lp_s, M, blk.nk);
  }
  cp_async_wait_all();
  float* dst = a.out + (static_cast<size_t>(blk.run) * K + blk.k0) * a.cx * a.cd;
  tile.store(dst, a.cx, a.cd, blk.d0, blk.x0, blk.nk, blk.ncols);
  if (a.counts == nullptr) return;
  // one set of atomics a block: the warpgroups' steps to thread 0 (through
  // the record buffers, read no more)
  uint32_t* ran_s = reinterpret_cast<uint32_t*>(rec_b);
  __syncthreads();
  if (t % 128 == 0) ran_s[t / 128] = tile.ran;
  __syncthreads();
  if (t != 0) return;
  unsigned long long ran = 0;
  for (int w = 0; w < kTcThreads / 128; ++w) ran += ran_s[w];
  const unsigned long long steps = static_cast<unsigned long long>(
      blk.c_end - blk.c_begin) * blk.nk * (M / 8);
  atomicAdd(a.counts, ran);
  atomicAdd(a.counts + 1, steps - ran);
  atomicAdd(a.counts + 2, static_cast<unsigned long long>(stage_cycles));
  atomicAdd(a.counts + 3,
            static_cast<unsigned long long>(clock64() - t_start));
}

// bf16 and the f32 FMA tile.
template <typename T, int CT, bool kRowsGathered>
__device__ void dw_block(const DwArgs& a, unsigned char* smem) {
  using L = DwLayout<T, CT>;
  constexpr int kVec = L::kVec;
  const L lay(a.U);
  T* f_s = reinterpret_cast<T*>(smem);
  int32_t* lidx_b = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  int32_t* in_b = reinterpret_cast<int32_t*>(smem + lay.in_off);
  T* g_s = reinterpret_cast<T*>(smem + lay.g_off);

  const int U = a.U, K = a.K, M = a.M;
  const DwBlock blk(a, CT);
  const int d0 = blk.d0, x0 = blk.x0, k0 = blk.k0, nk = blk.nk;
  const int t = threadIdx.x;
  const T* xs = static_cast<const T*>(a.x);
  const T* ds = static_cast<const T*>(a.d);
  const size_t in_stride = lay.in_stride(U);

  // chunk c's in_idx row and the lidx rows of offsets k0.. into buffer b
  auto load_meta = [&](int c, int b) {
    copy_ints(in_b + b * in_stride, a.in_idx + static_cast<size_t>(c) * U, U,
              t, kThreads);
    copy_ints(lidx_b + b * L::kLidx,
              a.lidx + (static_cast<size_t>(c) * K + k0) * M, nk * M, t,
              kThreads);
  };

  DwTileOf<T, CT, kRowsGathered> tile(t);
  zero_bytes(g_s + static_cast<size_t>(U) * L::kLdg, L::kLdg * sizeof(T), t,
             kThreads);
  if (blk.c_begin < blk.c_end) load_meta(blk.c_begin, 0);
  for (int c = blk.c_begin; c < blk.c_end; ++c) {
    const int b = (c - blk.c_begin) & 1;
    const int32_t* in_s = in_b + b * in_stride;
    // chunk c's meta is in; the previous chunk's readers are done
    cp_async_wait_all();
    __syncthreads();
    const bool live = in_s[0] >= 0;  // uniform: all-pad chunks add nothing
    if (live) {
      // D rows c*M.., columns d0..d0+64 (zero past cd); bf16 rows are 128
      // bytes, their 16-byte pieces swizzled by the row's low bits
      constexpr int kVpr = kRows / kVec;
      for (int i = t; i < M * kVpr; i += kThreads) {
        const int m = i / kVpr, v = i % kVpr, col = d0 + v * kVec;
        T* dd = L::kSwizzled ? f_s + m * kRows + ((v ^ (m & 7)) * kVec)
                             : f_s + m * L::kLdf + v * kVec;
        if (col < a.cd)
          cp_async16(dd, ds + (static_cast<size_t>(c) * M + m) * a.cd + col);
        else
          *reinterpret_cast<uint4*>(dd) = make_uint4(0, 0, 0, 0);
      }
      stage_rows<T, CT>(g_s, L::kLdg, xs, a.n_x, a.cx, a.cx, in_s, U, x0, t,
                        kThreads);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (c + 1 < blk.c_end) load_meta(c + 1, b ^ 1);
    // this chunk's rows are in (the next chunk's meta may still fly)
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::);
    if (!live) continue;
    if constexpr (L::kSwizzled) fence_proxy_async();  // wgmma reads f_s
    __syncthreads();
    tile.chunk(f_s, g_s, lidx_b + b * L::kLidx, M, U, nk);
  }
  cp_async_wait_all();
  float* dst = a.out + (static_cast<size_t>(blk.run) * K + k0) * a.cx * a.cd;
  tile.store(dst, a.cx, a.cd, d0, x0, nk, blk.ncols);
}

// kTc: f32 on the tensor cores (`dw_tc_block`), one block an SM.
template <typename T, int CT, bool kRowsGathered, bool kTc>
__global__ void __launch_bounds__(kTc ? kTcThreads : kThreads, kTc ? 1 : 2)
dw_kernel(const DwArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if constexpr (kTc) {
    static_assert(sizeof(T) == 4 && CT == 64, "the tensor-core tile is f32");
    dw_tc_block<kRowsGathered>(a, smem);
  } else {
    dw_block<T, CT, kRowsGathered>(a, smem);
  }
}

template <typename T, int CT, bool kRowsGathered, bool kTc = false>
int launch_dw(const DwArgs& a, cudaStream_t stream) {
  const DwLayout<T, CT, kTc> lay(a.U);
  const int smem = static_cast<int>(lay.total);
  auto kernel = dw_kernel<T, CT, kRowsGathered, kTc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((a.cd + kRows - 1) / kRows) * ((a.cx + CT - 1) / CT),
                  (a.K + kOffsets - 1) / kOffsets, a.runs);
  kernel<<<grid, kTc ? kTcThreads : kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// Shared memory of one block when two share an SM (228 KiB less 1 KiB
// reserved per block, halved).
constexpr size_t kTwoPerSm = 115712;

// bf16 takes 64 X columns (wgmma's 64 rows). f32 with `tc` takes the
// tensor-core tile (64 X columns) where its block fits the device's opt-in
// shared memory, else returns -2; without, the FMA tile at the widest X
// tile with which two blocks share an SM (at U=384, 64 columns of staged
// f32 rows leave room for one), else the widest that fits. Then, with
// runs > 1, the ordered sum of the runs' partials into `out`. Returns a
// cudaError_t, or -2 when no X tile fits in shared memory.
template <typename T, bool kRowsGathered>
int run_dw(const DwArgs& a, float* out, bool tc, cudaStream_t s) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  const size_t s64 = DwLayout<T, 64>(a.U).total;
  int rc = -2;
  if constexpr (sizeof(T) == 4) {
    const size_t s32 = DwLayout<T, 32>(a.U).total;
    if (tc) {
      if (DwLayout<float, 64, true>(a.U).total <= limit) {
        const int G = (a.K + kOffsets - 1) / kOffsets;
        const size_t slots = static_cast<size_t>(a.U) * sizeof(int32_t);
        if (slots > 48 * 1024)
          cudaFuncSetAttribute(dw_kernel_row_order,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(slots));
        dw_kernel_row_order<<<dim3(G, a.C), kMaxM, slots, s>>>(
            a.in_idx, a.lidx, a.U, a.K, a.M, G, a.order);
        rc = static_cast<int>(cudaGetLastError());
        if (rc == 0) rc = launch_dw<float, 64, kRowsGathered, true>(a, s);
      }
    } else if (s64 > kTwoPerSm && s32 <= kTwoPerSm) {
      rc = launch_dw<T, 32, kRowsGathered>(a, s);
    } else if (s64 <= limit) {
      rc = launch_dw<T, 64, kRowsGathered>(a, s);
    } else if (s32 <= limit) {
      rc = launch_dw<T, 32, kRowsGathered>(a, s);
    }
  } else if (s64 <= limit) {
    rc = launch_dw<T, 64, kRowsGathered>(a, s);
  }
  if (rc != 0 || a.runs == 1) return rc;
  const size_t n4 = static_cast<size_t>(a.K) * a.cx * a.cd / 4;
  const size_t want = (n4 + kThreads - 1) / kThreads;
  sum_partials_kernel<<<static_cast<int>(want < 4096 ? want : 4096),
                        kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(a.out), a.runs, n4,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dwt [K, cin, Ct] f32 = sum over the chunks of the transpose plan of
// feats_c^T @ Gct_k (see the header), in `runs` runs of consecutive chunks;
// with runs > 1, partial is caller-owned f32 scratch [runs, K, cin, Ct]
// whose runs are then summed in order. f32 takes the tensor-core tile with
// tc != 0, else the FMA tile; the tensor-core tile adds its blocks' k8
// steps run and skipped and their cycles (ordering rows, in the block)
// into counts[0..4) unless counts is null. Returns a cudaError_t, or -2
// when no Ct tile (or with tc, no tensor-core block) fits in shared memory.
int occ_chunk_conv_dwt(const void* ct, int n_ct, int Ct, const void* t_in_idx,
                       int C, int U, const void* t_lidx, int K, int M,
                       const void* feats, int cin, int runs, void* partial,
                       void* dwt, int is_bf16, int tc, void* order,
                       void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dwt);
  const DwArgs a{ct, static_cast<const int32_t*>(t_in_idx),
                 static_cast<const int32_t*>(t_lidx), feats,
                 runs > 1 ? static_cast<float*>(partial) : out,
                 static_cast<unsigned long long*>(counts),
                 static_cast<unsigned char*>(order), n_ct, Ct, C, U, K, M,
                 cin, runs};
  return is_bf16 ? run_dw<bf16, false>(a, out, false, s)
                 : run_dw<float, false>(a, out, tc != 0, s);
}

// dw [K, cin, cout] f32 = sum over the chunks of the forward plan of
// G_k^T @ ct_c (see the header), in `runs` runs of consecutive chunks;
// with runs > 1, partial is caller-owned f32 scratch [runs, K, cin, cout]
// whose runs are then summed in order. tc and counts as for
// `occ_chunk_conv_dwt`. Returns a cudaError_t, or -2 when no Cin tile (or
// with tc, no tensor-core block) fits in shared memory.
int occ_chunk_conv_dw(const void* feats, int n_rows, int cin,
                      const void* in_idx, int C, int U, const void* lidx,
                      int K, int M, const void* ct, int cout, int runs,
                      void* partial, void* dw, int is_bf16, int tc,
                      void* order, void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  const DwArgs a{feats, static_cast<const int32_t*>(in_idx),
                 static_cast<const int32_t*>(lidx), ct,
                 runs > 1 ? static_cast<float*>(partial) : out,
                 static_cast<unsigned long long*>(counts),
                 static_cast<unsigned char*>(order), n_rows, cin, C, U, K, M,
                 cout, runs};
  return is_bf16 ? run_dw<bf16, true>(a, out, false, s)
                 : run_dw<float, true>(a, out, tc != 0, s);
}

// Bytes of shared memory a block of the tensor-core dW tile asks for, at
// any U (the wrapper's route rule computes the same).
long long occ_chunk_conv_dw_tc_smem() {
  return static_cast<long long>(DwLayout<float, 64, true>(0).total);
}

}  // extern "C"
