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
// with f32 accumulation and the output in the feature dtype. The same kernel
// computes d_feats of the fused backward over the transpose plan
// (chunk_conv_bwd.cu). The TPU kernel permutes the staged rows with one-hot
// MXU products because Mosaic cannot gather rows; that formulation is not
// carried over: here the rows are gathered from shared memory directly.
//
// What bounds it on the H100: per chunk, M*K*Cin*Cout*2 FLOP against ~U*Cin
// staged input rows and M*Cout output elements, ~470 FLOP/byte at the bench
// L0 shape, above the bf16 ridge (~295), so a good kernel is tensor-core
// bound. Its first version (one block per 64 columns, WMMA) was bound by
// latency: per offset it copied an [M, CI_T] A tile inside shared memory,
// loaded W[k] with synchronous global loads and synchronised the block.
// This one still runs at ~25% of the tensor cores' dense rate: the staging
// of each Cin tile stops the block (only the other resident block covers
// it), and the A gathers read rows at random strides (bank conflicts).
// Every block reads all of W for its columns (W is not shared across
// chunks), but with W loaded only once per block the bench step measured
// ~3% faster: W traffic is not what bounds it.
//
// Design:
//  * one block per (chunk, NT-column tile, split): two warpgroups (8
//    warps). NT is 64, 96 or 128 in bf16 (the wrapper's `col_tile`), so
//    the chunk's rows are staged once per Cin tile for up to 128 columns;
//  * per Cin tile of CI_T columns the chunk's referenced rows (pad slots
//    skipped) are staged with 16-byte cp.async at a padded stride, with the
//    zero row at U that every missing neighbour (lidx = -1) points at;
//  * thread 0 streams the W[k] tiles of the block's (Cin tile, k) steps
//    through a ring of kStages stages: one TMA load per 128-byte-wide box
//    of a 2D tensor map of W [K*Cin, Cout] (128-byte swizzle, zeros past
//    Cout), completing on mbarriers; each warp releases a stage with one
//    arrive, and thread 0 refills it once all have. No global load sits on
//    the warps' path and there is no block-wide barrier per offset.
//    (Row-by-row bulk copies, 64 per stage, measured ~2x slower at L0: the
//    copy engine's cost per request set the pace. A separate producer warp
//    made 9 warps a block, capped the registers at 96 with spills, and
//    measured ~4% slower);
//  * bf16: warpgroup g owns rows g*64..+64 and all NT columns. Its warps
//    gather their A fragments with ldmatrix straight from the staged rows,
//    every lane's row address read from lidx (no A-tile copy), and the
//    group runs wgmma m64nNTk16 with A from registers and B = the swizzled
//    W stage through a shared-memory descriptor, accumulating in f32
//    registers. An (offset, 64-row group) with no valid reference is
//    skipped: a table of these flags is built once per chunk. (mma.sync
//    m16n8k16 from ldmatrix fragments of the same stage measured 12.05 ms
//    per bench step against 8.69 for wgmma; issuing a step's wgmma before
//    the previous one completes, with two sets of A fragments, measured
//    ~10% slower: the stage it holds is refilled a step later);
//  * f32 (the training CLI, parity checks): exact FMA products, each thread
//    an 8 x 4 register tile reading the staged rows through lidx (NT=64).
//    Most of a sparse map's (offset, row) pairs are missing neighbours
//    (2.7x the real products ran at the bench shapes when only dead
//    64-row groups were skipped), so each block first orders its chunk's
//    rows by their neighbour mask (bit k: a reference at offset k; ties by
//    row), warp w owns positions w*16..+16 of that order, and a warp
//    skips every offset at which none of its rows has a reference (it
//    still waits on and releases the W stage). A row's sum keeps its
//    (Cin tile, offset, ci) order; a skipped product is an exact zero, so
//    the output does not depend on the order. The blocks count their
//    warp-steps run and skipped and the clock cycles of building the
//    order into `counts`. A block takes about as long as its densest warp
//    (the W ring holds the warps within three steps), so f32 takes a Cin
//    tile with which two blocks share an SM. (Groups of 8 rows, two a
//    warp and the sparsest paired with the densest to even the warps out,
//    skipped 12% more but measured 6-10% slower: a step of four rows a
//    thread costs nearly what one of eight does);
//  * f32 on the tensor cores (the tile the wrapper takes wherever its
//    shared memory fits, but for two shapes where the FMA tile measured
//    faster: `f32_route` in ops/kernels/chunk_conv.py): a 3xTF32 split,
//    a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (`tf32_split`), the two
//    small terms issued first, at a third of the TF32 rate (495 TFLOP/s):
//    ~2.5x the 67 TFLOP/s of the FMA tile, with ~2^-22 of each product's
//    size left out. TF32 wgmma reads B K-major only, so the wrapper hands
//    W as [2, K, Cout, Cin] (hi, then lo; `occ_chunk_conv_tf32_split_w`,
//    once a call), Cin padded to a multiple of 32 and each 32 columns in
//    the order of the A fragments (`tc_col`), and TMA streams a hi and a
//    lo box of NT rows x 32 columns per step through the same ring.
//    Warpgroup g owns positions g*64..+64 of the neighbour-mask row order
//    above; each thread gathers its two rows' 8 staged columns through
//    lidx with two 16-byte loads, splits them in registers, and the group
//    runs 4 x 3 wgmma m64nNTk8 with A from registers into a partial
//    sum, which an f32 add then takes into the row's sum (`TcTile`). A
//    (Cin tile, offset, 64-row group) with no reference in the group's
//    rows is skipped (`TcTile::runs`); the blocks count the group-steps
//    run and skipped. The Cin tile is 32 (a Cin of 16 stages its tile
//    with zero columns, and W's padding is zero). The partial costs NT/2
//    registers a thread, so one block an SM;
//  * coarse levels, where chunks x column tiles would leave SMs idle: the
//    wrapper splits the (Cin tile, k) steps into `splits` ranges, one per
//    block; each writes an f32 partial and a second launch sums them in
//    split order and rounds to the feature dtype (deterministic);
//  * CI_T is the largest of 64/32/16 that divides Cin and whose shared
//    memory fits the device's opt-in limit (f32: 32 where that lets two
//    blocks share an SM and 64 does not); beyond it the call fails (the
//    wrapper raises) -- there is no other path;
//  * a chunk with no referenced row (all cap padding) writes zeros.

#include <type_traits>

#include "chunk_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // two warpgroups
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;                 // W ring depth
constexpr int kMaskOffsets = 32;  // f32: offsets a row's neighbour mask holds

struct FwdArgs {
  const void* feats;
  const int32_t* in_idx;
  const int32_t* lidx;
  void* out;    // [C*M, cout], feature dtype (splits == 1)
  float* part;  // [splits, C*M, cout] f32 (splits > 1)
  // f32: warp-steps run, skipped, thread 0's cycles building the row order
  // and its cycles in the block, then the tensor-core path's group-steps
  // run and skipped, summed over the blocks (6 slots, or null)
  unsigned long long* counts;
  int n_rows, cin, C, U, K, M, cout, splits;
};

// Shared memory plan shared by host and device, from a 1024-byte aligned
// base (the 128-byte swizzle of the W boxes needs it). kTc: the W stage is
// a hi and a lo box of NT K-major rows of 128 bytes (32 f32 of Cin).
template <typename T, int CI_T, int NT, bool kTc = false>
struct FwdLayout {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLdg = CI_T + kVec;              // staged row stride
  static constexpr int kBoxCols = kBox / sizeof(T);     // columns per box
  static constexpr int kBoxes = (NT + kBoxCols - 1) / kBoxCols;
  static constexpr int kBoxBytes = kTc ? NT * kBox : CI_T * kBox;
  static constexpr int kStageBytes =  // one W tile
      kTc ? 2 * kBoxBytes : kBoxes * kBoxBytes;
  size_t bar_off, in_off, lidx_off, live_off, gin_off, total;
  __host__ __device__ FwdLayout(int U, int K) {
    size_t off = static_cast<size_t>(kStages) * kStageBytes;  // W ring
    bar_off = off;
    off += align128(2 * kStages * sizeof(uint64_t));
    in_off = off;
    off += align128(static_cast<size_t>(U) * sizeof(int32_t));
    lidx_off = off;
    off += align128(static_cast<size_t>(K) * kMaxM * sizeof(int32_t));
    // bf16: per (offset, 64-row group), any valid reference; f32: each
    // row's neighbour mask, each warp's live offsets, the row order
    live_off = off;
    off += align128(sizeof(T) == 2 ? static_cast<size_t>(K) * 2
                                   : kMaxM * 4 + kWarps * 4 + kMaxM);
    gin_off = off;
    off += align128(static_cast<size_t>(U + 1) * kLdg * sizeof(T));
    total = off + 1024;  // room to align the base
  }
};

// bf16 consumer tile: warpgroup g holds rows g*64..+64 and all NT columns
// of the block's [128, NT] output as one wgmma accumulator (NT/2 f32 per
// thread); warp w of the group gathers the A fragments of rows
// g*64 + w*16..+16.
template <int CI_T, int NT>
struct WgTile {
  static constexpr int kLdg = CI_T + 8;
  float acc[NT / 2];
  int g, row0, lane;

  __device__ WgTile(int t) {
    const int warp = t / 32;
    lane = t % 32;
    g = warp >> 2;
    row0 = g * 64 + (warp & 3) * 16;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  }

  // out += G_k @ W_k over one Cin tile (lk = lidx of offset k, live_k its
  // two 64-row liveness flags). The A fragments are gathered with ldmatrix
  // straight from the staged rows, every lane's row address read from
  // lidx; B is the swizzled W stage. The MMAs complete before return: the
  // caller then releases the stage.
  __device__ void step(const bf16* gin_s, const bf16* w_b,
                       const int32_t* lk, const uint8_t* live_k, int M,
                       int U) {
    if (!live_k[g]) return;  // uniform over the warpgroup
    const int m = row0 + (lane & 15);
    const int l = m < M ? row_of(lk[m], U) : U;
    const uint32_t a_addr = smem_u32(gin_s + l * kLdg + (lane >> 4) * 8);
    uint32_t af[CI_T / 16][4];
#pragma unroll
    for (int kk = 0; kk < CI_T / 16; ++kk)
      ldmatrix_x4(af[kk], a_addr + kk * 32);
    const uint32_t w0 = smem_u32(w_b);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CI_T / 16; ++kk)
      wgmma_bf16<NT>(acc, af[kk],
                     wgmma_desc_b128(w0 + kk * 16 * kBox, CI_T * kBox));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(af);
    fence_regs(acc);
  }

  // Rows c*M.. of out (bf16) or of part (f32), columns co0..co0+ncols.
  __device__ void store(bf16* out, float* part, int cout, size_t rbase,
                        int M, int co0, int ncols) const {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      if (j * 8 >= ncols) continue;
      const int col = co0 + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + (lane >> 2) + h * 8;
        if (m >= M) continue;
        const size_t r = rbase + m;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (part)
          *reinterpret_cast<float2*>(part + r * cout + col) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + r * cout + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
};

// Component q of a float4 (q a compile-time constant once unrolled).
__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// f32 consumer tile (NT = 64): thread (rg, cg) holds the rows at
// positions rg*8..+8 of the block's row order `ord` (so warp w those at
// w*16..+16) and columns cg*4..+4 in registers; exact FMA products, in ci
// order. A thread reads each row's A values four ci at a time (one 16-byte
// load, not four of 4 bytes). The W stage is two swizzled boxes of 32
// columns.
template <int CI_T, int NT>
struct FmaTile {
  static_assert(NT == 64, "the f32 tile is 64 columns wide");
  static constexpr int kLdg = CI_T + 4;
  float acc[8][4];
  int rg, cg;
  uint32_t live = 0;  // bit k: one of the warp's rows references offset k

  __device__ FmaTile(int t) : rg(t / 16), cg(t % 16) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
  }

  // Whether the warp runs offset k (uniform over the warp).
  __device__ bool runs(int k) const {
    return k >= kMaskOffsets || (live >> k & 1u);
  }

  __device__ void step(const float* gin_s, const float* w_b,
                       const int32_t* lk, const uint8_t* ord, int M, int U) {
    int off[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = ord[rg * 8 + r];
      off[r] = (m < M ? row_of(lk[m], U) : U) * kLdg;
    }
    const char* wb = reinterpret_cast<const char*>(w_b) +
                     (cg >> 3) * (CI_T * kBox);
#pragma unroll 2
    for (int ci = 0; ci < CI_T; ci += 4) {
      float4 a[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a[r] = *reinterpret_cast<const float4*>(gin_s + off[r] + ci);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b =
            *reinterpret_cast<const float4*>(wb + swz(ci + q, cg & 7));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float av = lane_of(a[r], q);
          acc[r][0] = fmaf(av, b.x, acc[r][0]);
          acc[r][1] = fmaf(av, b.y, acc[r][1]);
          acc[r][2] = fmaf(av, b.z, acc[r][2]);
          acc[r][3] = fmaf(av, b.w, acc[r][3]);
        }
      }
    }
  }

  // out and part are both f32 here: write whichever is given.
  __device__ void store(float* out, float* part, int cout, size_t rbase,
                        int M, int co0, int ncols, const uint8_t* ord) const {
    float* dst = part ? part : out;
    const int c = cg * 4;
    if (c >= ncols) return;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = ord[rg * 8 + r];
      if (m >= M) continue;
      *reinterpret_cast<float4*>(dst + (rbase + m) * cout + co0 + c) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
};

// Position q (0..31) of a K-major W row of the tensor-core tile: the Cin
// column of its 32-column tile that it holds. A thread of the A fragment
// layout (lane & 3 = t) reads columns 8t..8t+8 of a staged row with two
// 16-byte loads, and step j of the tile's four k8 steps takes its fragment
// columns t and t + 4 from components j of the two loads: columns 8t + j
// and 8t + 4 + j. B's position 8j + t (resp. 8j + t + 4) holds the same
// column, so the sum over the tile is the same (`TC_COLS` in
// ops/kernels/chunk_conv.py).
__host__ __device__ constexpr int tc_col(int q) {
  return (q & 7) < 4 ? 8 * (q & 7) + (q >> 3) : 8 * ((q & 7) - 4) + 4 + (q >> 3);
}

// f32 on the tensor cores (3xTF32; CI_T = 32): warpgroup g holds the rows
// at positions g*64..+64 of the block's row order and all NT columns as
// wgmma accumulators (NT/2 f32 per thread); the thread's rows are the
// positions p0 = g*64 + (warp & 3)*16 + lane/4 and p0 + 8 (rows m0, m1,
// >= M: none). A step gathers each row's columns 8(lane&3)..+8 of the
// staged tile through lidx, splits them (`tf32_split`) into the four k8
// steps' hi and lo fragments, and runs lo*W_hi and hi*W_lo of every k8
// step (the small terms first), then hi*W_hi, against the stage's two
// K-major boxes, into a partial sum that starts at zero; the step's
// partial is then added into the sum with an f32 add. (With every
// product of a row in one wgmma accumulator, ~1000 at Cin 80, the sum
// measured 1.6e-5 of the largest output from the f32 plain version on
// the H100, past F32_TOL: the tensor cores' f32 accumulation loses more
// than an f32 add. With a partial a step, its error from float64 is at
// most 1.05x the FMA tile's over the bench plan's 66 maps, mostly 2-5x
// below it.)
template <int CI_T, int NT>
struct TcTile {
  static_assert(CI_T == 32, "one 128-byte K-major row of W per column");
  static constexpr int kLdg = CI_T + 4;
  float acc[NT / 2], part[NT / 2];
  int lane, m0 = 0, m1 = 0;
  uint32_t live = 0;  // bit k: one of the group's 64 rows references offset k

  __device__ TcTile(int t) : lane(t % 32) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  }

  // the thread's two rows, from the block's row order
  __device__ void rows(const uint8_t* ord, int t) {
    const int warp = t / 32;
    const int p = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
    m0 = ord[p];
    m1 = ord[p + 8];
  }

  // Whether the warpgroup runs offset k (uniform over the warpgroup).
  __device__ bool runs(int k) const {
    return k >= kMaskOffsets || (live >> k & 1u);
  }

  __device__ void step(const float* gin_s, const unsigned char* w_hi,
                       const unsigned char* w_lo, const int32_t* lk, int M,
                       int U) {
    const int c = (lane & 3) * 8;
    const float* r0 = gin_s + (m0 < M ? row_of(lk[m0], U) : U) * kLdg + c;
    const float* r1 = gin_s + (m1 < M ? row_of(lk[m1], U) : U) * kLdg + c;
    const float4 x0 = *reinterpret_cast<const float4*>(r0);
    const float4 y0 = *reinterpret_cast<const float4*>(r0 + 4);
    const float4 x1 = *reinterpret_cast<const float4*>(r1);
    const float4 y1 = *reinterpret_cast<const float4*>(r1 + 4);
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tf32_split(lane_of(x0, j), hi[j][0], lo[j][0]);
      tf32_split(lane_of(x1, j), hi[j][1], lo[j][1]);
      tf32_split(lane_of(y0, j), hi[j][2], lo[j][2]);
      tf32_split(lane_of(y1, j), hi[j][3], lo[j][3]);
    }
    const uint32_t bh = smem_u32(w_hi), bl = smem_u32(w_lo);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_tf32<NT>(part, lo[j], wgmma_desc_k128(bh + 32 * j), j > 0);
      wgmma_tf32<NT>(part, hi[j], wgmma_desc_k128(bl + 32 * j), 1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_tf32<NT>(part, hi[j], wgmma_desc_k128(bh + 32 * j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(hi);
    fence_regs(lo);
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }

  // f32 rows of out (splits == 1) or of part, columns co0..co0+ncols.
  __device__ void store(float* out, float* part, int cout, size_t rbase,
                        int M, int co0, int ncols) const {
    float* dst = part ? part : out;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      if (j * 8 >= ncols) continue;
      const int col = co0 + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = h ? m1 : m0;
        if (m >= M) continue;
        *reinterpret_cast<float2*>(dst + (rbase + m) * cout + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

template <typename T, int CI_T, int NT, bool kTc>
using TileOf = typename std::conditional<
    kTc, TcTile<CI_T, NT>,
    typename std::conditional<sizeof(T) == 2, WgTile<CI_T, NT>,
                              FmaTile<CI_T, NT>>::type>::type;

// f32: one block's counts (see FwdArgs), by one thread: its warp-steps
// (the FMA tile) or group-steps (kTc) run and skipped, and its cycles.
__device__ __forceinline__ void add_counts(unsigned long long* counts,
                                           bool tc, unsigned long long ran,
                                           unsigned long long skipped,
                                           long long order_cycles,
                                           long long cycles) {
  atomicAdd(counts + (tc ? 4 : 0), ran);
  atomicAdd(counts + (tc ? 5 : 1), skipped);
  atomicAdd(counts + 2, static_cast<unsigned long long>(order_cycles));
  atomicAdd(counts + 3, static_cast<unsigned long long>(cycles));
}

// kTc holds a partial sum beside the sum (`TcTile`): one block an SM, up to
// 255 registers a thread.
template <typename T, int CI_T, int NT, bool kTc>
__global__ void __launch_bounds__(kThreads, kTc ? 1 : 2)
chunk_conv_kernel(const __grid_constant__ CUtensorMap wmap,
                  const FwdArgs a) {
  constexpr bool kF32 = sizeof(T) == 4;
  static_assert(kF32 || !kTc, "the tensor-core f32 path is f32");
  static_assert(kThreads == 2 * kMaxM, "the f32 row order: two threads a row");
  const long long t_start = kF32 ? clock64() : 0;
  using L = FwdLayout<T, CI_T, NT, kTc>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const L lay(a.U, a.K);
  unsigned char* w_s = smem;  // kStages W tiles, each kBoxes swizzled boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + kStages;
  int32_t* in_s = reinterpret_cast<int32_t*>(smem + lay.in_off);
  int32_t* lidx_s = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  uint8_t* live_s = smem + lay.live_off;  // bf16
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + lay.live_off);  // f32
  uint32_t* wlive_s = mask_s + kMaxM;
  uint8_t* ord_s = reinterpret_cast<uint8_t*>(wlive_s + kWarps);
  T* gin_s = reinterpret_cast<T*>(smem + lay.gin_off);

  const int U = a.U, K = a.K, M = a.M;
  const int c = blockIdx.x, co0 = blockIdx.y * NT, split = blockIdx.z;
  const int ncols = min(NT, a.cout - co0);
  const int n_steps = (a.cin + CI_T - 1) / CI_T * K;  // kTc: Cin 16 pads
  const int s0 = static_cast<int>(static_cast<long long>(n_steps) * split /
                                  a.splits);
  const int s1 = static_cast<int>(static_cast<long long>(n_steps) *
                                  (split + 1) / a.splits);
  const int32_t* in_c = a.in_idx + static_cast<size_t>(c) * U;
  const size_t rbase = static_cast<size_t>(c) * M;
  T* out = static_cast<T*>(a.out);
  float* part = a.splits > 1 ? a.part + static_cast<size_t>(split) *
                                            a.C * M * a.cout
                             : nullptr;
  const int t = threadIdx.x;

  if (in_c[0] < 0) {  // no referenced row: pure cap padding
    const int esz = part ? 4 : sizeof(T);
    char* base = part ? reinterpret_cast<char*>(part)
                      : reinterpret_cast<char*>(out);
    const int vpr = ncols * esz / 16;
    for (int i = t; i < M * vpr; i += kThreads)
      reinterpret_cast<uint4*>(
          base + ((rbase + i / vpr) * a.cout + co0) * esz)[i % vpr] =
          make_uint4(0, 0, 0, 0);
    if (kF32 && t == 0 && a.counts)  // every warp- or group-step skipped
      add_counts(a.counts, kTc, 0,
                 static_cast<unsigned long long>(s1 - s0) *
                     (kTc ? kWarps / 4 : kWarps),
                 0, clock64() - t_start);
    return;
  }
  const int warp = t / 32, lane = t % 32;
  const int n = s1 - s0;  // this block's (Cin tile, offset) steps
  // W[k][ci0..ci0+CI_T][co0..) of step i into its ring stage, as the boxes
  // that start inside W (the last may run past Cout: zeros); thread 0
  // starts every load
  const int nbox =
      min(L::kBoxes, (a.cout - co0 + L::kBoxCols - 1) / L::kBoxCols);
  auto load_w = [&](int i) {
    const int stage = i % kStages, s = s0 + i;
    if constexpr (kTc) {
      // W [2K, cout, cin_p]: the hi box of offset k, then its lo box
      mbar_arrive_expect_tx(full + stage, L::kStageBytes);
      for (int b = 0; b < 2; ++b)
        tma_load_3d(w_s + stage * L::kStageBytes + b * L::kBoxBytes, &wmap,
                    (s / K) * CI_T, co0, s % K + b * K, full + stage);
      return;
    }
    mbar_arrive_expect_tx(full + stage, nbox * L::kBoxBytes);
    const int row = (s % K) * a.cin + (s / K) * CI_T;
    for (int b = 0; b < nbox; ++b)
      tma_load_2d(w_s + stage * L::kStageBytes + b * L::kBoxBytes, &wmap,
                  co0 + b * L::kBoxCols, row, full + stage);
  };
  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
    mbar_fence_init();
    for (int i = 0; i < min(kStages, n); ++i) load_w(i);
  }

  // the chunk's in_idx and lidx rows into shared memory, then per Cin tile
  // its rows
  copy_ints(in_s, in_c, U, t, kThreads);
  copy_ints(lidx_s, a.lidx + static_cast<size_t>(c) * K * M, K * M, t,
            kThreads);
  cp_async_wait_all();
  zero_bytes(gin_s + static_cast<size_t>(U) * L::kLdg, L::kLdg * sizeof(T), t,
             kThreads);
  __syncthreads();
  long long order_cycles = 0;
  uint32_t live = 0;  // f32: the offsets any of the warp's rows references
  if constexpr (!kF32) {
    // liveness of each (offset, 64-row group), one warp per pair (made
    // visible by the first staging's barrier): a group with no valid
    // reference at an offset skips it
    for (int p = warp; p < 2 * K; p += kWarps) {
      const int k = p >> 1, m0 = (p & 1) * 64;
      bool any = false;
      for (int m = m0 + lane; m < min(M, m0 + 64); m += 32)
        any |= lidx_s[k * M + m] >= 0;
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) live_s[p] = any;
    }
  } else {
    const long long t_order = clock64();
    // each row's neighbour mask over the offsets below kMaskOffsets
    for (int m = t; m < M; m += kThreads) {
      uint32_t mk = 0;
      for (int k = 0; k < min(K, kMaskOffsets); ++k)
        mk |= static_cast<uint32_t>(lidx_s[k * M + m] >= 0) << k;
      mask_s[m] = mk;
    }
    __syncthreads();
    // the row order: row m goes to its rank by (mask, row) among the
    // chunk's rows, counted by two threads over alternate rows; positions
    // M.. hold rows M.. (none)
    {
      const int m = t >> 1;
      int p = 0;
      if (m < M) {
        const uint32_t mk = mask_s[m];
        for (int j = t & 1; j < M; j += 2) {
          const uint32_t mj = mask_s[j];
          p += mj < mk || (mj == mk && j < m);
        }
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      if ((t & 1) == 0) ord_s[m < M ? p : m] = static_cast<uint8_t>(m);
    }
    __syncthreads();
    // the warp's live offsets: the OR of its 16 rows' masks (made visible
    // to thread 0 by the first staging's barrier)
    const int m = ord_s[warp * 16 + (lane & 15)];
    live = m < M ? mask_s[m] : 0u;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      live |= __shfl_xor_sync(0xffffffffu, live, o);
    if (lane == 0) wlive_s[warp] = live;
    if constexpr (kTc) {
      // the warpgroup's live offsets: the OR of its four warps'
      __syncthreads();
      const int w0 = warp & ~3;
      live = wlive_s[w0] | wlive_s[w0 + 1] | wlive_s[w0 + 2] |
             wlive_s[w0 + 3];
    }
    order_cycles = clock64() - t_order;
  }
  TileOf<T, CI_T, NT, kTc> tile(t);
  if constexpr (kTc) tile.rows(ord_s, t);
  if constexpr (kF32) tile.live = live;
  const T* feats = static_cast<const T*>(a.feats);
  int staged = -1;
  for (int i = 0; i < n; ++i) {
    const int s = s0 + i, k = s % K, cit = s / K;
    if (cit != staged) {
      __syncthreads();  // earlier readers of gin_s are done
      stage_rows<T, CI_T>(gin_s, L::kLdg, feats, a.n_rows, a.cin, a.cin, in_s,
                          U, cit * CI_T, t, kThreads);
      cp_async_wait_all();
      __syncthreads();
      staged = cit;
    }
    const int stage = i % kStages;
    mbar_wait(full + stage, (i / kStages) & 1);
    __syncwarp();  // wgmma wants the warp converged
    const T* w_b = reinterpret_cast<const T*>(w_s + stage * L::kStageBytes);
    if constexpr (!kF32) {
      tile.step(gin_s, w_b, lidx_s + k * M, live_s + 2 * k, M, U);
    } else if constexpr (kTc) {
      if (tile.runs(k))
        tile.step(gin_s, w_s + stage * L::kStageBytes,
                  w_s + stage * L::kStageBytes + L::kBoxBytes, lidx_s + k * M,
                  M, U);
    } else if (tile.runs(k)) {
      tile.step(gin_s, w_b, lidx_s + k * M, ord_s, M, U);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);
    // refill the stage once every warp is done with it
    if (t == 0 && i + kStages < n) {
      mbar_wait(empty + stage, (i / kStages) & 1);
      load_w(i + kStages);
    }
  }
  if constexpr (!kF32 || kTc) {
    tile.store(out, part, a.cout, rbase, M, co0, ncols);
  } else {
    tile.store(out, part, a.cout, rbase, M, co0, ncols, ord_s);
  }
  if constexpr (kF32) {
    if (a.counts == nullptr) return;
    __syncthreads();
    if (t != 0) return;
    // steps run below step s by the block's units (its 8 warps, or kTc its
    // 2 warpgroups, each the OR of its 4 warps): each unit's live offsets
    // once per Cin tile before s, and those of its tile below offset s % K;
    // offsets from kMaskOffsets on run in every unit
    constexpr int kUnits = kTc ? kWarps / 4 : kWarps;
    constexpr int kPer = kWarps / kUnits;
    auto ran_below = [&](int s) {
      const int r = s % K;
      const uint32_t below = r >= 32 ? ~0u : (1u << r) - 1u;
      unsigned long long per_tile = 0, rest = 0;
      for (int u = 0; u < kUnits; ++u) {
        uint32_t lv = 0;
        for (int w = u * kPer; w < (u + 1) * kPer; ++w) lv |= wlive_s[w];
        per_tile += __popc(lv);
        rest += __popc(lv & below);
      }
      per_tile += kUnits * max(0, K - kMaskOffsets);
      rest += kUnits * max(0, r - kMaskOffsets);
      return static_cast<unsigned long long>(s / K) * per_tile + rest;
    };
    const unsigned long long ran = ran_below(s1) - ran_below(s0);
    add_counts(a.counts, kTc, ran,
               static_cast<unsigned long long>(n) * kUnits - ran,
               order_cycles, clock64() - t_start);
  }
}

// out[i] = (feature dtype) sum over s in order of part[s][i].
template <typename T>
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float4* __restrict__ part, int S, size_t n4,
                  T* __restrict__ out) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * 256) {
    float4 v = part[i];
    for (int s = 1; s < S; ++s) {
      const float4 p = part[static_cast<size_t>(s) * n4 + i];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      reinterpret_cast<uint2*>(out)[i] = packed;
    } else {
      reinterpret_cast<float4*>(out)[i] = v;
    }
  }
}

template <typename T, int CI_T, int NT, bool kTc>
int run_kernel(const CUtensorMap& wmap, const FwdArgs& a,
               cudaStream_t stream);

template <typename T, int CI_T, int NT>
int launch(const void* w, const FwdArgs& a, cudaStream_t stream) {
  using L = FwdLayout<T, CI_T, NT>;
  // W [K, cin, cout] as a 2D tensor [K*cin rows, cout columns]; one box is
  // CI_T rows of 128 bytes, swizzled
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.cout),
                              static_cast<cuuint64_t>(a.K) * a.cin};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.cout) * sizeof(T)};
  const cuuint32_t box[2] = {L::kBoxCols, CI_T};
  const cuuint32_t estr[2] = {1, 1};
  const EncodeTiled encode = encoder();
  if (encode == nullptr ||
      encode(&wmap,
             sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(w), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -4;
  return run_kernel<T, CI_T, NT, false>(wmap, a, stream);
}

// The kernel (and, with splits, its sum of partials) on a W tensor map.
template <typename T, int CI_T, int NT, bool kTc>
int run_kernel(const CUtensorMap& wmap, const FwdArgs& a,
               cudaStream_t stream) {
  const FwdLayout<T, CI_T, NT, kTc> lay(a.U, a.K);
  const int smem = static_cast<int>(lay.total);
  auto kernel = chunk_conv_kernel<T, CI_T, NT, kTc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.C, (a.cout + NT - 1) / NT, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(wmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(a.C) * a.M * a.cout / 4;
  const size_t want = (n4 + 255) / 256;
  sum_splits_kernel<T><<<static_cast<int>(want < 4096 ? want : 4096), 256, 0,
                         stream>>>(reinterpret_cast<const float4*>(a.part),
                                   a.splits, n4, static_cast<T*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one block when two share an SM (228 KiB less 1 KiB
// reserved per block, halved), as `run_dw` of chunk_conv_bwd.cu has it.
constexpr size_t kTwoPerSm = 115712;

// The Cin tile of a call: f32 takes 32 where 64 leaves room for one block
// an SM and 32 for two (the warps of a block whose rows are sparse idle
// while its densest warp runs: a second block fills the SM); else the
// largest of 64/32/16 that divides Cin and whose shared memory fits the
// device's opt-in limit, or -2.
template <typename T, int NT>
int cin_tile(int cin, int U, int K) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  if (sizeof(T) == 4 && cin % 32 == 0 &&
      FwdLayout<T, 64, NT>(U, K).total > kTwoPerSm &&
      FwdLayout<T, 32, NT>(U, K).total <= kTwoPerSm)
    return 32;
  if (cin % 64 == 0 && FwdLayout<T, 64, NT>(U, K).total <= limit) return 64;
  if (cin % 32 == 0 && FwdLayout<T, 32, NT>(U, K).total <= limit) return 32;
  if (cin % 16 == 0 && FwdLayout<T, 16, NT>(U, K).total <= limit) return 16;
  return -2;
}

template <typename T, int NT>
int launch_fitting(const void* w, const FwdArgs& a, cudaStream_t s) {
  switch (cin_tile<T, NT>(a.cin, a.U, a.K)) {
    case 64: return launch<T, 64, NT>(w, a, s);
    case 32: return launch<T, 32, NT>(w, a, s);
    case 16: return launch<T, 16, NT>(w, a, s);
  }
  return -2;
}

// The tensor-core f32 path: wt [2, K, cout, cin_p] (`split_w_kernel`) as
// a 3D tensor map of boxes of NT rows x 32 columns (128 bytes, swizzled);
// rows past cout are filled with zeros.
template <int NT>
int launch_tc(const void* wt, const FwdArgs& a, cudaStream_t stream) {
  using L = FwdLayout<float, 32, NT, true>;
  if (L(a.U, a.K).total > static_cast<size_t>(max_dynamic_smem())) return -2;
  const int cin_p = (a.cin + 31) / 32 * 32;
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cin_p),
                              static_cast<cuuint64_t>(a.cout),
                              static_cast<cuuint64_t>(2 * a.K)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cin_p) * 4,
                                 static_cast<cuuint64_t>(cin_p) * 4 * a.cout};
  const cuuint32_t box[3] = {32, NT, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const EncodeTiled encode = encoder();
  if (encode == nullptr ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(wt), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -4;
  return run_kernel<float, 32, NT, true>(wmap, a, stream);
}

// w [K, cin, cout] f32 -> wt [2, K, cout, cin_p]: hi, then lo
// (`tf32_split`), K-major, each 32 columns in `tc_col` order, zero past
// cin. One element of each a thread.
__global__ void __launch_bounds__(256)
split_w_kernel(const float* __restrict__ w, int K, int cin, int cout,
               int cin_p, float* __restrict__ wt) {
  const size_t n = static_cast<size_t>(K) * cout * cin_p;
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * 256) {
    const int q = static_cast<int>(i % cin_p);
    const size_t kn = i / cin_p;
    const int co = static_cast<int>(kn % cout);
    const int k = static_cast<int>(kn / cout);
    const int ci = (q & ~31) + tc_col(q & 31);
    uint32_t hi = 0, lo = 0;
    if (ci < cin)
      tf32_split(w[(static_cast<size_t>(k) * cin + ci) * cout + co], hi, lo);
    wt[i] = __uint_as_float(hi);
    wt[n + i] = __uint_as_float(lo);
  }
}

}  // namespace

extern "C" {

// out [C*M, cout] = chunk conv of feats [n_rows, cin] (see the header), in
// column tiles of nt (bf16: 64, 96, 128; f32: 64) and `splits` ranges of
// (Cin tile, k) steps per block; with splits > 1, part is caller-owned f32
// scratch [splits, C*M, cout]. f32 adds its blocks' counts into `counts`
// (4 x uint64: warp-steps run, skipped, cycles building the row order,
// cycles in the block), unless it is null. Returns a cudaError_t, -2 when
// no Cin tile fits in shared memory, -3 for an unsupported nt, -4 when the
// tensor-map encoder is missing or refuses W.
int occ_chunk_conv_fwd(const void* feats, int n_rows, int cin,
                       const void* in_idx, int C, int U, const void* lidx,
                       int K, int M, const void* w, int cout, int nt,
                       int splits, void* part, void* out, int is_bf16,
                       void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{feats, static_cast<const int32_t*>(in_idx),
                  static_cast<const int32_t*>(lidx), out,
                  static_cast<float*>(part),
                  static_cast<unsigned long long*>(counts), n_rows, cin, C,
                  U, K, M, cout, splits};
  if (is_bf16) {
    switch (nt) {
      case 64: return launch_fitting<bf16, 64>(w, a, s);
      case 96: return launch_fitting<bf16, 96>(w, a, s);
      case 128: return launch_fitting<bf16, 128>(w, a, s);
    }
    return -3;
  }
  return nt == 64 ? launch_fitting<float, 64>(w, a, s) : -3;
}

// The Cin tile the f32 `occ_chunk_conv_fwd` takes at these shapes on the
// current device (64, 32 or 16), or -2 when none fits.
int occ_chunk_conv_fwd_cin_tile(int cin, int U, int K) {
  return cin_tile<float, 64>(cin, U, K);
}

// f32 on the tensor cores: out [C*M, cout] f32 = the chunk conv of feats
// [n_rows, cin] f32 with wt = `occ_chunk_conv_tf32_split_w`'s [2, K, cout,
// cin_p], in column tiles of nt (64, 96, 128) and `splits` ranges of
// (Cin tile, k) steps per block (part: f32 [splits, C*M, cout] scratch
// when splits > 1). Its blocks add their group-steps run and skipped into
// counts[4..6) and their cycles into counts[2..4), unless counts is null.
// Returns a cudaError_t, -2 when the block's shared memory does not fit,
// -3 for an unsupported nt, -4 when the tensor-map encoder is missing or
// refuses wt.
int occ_chunk_conv_fwd_tf32(const void* feats, int n_rows, int cin,
                            const void* in_idx, int C, int U,
                            const void* lidx, int K, int M, const void* wt,
                            int cout, int nt, int splits, void* part,
                            void* out, void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{feats, static_cast<const int32_t*>(in_idx),
                  static_cast<const int32_t*>(lidx), out,
                  static_cast<float*>(part),
                  static_cast<unsigned long long*>(counts), n_rows, cin, C,
                  U, K, M, cout, splits};
  switch (nt) {
    case 64: return launch_tc<64>(wt, a, s);
    case 96: return launch_tc<96>(wt, a, s);
    case 128: return launch_tc<128>(wt, a, s);
  }
  return -3;
}

// wt [2, K, cout, cin_p] (cin_p: cin rounded up to 32) from w [K, cin,
// cout], both f32 on the device, for `occ_chunk_conv_fwd_tf32`.
int occ_chunk_conv_tf32_split_w(const void* w, int K, int cin, int cout,
                                void* wt, void* stream) {
  const int cin_p = (cin + 31) / 32 * 32;
  const size_t n = static_cast<size_t>(K) * cout * cin_p;
  const size_t want = (n + 255) / 256;
  split_w_kernel<<<static_cast<int>(want < 4096 ? want : 4096), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), K, cin, cout, cin_p,
      static_cast<float*>(wt));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory a block of `occ_chunk_conv_fwd_tf32` asks for at
// these shapes (the wrapper's route rule computes the same), or -3.
long long occ_chunk_conv_fwd_tf32_smem(int U, int K, int nt) {
  switch (nt) {
    case 64: return FwdLayout<float, 32, 64, true>(U, K).total;
    case 96: return FwdLayout<float, 32, 96, true>(U, K).total;
    case 128: return FwdLayout<float, 32, 128, true>(U, K).total;
  }
  return -3;
}

}  // extern "C"
