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
// 64 chunks (8192 rows) before the ordered sum. f32 (training CLI,
// parity): the same blocks with exact FMA products, each thread an
// 8 x (CT/8) register tile, rows with no valid reference skipped.
//
// What bounds it: latency per chunk. A block stages a chunk, waits, and
// then runs ~4 MFLOP; only the other resident block overlaps that. On the
// H100, per bench step (dWt at the 29 fused shapes): mma.sync in place of
// wgmma measured 9.9 ms against 9.0; 8 offsets per block (16 warps, half
// the restaging) measured 10.3-10.8 ms against 9.8-10.0 at 4 offsets (one
// block per SM fitted). The dW route's first kernel (one block per 64x64
// tile and ONE offset, M gathered rows and M ct rows read per chunk
// straight into WMMA tiles, nothing overlapped) read the ct tile again
// for every offset: 27x the ct traffic, 2.20 ms per bench step for its
// four convolutions.

#include <type_traits>

#include "chunk_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kOffsets = 4;    // offsets per block
constexpr int kRows = 64;      // D columns per block

struct DwArgs {
  const void* x;          // gathered operand [n_x, cx]
  const int32_t* in_idx;  // [C, U]
  const int32_t* lidx;    // [C, K, M]
  const void* d;          // dense operand [C*M, cd]
  float* out;  // the result (runs == 1) or the runs' partials
  int n_x, cx, C, U, K, M, cd, runs;
};

// Shared memory plan, from a 1024-byte aligned base: the D tile first
// (bf16: kMaxM rows of 64 columns, 128 bytes each, in the 128-byte swizzle
// that wgmma reads through a descriptor; f32: rows padded against bank
// conflicts), two buffers of the chunk's lidx rows and in_idx row (the
// next chunk's are loaded while this one computes), then one set of staged
// X rows.
template <typename T, int CT>
struct DwLayout {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr bool kSwizzled = sizeof(T) == 2;
  static constexpr int kLdf = kRows + kVec;  // f32 D tile stride
  // staged X row stride: bf16 rows are read by ldmatrix at 8 different
  // rows per instruction and are padded against bank conflicts; a warp of
  // the f32 tile reads one row, 128 contiguous bytes, and needs no padding
  // (which lets tier 1.7's U=1312 fit at CT=32)
  static constexpr int kLdg = CT + (kSwizzled ? kVec : 0);
  static constexpr size_t kLidx = static_cast<size_t>(kOffsets) * kMaxM;
  size_t lidx_off, in_off, g_off, total;
  __host__ __device__ DwLayout(int U) {
    size_t off = align128(static_cast<size_t>(kMaxM) *
                          (kSwizzled ? 128 : kLdf * sizeof(T)));
    lidx_off = off;
    off += align128(2 * kLidx * sizeof(int32_t));
    in_off = off;
    off += 2 * align128(static_cast<size_t>(U) * sizeof(int32_t));
    g_off = off;
    off += align128(static_cast<size_t>(U + 1) * kLdg * sizeof(T));
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

template <typename T, int CT, bool kRowsGathered>
using DwTileOf =
    typename std::conditional<sizeof(T) == 2, DwWgTile<CT, kRowsGathered>,
                              DwFmaTile<CT, kRowsGathered>>::type;

// blockIdx: x = (64-column D tile, CT-column X tile), y = group of 4
// offsets, z = run of consecutive chunks.
template <typename T, int CT, bool kRowsGathered>
__global__ void __launch_bounds__(kThreads, 2)
dw_kernel(const DwArgs a) {
  using L = DwLayout<T, CT>;
  constexpr int kVec = L::kVec;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const L lay(a.U);
  T* f_s = reinterpret_cast<T*>(smem);
  int32_t* lidx_b = reinterpret_cast<int32_t*>(smem + lay.lidx_off);
  int32_t* in_b = reinterpret_cast<int32_t*>(smem + lay.in_off);
  T* g_s = reinterpret_cast<T*>(smem + lay.g_off);

  const int U = a.U, K = a.K, M = a.M;
  const int tiles_x = (a.cx + CT - 1) / CT;
  const int d0 = (blockIdx.x / tiles_x) * kRows;
  const int x0 = (blockIdx.x % tiles_x) * CT;
  const int ncols = min(CT, a.cx - x0);
  const int k0 = blockIdx.y * kOffsets, run = blockIdx.z;
  const int nk = min(kOffsets, K - k0);
  const int c_begin =
      static_cast<int>(static_cast<long long>(a.C) * run / a.runs);
  const int c_end =
      static_cast<int>(static_cast<long long>(a.C) * (run + 1) / a.runs);
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
  if (c_begin < c_end) load_meta(c_begin, 0);
  for (int c = c_begin; c < c_end; ++c) {
    const int b = (c - c_begin) & 1;
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
    if (c + 1 < c_end) load_meta(c + 1, b ^ 1);
    // this chunk's rows are in (the next chunk's meta may still fly)
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::);
    if (!live) continue;
    if constexpr (L::kSwizzled) fence_proxy_async();  // wgmma reads f_s
    __syncthreads();
    tile.chunk(f_s, g_s, lidx_b + b * L::kLidx, M, U, nk);
  }
  cp_async_wait_all();
  float* dst = a.out + (static_cast<size_t>(run) * K + k0) * a.cx * a.cd;
  tile.store(dst, a.cx, a.cd, d0, x0, nk, ncols);
}

template <typename T, int CT, bool kRowsGathered>
int launch_dw(const DwArgs& a, cudaStream_t stream) {
  const DwLayout<T, CT> lay(a.U);
  const int smem = static_cast<int>(lay.total);
  auto kernel = dw_kernel<T, CT, kRowsGathered>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((a.cd + kRows - 1) / kRows) * ((a.cx + CT - 1) / CT),
                  (a.K + kOffsets - 1) / kOffsets, a.runs);
  kernel<<<grid, kThreads, smem, stream>>>(a);
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

// bf16 takes 64 X columns (wgmma's 64 rows). f32 takes the widest tile
// with which two blocks share an SM (at U=384, 64 columns of staged f32
// rows leave room for one), else the widest that fits. Then, with
// runs > 1, the ordered sum of the runs' partials into `out`. Returns a
// cudaError_t, or -2 when no X tile fits in shared memory.
template <typename T, bool kRowsGathered>
int run_dw(const DwArgs& a, float* out, cudaStream_t s) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  const size_t s64 = DwLayout<T, 64>(a.U).total;
  int rc = -2;
  if constexpr (sizeof(T) == 4) {
    const size_t s32 = DwLayout<T, 32>(a.U).total;
    if (s64 > kTwoPerSm && s32 <= kTwoPerSm)
      rc = launch_dw<T, 32, kRowsGathered>(a, s);
    else if (s64 <= limit)
      rc = launch_dw<T, 64, kRowsGathered>(a, s);
    else if (s32 <= limit)
      rc = launch_dw<T, 32, kRowsGathered>(a, s);
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
// whose runs are then summed in order. Returns a cudaError_t, or -2 when
// no Ct tile fits in shared memory.
int occ_chunk_conv_dwt(const void* ct, int n_ct, int Ct, const void* t_in_idx,
                       int C, int U, const void* t_lidx, int K, int M,
                       const void* feats, int cin, int runs, void* partial,
                       void* dwt, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dwt);
  const DwArgs a{ct, static_cast<const int32_t*>(t_in_idx),
                 static_cast<const int32_t*>(t_lidx), feats,
                 runs > 1 ? static_cast<float*>(partial) : out, n_ct, Ct, C,
                 U, K, M, cin, runs};
  return is_bf16 ? run_dw<bf16, false>(a, out, s)
                 : run_dw<float, false>(a, out, s);
}

// dw [K, cin, cout] f32 = sum over the chunks of the forward plan of
// G_k^T @ ct_c (see the header), in `runs` runs of consecutive chunks;
// with runs > 1, partial is caller-owned f32 scratch [runs, K, cin, cout]
// whose runs are then summed in order. Returns a cudaError_t, or -2 when
// no Cin tile fits in shared memory.
int occ_chunk_conv_dw(const void* feats, int n_rows, int cin,
                      const void* in_idx, int C, int U, const void* lidx,
                      int K, int M, const void* ct, int cout, int runs,
                      void* partial, void* dw, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  const DwArgs a{feats, static_cast<const int32_t*>(in_idx),
                 static_cast<const int32_t*>(lidx), ct,
                 runs > 1 ? static_cast<float*>(partial) : out, n_rows, cin,
                 C, U, K, M, cout, runs};
  return is_bf16 ? run_dw<bf16, true>(a, out, s)
                 : run_dw<float, true>(a, out, s);
}

}  // extern "C"
