// Device helpers shared by the convolution kernels (chunk_conv.cu, the
// forward; chunk_conv_bwd.cu, the backward; gather_conv.cu). Everything is
// in an anonymous namespace: each translation unit gets its own copy.
//
// A chunk is M <= 128 consecutive output rows. Its rulebook is in_idx[c, :U]
// (the sorted distinct input rows it references, -1 pad at the end) and
// lidx[c, k, m] (the position of row m's neighbour at offset k in that
// list, -1 missing). The kernels stage the chunk's referenced rows (one
// column tile of them) in shared memory, with one zero row at index U that
// every -1 points at, so missing neighbours contribute exact zeros without
// branches. Pad slots of in_idx are never referenced and are not staged.

#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 128;  // output rows per chunk (planner M <= 128)
constexpr int kBox = 128;   // bytes per row of a 128-byte-swizzled box

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(gmem_src));
}

// A copy of 16 bytes, of which only the first src_bytes are read:
// 0 fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst,
                                                 const void* gmem_src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread's copies are
// pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- mbarriers and bulk copies (the W ring of the forward kernel) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 2D tensor map (inner coordinate c0, row c1) into shared
// memory; completion is counted on `bar`'s transaction count, the full box
// always (elements past the tensor's edge are filled with zeros).
__device__ __forceinline__ void tma_load_2d(void* smem_dst, const void* tmap,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(smem_dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The same for a 3D tensor map (coordinates c0 innermost).
__device__ __forceinline__ void tma_load_3d(void* smem_dst, const void* tmap,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(smem_dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of 16-byte chunk `c16` of row `r` in a 128-byte-swizzled box
// (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ uint32_t swz(int r, int c16) {
  return r * kBox + ((c16 ^ (r & 7)) << 4);
}

// ---- 16x16 bf16 fragments from shared memory (the mma.sync A layout) ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---- warpgroup MMA (wgmma, sm_90a): A from registers, B in shared memory ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes (plain stores, completed
// cp.async) visible to the async proxy that wgmma reads through; a barrier
// then publishes them to the warpgroup.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous MMA owns (its accumulator, its A fragments) across it:
// they stay where they are until this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Descriptor of a bf16 B operand (16 rows of K, N columns) stored N-major
// as 128-byte-swizzled boxes of 64 columns (what TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups 1024 bytes apart (stride byte
// offset), boxes `box_bytes` apart (leading byte offset). `addr` is
// 1024-byte aligned.
__device__ __forceinline__ uint64_t wgmma_desc_b128(uint32_t addr,
                                                    uint32_t box_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(box_bytes >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                       << 62;
}

// d (64 x N, f32, the warpgroup's accumulator fragment) += a (64 x 16 bf16,
// this warp's 16 rows in the mma.sync A-fragment layout) @ B (16 x N,
// N-major in shared memory: the transposed-B form).
template <int N>
__device__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                           uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// ---- f32 on the tensor cores: the 3xTF32 split ----

// x = hi + lo. hi is x rounded to TF32's 11 significant bits by Veltkamp's
// split (c = x * (2^13 + 1), hi = c - (c - x); the _rn intrinsics keep the
// compiler from contracting it into an FMA, which would break it), and
// lo = x - hi, exact in f32, with the 13 low bits that TF32 drops cleared.
// So hi + lo is x to within 2^-23 of |x|, and a product a*b is
// a_hi*b_hi + a_hi*b_lo + a_lo*b_hi but for a_lo*b_lo and those
// cleared bits (~2^-22 of |a*b|). |x| must stay below ~2^114 (c finite).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.0f);
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h)) & 0xffffe000u;
}

// Descriptor of a K-major operand (one row of 128 bytes of K per N
// column) in 128-byte-swizzled atoms of 8 rows, 1024 bytes apart (what TMA
// writes for a box of 32 f32 columns with CU_TENSOR_MAP_SWIZZLE_128B);
// `addr` is the tile's 1024-byte aligned base plus 32 bytes per k8 step.
__device__ __forceinline__ uint64_t wgmma_desc_k128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                       << 62;
}

// d (64 x N, f32, the warpgroup's accumulator fragment) = a (64 x 8 tf32,
// this warp's 16 rows in the mma.sync m16n8k8 A-fragment layout) @ B (8 x
// N, K-major in shared memory) + (scale_d ? d : 0).
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                           uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ---- staging ----

// Stage the chunk's referenced rows in_s[0..U) (its in_idx row, already in
// shared memory; columns c0..c0+W of a [n_rows, ld] matrix) into dst at row
// stride ldd, with `nthreads` threads (thread index t). Pad slots are
// skipped; a row past n_rows or a column past `width` is zero. Starts
// cp.async; the caller waits.
template <typename T, int W>
__device__ void stage_rows(T* dst, int ldd, const T* __restrict__ src,
                           int n_rows, int ld, int width,
                           const int32_t* in_s, int U, int c0, int t,
                           int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = W / kVec;
  for (int i = t; i < U * kVpr; i += nthreads) {
    const int u = i / kVpr, v = i % kVpr;
    const int row = in_s[u];
    if (row < 0) continue;  // pad slot: never referenced
    T* d = dst + static_cast<size_t>(u) * ldd + v * kVec;
    const int col = c0 + v * kVec;
    if (row < n_rows && col < width)
      cp_async16(d, src + static_cast<size_t>(row) * ld + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// Zero `n` bytes at dst (16-byte aligned, n a multiple of 16).
__device__ __forceinline__ void zero_bytes(void* dst, int n, int t,
                                           int nthreads) {
  for (int i = t; i < n / 16; i += nthreads)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
}

// n ints from device to shared memory: 16-byte cp.async where both ends
// allow it (the caller waits), plain loads otherwise.
__device__ __forceinline__ void copy_ints(int32_t* dst,
                                          const int32_t* __restrict__ src,
                                          int n, int t, int nthreads) {
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = t; i < n / 4; i += nthreads) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = t; i < n; i += nthreads) dst[i] = src[i];
  }
}

// A staged lidx entry as a row of the staged rows: -1 (and anything out
// of range) is the zero row U.
__device__ __forceinline__ int row_of(int l, int U) {
  return static_cast<unsigned>(l) < static_cast<unsigned>(U) ? l : U;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor-map encoder cuTensorMapEncodeTiled, looked up once through
// the runtime (no link against libcuda); null where the driver lacks it.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

inline int max_dynamic_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

}  // namespace
