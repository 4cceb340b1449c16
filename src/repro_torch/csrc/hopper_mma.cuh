// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_attention.cu, flash_attention_bwd.cu, ssd_scan.cu,
// ssd_scan_bwd.cu): cp.async copies into 128-byte-swizzled shared memory,
// the wgmma shared-memory descriptors for that layout, and the bf16 wgmma
// instructions the kernels issue. One warpgroup (128 threads) issues each
// wgmma.
//
// Tile layout. Every bf16 tile in shared memory is `rows` x D, row-major
// in global memory, kept as D / 64 panels of `rows` x 64 elements: panel p
// holds columns 64p..64p+63, one 128-byte line per row, and the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8) of its line (the 128-byte
// swizzle that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes). Panels start on
// 1024-byte boundaries. The same tile serves both ways:
//   * K-major operand (the product runs over D, e.g. Q K^T): descriptor
//     SBO = 1024 bytes (the next 8 rows), LBO unused (1); the k-step kk of
//     16 columns starts at panel kk / 4, byte 32 (kk % 4) of the line.
//   * MN-major operand (the product runs over the rows, e.g. P V): LBO =
//     the panel's bytes (the next 64 columns of N), SBO = 1024 bytes (the
//     next 8 rows of K); the k-step kk of 16 rows starts 2048 kk bytes in.
//     A may be read so too (wgmma_ss_n64<1, ..>, M = one panel): a tile
//     staged once serves a product K-major and its transpose MN-major.
//
// Register fragments (per warp w = 0..3 of the warpgroup, lane = 4 g + t):
// a 64 x N float32 accumulator d[N / 2] holds rows 16 w + g (+8) and
// columns 8 j + 2 t (+1): d[4 j + 2 h + e] is row 16 w + g + 8 h, column
// 8 j + 2 t + e. The A operand of an RS wgmma, a 64 x 16 bf16 tile, has
// the layout of 16 such columns, so the accumulator columns 16 kk..16 kk
// + 15 packed in pairs, a = {d[8kk..8kk+1], d[8kk+2..+3], d[8kk+4..+5],
// d[8kk+6..+7]}, feed the next product without passing through memory.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory rounded up to the 1024-byte boundary the swizzle
// needs (the launch asks for 1024 bytes more than the tiles take)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// 16-byte copy global -> shared; bytes < 16 zero-fills the rest (0: all)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// 4-byte copy global -> shared (for float rows whose start is not 16-byte
// aligned); bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy of this thread has landed, and the copies are visible to the
// async proxy that wgmma reads shared memory through (the caller then
// synchronises the block, so every thread's copies are)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of the 16-byte chunk c (columns 8c..8c+7) of row r in a
// swizzled ROWS x D tile
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// rows r0..r0+ROWS-1 of a bf16 matrix with row stride `ld` elements, D
// columns from `src`, into the swizzled tile at shared address `dst`;
// rows at or past `nrows` are zero-filled. All 128 threads take part.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int r0, int nrows, size_t ld) {
  constexpr int CPR = D / 8;                  // chunks per row
  static_assert(ROWS * CPR % 128 == 0, "whole rounds of 128 chunks");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / 128; ++it) {
    const int i = it * 128 + threadIdx.x % 128;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < nrows;
    const __nv_bfloat16* g = src + (ok ? static_cast<size_t>(r0 + r) * ld : 0) + c * 8;
    cp_async16(dst + swz<ROWS>(r, c), g, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint64_t desc_encode(uint32_t x) {
  return static_cast<uint64_t>((x & 0x3FFFF) >> 4);
}

// descriptor of a K-major operand whose 64-row group (8 rows of 128 bytes
// per 1024) starts at shared address `addr`
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_encode(addr) | (desc_encode(16) << 16) |
         (desc_encode(1024) << 32) | (1ull << 62);
}

// descriptor of an MN-major operand at `addr` whose panels of 64 columns
// lie `panel_bytes` apart
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t panel_bytes) {
  return desc_encode(addr) | (desc_encode(panel_bytes) << 16) |
         (desc_encode(1024) << 32) | (1ull << 62);
}

// K-major operand: the k-step kk (16 columns) of a swizzled ROWS x D tile
template <int ROWS>
__device__ __forceinline__ uint64_t kstep_kmajor(uint32_t tile, int kk) {
  return desc_kmajor(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32);
}

// MN-major operand: the k-step kk (16 rows) of a swizzled ROWS x D tile
template <int ROWS>
__device__ __forceinline__ uint64_t kstep_mnmajor(uint32_t tile, int kk) {
  return desc_mnmajor(tile + kk * 2048, ROWS * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (place after the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of k-step kk (accumulator columns 16 kk..16 kk + 15)
template <int N>
__device__ __forceinline__ void a_frag(const float (&d)[N], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// the same fragment split into bf16 hi + lo parts: x = hi + lo to about
// 2^-17 relative, so two bf16 products carry x at nearly float32 precision
template <int N>
__device__ __forceinline__ void a_frag_hilo(const float (&d)[N], int kk,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = d[8 * kk + 2 * i], x1 = d[8 * kk + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory,
// K-major by default; TA = 1 reads A MN-major (a tile stored K rows by M
// columns, i.e. the transpose of what it holds), TB = 1 reads B MN-major.
// scale_d 0 overwrites D.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], both from shared memory, K-major:
// a product against a 32-row tile (the accumulator d[4 j + 2 h + e], j < 4)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x N] (+)= A B^T with both operands K-major, N = 64 or 32 (the rows
// of B's tile)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 32, "wgmma_ss: N = 64 or 32");
    wgmma_ss_n32(d, desc_a, desc_b, scale_d);
  }
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the accumulator
// layout of a 64 x 16 tile, packed to bf16 pairs), B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the accumulator
// layout of a 64 x 16 tile, packed to bf16 pairs), B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 192] += A[64 x 16] B[16 x 192], A from registers (the accumulator
// layout of a 64 x 16 tile, packed to bf16 pairs), B from shared memory
// MN-major (transposed): three panels of 64 columns, the descriptor's LBO
// apart, as n128 reads two.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x D] += A B with B MN-major: the products that end in a head dim
// (D = 64, 128 or 192)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    static_assert(D == 192, "wgmma_rs: D = 64, 128 or 192");
    wgmma_rs_n192(d, a, desc_b);
  }
}

}  // namespace hopper
