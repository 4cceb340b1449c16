// Device code shared by the SSD scan's tensor-core (bf16) kernels, the
// forward (ssd_scan.cu) and the backward (ssd_scan_bwd.cu): the chunk's
// cumsum, the swizzled bf16 tiles of a chunk's rows and their element
// reads, the chunk state product sum_j s_j x_j B_j^T on wgmma, and the
// float32 P x N state as bf16 hi + lo tiles. Tiles are TQ = 128 rows of a
// chunk (or 64 PP rows of P for a state) by 64-column panels, swizzled as
// in hopper_mma.cuh; a block is two warpgroups (TC_NT = 256 threads).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "hopper_mma.cuh"

namespace ssd {

constexpr int QMAX = 128;      // longest chunk
constexpr int TQ = 128;        // chunk rows of a tile
constexpr int TC_NT = 256;     // two warpgroups

// cs[i] = sum of dts[0..i] * a for i < Qc <= QMAX: the inclusive cumsum of
// one chunk, run by one warp (QMAX / 32 steps a lane, then a shuffle scan of
// the lanes' totals)
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* css,
                                             float a, int Qc, int lane) {
  constexpr int PER = QMAX / 32;
  float v[PER];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane * PER + k;
    run += i < Qc ? dts[i] * a : 0.f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane * PER + k;
    if (i < Qc) css[i] = v[k] + excl;
  }
}

// rows 0..nrows-1 (nrows <= TQ) of a strided bf16 matrix, element (r, col)
// at src[r * rs + col * cs], into the swizzled TQ x 64 `panels` tile at
// `dst`; rows past nrows and columns past ncols are zero. With `vec` the
// rows are contiguous (cs = 1), 16-byte aligned, ncols % 8 == 0, and the
// copies are cp.async ones (the caller waits: cp_async_wait_all); else
// each thread loads element by element.
__device__ __forceinline__ void load_rows(uint8_t* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          long long rs, long long cs, int nrows,
                                          int ncols, int panels, bool vec) {
  const int sh = panels == 2 ? 4 : 3;        // 16-byte chunks per row: 1 << sh
  const uint32_t dst_s = hopper::smem_u32(dst);
  for (int i = threadIdx.x; i < TQ << sh; i += TC_NT) {
    const int r = i >> sh, c = i & ((1 << sh) - 1);
    const bool ok = r < nrows && c * 8 < ncols;
    const __nv_bfloat16* row = src + (ok ? r * rs : 0);
    if (vec) {
      hopper::cp_async16(dst_s + hopper::swz<TQ>(r, c), row + (ok ? c * 8 : 0),
                         ok ? 16 : 0);
      continue;
    }
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c0 = c * 8 + 2 * e;
      const float lo = ok && c0 < ncols ? __bfloat162float(row[c0 * cs]) : 0.f;
      const float hi = ok && c0 + 1 < ncols ? __bfloat162float(row[(c0 + 1) * cs]) : 0.f;
      w[e] = hopper::pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(dst + hopper::swz<TQ>(r, c)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the element (r, col) of a swizzled bf16 tile of `rows` rows, and the
// pair (r, col), (r, col + 1) for an even col
template <int ROWS>
__device__ __forceinline__ float tile_at(const uint8_t* tile, int r, int col) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      tile + hopper::swz<ROWS>(r, col >> 3) + (col & 7) * 2));
}
template <int ROWS>
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int r, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + hopper::swz<ROWS>(r, col >> 3) + (col & 7) * 2));
}

// exp(x) as exp2 (the attention kernels' form, a few instructions)
__device__ __forceinline__ float exp_(float x) { return exp2f(x * hopper::kLog2e); }

// the chunk's dt (this thread's `dtv`, row threadIdx.x) into shared memory
// and its cumsum cs (one warp)
__device__ __forceinline__ void store_dt_cs(float dtv, float a_h, int Qc,
                                            float* dts, float* css) {
  if (threadIdx.x < TQ) dts[threadIdx.x] = dtv;
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, css, a_h, Qc, threadIdx.x);
}

// acc = one 64 x 64 tile (rows p = 64 pp.., columns n = 64 np..) of the
// P x N product sum_j s_j x_j B_j^T over the chunk's first 16 ksteps rows,
// issued by one warpgroup: A = (s o x)^T from registers as bf16 hi + lo
// fragments (x = hi + lo to about 2^-17, two products each) of the
// swizzled x tile `sX`, B MN-major from the swizzled B tile at `sBa`.
// Fragment rows p = 64 pp + 16 warp + gq (+8), columns j.
__device__ __forceinline__ void scaled_state_tile(float (&acc)[32],
                                                  const uint8_t* sX,
                                                  const float* s, uint32_t sBa,
                                                  int pp, int np, int ksteps) {
  using namespace hopper;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  uint32_t ahi[TQ / 16][4], alo[TQ / 16][4];
#pragma unroll
  for (int kk = 0; kk < TQ / 16; ++kk) {
    if (kk >= ksteps) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 64 * pp + 16 * warp + gq + 8 * (i & 1);
      const int j = 16 * kk + 8 * (i >> 1) + 2 * tq;
      const float v0 = s[j] * tile_at<TQ>(sX, j, p);
      const float v1 = s[j + 1] * tile_at<TQ>(sX, j + 1, p);
      const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
      ahi[kk][i] = *reinterpret_cast<const uint32_t*>(&hv);
      alo[kk][i] = pack_bf16(v0 - __low2float(hv), v1 - __high2float(hv));
    }
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TQ / 16; ++kk) {
    if (kk >= ksteps) break;
    const uint64_t db = kstep_mnmajor<TQ>(sBa + np * TQ * 128, kk);
    wgmma_rs_n64(acc, ahi[kk], db);
    wgmma_rs_n64(acc, alo[kk], db);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// a tile of scaled_state_tile into the float32 P x N matrix `out` (rows
// p < P, columns n < N): acc[4 jj + 2 hh + e] is p = 64 pp + 16 warp + gq
// + 8 hh, n = 64 np + 8 jj + 2 tq + e
__device__ __forceinline__ void store_state_tile(const float (&acc)[32],
                                                 float* out, int pp, int np,
                                                 int P, int N) {
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int p = 64 * pp + 16 * warp + gq + 8 * ((e >> 1) & 1);
    const int n = 64 * np + 8 * (e >> 2) + 2 * tq;
    if (p >= P || n >= N) continue;
    float* o = out + static_cast<size_t>(p) * N + n;
    if (N % 2 == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[e], acc[e + 1]);
    } else {
      o[0] = acc[e];
      if (n + 1 < N) o[1] = acc[e + 1];
    }
  }
}

// A float32 P x N state (`hs`, rows of N floats) as two swizzled bf16
// tiles of HR rows and NP panels, hi and lo (zero past P and N), in two
// steps so that the loads can go out before other copies: fetch_state
// reads the thread's 16-byte chunks of the tiles (8 floats each; its
// chunk i is row i >> 4 (NP = 2) or i >> 3 (NP = 1)), store_state_hilo
// writes their hi + lo parts.
template <int HR>
constexpr int kStateChunks = HR * 16 / TC_NT;   // a thread's, at NP = 2

template <int HR>
__device__ __forceinline__ void fetch_state(float (&v)[kStateChunks<HR>][8],
                                            const float* hs, int P, int N,
                                            int NP) {
  const int csh = NP == 2 ? 4 : 3, cpr = 1 << csh;   // chunks a row
#pragma unroll
  for (int it = 0; it < kStateChunks<HR>; ++it) {
    const int i = it * TC_NT + threadIdx.x;
    const int r = i >> csh, n0 = 8 * (i & (cpr - 1));
    const float* src = hs + static_cast<size_t>(r) * N + n0;
    if (i < HR * cpr && r < P && n0 + 8 <= N && N % 4 == 0) {
      const float4 u0 = *reinterpret_cast<const float4*>(src);
      const float4 u1 = *reinterpret_cast<const float4*>(src + 4);
      v[it][0] = u0.x; v[it][1] = u0.y; v[it][2] = u0.z; v[it][3] = u0.w;
      v[it][4] = u1.x; v[it][5] = u1.y; v[it][6] = u1.z; v[it][7] = u1.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[it][e] = i < HR * cpr && r < P && n0 + e < N ? src[e] : 0.f;
    }
  }
}

template <int HR>
__device__ __forceinline__ void store_state_hilo(
    const float (&v)[kStateChunks<HR>][8], uint8_t* hi_tile,
    uint8_t* lo_tile, int NP) {
  using namespace hopper;
  const int csh = NP == 2 ? 4 : 3, cpr = 1 << csh;
#pragma unroll
  for (int it = 0; it < kStateChunks<HR>; ++it) {
    const int i = it * TC_NT + threadIdx.x;
    if (i >= HR * cpr) continue;
    const int r = i >> csh, k = i & (cpr - 1);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v0 = v[it][2 * e], v1 = v[it][2 * e + 1];
      const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
      hi[e] = *reinterpret_cast<const uint32_t*>(&hv);
      lo[e] = pack_bf16(v0 - __low2float(hv), v1 - __high2float(hv));
    }
    const uint32_t off = swz<HR>(r, k);
    *reinterpret_cast<uint4*>(hi_tile + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(lo_tile + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

}  // namespace ssd
