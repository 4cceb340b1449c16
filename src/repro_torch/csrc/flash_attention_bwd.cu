// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of causal
// self-attention, the port's training kernels.
//
// No Pallas counterpart: the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention_pallas
// is forward-only, and the JAX model trains by autodiff through
// flash_attention_triangular. This computes that gradient from the forward's
// saved logsumexp (flash_attention.cu writes lse = m + log l per row):
//   P  = exp(S - lse),  S = scale * Q K^T, masked entries P = 0
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(P o dP)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// delta is rowsum(dO o O) in exact arithmetic; taking it from P and dP in
// float32 instead of from the bf16-rounded O keeps the gradient that of the
// float32 softmax (from the bf16 O it was 1.6e-2 off at the training
// shape). The backward needs no O.
//
// Scope: what the training path gives it. Sq == Sk, q_offset 0, causal, an
// optional sliding window, GQA (q head h reads kv head h / (H / KV)), head
// dims 64 and 128. No row of that mask is fully masked (the diagonal is
// always kept), so P never needs the forward's all-masked rule.
//
// The FlashAttention-2 split into two kernels, so neither needs atomics
// (float32 atomics would make dq differ from run to run), each launched by
// its own entry point (the caller counts each), dq first:
//   * the dq kernel: one block per (64-row q tile, q head, batch), walking
//     the kv tiles of the band (the forward's tile skipping); it writes
//     each row's delta for the second kernel;
//   * the dk/dv kernel: one block per (64-key tile, kv head, batch); K and
//     V of the tile stay in shared memory; the block walks the G q heads of
//     its kv head and, for each, the 64-row q tiles that meet the
//     causal/window band of its keys, accumulating dK and dV in registers.
// Two versions of each, chosen by the input dtype (the wrapper states it):
// bf16 on the tensor cores (flash_bwd_dq_wgmma_kernel,
// flash_bwd_dkdv_wgmma_kernel), float32 on CUDA cores (flash_bwd_dq_kernel,
// flash_bwd_dkdv_kernel). wgmma has no float32 input, and its TF32 mode
// keeps about three decimal digits, which would break the float32 checks
// at 1e-4 that the port holds its kernels to.
//
// Bound. At the training shape (q (2, 2048, 16, 128), kv (2, 2048, 8,
// 128)) the backward does 5 products of 2 D flops per unmasked (q, k) pair
// (S, dP, dV, dQ, dK): 86 GFLOP, 0.087 ms at the 989 TFLOP/s bf16 peak,
// against 0.025 ms for its 84 MB of inputs and gradients at 3.35 TB/s:
// bound by operations.
//
// The tensor-core kernels (bf16). One warpgroup (128 threads) a block; the
// block's own 64-row tile is wgmma's M. Tiles of 64 rows sit in shared
// memory in bf16 with the 128-byte swizzle (hopper_mma.cuh), filled by
// 16-byte cp.async copies; the walked tiles go through a ring of two
// stages, the next one loading while the current one is computed. Two
// blocks share an SM (about 100 KB of shared memory each).
//   * dq kernel (Q, dO stay; K, V walk). delta must be complete before any
//     dS is formed, and on tensor cores the one-sweep form dQ = scale (sum
//     P dP K - delta sum P K) of the float32 kernel costs a fourth product
//     and a second 64 x D accumulator. This kernel pays a second sweep
//     instead: sweep 1 computes S = Q K^T and dP = dO V^T (SS wgmma, both
//     K-major) and sums delta = rowsum(P o dP) in float32; sweep 2
//     recomputes S and dP, forms dS = P o (dP - delta) in float32, and
//     dQ += dS K takes dS from registers as bf16 with K MN-major (5
//     products a tile over the two sweeps, one 64 x D accumulator).
//   * dk/dv kernel (K, V stay; Q, dO, lse, delta walk; lse and delta by
//     4-byte cp.async, since a row of S floats need not start on 16
//     bytes). S^T = K Q^T and dP^T = V dO^T are SS wgmmas with K-major
//     operands, so P^T and dS^T come out in the accumulator layout of
//     rows = keys and are the register A operands of dV += P^T dO and
//     dK += dS^T Q, with Q and dO MN-major (the transpose bit). The
//     64 x 128 dK and dV accumulators (128 registers a thread at D = 128)
//     and the two 64 x 64 score fragments fit in the 255 registers of one
//     thread at a 64-row q tile (ptxas: 255, no spill; the dq kernel 167).
// Rounding. The products take P and dS in bf16 where the float32 version
// keeps them in float32. Emulated on the CPU at a qwen3 layer
// (tests/test_torch_kernels.py), bf16 P in dV and bf16 dS in dK put the
// worst element of dk and dv at 1.0-1.1x of the 5e-3 + 1e-2 |ref| limit
// that chip_smoke.py holds them to, and dq at 0.5x. So the dk/dv kernel
// splits P and dS into bf16 hi + lo parts (x = hi + lo to 2^-17) and runs
// dV and dK as two products each (6 products a tile instead of 4); dq keeps
// a single bf16 dS.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs. 256 threads as 16 x 16; for a 64 x 64 score
// tile thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4);
// every tile sits in shared memory row-major with rows padded by 4 floats,
// so the products over the head dim read float4s without bank conflicts.
// S, P, dP and dS are float32. The dq kernel accumulates, in one sweep,
// A = sum_j P dP k_j, B = sum_j P k_j and delta = sum_j P dP in registers,
// so dQ = scale * (A - delta B).
// ---------------------------------------------------------------------------

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 256;     // threads per block (16 x 16)
constexpr int PAD = 4;      // row padding of the [row][d] tiles (floats)
constexpr int PPAD = 16;    // row padding of the [q][k] tiles: rows 16 banks apart


__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [r0, r0 + R) of one head of a (B, S, NH, D) tensor into dst[R][D + PAD]
// as float32, zeros past S
template <int D, int R>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                          int b, int r0, int S, int NH, int head) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D, row = r0 + r;
    float x = 0.f;
    if (row < S) x = src[((static_cast<size_t>(b) * S + row) * NH + head) * D + d];
    dst[r * (D + PAD) + d] = x;
  }
}

// S (scaled) and dP of one 64 x 64 tile for the thread's 4 x 4 entries:
// rows ty + 16 i of A1/A2, columns tx + 16 j of B1/B2 (all [row][D + PAD])
template <int D>
__device__ __forceinline__ void two_products(const float* A1, const float* B1,
                                             const float* A2, const float* B2,
                                             float (&s)[4][4], float (&dp)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A1[(ty + 16 * i) * (D + PAD) + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(&B1[(tx + 16 * j) * (D + PAD) + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A2[(ty + 16 * i) * (D + PAD) + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(&B2[(tx + 16 * j) * (D + PAD) + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], c[j], dp[i][j]);
  }
}

__device__ __forceinline__ bool in_band(int qi, int kj, int S, int window) {
  return qi < S && kj < S && kj <= qi && (window <= 0 || kj > qi - window);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    int S, int H, int KV, int window, float sm_scale) {
  constexpr int C = D / 16;                 // head-dim columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                         // [BK][D + PAD]
  float* Vs = Ks + BK * (D + PAD);          // [BK][D + PAD]
  float* Qs = Vs + BK * (D + PAD);          // [BQ][D + PAD]
  float* dOs = Qs + BQ * (D + PAD);         // [BQ][D + PAD]
  float* Ps = dOs + BQ * (D + PAD);         // [BQ][BK + PPAD]
  float* dSs = Ps + BQ * (BK + PPAD);       // [BQ][BK + PPAD]
  float* lse_s = dSs + BQ * (BK + PPAD);    // [BQ]
  float* delta_s = lse_s + BQ;              // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  load_tile_f32<D, BK>(Ks, k, b, k0, S, KV, kvh);
  load_tile_f32<D, BK>(Vs, v, b, k0, S, KV, kvh);

  // q tiles that meet the band of keys [k0, k_last]: q >= k, q < k + window
  const int k_last = min(k0 + BK, S) - 1;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int qt_begin = k0 / BQ, qt_end = (q_end + BQ - 1) / BQ;

  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();    // K/V stored / the previous tile's reads done
      load_tile_f32<D, BQ>(Qs, q, b, q0, S, H, h);
      load_tile_f32<D, BQ>(dOs, dout, b, q0, S, H, h);
      if (tid < BQ) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse_h[q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = in_band(q0 + r, k0 + c, S, window)
                              ? expf(s[i][j] * sm_scale - lse_s[r]) : 0.f;
          Ps[r * (BK + PPAD) + c] = p;
          dSs[r * (BK + PPAD) + c] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: key rows ty + 16 i, head-dim columns
      // 64 cc + 4 tx + e
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[r * (BK + PPAD) + ty + 16 * i];
          ds[i] = dSs[r * (BK + PPAD) + ty + 16 * i];
        }
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc) {
          const float4 o4 = *reinterpret_cast<const float4*>(&dOs[r * (D + PAD) + cc * 64 + tx * 4]);
          const float4 q4 = *reinterpret_cast<const float4*>(&Qs[r * (D + PAD) + cc * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][cc * 4 + 0] = fmaf(p[i], o4.x, dv_acc[i][cc * 4 + 0]);
            dv_acc[i][cc * 4 + 1] = fmaf(p[i], o4.y, dv_acc[i][cc * 4 + 1]);
            dv_acc[i][cc * 4 + 2] = fmaf(p[i], o4.z, dv_acc[i][cc * 4 + 2]);
            dv_acc[i][cc * 4 + 3] = fmaf(p[i], o4.w, dv_acc[i][cc * 4 + 3]);
            dk_acc[i][cc * 4 + 0] = fmaf(ds[i], q4.x, dk_acc[i][cc * 4 + 0]);
            dk_acc[i][cc * 4 + 1] = fmaf(ds[i], q4.y, dk_acc[i][cc * 4 + 1]);
            dk_acc[i][cc * 4 + 2] = fmaf(ds[i], q4.z, dk_acc[i][cc * 4 + 2]);
            dk_acc[i][cc * 4 + 3] = fmaf(ds[i], q4.w, dk_acc[i][cc * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    const size_t row = ((static_cast<size_t>(b) * S + kj) * KV + kvh) * D;
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = cc * 64 + tx * 4 + e;
        dk[row + d] = dk_acc[i][cc * 4 + e] * sm_scale;
        dv[row + d] = dv_acc[i][cc * 4 + e];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ dq, int S, int H, int KV,
    int window, float sm_scale) {
  constexpr int C = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [BQ][D + PAD]
  float* dOs = Qs + BQ * (D + PAD);         // [BQ][D + PAD]
  float* Ks = dOs + BQ * (D + PAD);         // [BK][D + PAD]
  float* Vs = Ks + BK * (D + PAD);          // [BK][D + PAD]
  float* Ps = Vs + BK * (D + PAD);          // [BQ][BK + PPAD]
  float* PdPs = Ps + BQ * (BK + PPAD);      // [BQ][BK + PPAD]
  float* lse_s = PdPs + BQ * (BK + PPAD);   // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S + q0;
  load_tile_f32<D, BQ>(Qs, q, b, q0, S, H, h);
  load_tile_f32<D, BQ>(dOs, dout, b, q0, S, H, h);
  if (tid < BQ) lse_s[tid] = q0 + tid < S ? lse[row0 + tid] : 0.f;

  // kv tiles that meet the band of this q tile (the forward's skipping)
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / BK, kt_end = (q_last + 1 + BK - 1) / BK;

  // dQ = scale * (A - delta B) with A = sum_j P dP k_j, B = sum_j P k_j and
  // delta = sum_j P dP, all accumulated in the one sweep over the band
  float a_acc[4][C], b_acc[4][C], dsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) a_acc[i][c] = b_acc[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();    // Q/dO stored / the previous tile's reads done
    load_tile_f32<D, BK>(Ks, k, b, k0, S, KV, kvh);
    load_tile_f32<D, BK>(Vs, v, b, k0, S, KV, kvh);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = in_band(q0 + r, k0 + c, S, window)
                            ? expf(s[i][j] * sm_scale - lse_s[r]) : 0.f;
        Ps[r * (BK + PPAD) + c] = p;
        PdPs[r * (BK + PPAD) + c] = p * dp[i][j];
        dsum[i] += p * dp[i][j];
      }
    }
    __syncthreads();

    // q rows ty + 16 i, head-dim columns 64 cc + 4 tx + e
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], pdp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty + 16 * i) * (BK + PPAD) + c];
        pdp[i] = PdPs[(ty + 16 * i) * (BK + PPAD) + c];
      }
#pragma unroll
      for (int cc = 0; cc < D / 64; ++cc) {
        const float4 k4 = *reinterpret_cast<const float4*>(&Ks[c * (D + PAD) + cc * 64 + tx * 4]);
        const float kv4[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a_acc[i][cc * 4 + e] = fmaf(pdp[i], kv4[e], a_acc[i][cc * 4 + e]);
            b_acc[i][cc * 4 + e] = fmaf(pv[i], kv4[e], b_acc[i][cc * 4 + e]);
          }
      }
    }
  }

  // each row's delta: the 16 lanes of the half-warp hold its column sums
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= S) continue;
    if (tx == 0) delta[row0 + r] = dsum[i];
    const size_t row = ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dq[row + cc * 64 + tx * 4 + e] =
            (a_acc[i][cc * 4 + e] - dsum[i] * b_acc[i][cc * 4 + e]) * sm_scale;
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (see the header).
// ---------------------------------------------------------------------------
constexpr int TC = 64;              // rows of every tile
constexpr int TC_THREADS = 128;     // one warpgroup

template <int D>
constexpr int dq_smem_bytes() { return 6 * TC * D * 2 + TC * 4 + 1024; }
template <int D>
constexpr int dkdv_smem_bytes() { return 6 * TC * D * 2 + 4 * TC * 4 + 1024; }

// S (scaled 1 / sm_scale) and dP of one 64 x 64 tile: A1 B1^T and A2 B2^T,
// all four operands swizzled 64 x D tiles, K-major
template <int D>
__device__ __forceinline__ void two_products_tc(uint32_t a1, uint32_t b1,
                                                uint32_t a2, uint32_t b2,
                                                float (&s)[32], float (&dp)[32]) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, kstep_kmajor<TC>(a1, kk), kstep_kmajor<TC>(b1, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(dp, kstep_kmajor<TC>(a2, kk), kstep_kmajor<TC>(b2, kk), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int S, int H, int KV, int window,
    float sm_scale) {
  using namespace hopper;
  constexpr uint32_t TILE = TC * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sQ = smem_u32(smem), sdO = sQ + TILE;   // stage s: K, V at TILE (2 + 2s), (3 + 2s)
  float* lse_s = reinterpret_cast<float*>(smem + 6 * TILE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r_lo = 16 * warp + g;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t ldq = static_cast<size_t>(H) * D, ldk = static_cast<size_t>(KV) * D;
  const size_t qoff = static_cast<size_t>(b) * S * ldq + static_cast<size_t>(h) * D;
  const size_t koff = static_cast<size_t>(b) * S * ldk + static_cast<size_t>(kvh) * D;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S + q0;

  hopper::load_tile<D, TC>(sQ, q + qoff, q0, S, ldq);
  hopper::load_tile<D, TC>(sdO, dout + qoff, q0, S, ldq);
  if (tid < TC) lse_s[tid] = q0 + tid < S ? lse[row0 + tid] : 0.f;

  // kv tiles that meet the band of this q tile (the forward's skipping)
  const int q_last = min(q0 + TC, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / TC, n = (q_last + TC) / TC - kt_begin;
  hopper::load_tile<D, TC>(sQ + 2 * TILE, k + koff, kt_begin * TC, S, ldk);
  hopper::load_tile<D, TC>(sQ + 3 * TILE, v + koff, kt_begin * TC, S, ldk);
  cp_async_commit();

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  float dl[2] = {0.f, 0.f};           // sweep 1: delta's lane parts; then delta

  for (int i = 0; i < 2 * n; ++i) {
    const bool sweep2 = i >= n;
    const int k0 = (kt_begin + (sweep2 ? i - n : i)) * TC, st = i & 1;
    cp_async_wait_all();
    __syncthreads();    // tile i landed; every warp is done with tile i - 1
    if (i + 1 < 2 * n) {
      const int nk = (kt_begin + (i + 1) % n) * TC;
      hopper::load_tile<D, TC>(sQ + TILE * (2 + 2 * (st ^ 1)), k + koff, nk, S, ldk);
      hopper::load_tile<D, TC>(sQ + TILE * (3 + 2 * (st ^ 1)), v + koff, nk, S, ldk);
    }
    cp_async_commit();
    const uint32_t sK = sQ + TILE * (2 + 2 * st), sV = sK + TILE;

    float s[32], dp[32];
    two_products_tc<D>(sQ, sK, sdO, sV, s, dp);
    const bool edge = k0 + TC - 1 > q0 || k0 + TC > S || q0 + TC > S ||
                      (window > 0 && k0 <= q0 + TC - 1 - window);
    const float lr[2] = {lse_s[r_lo], lse_s[r_lo + 8]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      const int qi = q0 + r_lo + 8 * hh, kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      s[e] = (!edge || in_band(qi, kj, S, window))
                 ? exp2f((s[e] * sm_scale - lr[hh]) * kLog2e) : 0.f;
    }
    if (!sweep2) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dl[(e >> 1) & 1] += s[e] * dp[e];
      if (i == n - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          dl[hh] += __shfl_xor_sync(0xffffffffu, dl[hh], 1);
          dl[hh] += __shfl_xor_sync(0xffffffffu, dl[hh], 2);
          if (t == 0 && q0 + r_lo + 8 * hh < S) delta[row0 + r_lo + 8 * hh] = dl[hh];
        }
      }
      continue;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]);
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(dp, kk, da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dqa, da[kk], kstep_mnmajor<TC>(sK, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqa);
  }
  cp_async_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + r_lo + 8 * hh;
    if (qi >= S) continue;
    __nv_bfloat16* row = dq + qoff + static_cast<size_t>(qi) * ldq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * hh] * sm_scale,
                                dqa[4 * j + 2 * hh + 1] * sm_scale);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dkdv_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
    int H, int KV, int window, float sm_scale) {
  using namespace hopper;
  constexpr uint32_t TILE = TC * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + TILE;    // stage s: Q, dO at TILE (2 + 2s), (3 + 2s)
  const uint32_t sL = sK + 6 * TILE;                     // lse [2][64], then delta [2][64]
  const float* lse_s = reinterpret_cast<const float*>(smem + 6 * TILE);
  const float* delta_s = lse_s + 2 * TC;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r_lo = 16 * warp + g;
  const int k0 = blockIdx.x * TC, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t ldq = static_cast<size_t>(H) * D, ldk = static_cast<size_t>(KV) * D;
  const size_t koff = static_cast<size_t>(b) * S * ldk + static_cast<size_t>(kvh) * D;
  hopper::load_tile<D, TC>(sK, k + koff, k0, S, ldk);
  hopper::load_tile<D, TC>(sV, v + koff, k0, S, ldk);

  // q tiles that meet the band of keys [k0, k_last]: q >= k, q < k + window
  const int k_last = min(k0 + TC, S) - 1;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int qt_begin = k0 / TC, nq = (q_end + TC - 1) / TC - qt_begin;
  const int total = G * nq;

  // the i-th (head, q tile) of the walk into stage st
  auto load_q = [&](int i, int st) {
    const int h = kvh * G + i / nq, q0 = (qt_begin + i % nq) * TC;
    const size_t qoff = static_cast<size_t>(b) * S * ldq + static_cast<size_t>(h) * D;
    hopper::load_tile<D, TC>(sK + TILE * (2 + 2 * st), q + qoff, q0, S, ldq);
    hopper::load_tile<D, TC>(sK + TILE * (3 + 2 * st), dout + qoff, q0, S, ldq);
    const int r = tid % TC, row = q0 + r;
    const float* src = (tid < TC ? lse : delta) + (static_cast<size_t>(b) * H + h) * S;
    const bool ok = row < S;
    cp_async4(sL + 4 * ((tid < TC ? 0 : 2 * TC) + st * TC + r), ok ? src + row : src,
              ok ? 4 : 0);
  };
  load_q(0, 0);
  cp_async_commit();

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int i = 0; i < total; ++i) {
    const int st = i & 1, q0 = (qt_begin + i % nq) * TC;
    cp_async_wait_all();
    __syncthreads();    // tile i landed; every warp is done with tile i - 1
    if (i + 1 < total) load_q(i + 1, st ^ 1);
    cp_async_commit();
    const uint32_t sQ = sK + TILE * (2 + 2 * st), sdO = sQ + TILE;

    // S^T and dP^T: rows are this block's keys, columns the tile's queries
    float s[32], dp[32];
    two_products_tc<D>(sK, sQ, sV, sdO, s, dp);
    const bool edge = q0 < k0 + TC - 1 || q0 + TC > S || k0 + TC > S ||
                      (window > 0 && q0 + TC - 1 - k0 >= window);
    const float* ls = lse_s + st * TC;
    const float* ds = delta_s + st * TC;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int kj = k0 + r_lo + 8 * ((e >> 1) & 1);
      const int c = 8 * (e >> 2) + 2 * t + (e & 1);
      const float p = (!edge || in_band(q0 + c, kj, S, window))
                          ? exp2f((s[e] * sm_scale - ls[c]) * kLog2e) : 0.f;
      s[e] = p;
      dp[e] = p * (dp[e] - ds[c]);
    }
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_frag_hilo(s, kk, ph[kk], pl[kk]);
      a_frag_hilo(dp, kk, dh[kk], dl[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bdo = kstep_mnmajor<TC>(sdO, kk), bq = kstep_mnmajor<TC>(sQ, kk);
      wgmma_rs<D>(dva, ph[kk], bdo);
      wgmma_rs<D>(dva, pl[kk], bdo);
      wgmma_rs<D>(dka, dh[kk], bq);
      wgmma_rs<D>(dka, dl[kk], bq);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dka);
    fence_regs(dva);
  }
  cp_async_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = k0 + r_lo + 8 * hh;
    if (kj >= S) continue;
    const size_t row = koff + static_cast<size_t>(kj) * ldk;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dka[4 * j + 2 * hh] * sm_scale,
                                dka[4 * j + 2 * hh + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
    }
  }
}

// Sets each kernel's shared-memory attribute once per launcher instance
// (thread-safe static initialisation), then launches the one kernel asked
// for.
template <int D>
int launch_f32(bool dq_part, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int S, int H, int KV, int window,
               float sm_scale, cudaStream_t stream) {
  constexpr int tiles = static_cast<int>(sizeof(float)) *
                        (4 * BQ * (D + PAD) + 2 * BQ * (BK + PPAD));
  constexpr int smem_dq = tiles + static_cast<int>(sizeof(float)) * BQ;
  constexpr int smem_dkdv = tiles + static_cast<int>(sizeof(float)) * 2 * BQ;
  auto kdq = flash_bwd_dq_kernel<D>;
  auto kdkdv = flash_bwd_dkdv_kernel<D>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  if (dq_part)
    kdq<<<dim3((S + BQ - 1) / BQ, H, B), NT, smem_dq, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), S, H, KV,
        window, sm_scale);
  else
    kdkdv<<<dim3((S + BK - 1) / BK, KV, B), NT, smem_dkdv, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), S, H, KV, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(bool dq_part, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int S, int H, int KV, int window,
                 float sm_scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kdq = flash_bwd_dq_wgmma_kernel<D>;
  auto kdkdv = flash_bwd_dkdv_wgmma_kernel<D>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes<D>());
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem_bytes<D>());
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  if (dq_part)
    kdq<<<dim3((S + TC - 1) / TC, H, B), TC_THREADS, dq_smem_bytes<D>(), stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), S, H, KV, window,
        sm_scale);
  else
    kdkdv<<<dim3((S + TC - 1) / TC, KV, B), TC_THREADS, dkdv_smem_bytes<D>(), stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, H, KV, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int entry(bool dq_part, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, void* delta, void* dq, void* dk,
          void* dv, int dtype, int B, int S, int H, int KV, int D, int window,
          float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(dq_part, q, k, v, dout, l, dl, dq, dk, dv, B, S, H,
                          KV, window, sm_scale, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(dq_part, q, k, v, dout, l, dl, dq, dk, dv, B, S,
                           H, KV, window, sm_scale, st);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64>(dq_part, q, k, v, dout, l, dl, dq, dk, dv, B, S,
                            H, KV, window, sm_scale, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(dq_part, q, k, v, dout, l, dl, dq, dk, dv, B, S,
                             H, KV, window, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the tensor-core
// kernels). Layouts (contiguous, 16-byte aligned): q, dout, dq (B, S, H,
// D); k, v, dk, dv (B, S, KV, D); lse (B, H, S) float32 in; delta (B, H, S)
// float32, written by the dq kernel and read by the dk/dv kernel, so the dq
// entry point runs first on the same stream. Each entry point launches its
// one kernel on `stream`, allocates nothing, does not synchronise, and
// returns the CUDA error of the launch.
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, int dtype, int B, int S, int H,
    int KV, int D, int window, float sm_scale, void* stream) {
  return entry(true, q, k, v, dout, lse, delta, dq, nullptr, nullptr, dtype,
               B, S, H, KV, D, window, sm_scale, stream);
}

extern "C" int repro_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int S, int H, int KV, int D, int window, float sm_scale, void* stream) {
  return entry(false, q, k, v, dout, lse, const_cast<void*>(delta), nullptr,
               dk, dv, dtype, B, S, H, KV, D, window, sm_scale, stream);
}
