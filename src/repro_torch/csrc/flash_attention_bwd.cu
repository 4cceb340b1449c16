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
// optional sliding window, GQA (q head h reads kv head h / (H / KV)), and
// the forward's head-dim pairs (D of q, k, dq, dk; Dv of v, dO, dv): (64,
// 64), (128, 128) and MLA's (192, 128) in both dtypes (deepseek-v2-lite:
// q and k are nope 128 + rope 64, v is 128), and in float32 also the
// reduced MLA's (96, 64). Any other pair is refused (cudaErrorInvalidValue).
// No row of the causal mask is fully masked (the diagonal is always kept),
// so P never needs the forward's all-masked rule.
//
// The FlashAttention-2 split into two kernels, so neither needs atomics
// (float32 atomics would make dq differ from run to run), each launched by
// its own entry point (the caller counts each), dq first:
//   * the dq kernel: one block per (64-row q tile, q head, batch), walking
//     the kv tiles of the band (the forward's tile skipping); it writes
//     each row's delta for the second kernel;
//   * the dk/dv kernel: one block per (64-key tile, kv head, batch); K and
//     V of the tile stay in shared memory; the block walks the G q heads of
//     its kv head and, for each, the q tiles that meet the causal/window
//     band of its keys, accumulating dK and dV in registers.
// Two versions of each, chosen by the input dtype (the wrapper states it):
// bf16 on the tensor cores (flash_bwd_dq_wgmma_kernel,
// flash_bwd_dkdv_wgmma_kernel), float32 on CUDA cores (flash_bwd_dq_kernel,
// flash_bwd_dkdv_kernel). wgmma has no float32 input, and its TF32 mode
// keeps about three decimal digits, which would break the float32 checks
// at 1e-4 that the port holds its kernels to.
//
// Bound. The backward does 2 flops a multiply-add over 3 D + 2 Dv products
// per unmasked (q, k) pair (S and dQ, dK over D; dP and dV over Dv). At
// qwen3's training layer (q (2, 2048, 16, 128), kv (2, 2048, 8, 128)):
// 86 GFLOP, 0.087 ms at the 989 TFLOP/s bf16 peak, against 0.025 ms for its
// 84 MB of inputs and gradients at 3.35 TB/s. At deepseek-v2-lite's (q/k
// (2, 2048, 16, 192), v (2, 2048, 16, 128)): 111.7 GFLOP, 0.1129 ms,
// against 0.045 ms for about 151 MB. Both bound by operations.
//
// The tensor-core kernels (bf16). One warpgroup (128 threads) a block;
// 64-row key tiles and 64-row q tiles of the dq kernel are wgmma's M. Tiles
// sit in shared memory in bf16 with the 128-byte swizzle (hopper_mma.cuh),
// D / 64 panels of 64 columns (three at D = 192, the forward's layout) and
// Dv / 64 for v and dO, each loaded with its own row pitch (MLA's v rows
// lie KV Dv apart, its k rows KV D apart), filled by 16-byte cp.async
// copies; the walked tiles go through a ring of two stages, the next one
// loading while the current one is computed.
//   * dq kernel (Q, dO stay; K, V walk). delta must be complete before any
//     dS is formed, and on tensor cores the one-sweep form dQ = scale (sum
//     P dP K - delta sum P K) of the float32 kernel costs a fourth product
//     and a second 64 x D accumulator. This kernel pays a second sweep
//     instead: sweep 1 computes S = Q K^T and dP = dO V^T (SS wgmma, both
//     K-major) and sums delta = rowsum(P o dP) in float32; sweep 2
//     recomputes S and dP, forms dS = P o (dP - delta) in float32, and
//     dQ += dS K takes dS from registers as bf16 with K MN-major (5
//     products a tile over the two sweeps, one 64 x D accumulator; at D =
//     192 one m64n192k16 a k-step). Shared memory: 3 (64 D + 64 Dv) bf16,
//     96 KB at D = Dv = 128 (two blocks an SM), 120 KB at (192, 128) (one).
//   * dk/dv kernel (K, V stay; Q, dO, lse, delta walk; lse and delta by
//     4-byte cp.async, since a row of S floats need not start on 16
//     bytes). S^T = K Q^T and dP^T = V dO^T are SS wgmmas with K-major
//     operands, so P^T and dS^T come out in the accumulator layout of
//     rows = keys and are the register A operands of dV += P^T dO and
//     dK += dS^T Q, with Q and dO MN-major (the transpose bit). The q tile
//     is QT rows, wgmma's N of S^T and dP^T: 64 at D <= 128, where the
//     64 x D dK and dV accumulators (128 registers a thread at D = 128)
//     and the two 64 x 64 score fragments fit in the 255 registers of one
//     thread (ptxas: 255, no spill; the dq kernel 167); 32 at D = 192,
//     where the accumulators alone (dK 64 x 192 + dV 64 x 128, float32)
//     take 160 registers a thread and two 64 x 64 score fragments (64
//     more) with their bf16 hi/lo A fragments would spill: a 32-row q tile
//     halves the fragments (S^T and dP^T by m64n32k16, two k-steps of dV
//     and dK a tile) at twice the tiles, and halves the walked stages (80
//     KB of shared memory, two blocks an SM).
// Rounding. The products take P and dS in bf16 where the float32 version
// keeps them in float32. Emulated on the CPU at a qwen3 layer
// (tests/test_torch_kernels.py), bf16 P in dV and bf16 dS in dK put the
// worst element of dk and dv at 1.0-1.1x of the 5e-3 + 1e-2 |ref| limit
// that chip_smoke.py holds them to, and dq at 0.5x. So the dk/dv kernel
// splits P and dS into bf16 hi + lo parts (x = hi + lo to 2^-17) and runs
// dV and dK as two products each (6 products a tile instead of 4); dq keeps
// a single bf16 dS. At MLA's (192, 128) the same emulation
// (test_tensor_core_backward_rounding_at_mla_head_dims: a deepseek layer's
// 16 heads at S = 256, a ragged S = 150, a window) puts single bf16 P and
// dS at 1.11-1.24x of the limit on dv and 0.51-0.81x on dk, against
// 0.25-0.32x on both with the split, and dq at 0.51-0.78x with its single
// bf16 dS: the split stays at D = 192, and dq keeps one rounding.
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
// so dQ = scale * (A - delta B). A thread owns head-dim columns 64 cc +
// 4 tx + e (e < 4) of each 64-column group cc: at D = 96 the second group
// is half full (its columns at tx < 8).
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

// the thread's 4 x 4 entries of A B^T over N columns: rows ty + 16 i of A,
// rows tx + 16 j of B (both [row][N + PAD])
template <int N>
__device__ __forceinline__ void product_f32(const float* A, const float* B,
                                            float (&out)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < N; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * (N + PAD) + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * (N + PAD) + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = dot4(a[i], c[j], out[i][j]);
  }
}

__device__ __forceinline__ bool in_band(int qi, int kj, int S, int window) {
  return qi < S && kj < S && kj <= qi && (window <= 0 || kj > qi - window);
}

// whether the thread's columns 64 cc + 4 tx .. + 3 of a D-column tile exist
template <int D>
__device__ __forceinline__ bool has_cols(int cc, int tx) {
  return D % 64 == 0 || cc * 64 + tx * 4 < D;
}

template <int D, int DV>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    int S, int H, int KV, int window, float sm_scale) {
  constexpr int GD = (D + 63) / 64, GV = (DV + 63) / 64;   // 64-column groups
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                         // [BK][D + PAD]
  float* Vs = Ks + BK * (D + PAD);          // [BK][DV + PAD]
  float* Qs = Vs + BK * (DV + PAD);         // [BQ][D + PAD]
  float* dOs = Qs + BQ * (D + PAD);         // [BQ][DV + PAD]
  float* Ps = dOs + BQ * (DV + PAD);        // [BQ][BK + PPAD]
  float* dSs = Ps + BQ * (BK + PPAD);       // [BQ][BK + PPAD]
  float* lse_s = dSs + BQ * (BK + PPAD);    // [BQ]
  float* delta_s = lse_s + BQ;              // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  load_tile_f32<D, BK>(Ks, k, b, k0, S, KV, kvh);
  load_tile_f32<DV, BK>(Vs, v, b, k0, S, KV, kvh);

  // q tiles that meet the band of keys [k0, k_last]: q >= k, q < k + window
  const int k_last = min(k0 + BK, S) - 1;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int qt_begin = k0 / BQ, qt_end = (q_end + BQ - 1) / BQ;

  float dk_acc[4][4 * GD], dv_acc[4][4 * GV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * GD; ++c) dk_acc[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * GV; ++c) dv_acc[i][c] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();    // K/V stored / the previous tile's reads done
      load_tile_f32<D, BQ>(Qs, q, b, q0, S, H, h);
      load_tile_f32<DV, BQ>(dOs, dout, b, q0, S, H, h);
      if (tid < BQ) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse_h[q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      product_f32<D>(Qs, Ks, s);
      product_f32<DV>(dOs, Vs, dp);
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
        for (int cc = 0; cc < GV; ++cc) {
          if (!has_cols<DV>(cc, tx)) continue;
          const float4 o4 = *reinterpret_cast<const float4*>(&dOs[r * (DV + PAD) + cc * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][cc * 4 + 0] = fmaf(p[i], o4.x, dv_acc[i][cc * 4 + 0]);
            dv_acc[i][cc * 4 + 1] = fmaf(p[i], o4.y, dv_acc[i][cc * 4 + 1]);
            dv_acc[i][cc * 4 + 2] = fmaf(p[i], o4.z, dv_acc[i][cc * 4 + 2]);
            dv_acc[i][cc * 4 + 3] = fmaf(p[i], o4.w, dv_acc[i][cc * 4 + 3]);
          }
        }
#pragma unroll
        for (int cc = 0; cc < GD; ++cc) {
          if (!has_cols<D>(cc, tx)) continue;
          const float4 q4 = *reinterpret_cast<const float4*>(&Qs[r * (D + PAD) + cc * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
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
    const size_t row = (static_cast<size_t>(b) * S + kj) * KV + kvh;
#pragma unroll
    for (int cc = 0; cc < GD; ++cc) {
      if (!has_cols<D>(cc, tx)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dk[row * D + cc * 64 + tx * 4 + e] = dk_acc[i][cc * 4 + e] * sm_scale;
    }
#pragma unroll
    for (int cc = 0; cc < GV; ++cc) {
      if (!has_cols<DV>(cc, tx)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv[row * DV + cc * 64 + tx * 4 + e] = dv_acc[i][cc * 4 + e];
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ dq, int S, int H, int KV,
    int window, float sm_scale) {
  constexpr int GD = (D + 63) / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [BQ][D + PAD]
  float* dOs = Qs + BQ * (D + PAD);         // [BQ][DV + PAD]
  float* Ks = dOs + BQ * (DV + PAD);        // [BK][D + PAD]
  float* Vs = Ks + BK * (D + PAD);          // [BK][DV + PAD]
  float* Ps = Vs + BK * (DV + PAD);         // [BQ][BK + PPAD]
  float* PdPs = Ps + BQ * (BK + PPAD);      // [BQ][BK + PPAD]
  float* lse_s = PdPs + BQ * (BK + PPAD);   // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S + q0;
  load_tile_f32<D, BQ>(Qs, q, b, q0, S, H, h);
  load_tile_f32<DV, BQ>(dOs, dout, b, q0, S, H, h);
  if (tid < BQ) lse_s[tid] = q0 + tid < S ? lse[row0 + tid] : 0.f;

  // kv tiles that meet the band of this q tile (the forward's skipping)
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / BK, kt_end = (q_last + 1 + BK - 1) / BK;

  // dQ = scale * (A - delta B) with A = sum_j P dP k_j, B = sum_j P k_j and
  // delta = sum_j P dP, all accumulated in the one sweep over the band
  float a_acc[4][4 * GD], b_acc[4][4 * GD], dsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * GD; ++c) a_acc[i][c] = b_acc[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();    // Q/dO stored / the previous tile's reads done
    load_tile_f32<D, BK>(Ks, k, b, k0, S, KV, kvh);
    load_tile_f32<DV, BK>(Vs, v, b, k0, S, KV, kvh);
    __syncthreads();

    float s[4][4], dp[4][4];
    product_f32<D>(Qs, Ks, s);
    product_f32<DV>(dOs, Vs, dp);
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
      for (int cc = 0; cc < GD; ++cc) {
        if (!has_cols<D>(cc, tx)) continue;
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
    for (int cc = 0; cc < GD; ++cc) {
      if (!has_cols<D>(cc, tx)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dq[row + cc * 64 + tx * 4 + e] =
            (a_acc[i][cc * 4 + e] - dsum[i] * b_acc[i][cc * 4 + e]) * sm_scale;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (see the header).
// ---------------------------------------------------------------------------
constexpr int TC = 64;              // rows of a key tile and of a dq q tile
constexpr int TC_THREADS = 128;     // one warpgroup

// the dk/dv kernel's q tile rows (see the header)
template <int D>
constexpr int kDkdvQt = D > 128 ? 32 : 64;

// Q and dO, then each of the two stages' K and V tiles, lse, the alignment
template <int D, int DV>
constexpr int dq_smem_bytes() { return 3 * TC * (D + DV) * 2 + TC * 4 + 1024; }
// K and V, then each of the two stages' Q and dO tiles, lse and delta of
// both stages, the alignment
template <int D, int DV, int QT>
constexpr int dkdv_smem_bytes() {
  return TC * (D + DV) * 2 + 2 * QT * (D + DV) * 2 + 4 * QT * 4 + 1024;
}

// S (unscaled) and dP of one 64 x N tile: A1 B1^T over D and A2 B2^T over
// DV; A1, A2 swizzled 64-row tiles, B1, B2 N-row ones, all K-major
template <int D, int DV, int N>
__device__ __forceinline__ void two_products_tc(uint32_t a1, uint32_t b1,
                                                uint32_t a2, uint32_t b2,
                                                float (&s)[N / 2],
                                                float (&dp)[N / 2]) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(s, kstep_kmajor<TC>(a1, kk), kstep_kmajor<N>(b1, kk), 1);
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk)
    wgmma_ss<N>(dp, kstep_kmajor<TC>(a2, kk), kstep_kmajor<N>(b2, kk), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

template <int D, int DV>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int S, int H, int KV, int window,
    float sm_scale) {
  using namespace hopper;
  constexpr uint32_t TILE = TC * D * 2;      // a Q or K tile
  constexpr uint32_t VTILE = TC * DV * 2;    // a dO or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  // Q, dO, then stage s's K at (1 + s) (TILE + VTILE) and its V after it
  const uint32_t sQ = smem_u32(smem), sdO = sQ + TILE;
  auto sK_of = [&](int stage) { return sQ + (1 + stage) * (TILE + VTILE); };
  float* lse_s = reinterpret_cast<float*>(smem + 3 * (TILE + VTILE));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r_lo = 16 * warp + g;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t ldq = static_cast<size_t>(H) * D, ldk = static_cast<size_t>(KV) * D;
  const size_t ldo = static_cast<size_t>(H) * DV, ldv = static_cast<size_t>(KV) * DV;
  const size_t qoff = static_cast<size_t>(b) * S * ldq + static_cast<size_t>(h) * D;
  const size_t ooff = static_cast<size_t>(b) * S * ldo + static_cast<size_t>(h) * DV;
  const size_t koff = static_cast<size_t>(b) * S * ldk + static_cast<size_t>(kvh) * D;
  const size_t voff = static_cast<size_t>(b) * S * ldv + static_cast<size_t>(kvh) * DV;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S + q0;

  load_tile<D, TC>(sQ, q + qoff, q0, S, ldq);
  load_tile<DV, TC>(sdO, dout + ooff, q0, S, ldo);
  if (tid < TC) lse_s[tid] = q0 + tid < S ? lse[row0 + tid] : 0.f;

  // kv tiles that meet the band of this q tile (the forward's skipping)
  const int q_last = min(q0 + TC, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / TC, n = (q_last + TC) / TC - kt_begin;
  load_tile<D, TC>(sK_of(0), k + koff, kt_begin * TC, S, ldk);
  load_tile<DV, TC>(sK_of(0) + TILE, v + voff, kt_begin * TC, S, ldv);
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
      load_tile<D, TC>(sK_of(st ^ 1), k + koff, nk, S, ldk);
      load_tile<DV, TC>(sK_of(st ^ 1) + TILE, v + voff, nk, S, ldv);
    }
    cp_async_commit();
    const uint32_t sK = sK_of(st), sV = sK + TILE;

    float s[32], dp[32];
    two_products_tc<D, DV, TC>(sQ, sK, sdO, sV, s, dp);
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

template <int D, int DV, int QT>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dkdv_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
    int H, int KV, int window, float sm_scale) {
  using namespace hopper;
  constexpr uint32_t KTILE = TC * D * 2, VTILE = TC * DV * 2;   // K, V
  constexpr uint32_t QTILE = QT * D * 2, OTILE = QT * DV * 2;   // Q, dO
  constexpr uint32_t LOFF = KTILE + VTILE + 2 * (QTILE + OTILE);
  constexpr int KS = QT / 16;                 // k-steps of dV and dK a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  // K, V, then stage s's Q at KTILE + VTILE + s (QTILE + OTILE) and its dO
  // after it; lse [2][QT], then delta [2][QT]
  const uint32_t sK = smem_u32(smem), sV = sK + KTILE;
  auto sQ_of = [&](int stage) { return sV + VTILE + stage * (QTILE + OTILE); };
  const uint32_t sL = sK + LOFF;
  const float* lse_s = reinterpret_cast<const float*>(smem + LOFF);
  const float* delta_s = lse_s + 2 * QT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r_lo = 16 * warp + g;
  const int k0 = blockIdx.x * TC, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t ldq = static_cast<size_t>(H) * D, ldk = static_cast<size_t>(KV) * D;
  const size_t ldo = static_cast<size_t>(H) * DV, ldv = static_cast<size_t>(KV) * DV;
  const size_t koff = static_cast<size_t>(b) * S * ldk + static_cast<size_t>(kvh) * D;
  const size_t voff = static_cast<size_t>(b) * S * ldv + static_cast<size_t>(kvh) * DV;
  load_tile<D, TC>(sK, k + koff, k0, S, ldk);
  load_tile<DV, TC>(sV, v + voff, k0, S, ldv);

  // q tiles that meet the band of keys [k0, k_last]: q >= k, q < k + window
  const int k_last = min(k0 + TC, S) - 1;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int qt_begin = k0 / QT, nq = (q_end + QT - 1) / QT - qt_begin;
  const int total = G * nq;

  // the i-th (head, q tile) of the walk into stage st
  auto load_q = [&](int i, int st) {
    const int h = kvh * G + i / nq, q0 = (qt_begin + i % nq) * QT;
    const size_t qoff = static_cast<size_t>(b) * S * ldq + static_cast<size_t>(h) * D;
    const size_t ooff = static_cast<size_t>(b) * S * ldo + static_cast<size_t>(h) * DV;
    load_tile<D, QT>(sQ_of(st), q + qoff, q0, S, ldq);
    load_tile<DV, QT>(sQ_of(st) + QTILE, dout + ooff, q0, S, ldo);
    if (tid < 2 * QT) {
      const bool is_lse = tid < QT;
      const int r = tid % QT, row = q0 + r;
      const float* src = (is_lse ? lse : delta) + (static_cast<size_t>(b) * H + h) * S;
      const bool ok = row < S;
      cp_async4(sL + 4 * ((is_lse ? 0 : 2 * QT) + st * QT + r),
                ok ? src + row : src, ok ? 4 : 0);
    }
  };
  load_q(0, 0);
  cp_async_commit();

  float dka[D / 2], dva[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;

  for (int i = 0; i < total; ++i) {
    const int st = i & 1, q0 = (qt_begin + i % nq) * QT;
    cp_async_wait_all();
    __syncthreads();    // tile i landed; every warp is done with tile i - 1
    if (i + 1 < total) load_q(i + 1, st ^ 1);
    cp_async_commit();
    const uint32_t sQ = sQ_of(st), sdO = sQ + QTILE;

    // S^T and dP^T: rows are this block's keys, columns the tile's queries
    float s[QT / 2], dp[QT / 2];
    two_products_tc<D, DV, QT>(sK, sQ, sV, sdO, s, dp);
    const bool edge = q0 < k0 + TC - 1 || q0 + QT > S || k0 + TC > S ||
                      (window > 0 && q0 + QT - 1 - k0 >= window);
    const float* ls = lse_s + st * QT;
    const float* ds = delta_s + st * QT;
#pragma unroll
    for (int e = 0; e < QT / 2; ++e) {
      const int kj = k0 + r_lo + 8 * ((e >> 1) & 1);
      const int c = 8 * (e >> 2) + 2 * t + (e & 1);
      const float p = (!edge || in_band(q0 + c, kj, S, window))
                          ? exp2f((s[e] * sm_scale - ls[c]) * kLog2e) : 0.f;
      s[e] = p;
      dp[e] = p * (dp[e] - ds[c]);
    }
    uint32_t ph[KS][4], pl[KS][4], dh[KS][4], dl[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      a_frag_hilo(s, kk, ph[kk], pl[kk]);
      a_frag_hilo(dp, kk, dh[kk], dl[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t bdo = kstep_mnmajor<QT>(sdO, kk), bq = kstep_mnmajor<QT>(sQ, kk);
      wgmma_rs<DV>(dva, ph[kk], bdo);
      wgmma_rs<DV>(dva, pl[kk], bdo);
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
    __nv_bfloat16* krow = dk + koff + static_cast<size_t>(kj) * ldk;
    __nv_bfloat16* vrow = dv + voff + static_cast<size_t>(kj) * ldv;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dka[4 * j + 2 * hh] * sm_scale,
                                dka[4 * j + 2 * hh + 1] * sm_scale);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
  }
}

// Sets each kernel's shared-memory attribute once per launcher instance
// (thread-safe static initialisation), then launches the one kernel asked
// for.
template <int D, int DV>
int launch_f32(bool dq_part, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int S, int H, int KV, int window,
               float sm_scale, cudaStream_t stream) {
  constexpr int tiles = static_cast<int>(sizeof(float)) *
                        (2 * BQ * (D + PAD) + 2 * BQ * (DV + PAD) +
                         2 * BQ * (BK + PPAD));
  constexpr int smem_dq = tiles + static_cast<int>(sizeof(float)) * BQ;
  constexpr int smem_dkdv = tiles + static_cast<int>(sizeof(float)) * 2 * BQ;
  static_assert(smem_dkdv <= 232448, "a block's shared memory");
  auto kdq = flash_bwd_dq_kernel<D, DV>;
  auto kdkdv = flash_bwd_dkdv_kernel<D, DV>;
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

template <int D, int DV>
int launch_wgmma(bool dq_part, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int S, int H, int KV, int window,
                 float sm_scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int QT = kDkdvQt<D>;
  constexpr int smem_dq = dq_smem_bytes<D, DV>();
  constexpr int smem_dkdv = dkdv_smem_bytes<D, DV, QT>();
  static_assert(smem_dq <= 232448 && smem_dkdv <= 232448,
                "a block's shared memory");
  auto kdq = flash_bwd_dq_wgmma_kernel<D, DV>;
  auto kdkdv = flash_bwd_dkdv_wgmma_kernel<D, DV, QT>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  if (dq_part)
    kdq<<<dim3((S + TC - 1) / TC, H, B), TC_THREADS, smem_dq, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), S, H, KV, window,
        sm_scale);
  else
    kdkdv<<<dim3((S + TC - 1) / TC, KV, B), TC_THREADS, smem_dkdv, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, H, KV, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int entry(bool dq_part, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, void* delta, void* dq, void* dk,
          void* dv, int dtype, int B, int S, int H, int KV, int D, int Dv,
          int window, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_FA_BWD_CASE(DT, HD, HDV, LAUNCH)                               \
  if (dtype == DT && D == HD && Dv == HDV)                                   \
    return LAUNCH<HD, HDV>(dq_part, q, k, v, dout, l, dl, dq, dk, dv, B, S, \
                           H, KV, window, sm_scale, st);
  REPRO_FA_BWD_CASE(0, 64, 64, launch_f32)
  REPRO_FA_BWD_CASE(0, 128, 128, launch_f32)
  REPRO_FA_BWD_CASE(0, 192, 128, launch_f32)
  REPRO_FA_BWD_CASE(0, 96, 64, launch_f32)
  REPRO_FA_BWD_CASE(1, 64, 64, launch_wgmma)
  REPRO_FA_BWD_CASE(1, 128, 128, launch_wgmma)
  REPRO_FA_BWD_CASE(1, 192, 128, launch_wgmma)
#undef REPRO_FA_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the tensor-core
// kernels). Layouts (contiguous, 16-byte aligned): q, dq (B, S, H, D); k,
// dk (B, S, KV, D); v, dv (B, S, KV, Dv); dout (B, S, H, Dv); lse (B, H, S)
// float32 in; delta (B, H, S) float32, written by the dq kernel and read by
// the dk/dv kernel, so the dq entry point runs first on the same stream.
// (D, Dv): (64, 64), (128, 128), (192, 128), and in float32 also (96, 64);
// any other pair returns cudaErrorInvalidValue. Each entry point launches
// its one kernel on `stream`, allocates nothing, does not synchronise, and
// returns the CUDA error of the launch.
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, int dtype, int B, int S, int H,
    int KV, int D, int Dv, int window, float sm_scale, void* stream) {
  return entry(true, q, k, v, dout, lse, delta, dq, nullptr, nullptr, dtype,
               B, S, H, KV, D, Dv, window, sm_scale, stream);
}

extern "C" int repro_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int S, int H, int KV, int D, int Dv, int window, float sm_scale,
    void* stream) {
  return entry(false, q, k, v, dout, lse, const_cast<void*>(delta), nullptr,
               dk, dv, dtype, B, S, H, KV, D, Dv, window, sm_scale, stream);
}
