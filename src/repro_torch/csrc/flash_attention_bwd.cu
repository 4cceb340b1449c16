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
// float32 softmax (FlashAttention-2 uses the rounded O, which costs up to a
// few bf16 ulps of dq at the training shape). The backward needs no O.
//
// Scope: what the training path gives it. Sq == Sk, q_offset 0, causal, an
// optional sliding window, GQA (q head h reads kv head h / (H / KV)), head
// dims 64 and 128, bf16 or float32. No row of that mask is fully masked (the
// diagonal is always kept), so P never needs the forward's all-masked rule.
//
// Design: the FlashAttention-2 split into two kernels, so neither needs
// atomics, each launched by its own entry point (the caller counts each).
//   * flash_bwd_dq_kernel, launched first: one block per (64-row q tile,
//     q head, batch). Q, dO and lse of the tile stay in shared memory; the
//     block walks the kv tiles of the band (the forward's tile skipping)
//     and accumulates, in one sweep, A = sum_j P dP k_j, B = sum_j P k_j and
//     delta = sum_j P dP in registers, so dQ = scale * (A - delta B); it
//     writes delta for the second kernel.
//   * flash_bwd_dkdv_kernel: one block per (64-key tile, kv head, batch).
//     K and V of the tile stay in shared memory; the block walks the G q heads
//     of its kv head and, for each, the 64-row q tiles that meet the
//     causal/window band of its keys, and accumulates dK and dV in registers.
// 256 threads as 16 x 16. For the 64 x 64 score tile thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j (i, j < 4); every tile sits in shared
// memory row-major with rows padded by 4 floats, so the products over the
// head dim read float4s without bank conflicts. S, P, dP and dS are float32,
// as in the forward; inputs are converted to float32 on load and the
// gradients are written in the input type.
//
// Bound. At the training shape (B 2, S 2048, 16 q / 8 kv heads, D 128) the
// backward does 4 products of 2 * D flops per unmasked (q, k) pair plus the
// recomputed scores: about 2.5x the forward's operations, so it is bound by
// operations. This version uses CUDA-core FMAs (no tensor cores) and sits
// far below the 989 TFLOP/s bf16 peak; wgmma with TMA-fed rings is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 256;     // threads per block (16 x 16)
constexpr int PAD = 4;      // row padding of the [row][d] tiles (floats)
constexpr int PPAD = 16;    // row padding of the [q][k] tiles: rows 16 banks apart

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [r0, r0 + R) of one head of a (B, S, NH, D) tensor into dst[R][D + PAD]
// as float32, zeros past S
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int r0, int S, int NH, int head) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D, row = r0 + r;
    float x = 0.f;
    if (row < S) x = to_f(src[((static_cast<size_t>(b) * S + row) * NH + head) * D + d]);
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

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
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
  load_tile<T, D, BK>(Ks, k, b, k0, S, KV, kvh);
  load_tile<T, D, BK>(Vs, v, b, k0, S, KV, kvh);

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
      load_tile<T, D, BQ>(Qs, q, b, q0, S, H, h);
      load_tile<T, D, BQ>(dOs, dout, b, q0, S, H, h);
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
        store(&dk[row + d], dk_acc[i][cc * 4 + e] * sm_scale);
        store(&dv[row + d], dv_acc[i][cc * 4 + e]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int S, int H, int KV,
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
  load_tile<T, D, BQ>(Qs, q, b, q0, S, H, h);
  load_tile<T, D, BQ>(dOs, dout, b, q0, S, H, h);
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
    load_tile<T, D, BK>(Ks, k, b, k0, S, KV, kvh);
    load_tile<T, D, BK>(Vs, v, b, k0, S, KV, kvh);
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
        store(&dq[row + cc * 64 + tx * 4 + e],
              (a_acc[i][cc * 4 + e] - dsum[i] * b_acc[i][cc * 4 + e]) * sm_scale);
  }
}

template <typename T, int D>
int launch(bool dq_part, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int H, int KV, int window,
           float sm_scale, cudaStream_t stream) {
  constexpr int tiles = static_cast<int>(sizeof(float)) *
                        (4 * BQ * (D + PAD) + 2 * BQ * (BK + PPAD));
  constexpr int smem_dq = tiles + static_cast<int>(sizeof(float)) * BQ;
  constexpr int smem_dkdv = tiles + static_cast<int>(sizeof(float)) * 2 * BQ;
  auto kdq = flash_bwd_dq_kernel<T, D>;
  auto kdkdv = flash_bwd_dkdv_kernel<T, D>;
  // set once per template instance (thread-safe static initialisation)
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if (dq_part)
    kdq<<<dim3((S + BQ - 1) / BQ, H, B), NT, smem_dq, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, H, KV, window,
        sm_scale);
  else
    kdkdv<<<dim3((S + BK - 1) / BK, KV, B), NT, smem_dkdv, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        S, H, KV, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool dq_part, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int S, int H, int KV, int D,
             int window, float sm_scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(dq_part, q, k, v, dout, lse, delta, dq, dk, dv, B, S,
                         H, KV, window, sm_scale, stream);
  if (D == 128)
    return launch<T, 128>(dq_part, q, k, v, dout, lse, delta, dq, dk, dv, B,
                          S, H, KV, window, sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (dtype == 0)
    return dispatch<float>(dq_part, q, k, v, dout, l, dl, dq, dk, dv, B, S, H,
                           KV, D, window, sm_scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dq_part, q, k, v, dout, l, dl, dq, dk, dv,
                                   B, S, H, KV, D, window, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts (contiguous): q, dout, dq
// (B, S, H, D); k, v, dk, dv (B, S, KV, D); lse (B, H, S) float32 in;
// delta (B, H, S) float32, written by the dq kernel and read by the dk/dv
// kernel, so the dq entry point runs first on the same stream. Each entry
// point launches its one kernel on `stream`, allocates nothing, does not
// synchronise, and returns the CUDA error of the launch.
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
