// Split-KV flash decode for Hopper (sm_90a): the port's one-token kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_decode/kernel.py: flash_decode_pallas
//   (body _decode_kernel): per cache split, the partial (m, l, acc) of a
//   one-token query over the split's keys, with the masks kpos <= cur_pos,
//   kpos < k_offset + L and the sliding window. The splits are combined by
//   the wrapper, as the Pallas wrapper combines them outside its kernel.
//
// Design. One block per (split of SPLIT keys, kv head, batch row):
//   * the block loads each of its K/V rows ONCE for all G = H / KV q heads of
//     the group; the TPU kernel instead repeats the kv heads G times
//     (flash_decode/kernel.py:33-34);
//   * it reads only the keys the row's mask lets through: rows with a short
//     cur_pos skip the rest of a pre-allocated cache, and splits past
//     cur_pos write (m, l, acc) = (-1e30, 0, 0) without touching memory. The
//     combine weighs such a split by exp(-1e30 - m_g) = 0, so the result is
//     the reference's. A row with no unmasked key at all keeps the
//     reference's finite-sentinel semantics (every key scores -1e30 and the
//     row averages v);
//   * scores: one warp per key, D / 32 elements per lane, a warp reduction
//     per q head; then one warp per q head takes the split's max and
//     exp-sum; the P V product has one thread per value column, reading V
//     rows coalesced. Everything accumulates in float32; P is float32.
// Inputs bf16 or float32; partials are float32: m, l (B, NS, H) and
// acc (B, NS, H, Dv) with NS = ceil(L / SPLIT). Head dims 64 or 128, Dv = D.
//
// Bound. Decoding moves bytes: the K and V rows up to cur_pos are read once
// and every key costs 4 * D flops per q head, far below the card's
// operations-per-byte balance. A faster version would keep more loads in
// flight per block (TMA or cp.async double buffering) and fuse the combine.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int SPLIT = 64;   // keys per split (the wrapper's DECODE_SPLIT)
constexpr int NT = 128;     // threads per block (4 warps)
constexpr int MAXG = 16;    // q heads per kv head

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ cur_pos, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int L, int H,
    int KV, int k_offset, int window, float sm_scale) {
  constexpr int PER_LANE = D / 32;
  __shared__ float qs[MAXG * D];
  __shared__ float ps[MAXG * SPLIT];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cur = cur_pos[b];
  const int kbase = split * SPLIT;

  // unmasked local key range [lo, hi] of this row over the whole cache
  const int hi = min(L - 1, cur - k_offset);
  const int lo = window > 0 ? max(0, cur - window + 1 - k_offset) : 0;
  const bool row_masked = lo > hi;   // no unmasked key: finite-sentinel mean
  int jlo, jhi;                      // active keys of this split, local
  if (row_masked) {
    jlo = 0;
    jhi = min(SPLIT, L - kbase) - 1;
  } else {
    jlo = max(lo, kbase) - kbase;
    jhi = min(hi, kbase + SPLIT - 1) - kbase;
  }
  const size_t head0 = static_cast<size_t>(b) * NS * H + static_cast<size_t>(split) * H
                       + static_cast<size_t>(kvh) * G;
  if (jlo > jhi) {                   // nothing of this row in the split
    for (int i = tid; i < G * (D + 2); i += NT) {
      const int g = i / (D + 2), c = i - g * (D + 2);
      if (c == D) m_out[head0 + g] = kNegInf;
      else if (c == D + 1) l_out[head0 + g] = 0.f;
      else acc_out[(head0 + g) * D + c] = 0.f;
    }
    return;
  }

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i - g * D;
    qs[i] = to_f(q[(static_cast<size_t>(b) * H + kvh * G + g) * D + d]);
  }
  __syncthreads();

  // scores: -inf marks keys outside [jlo, jhi] (weight exactly 0 below)
  const float skip = __int_as_float(0xff800000);
  for (int j = warp; j < SPLIT; j += NT / 32) {
    if (j < jlo || j > jhi) {
      if (lane < G) ps[lane * SPLIT + j] = skip;
      continue;
    }
    if (row_masked) {
      if (lane < G) ps[lane * SPLIT + j] = kNegInf;
      continue;
    }
    const T* krow = k + ((static_cast<size_t>(b) * L + kbase + j) * KV + kvh) * D;
    float kr[PER_LANE];
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) kr[e] = to_f(krow[lane + 32 * e]);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) part = fmaf(qs[g * D + lane + 32 * e], kr[e], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) ps[g * SPLIT + j] = part * sm_scale;
    }
  }
  __syncthreads();

  // per q head: split max and exp-sum; P overwrites the scores
  for (int g = warp; g < G; g += NT / 32) {
    float s0 = ps[g * SPLIT + lane], s1 = ps[g * SPLIT + lane + 32];
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    s0 = expf(s0 - mx);
    s1 = expf(s1 - mx);
    float sum = s0 + s1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    ps[g * SPLIT + lane] = s0;
    ps[g * SPLIT + lane + 32] = s1;
    if (lane == 0) {
      m_out[head0 + g] = mx;
      l_out[head0 + g] = sum;
    }
  }
  __syncthreads();

  // acc[g][c] = sum_j p[g][j] * v[j][c]: one thread per value column
  for (int c = tid; c < D; c += NT) {
    float acc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
    for (int j = jlo; j <= jhi; ++j) {
      const float x = to_f(v[((static_cast<size_t>(b) * L + kbase + j) * KV + kvh) * D + c]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] = fmaf(ps[g * SPLIT + j], x, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc_out[(head0 + g) * D + c] = acc[g];
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* cur_pos,
             void* m, void* l, void* acc, int B, int L, int H, int KV, int D,
             int k_offset, int window, float sm_scale, cudaStream_t stream) {
  const dim3 grid((L + SPLIT - 1) / SPLIT, KV, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* cp = static_cast<const int*>(cur_pos);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  if (D == 64)
    flash_decode_kernel<T, 64><<<grid, NT, 0, stream>>>(
        qt, kt, vt, cp, mf, lf, af, L, H, KV, k_offset, window, sm_scale);
  else if (D == 128)
    flash_decode_kernel<T, 128><<<grid, NT, 0, stream>>>(
        qt, kt, vt, cp, mf, lf, af, L, H, KV, k_offset, window, sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts (contiguous): q (B, H, D),
// k and v (B, L, KV, D), cur_pos (B,) int32; outputs float32 m, l
// (B, NS, H) and acc (B, NS, H, D), NS = ceil(L / split). `split` must equal
// the compiled SPLIT. Launches on `stream`, allocates nothing, does not
// synchronise; returns the CUDA error of the launch (0 = success).
extern "C" int repro_flash_decode_partials(
    const void* q, const void* k, const void* v, const void* cur_pos, void* m,
    void* l, void* acc, int dtype, int B, int L, int H, int KV, int D,
    int split, int k_offset, int window, float sm_scale, void* stream) {
  if (split != SPLIT || B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, cur_pos, m, l, acc, B, L, H, KV, D,
                           k_offset, window, sm_scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, cur_pos, m, l, acc, B, L, H, KV,
                                   D, k_offset, window, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
