// Split-KV flash decode for Hopper (sm_90a): the port's one-token kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_decode/kernel.py: flash_decode_pallas
//   (body _decode_kernel, and the split combine of its wrapper): per cache
//   split, the partial (m, l, acc) of a one-token query over the split's
//   keys, with the masks kpos <= cur_pos, kpos < k_offset + L and the
//   sliding window, then the P(max)/P(sum) combine of the splits. The
//   Pallas wrapper combines the splits outside its kernel; here the kernel
//   does, so one launch returns the cache's (m, l, acc).
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
//     rows coalesced. Everything accumulates in float32; P is float32;
//   * the combine: each block writes its partial to a float32 scratch, and
//     the last block of its (b, kv head) group to finish -- every thread
//     fences its writes, then one atomic ticket per group -- reads the
//     group's splits back from L2 and folds them in split order: m_g = max
//     of the splits' m, then l and acc summed with weights exp(m_s - m_g).
//     It writes (m, l, acc) and resets the ticket to 0 for the next call
//     (the tickets live with the caller, one zeroed int per group and
//     stream). Nothing runs on the card between the launch and the
//     returned tensors: no eager PyTorch combine over the splits.
// Inputs bf16 or float32; (m, l, acc) float32 of shapes (B, H), (B, H),
// (B, H, D). Head dims 64 or 128, Dv = D.
//
// Bound. Decoding moves bytes: the K and V rows up to cur_pos are read once
// and every key costs 4 * D flops per q head, far below the card's
// operations-per-byte balance. At the qwen3 decode shape 288 blocks share
// the K/V reads; the fixed cost of a launch and of the last block's
// combine is what remains.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int SPLIT = 64;   // keys per split (the wrapper's DECODE_SPLIT)
constexpr int NT = 128;     // threads per block (4 warps)
constexpr int MAXG = 16;    // q heads per kv head

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The scratch and output layout of one call, in floats from `out`: the
// combined m (B, H), l (B, H), acc (B, H, D), then the splits' partials m,
// l (B, NS, H) and acc (B, NS, H, D).
struct Layout {
  float *m, *l, *acc, *ms, *ls, *accs;
  __host__ __device__ Layout(float* out, int B, int NS, int H, int D) {
    const size_t bh = static_cast<size_t>(B) * H;
    m = out;
    l = m + bh;
    acc = l + bh;
    ms = acc + bh * D;
    ls = ms + bh * NS;
    accs = ls + bh * NS;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ cur_pos, float* __restrict__ out,
    int* __restrict__ tickets, int L, int H, int KV, int k_offset,
    int window, float sm_scale) {
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
  const Layout lay(out, gridDim.z, NS, H, D);
  float* m_out = lay.ms;                 // this call's split partials
  float* l_out = lay.ls;
  float* acc_out = lay.accs;
  const size_t head0 = static_cast<size_t>(b) * NS * H + static_cast<size_t>(split) * H
                       + static_cast<size_t>(kvh) * G;
  if (jlo > jhi) {                   // nothing of this row in the split
    for (int i = tid; i < G * (D + 2); i += NT) {
      const int g = i / (D + 2), c = i - g * (D + 2);
      if (c == D) m_out[head0 + g] = kNegInf;
      else if (c == D + 1) l_out[head0 + g] = 0.f;
      else acc_out[(head0 + g) * D + c] = 0.f;
    }
  } else {
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

  // the last block of the (b, kvh) group to finish combines its splits
  __shared__ int last;
  __threadfence();                   // this thread's partial is visible
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[b * KV + kvh], 1) == NS - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t row0 = static_cast<size_t>(b) * NS * H + static_cast<size_t>(kvh) * G;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, c = i - g * D;
    float mg = kNegInf;
#pragma unroll 8
    for (int s = 0; s < NS; ++s) mg = fmaxf(mg, __ldcg(&m_out[row0 + s * H + g]));
    float lg = 0.f, ag = 0.f;
#pragma unroll 8
    for (int s = 0; s < NS; ++s) {
      const size_t hs = row0 + static_cast<size_t>(s) * H + g;
      const float w = expf(__ldcg(&m_out[hs]) - mg);
      lg += __ldcg(&l_out[hs]) * w;
      ag += __ldcg(&acc_out[hs * D + c]) * w;
    }
    const size_t hb = static_cast<size_t>(b) * H + kvh * G + g;
    lay.acc[hb * D + c] = ag;
    if (c == 0) {
      lay.m[hb] = mg;
      lay.l[hb] = lg;
    }
  }
  if (tid == 0) tickets[b * KV + kvh] = 0;
}


template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* cur_pos,
             void* out, void* tickets, int B, int L, int H, int KV, int D,
             int k_offset, int window, float sm_scale, cudaStream_t stream) {
  const dim3 grid((L + SPLIT - 1) / SPLIT, KV, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* cp = static_cast<const int*>(cur_pos);
  float* of = static_cast<float*>(out);
  int* tk = static_cast<int*>(tickets);
  if (D == 64)
    flash_decode_kernel<T, 64><<<grid, NT, 0, stream>>>(
        qt, kt, vt, cp, of, tk, L, H, KV, k_offset, window, sm_scale);
  else if (D == 128)
    flash_decode_kernel<T, 128><<<grid, NT, 0, stream>>>(
        qt, kt, vt, cp, of, tk, L, H, KV, k_offset, window, sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts (contiguous): q (B, H, D),
// k and v (B, L, KV, D), cur_pos (B,) int32. `out`: float32, B H (D + 2)
// (1 + NS) floats, NS = ceil(L / split): the combined m (B, H), l (B, H)
// and acc (B, H, D), then the splits' partials (scratch). `tickets`: B KV
// int32, zero before the call and zero again after it; calls that may run
// at the same time need their own. `split` must equal the compiled SPLIT.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// the CUDA error of the launch (0 = success).
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const void* cur_pos,
    void* out, void* tickets, int dtype, int B, int L, int H, int KV, int D,
    int split, int k_offset, int window, float sm_scale, void* stream) {
  if (split != SPLIT || B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, cur_pos, out, tickets, B, L, H, KV, D,
                           k_offset, window, sm_scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, cur_pos, out, tickets, B, L, H,
                                   KV, D, k_offset, window, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
