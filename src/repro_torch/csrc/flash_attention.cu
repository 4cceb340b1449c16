// Flash-attention forward for Hopper (sm_90a): the port's prefill kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention_pallas
//   (body _flash_kernel): blocked online-softmax attention forward with
//   causal (+ q_offset), sliding-window and q/kv padding masks, GQA.
//
// Design. The TPU kernel walks a sequential grid (B, H, q blocks, kv blocks)
// and carries (m, l, acc) in VMEM scratch across the kv axis. Here one
// thread block owns one (q tile of BQ rows, q head, batch row) and loops over
// the kv tiles itself, so the running state stays in registers:
//   * grid (ceil(Sq / BQ), H, B), 256 threads as a 16 x 16 grid; thread
//     (ty, tx) owns score rows ty*4..ty*4+3 and columns tx*4..tx*4+3 of the
//     BQ x BK tile, and output rows ty*4.. x columns tx*4 + 64*c + (0..3);
//   * the loop visits only kv tiles that intersect the causal/window band of
//     the q tile (the block skipping of flash_attention_triangular), so a
//     causal prompt does about half the tiles of the full rectangle;
//   * GQA: q head h reads kv head h / (H / KV), no materialised repeat;
//   * Q and K tiles sit transposed in shared memory ([d][row], rows padded by
//     4 floats) so each thread reads 4 rows / 4 columns as one float4;
//   * S = Q K^T, the softmax statistics and O accumulate in float32. P takes
//     part in the second product in float32, as in the reference
//     (flash_attention/ref.py keeps p in float32 for the P V einsum);
//   * masked scores take the finite sentinel -1e30 and l is floored at 1e-30
//     on output, as in the refs; a row with no unmasked key at all averages
//     v over all Sk keys, as the dense ref does with that sentinel, instead
//     of producing NaN.
// Inputs are bf16 or float32 (converted to float32 on load); O is written
// in the input type. Head dims: (D, Dv) = (64, 64) or (128, 128). When the
// caller passes an `lse` buffer (training), each row's logsumexp of its
// scaled scores, m + log(l), is written there in float32, (B, H, Sq): the
// backward kernel (flash_attention_bwd.cu) recomputes P = exp(S - lse)
// from it.
//
// Bound. At decode-like sizes (few q rows, long kv) the kernel moves bytes:
// every K/V row is read once per q tile. At long prompts it is bound by
// operations: 4 * Sq * Sk / 2 * D flops per head. This version computes with
// CUDA-core FMAs from shared memory (no tensor cores), so at long prompts it
// sits far below the 989 TFLOP/s bf16 peak; wgmma with TMA-fed shared-memory
// rings is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;      // q rows per block
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 256;     // threads per block (16 x 16)
constexpr int PAD = 4;      // row padding of the transposed tiles (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KV,
    int causal, int window, int q_offset, float sm_scale) {
  static_assert(D % 4 == 0 && DV % 64 == 0, "head dims: multiples of 64");
  constexpr int OC = DV / 16;               // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                         // [D][BQ + PAD]
  float* Kt = Qt + D * (BQ + PAD);          // [D][BK + PAD], then P [BK][BQ + PAD]
  float* Vs = Kt + D * (BK + PAD);          // [BK][DV]
  float* Ps = Kt;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D, qi = q0 + r;
    float x = 0.f;
    if (qi < Sq) x = to_f(q[((static_cast<size_t>(b) * Sq + qi) * H + h) * D + d]);
    Qt[d * (BQ + PAD) + r] = x;
  }

  // kv tiles that intersect the band of this q tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_offset + q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  float m_i[4], l_i[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();    // Q stored / the previous tile's P and V reads done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i - r * D, kj = k0 + r;
      float x = 0.f;
      if (kj < Sk) x = to_f(k[((static_cast<size_t>(b) * Sk + kj) * KV + kvh) * D + d]);
      Kt[d * (BK + PAD) + r] = x;
    }
    for (int i = tid; i < BK * DV; i += NT) {
      const int r = i / DV, d = i - r * DV, kj = k0 + r;
      float x = 0.f;
      if (kj < Sk) x = to_f(v[((static_cast<size_t>(b) * Sk + kj) * KV + kvh) * DV + d]);
      Vs[r * DV + d] = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * (BQ + PAD) + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * (BK + PAD) + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // masks, then the online-softmax update of each of the thread's 4 rows;
    // the 16 threads sharing a row are lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      const int qpos = q_offset + qi;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        bool ok = kj < Sk && qi < Sq;
        if (causal) ok = ok && qpos >= kj;
        if (window > 0) ok = ok && kj > qpos - window;
        s[i][j] = ok ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
      m_i[i] = m_new;
    }

    __syncthreads();    // every thread is done reading K before P overwrites it
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * (BQ + PAD) + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[kk * (BQ + PAD) + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c4 = 0; c4 < DV / 64; ++c4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&Vs[kk * DV + c4 * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c4 * 4 + 0] = fmaf(pv[i], v4.x, acc[i][c4 * 4 + 0]);
          acc[i][c4 * 4 + 1] = fmaf(pv[i], v4.y, acc[i][c4 * 4 + 1]);
          acc[i][c4 * 4 + 2] = fmaf(pv[i], v4.z, acc[i][c4 * 4 + 2]);
          acc[i][c4 * 4 + 3] = fmaf(pv[i], v4.w, acc[i][c4 * 4 + 3]);
        }
      }
    }
  }

  // A row with no unmasked key anywhere keeps m = -1e30. The dense ref then
  // scores all Sk keys -1e30 and averages v over them; the tiles visited
  // here cover only the band, so such rows take the mean of v over all Sk
  // keys, summed by the whole block (only when the block has such a row).
  int any_masked = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) any_masked |= (q0 + ty * 4 + i < Sq) && (m_i[i] == kNegInf);
  if (__syncthreads_or(any_masked)) {
    float* part = Vs;                       // [16][DV] column partial sums
    for (int c = tx; c < DV; c += 16) {
      float sum = 0.f;
      for (int kj = ty; kj < Sk; kj += 16)
        sum += to_f(v[((static_cast<size_t>(b) * Sk + kj) * KV + kvh) * DV + c]);
      part[ty * DV + c] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m_i[i] != kNegInf) continue;
      l_i[i] = static_cast<float>(Sk);
#pragma unroll
      for (int c4 = 0; c4 < DV / 64; ++c4)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = 0.f;
          for (int r = 0; r < 16; ++r) sum += part[r * DV + c4 * 64 + tx * 4 + e];
          acc[i][c4 * 4 + e] = sum;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float lm = fmaxf(l_i[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] = m_i[i] + logf(lm);
    T* orow = o + ((static_cast<size_t>(b) * Sq + qi) * H + h) * DV;
#pragma unroll
    for (int c4 = 0; c4 < DV / 64; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(&orow[c4 * 64 + tx * 4 + e], acc[i][c4 * 4 + e] / lm);
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float sm_scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D, DV>;
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (D * (BQ + PAD) + D * (BK + PAD) + BK * DV);
  // Set once per template instance, on the device current at its first
  // launch (the port serves on one card); the static's initialisation is
  // thread-safe, so concurrent stage actors set it once between them.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KV, causal,
      window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int Sq, int Sk, int H, int KV, int D, int Dv, int causal,
             int window, int q_offset, float sm_scale, cudaStream_t stream) {
  if (D == 64 && Dv == 64)
    return launch<T, 64, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                             window, q_offset, sm_scale, stream);
  if (D == 128 && Dv == 128)
    return launch<T, 128, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                               window, q_offset, sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts (contiguous): q (B, Sq, H, D),
// k (B, Sk, KV, D), v (B, Sk, KV, Dv), o (B, Sq, H, Dv); lse (B, H, Sq)
// float32, or null when the caller needs no backward. Launches on
// `stream`, allocates nothing, does not synchronise; returns the CUDA error
// of the launch (0 = success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
    int causal, int window, int q_offset, float sm_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse_f, B, Sq, Sk, H, KV, D, Dv, causal,
                           window, q_offset, sm_scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse_f, B, Sq, Sk, H, KV, D,
                                   Dv, causal, window, q_offset, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
