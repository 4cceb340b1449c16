// Mamba-2 SSD chunked scan for Hopper (sm_90a): the port's prefill kernel
// of every SSM layer.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py: ssd_scan_pallas (body _ssd_kernel)
// and computes what it computes, checked against the plain version
// (repro_torch/kernels/ssd_scan/ref.py: ssd_chunked_ref): per (b, h), with
// g = h / (H / G), the sequence is cut into chunks of Q = min(chunk, L) steps
// and, within a chunk, with cs = cumsum(dt * A),
//   y_diag = ((C B^T) o Lmat o dt_j) x,  Lmat[i, j] = exp(cs_i - cs_j), i >= j
//   y_off  = exp(cs_i) * C h
//   y      = y_diag + y_off + D x
//   h     <- exp(cs_last) h + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T.
// It returns y in x's dtype and the final state hT (B, H, P, N) in float32.
// The reference zero-pads the ragged last chunk (dt = 0 there: padded steps
// neither decay nor feed the state); this kernel runs that chunk over its
// valid steps only, which is the same arithmetic without the zero terms.
//
// Design. The TPU grid runs sequentially over chunks and carries h in VMEM
// scratch. Here one block loops over its chunks in order and carries its
// part of h itself; nothing is carried between blocks. Serving prefills one
// request at a time (B = 1), so a block per (b, h) would be only 32 blocks
// for mamba2-370m on 132 SMs. Every row p of h (P, N) depends only on column
// p of x, so P is split into slices of PS = 16 rows, one block per
// (slice, h, b): 128 blocks at the mamba2 prefill shape. Each slice
// recomputes the chunk's Q x Q scores C B^T, the price of the parallelism.
// The other way, the reference's two-pass form (chunk-parallel y_diag and
// chunk states, then a short scan over chunks), needs a second launch and
// the chunk states in device memory; it is the candidate when this kernel
// moves to tensor cores.
// Per chunk, with 256 threads:
//   1. load C and B (Q x N) and the block's x slice (Q x PS) into shared
//      memory as float32 (rows padded to N + 1 floats: no bank conflicts);
//   2. one warp scans cs = cumsum(dt * A) with shuffles;
//   3. scores: each thread owns an 8 x 8 register tile of rows i = ti + 16a
//      and columns j = tj + 16b and computes only the pairs with b <= a (the
//      others lie above the diagonal), then writes
//      W[i, j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j for j <= i. The mask
//      comes BEFORE the exp: cs_i - cs_j is positive above the diagonal and
//      could overflow (the Pallas body computes exp everywhere, then selects);
//   4. y: one thread per (row, p) sums W x over j <= i and C h over n, adds
//      D x, and writes y in x's dtype;
//   5. the state: each thread owns up to 8 entries of the block's (PS, N)
//      slice of h in registers for the whole sequence, updates them from B, x
//      and exp(cs_last - cs_j) dt_j, then publishes them to shared memory for
//      the next chunk's C h.
// All arithmetic is float32 FMAs on CUDA cores. Inputs x, B, C in bf16 or
// float32 (one dtype), dt, A, D float32; x, dt, B and C are read through
// element strides, so the model's views need no copy. Limits: Q <= 128,
// N <= 128 (shared memory: 216 KB at Q = N = 128).
//
// Bound. At the mamba2-370m prefill of 512 tokens the work is about 0.94
// GFLOP (C B^T and W x over the causal pairs, C h and the state update) and
// the traffic about 5.6 MB, so the card could do it in about 1.7 us, set by
// bytes. This kernel recomputes the scores for each P slice with float32
// FMAs on CUDA cores from shared memory, so it runs far above that bound;
// wgmma for its products, fed by TMA, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int PS = 16;        // rows of h (columns of x) per block
constexpr int QMAX = 128;     // longest chunk
constexpr int NMAX = 128;     // largest state size
constexpr int TILE = 8;       // score register tile is TILE x TILE
constexpr int HREG = PS * NMAX / NT;   // entries of h a thread owns

struct Strides {              // element strides of the inputs
  long long x[4];             // x (B, L, H, P)
  long long dt[3];            // dt (B, L, H)
  long long b[4];             // Bm (B, L, G, N)
  long long c[4];             // Cm (B, L, G, N)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

inline size_t smem_floats(int Q, int N) {
  const int ldn = N + 1, ldw = Q + 1;
  return static_cast<size_t>(2) * Q * ldn   // C, B
         + static_cast<size_t>(Q) * ldw     // W
         + static_cast<size_t>(Q) * PS      // x slice
         + static_cast<size_t>(PS) * ldn    // h slice
         + static_cast<size_t>(3) * Q;      // dt, cs, decay-to-end
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dv, T* __restrict__ y,
    float* __restrict__ hT, int L, int H, int P, int G, int N, int Q,
    Strides st) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldw = Q + 1;
  float* Cs = smem;                       // (Q, ldn)
  float* Bs = Cs + Q * ldn;               // (Q, ldn)
  float* Ws = Bs + Q * ldn;               // (Q, ldw)
  float* Xs = Ws + Q * ldw;               // (Q, PS)
  float* Hs = Xs + Q * PS;                // (PS, ldn)
  float* dts = Hs + PS * ldn;             // (Q)
  float* css = dts + Q;                   // (Q)
  float* decs = css + Q;                  // (Q)

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a_h = A[h], d_h = Dv[h];

  const T* xb = x + b * st.x[0] + h * st.x[2];
  const float* dtb = dt + b * st.dt[0] + h * st.dt[2];
  const T* bb = Bm + b * st.b[0] + g * st.b[2];
  const T* cb = Cm + b * st.c[0] + g * st.c[2];

  // the block's slice of h: entry e = tid + NT * k is (p, n) = (e / N, e % N)
  float hreg[HREG];
#pragma unroll
  for (int k = 0; k < HREG; ++k) hreg[k] = 0.f;
  for (int e = tid; e < PS * ldn; e += NT) Hs[e] = 0.f;

  const int ti = tid / 16, tj = tid % 16;   // score tile coordinates
  for (int t0 = 0; t0 < L; t0 += Q) {
    const int Qc = min(Q, L - t0);          // valid steps of this chunk

    // 1. loads, converted to float32
    for (int e = tid; e < Qc * N; e += NT) {
      const int i = e / N, n = e - i * N;
      const long long t = t0 + i;
      Cs[i * ldn + n] = to_f(cb[t * st.c[1] + n * st.c[3]]);
      Bs[i * ldn + n] = to_f(bb[t * st.b[1] + n * st.b[3]]);
    }
    for (int e = tid; e < Qc * PS; e += NT) {
      const int i = e / PS, p = e - i * PS;
      const long long t = t0 + i;
      Xs[e] = p0 + p < P ? to_f(xb[t * st.x[1] + (p0 + p) * st.x[3]]) : 0.f;
    }
    for (int i = tid; i < Qc; i += NT) dts[i] = dtb[(t0 + i) * st.dt[1]];
    __syncthreads();

    // 2. cs = inclusive cumsum of dt * A (one warp, QMAX / 32 steps a lane)
    if (warp == 0) {
      constexpr int PER = QMAX / 32;
      float v[PER];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = lane * PER + k;
        run += i < Qc ? dts[i] * a_h : 0.f;
        v[k] = run;
      }
      float incl = run;                     // scan of the lanes' totals
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
    __syncthreads();
    const float cs_last = css[Qc - 1];

    // 3. decay-masked scores W (lower triangle only) and decay-to-end
    {
      float acc[TILE][TILE];
#pragma unroll
      for (int a = 0; a < TILE; ++a)
#pragma unroll
        for (int c = 0; c < TILE; ++c) acc[a][c] = 0.f;
      const int nA = ti < Qc ? min(TILE, (Qc - ti + 15) / 16) : 0;
      const int nB = tj < Qc ? min(TILE, (Qc - tj + 15) / 16) : 0;
      if (nA > 0 && nB > 0) {
        for (int n = 0; n < N; ++n) {
          float cv[TILE], bv[TILE];
#pragma unroll
          for (int a = 0; a < TILE; ++a)
            cv[a] = a < nA ? Cs[(ti + 16 * a) * ldn + n] : 0.f;
#pragma unroll
          for (int c = 0; c < TILE; ++c)
            bv[c] = c < nB ? Bs[(tj + 16 * c) * ldn + n] : 0.f;
#pragma unroll
          for (int a = 0; a < TILE; ++a)
#pragma unroll
            for (int c = 0; c <= a; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < TILE; ++a) {
#pragma unroll
        for (int c = 0; c <= a; ++c) {
          const int i = ti + 16 * a, j = tj + 16 * c;
          if (a < nA && c < nB && j <= i)
            Ws[i * ldw + j] = acc[a][c] * expf(css[i] - css[j]) * dts[j];
        }
      }
    }
    for (int j = tid; j < Qc; j += NT) decs[j] = expf(cs_last - css[j]) * dts[j];
    __syncthreads();

    // 4. y = W x + exp(cs) C h + D x for the block's columns
    {
      const int p = tid % PS;
      for (int i = tid / PS; i < Qc; i += NT / PS) {
        float yd = 0.f;
        for (int j = 0; j <= i; ++j) yd = fmaf(Ws[i * ldw + j], Xs[j * PS + p], yd);
        float ch = 0.f;
        for (int n = 0; n < N; ++n) ch = fmaf(Cs[i * ldn + n], Hs[p * ldn + n], ch);
        const float out = yd + expf(css[i]) * ch + d_h * Xs[i * PS + p];
        if (p0 + p < P) {
          const long long t = t0 + i;
          from_f(out, y + ((static_cast<long long>(b) * L + t) * H + h) * P + p0 + p);
        }
      }
    }

    // 5. the state update, in registers
    const float dec_all = expf(cs_last);
#pragma unroll
    for (int k = 0; k < HREG; ++k) {
      const int e = tid + NT * k;
      if (e < PS * N) {
        const int p = e / N, n = e - p * N;
        float s = 0.f;
        for (int j = 0; j < Qc; ++j) s = fmaf(decs[j] * Xs[j * PS + p], Bs[j * ldn + n], s);
        hreg[k] = fmaf(dec_all, hreg[k], s);
      }
    }
    __syncthreads();                        // every read of this chunk is done
#pragma unroll
    for (int k = 0; k < HREG; ++k) {
      const int e = tid + NT * k;
      if (e < PS * N) {
        const int p = e / N, n = e - p * N;
        Hs[p * ldn + n] = hreg[k];
      }
    }
    // the next chunk's loads touch neither Hs nor the registers, and its
    // first read of Hs (step 4) comes after two more barriers
  }

#pragma unroll
  for (int k = 0; k < HREG; ++k) {
    const int e = tid + NT * k;
    if (e < PS * N) {
      const int p = e / N, n = e - p * N;
      if (p0 + p < P)
        hT[((static_cast<long long>(b) * H + h) * P + p0 + p) * N + n] = hreg[k];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* hT, int B, int L,
           int H, int P, int G, int N, int Q, const Strides& st,
           cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  const int smem = static_cast<int>(sizeof(float) * smem_floats(QMAX, NMAX));
  // Set once per template instance, on the device current at its first
  // launch; the static's initialisation is thread-safe.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((P + PS - 1) / PS, H, B);
  kern<<<grid, NT, sizeof(float) * smem_floats(Q, N), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(hT), L, H, P, G, N, Q, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the dtype of x, Bm, Cm and y; dt, A and
// D are float32. strides: 15 element strides, x (4), dt (3), Bm (4), Cm (4).
// Outputs (contiguous): y (B, L, H, P) in the input dtype, hT (B, H, P, N)
// float32. Q = min(chunk, L) <= 128, N <= 128, H % G == 0. Launches on
// `stream`, allocates nothing, does not synchronise; returns the CUDA error
// of the launch (0 = success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              void* y, void* hT, int dtype, int B, int L,
                              int H, int P, int G, int N, int Q,
                              const long long* strides, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > NMAX || Q <= 0 || Q > QMAX || Q > L)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 4; ++i) st.x[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.dt[i] = strides[4 + i];
  for (int i = 0; i < 4; ++i) st.b[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) st.c[i] = strides[11 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, D, y, hT, B, L, H, P, G, N, Q, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, hT, B, L, H, P, G, N,
                                 Q, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
