// Mamba-2 SSD chunked scan for Hopper (sm_90a): the port's prefill kernels
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
// neither decay nor feed the state); these kernels run that chunk over its
// valid steps only, which is the same arithmetic without the zero terms.
// Inputs x, B, C in bf16 or float32 (one dtype), dt, A, D float32; x, dt, B
// and C are read through element strides, so the model's views need no
// copy. Limits: Q <= 128, N <= 128, and P <= 128 for bf16.
//
// Two designs, chosen by the input dtype (the wrapper states the dispatch):
//   * bf16: three tensor-core (wgmma) kernels over the chunk-parallel form;
//   * float32: ssd_scan_kernel, one block per (16-row slice of P, head,
//     batch row) walking its chunks in order on CUDA cores. wgmma has no
//     float32 input, and its TF32 mode would miss the float32 checks at 1e-4.
//
// Bound. At the mamba2-370m prefill of 512 tokens (x (1, 512, 32, 64), N =
// 128) the work is about 0.94 GFLOP (C B^T and W x over the causal pairs,
// C h and the state update) and the traffic about 5.6 MB, so the card could
// do it in about 1.7 us, set by bytes. The TPU grid runs sequentially over
// chunks and carries h in VMEM; a block that walks its chunks in order does
// the same here, so at one request's prefill the card sees at most B x H x
// (P / 16) = 128 blocks that each wait on their previous chunk.
//
// bf16, chunk-parallel (ssd_tc_state_kernel, ssd_tc_carry_kernel,
// ssd_tc_out_kernel). Only the carried state is sequential, and it is an
// elementwise recurrence over P x N entries; everything else is per chunk:
//   1. state: one block (two warpgroups) per (chunk, head, batch row)
//      computes cs and the chunk's own state contribution
//      S_c = sum_j exp(cs_last - cs_j) dt_j x_j B_j^T (P x N) as a wgmma
//      with A = (w o x)^T from registers and B MN-major from shared memory,
//      and writes S_c and cs_last to a float32 scratch (4 MB at the mamba2
//      prefill shape): 128 blocks there;
//   2. carry: one thread per (b, h, p, n) runs h_c = exp(cs_last,c) h_{c-1}
//      + S_c over the chunks in float32, overwrites S_c with the state that
//      enters chunk c, and writes hT;
//   3. out: one block per (chunk, head, batch row), one warpgroup per 64
//      rows of the chunk, computes the scores C B^T once for all P (SS wgmma,
//      only the column tiles left of the diagonal), masks them BEFORE the
//      exp (cs_i - cs_j is positive above the diagonal and could overflow),
//      forms W = (C B^T) o exp(cs_i - cs_j) o dt_j in registers, and
//      accumulates y = exp(cs_i) C h_prev^T (SS wgmma, the row scale applied
//      to the accumulator) + W x (RS wgmma, x MN-major) + D x.
// Operands go to the tensor cores in bf16; x, B and C are bf16 already, so
// their products are exact in the float32 accumulators. The three operands
// formed in float32 (w o x in S_c, the carried h in C h^T, W in W x) enter
// as bf16 hi + lo pairs (x = hi + lo to 2^-17, two products each): the CPU
// emulation at the mamba2 prefill shape (tests/test_torch_ssd_tc.py) put
// one bf16 rounding of W at 5.7x chip_smoke.py's limit on y (5e-3 + 1e-2
// |ref|), of h at 2.3x, and of w o x at 23x the 1e-4 limit on hT; with the
// pairs all three stay at the float32 version's error. Tiles use the
// 128-byte swizzle of hopper_mma.cuh, rows and columns past Q, N and P
// zero-filled; x, B and C arrive by 16-byte cp.async copies when their
// rows are contiguous and 16-byte aligned (the model's views are), element
// by element otherwise. Each block issues its global loads first (dt, the
// entering state, the tiles' copies) so that one round trip covers them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_mma.cuh"
#include "ssd_tc.cuh"

namespace {

using namespace ssd;

constexpr int NT = 256;       // threads per block
constexpr int PS = 16;        // rows of h (columns of x) per block
constexpr int NMAX = 128;     // largest state size
constexpr int TILE = 8;       // score register tile is TILE x TILE
constexpr int HREG = PS * NMAX / NT;   // entries of h a thread owns

struct Strides {              // element strides of the inputs
  long long x[4];             // x (B, L, H, P)
  long long dt[3];            // dt (B, L, H)
  long long b[4];             // Bm (B, L, G, N)
  long long c[4];             // Cm (B, L, G, N)
};

inline size_t smem_floats(int Q, int N) {
  const int ldn = N + 1, ldw = Q + 1;
  return static_cast<size_t>(2) * Q * ldn   // C, B
         + static_cast<size_t>(Q) * ldw     // W
         + static_cast<size_t>(Q) * PS      // x slice
         + static_cast<size_t>(PS) * ldn    // h slice
         + static_cast<size_t>(3) * Q;      // dt, cs, decay-to-end
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs. Every row p of h (P, N) depends only on column p
// of x, so P is split into slices of PS = 16 rows, one block per (slice, h,
// b), each looping over its chunks in order with its slice of h in
// registers (and recomputing the chunk's scores). Per chunk, 256 threads:
//   1. load C and B (Q x N) and the block's x slice (Q x PS) into shared
//      memory as float32 (rows padded to N + 1 floats: no bank conflicts);
//   2. one warp scans cs = cumsum(dt * A) with shuffles;
//   3. scores: each thread owns an 8 x 8 register tile of rows i = ti + 16a
//      and columns j = tj + 16b and computes only the pairs with b <= a,
//      then writes W[i, j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j, j <= i;
//   4. y: one thread per (row, p) sums W x over j <= i and C h over n, adds
//      D x, and writes y in x's dtype;
//   5. the state: each thread updates its entries of the block's (PS, N)
//      slice of h from B, x and exp(cs_last - cs_j) dt_j, then publishes
//      them to shared memory for the next chunk's C h.
// Shared memory: 216 KB at Q = N = 128.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT, 1) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dv,
    float* __restrict__ y, float* __restrict__ hT, int L, int H, int P, int G,
    int N, int Q, Strides st) {
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

  const float* xb = x + b * st.x[0] + h * st.x[2];
  const float* dtb = dt + b * st.dt[0] + h * st.dt[2];
  const float* bb = Bm + b * st.b[0] + g * st.b[2];
  const float* cb = Cm + b * st.c[0] + g * st.c[2];

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
      Cs[i * ldn + n] = cb[t * st.c[1] + n * st.c[3]];
      Bs[i * ldn + n] = bb[t * st.b[1] + n * st.b[3]];
    }
    for (int e = tid; e < Qc * PS; e += NT) {
      const int i = e / PS, p = e - i * PS;
      const long long t = t0 + i;
      Xs[e] = p0 + p < P ? xb[t * st.x[1] + (p0 + p) * st.x[3]] : 0.f;
    }
    for (int i = tid; i < Qc; i += NT) dts[i] = dtb[(t0 + i) * st.dt[1]];
    __syncthreads();

    // 2. cs = inclusive cumsum of dt * A
    if (warp == 0) chunk_cumsum(dts, css, a_h, Qc, lane);
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
          y[((static_cast<long long>(b) * L + t) * H + h) * P + p0 + p] = out;
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

int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* D, void* y, void* hT, int B, int L,
               int H, int P, int G, int N, int Q, const Strides& st,
               cudaStream_t stream) {
  auto kern = ssd_scan_kernel;
  const int smem = static_cast<int>(sizeof(float) * smem_floats(QMAX, NMAX));
  // Set once, on the device current at the first launch; the static's
  // initialisation is thread-safe.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((P + PS - 1) / PS, H, B);
  kern<<<grid, NT, sizeof(float) * smem_floats(Q, N), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<float*>(hT), L, H, P, G, N, Q, st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, chunk-parallel (see the header). Tiles are TQ = 128
// rows of a chunk (or 64 PP rows of P for h) by 64-column panels, swizzled
// as in hopper_mma.cuh; PP = P panels (1 or 2), NP = N panels (1 or 2).
// The device code these kernels share with the backward's tensor-core
// kernels (tiles, cumsum, the chunk state product, h as hi + lo tiles) is
// ssd_tc.cuh.
// ---------------------------------------------------------------------------
struct TcArgs {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* Bm;
  const __nv_bfloat16* Cm;
  const float* D;
  __nv_bfloat16* y;
  float* hT;
  float* states;               // (B, H, nc, P, N): S_c, then the entering h
  float* totals;               // (B, H, nc): cs_last of each chunk
  int L, H, P, G, N, Q, nc, NP;
  int vec_x, vec_b, vec_c;     // rows contiguous and 16-byte aligned
  Strides st;
};

// this thread's dt of the chunk, row threadIdx.x (0 past Qc; TQ <= TC_NT),
// loaded first so its latency overlaps the tiles' copies
__device__ __forceinline__ float load_dt(const TcArgs& a, int b, int h,
                                         int t0, int Qc) {
  const int i = threadIdx.x;
  return i < Qc ? a.dt[b * a.st.dt[0] + (t0 + i) * a.st.dt[1] + h * a.st.dt[2]]
                : 0.f;
}

// shared memory of each kernel, with the 1024 bytes the swizzle's alignment
// may take
template <int PP>
inline int state_smem(int NP) {
  return TQ * 128 * NP + TQ * 128 * PP + 3 * TQ * 4 + 1024;
}
template <int PP>
inline int out_smem(int NP) {
  return 2 * TQ * 128 * NP + TQ * 128 * PP + 2 * 64 * PP * 128 * NP +
         2 * TQ * 4 + 1024;
}

// Pass 1: per (chunk, head, batch row), S_c (P x N) = (w o x)^T B with
// w_j = exp(cs_last - cs_j) dt_j, and cs_last.
template <int PP>
__global__ void __launch_bounds__(TC_NT, 1) ssd_tc_state_kernel(TcArgs a) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sB = align1024(smem_raw);          // TQ x 64 NP, swizzled
  uint8_t* sX = sB + TQ * 128 * a.NP;         // TQ x 64 PP
  float* dts = reinterpret_cast<float*>(sX + TQ * 128 * PP);
  float* css = dts + TQ;
  float* w = css + TQ;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int t0 = c * a.Q, Qc = min(a.Q, a.L - t0);
  const Strides& st = a.st;
  const float dtv = load_dt(a, b, h, t0, Qc);
  load_rows(sB, a.Bm + b * st.b[0] + t0 * st.b[1] + g * st.b[2], st.b[1],
            st.b[3], Qc, a.N, a.NP, a.vec_b);
  load_rows(sX, a.x + b * st.x[0] + t0 * st.x[1] + h * st.x[2], st.x[1],
            st.x[3], Qc, a.P, PP, a.vec_x);
  cp_async_commit();
  store_dt_cs(dtv, a.A[h], Qc, dts, css);
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const float cs_last = css[Qc - 1];
  for (int j = threadIdx.x; j < TQ; j += TC_NT)
    w[j] = j < Qc ? exp_(cs_last - css[j]) * dts[j] : 0.f;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  if (threadIdx.x == 0) a.totals[bh * a.nc + c] = cs_last;
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int ksteps = (Qc + 15) / 16;
  const uint32_t sBa = smem_u32(sB);
  float* out = a.states + (bh * a.nc + c) * a.P * a.N;
  for (int item = wg; item < PP * a.NP; item += 2) {
    const int pp = item / a.NP, np = item - pp * a.NP;
    float acc[32];
    scaled_state_tile(acc, sX, w, sBa, pp, np, ksteps);
    store_state_tile(acc, out, pp, np, a.P, a.N);
  }
}

// Pass 2: per (b, h, p, n), the carry over the chunks in float32; S_c is
// overwritten with the state that enters chunk c, and hT gets the last.
__global__ void __launch_bounds__(TC_NT) ssd_tc_carry_kernel(
    float* __restrict__ states, const float* __restrict__ totals,
    float* __restrict__ hT, int H, int nc, int PN) {
  const int e = blockIdx.x * TC_NT + threadIdx.x;
  if (e >= PN) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  float* s = states + bh * nc * PN + e;
  const float* tot = totals + bh * nc;
  float hv = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 4) {        // four chunks' loads at once
    float sc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sc[k] = c0 + k < nc ? s[static_cast<size_t>(c0 + k) * PN] : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= nc) break;
      s[static_cast<size_t>(c0 + k) * PN] = hv;
      hv = hv * expf(tot[c0 + k]) + sc[k];
    }
  }
  hT[bh * PN + e] = hv;
}

// Pass 3: per (chunk, head, batch row), y = exp(cs_i) C h_prev^T + W x +
// D x; warpgroup wg owns the chunk's rows 64 wg .. 64 wg + 63.
template <int PP>
__global__ void __launch_bounds__(TC_NT, 1) ssd_tc_out_kernel(TcArgs a) {
  using namespace hopper;
  constexpr int HR = 64 * PP;                 // rows of the h tiles
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sC = align1024(smem_raw);          // TQ x 64 NP
  uint8_t* sB = sC + TQ * 128 * a.NP;         // TQ x 64 NP
  uint8_t* sX = sB + TQ * 128 * a.NP;         // TQ x 64 PP
  uint8_t* sHhi = sX + TQ * 128 * PP;         // HR x 64 NP
  uint8_t* sHlo = sHhi + HR * 128 * a.NP;     // HR x 64 NP
  float* dts = reinterpret_cast<float*>(sHlo + HR * 128 * a.NP);
  float* css = dts + TQ;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int t0 = c * a.Q, Qc = min(a.Q, a.L - t0);
  const Strides& st = a.st;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const float dtv = load_dt(a, b, h, t0, Qc);
  // the entering state h (P x N, float32), to become bf16 hi + lo tiles:
  // the thread's loads (8 floats for each 16-byte chunk of the tiles) go
  // out before the tiles' copies, the stores come after them
  const float* hs = a.states + (bh * a.nc + c) * a.P * a.N;
  float v[kStateChunks<HR>][8];
  if (c > 0) fetch_state<HR>(v, hs, a.P, a.N, a.NP);
  load_rows(sC, a.Cm + b * st.c[0] + t0 * st.c[1] + g * st.c[2], st.c[1],
            st.c[3], Qc, a.N, a.NP, a.vec_c);
  load_rows(sB, a.Bm + b * st.b[0] + t0 * st.b[1] + g * st.b[2], st.b[1],
            st.b[3], Qc, a.N, a.NP, a.vec_b);
  load_rows(sX, a.x + b * st.x[0] + t0 * st.x[1] + h * st.x[2], st.x[1],
            st.x[3], Qc, a.P, PP, a.vec_x);
  cp_async_commit();
  if (c > 0) store_state_hilo<HR>(v, sHhi, sHlo, a.NP);
  store_dt_cs(dtv, a.A[h], Qc, dts, css);
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int r0 = 64 * wg;
  if (r0 >= Qc) return;                       // no row of this warpgroup
  const uint32_t sCa = smem_u32(sC) + r0 * 128, sBa = smem_u32(sB);
  const uint32_t sXa = smem_u32(sX);
  const int nk = 4 * a.NP;                    // k-steps over N

  // scores s[jb] = C B^T over the column tiles jb <= wg (the causal band),
  // and y = C h_prev^T
  float s[2][32], y[PP][32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[0][e] = s[1][e] = 0.f;
#pragma unroll
    for (int pp = 0; pp < PP; ++pp) y[pp][e] = 0.f;
  }
  wgmma_fence();
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (jb > wg) break;
    for (int kk = 0; kk < nk; ++kk)
      wgmma_ss_n64(s[jb], kstep_kmajor<TQ>(sCa, kk),
                   kstep_kmajor<TQ>(sBa + jb * 64 * 128, kk), 1);
  }
  if (c > 0) {
#pragma unroll
    for (int pp = 0; pp < PP; ++pp)
      for (int kk = 0; kk < nk; ++kk) {
        const uint64_t da = kstep_kmajor<TQ>(sCa, kk);
        wgmma_ss_n64(y[pp], da, kstep_kmajor<HR>(smem_u32(sHhi) + pp * 64 * 128, kk), 1);
        wgmma_ss_n64(y[pp], da, kstep_kmajor<HR>(smem_u32(sHlo) + pp * 64 * 128, kk), 1);
      }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s[0]);
  fence_regs(s[1]);
#pragma unroll
  for (int pp = 0; pp < PP; ++pp) fence_regs(y[pp]);

  // this thread's rows i = r0 + 16 warp + gq + 8 hh
  float cs_i[2], dec_i[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r0 + 16 * warp + gq + 8 * hh;
    cs_i[hh] = i < Qc ? css[i] : 0.f;
    dec_i[hh] = i < Qc ? exp_(cs_i[hh]) : 0.f;
  }
  if (c > 0) {
#pragma unroll
    for (int pp = 0; pp < PP; ++pp)
#pragma unroll
      for (int e = 0; e < 32; ++e) y[pp][e] *= dec_i[(e >> 1) & 1];
  }

  // W = s o exp(cs_i - cs_j) o dt_j on j <= i < Qc (masked before the exp),
  // as bf16 hi + lo A fragments
  uint32_t whi[2][4][4], wlo[2][4][4];
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (jb > wg) break;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      const int i = r0 + 16 * warp + gq + 8 * hh;
      const int j = 64 * jb + 8 * (e >> 2) + 2 * tq + (e & 1);
      s[jb][e] = j <= i && i < Qc
          ? s[jb][e] * exp_(cs_i[hh] - css[j]) * dts[j] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag_hilo(s[jb], kk, whi[jb][kk], wlo[jb][kk]);
  }
  wgmma_fence();
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (jb > wg) break;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pp = 0; pp < PP; ++pp) {
        const uint64_t db = kstep_mnmajor<TQ>(sXa + pp * TQ * 128, 4 * jb + kk);
        wgmma_rs_n64(y[pp], whi[jb][kk], db);
        wgmma_rs_n64(y[pp], wlo[jb][kk], db);
      }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int pp = 0; pp < PP; ++pp) fence_regs(y[pp]);

  // y += D x; write y (B, L, H, P) in bf16
  const float d_h = a.D[h];
#pragma unroll
  for (int pp = 0; pp < PP; ++pp)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = r0 + 16 * warp + gq + 8 * ((e >> 1) & 1);
      const int p = 64 * pp + 8 * (e >> 2) + 2 * tq;
      if (i >= Qc || p >= a.P) continue;
      __nv_bfloat16* yr = a.y + ((static_cast<size_t>(b) * a.L + t0 + i) * a.H + h) * a.P + p;
      if (p + 1 < a.P) {
        const float2 xv = tile_pair<TQ>(sX, i, p);
        const float o0 = y[pp][e] + d_h * xv.x, o1 = y[pp][e + 1] + d_h * xv.y;
        if (a.P % 2 == 0)
          *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(o0, o1);
        else {
          yr[0] = __float2bfloat16(o0);
          yr[1] = __float2bfloat16(o1);
        }
      } else {
        yr[0] = __float2bfloat16(y[pp][e] + d_h * tile_at<TQ>(sX, i, p));
      }
    }
}

// Sets each kernel's shared-memory attribute once per template instance (to
// its largest size, NP = 2), on the device current at its first launch.
template <int PP>
int launch_tc(TcArgs& a, int B, cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_state_kernel<PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        state_smem<PP>(2));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_tc_out_kernel<PP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                out_smem<PP>(2));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.nc, a.H, B);
  ssd_tc_state_kernel<PP><<<grid, TC_NT, state_smem<PP>(a.NP), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int PN = a.P * a.N;
  ssd_tc_carry_kernel<<<dim3((PN + TC_NT - 1) / TC_NT, a.H, B), TC_NT, 0,
                        stream>>>(a.states, a.totals, a.hT, a.H, a.nc, PN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_tc_out_kernel<PP><<<grid, TC_NT, out_smem<PP>(a.NP), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// rows of a strided bf16 matrix can be copied in 16-byte loads: columns
// contiguous, a multiple of 8 of them, every row start 16-byte aligned
bool rows_vec(const void* p, const long long* s, int ndim, int ncols) {
  bool ok = s[ndim - 1] == 1 && ncols % 8 == 0 &&
            reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < ndim - 1; ++i) ok = ok && s[i] % 8 == 0;
  return ok;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the three
// tensor-core kernels), the dtype of x, Bm, Cm and y; dt, A and D are
// float32. strides: 15 element strides, x (4), dt (3), Bm (4), Cm (4).
// Outputs (contiguous): y (B, L, H, P) in the input dtype, hT (B, H, P, N)
// float32. scratch (bf16 only; float32 ignores it): B H nc (P N + 1) floats,
// nc = ceil(L / Q). Q = min(chunk, L) <= 128, N <= 128, H % G == 0, and
// P <= 128 for bf16. Launches on `stream`,
// allocates nothing, does not synchronise; returns the CUDA error of the
// launch (0 = success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              void* y, void* hT, void* scratch, int dtype,
                              int B, int L, int H, int P, int G, int N, int Q,
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
    return launch_f32(x, dt, A, Bm, Cm, D, y, hT, B, L, H, P, G, N, Q, st, s);
  if (dtype != 1 || P > 128 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const __nv_bfloat16*>(Bm);
  a.Cm = static_cast<const __nv_bfloat16*>(Cm);
  a.D = static_cast<const float*>(D);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.hT = static_cast<float*>(hT);
  a.L = L;
  a.H = H;
  a.P = P;
  a.G = G;
  a.N = N;
  a.Q = Q;
  a.nc = (L + Q - 1) / Q;
  a.NP = (N + 63) / 64;
  a.states = static_cast<float*>(scratch);
  a.totals = a.states + static_cast<size_t>(B) * H * a.nc * P * N;
  a.vec_x = rows_vec(x, st.x, 4, P);
  a.vec_b = rows_vec(Bm, st.b, 4, N);
  a.vec_c = rows_vec(Cm, st.c, 4, N);
  a.st = st;
  return P <= 64 ? launch_tc<1>(a, B, s) : launch_tc<2>(a, B, s);
}
