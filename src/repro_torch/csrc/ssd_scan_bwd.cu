// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a): the gradient of
// every SSM layer's scan in training.
//
// It replaces no Pallas kernel. The TPU reference trains by autodiff through
// the jnp chunked form (src/repro/kernels/ssd_scan/ref.py: ssd_chunked_ref);
// the port's forward is a kernel (ssd_scan.cu), which autograd cannot
// differentiate, so its gradient is written by hand here, under
// repro_torch/kernels/ssd_scan/kernel.py: SsdScan. Its plain version is
// repro_torch/kernels/ssd_scan/ref.py: ssd_chunked_bwd_ref, which follows
// the same decomposition. Given dy (B, L, H, P) and dhT (B, H, P, N; null is
// zero) it returns dx, ddt, dA, dB, dC and dD of y and hT. Per (b, h) and
// chunk c of Q steps, with a = dt A, cs its inclusive cumsum in the chunk,
// T_c = cs_last and w_j = exp(T_c - cs_j) dt_j, the CUDA-core route runs:
//   1. state: one block per (chunk, head, batch row) computes the chunk's
//      own state S_c = sum_j w_j x_j B_j^T and the reverse carry's input
//      U_c = sum_i exp(cs_i) dy_i C_i^T (P x N each) and T_c;
//   2. carry: one thread per (b, h, p, n) runs the forward recurrence
//      h_{c+1} = exp(T_c) h_c + S_c over the chunks, leaving in place of S_c
//      the state h_c that enters chunk c, then the reverse one g_{c-1} =
//      exp(T_c) g_c + U_c from g = dhT, leaving in place of U_c the
//      gradient g_c of the state that leaves chunk c. The chunk states are
//      recomputed here, not kept from the forward: the float32 forward
//      keeps none, and at the training shape (x (2, 2048, 32, 64), N = 128)
//      they would be 2 x 16 chunks x 32 heads x 64 x 128 x 4 B = 33.6 MB a
//      layer held from each forward to its backward;
//   3. inter: per (chunk, head, batch row), the carried state's terms: dC_i
//      += exp(cs_i) h_c^T dy_i, dB_j += w_j g_c^T x_j, dx_j += w_j g_c B_j,
//      and the scalars that feed the decays (dw_j = x_j . g_c B_j, the
//      gradient of cs_i through exp(cs_i) C_i h_c, and of T_c);
//   4. intra: per (chunk, head, batch row), the Q x Q term: M = C B^T,
//      dW = dy x^T on j <= i, W = M o exp(cs_i - cs_j) o dt_j, dM = dW o
//      exp(cs_i - cs_j) o dt_j; dC += dM B, dB += dM^T C, dx += W^T dy +
//      D dy; the gradient of cs (R = dW o W by rows minus by columns, plus
//      pass 3's), turned into that of a by a reverse cumsum in the chunk
//      (T_c = cs_last adds to every step), ddt = its direct terms + A da,
//      and per-block partials of dA = sum dt da and dD = sum dy x;
//   5. reduce: dB and dC summed over the H / G heads of each group, in head
//      order, and cast to the input dtype; dA and dD summed over their
//      partials in (b, chunk) order.
// In the CUDA-core route passes 3 and 4 write their per-head dB, dC (and
// pass 3 its dx term) to a float32 scratch, which the later pass reads
// back: no atomics, so a call gives the same bits on every run. The ragged
// last chunk runs over its valid steps (the reference's zero-padded steps
// contribute nothing).
//
// Two routes, chosen by the input dtype and shape (the wrapper states the
// dispatch; nothing switches routes on an error):
//   * bf16 where the chunk pass's tiles fit (P <= 64, or P <= 128 with N <=
//     64): four kernels, the products on the tensor cores (wgmma):
//     ssd_bwd_tc_state_kernel, the carry above, ssd_bwd_tc_chunk_kernel,
//     and the reduce above;
//   * float32, and bf16 past those tiles (P > 64 with N > 64, or P > 128):
//     the five CUDA-core kernels below (state, carry, inter, intra, reduce),
//     float32 FMAs throughout: wgmma takes no float32, and its TF32 mode
//     would miss the float32 checks at 1e-4.
//
// Bound. At the training shape (x (2, 2048, 32, 64) bf16, B and C (2, 2048,
// 1, 128), chunk 128) the work these inputs need is about 19.4 GFLOP: per
// (b, chunk, h), Q^2 (3N + 2P) / 2 multiply-adds for the causal Q x Q
// products (M, dW, dC, dB, dx) and 5 Q P N for the state ones (S_c, U_c,
// and the carried states' terms dy h, x g and B g^T; the carried part of
// the gradient of cs is read off dC's first term, no product of its own);
// the bytes are about 56 MB (x, dy and dx bf16, B, C and their gradients,
// dt and ddt). On the tensor cores that would take 0.0196 ms (operations)
// against 0.017 ms of bytes. The CUDA-core route runs every product on CUDA
// cores (about 0.3 ms at their 67 TFLOP/s peak, 2.8-3.4 ms measured at this
// shape on bf16 inputs): each block keeps its chunk's B and C (and its Q x Q
// matrix) in shared memory as float32 and walks P in tiles; register tiles
// of 8 x 8 (or 4 x 4) outputs a thread reuse each shared load.
//
// The bf16 route, what bounds it and how it is built. Its float32 scratch
// and the per-head dB and dC partials set the bytes (about 0.27 GB moved
// at the training shape: 67 MB of chunk states written and read twice,
// 134 MB of partials written once and read once), the products the time
// of the tensor cores; the design keeps every product on wgmma and reads
// the chunk's tiles once:
//   1. state (tensor cores): one block (two warpgroups) per (chunk, head,
//      batch row) computes S_c = (w o x)^T B and U_c = (e o dy)^T C, e_i =
//      exp(cs_i), with the forward's chunk state product (ssd_tc.cuh:
//      scaled_state_tile), and T_c;
//   2. carry: as the CUDA-core route's;
//   3. chunk (tensor cores): one block per (chunk, head, batch row) loads
//      the chunk's C, B, x and dy tiles and its h_c and g_c once and
//      computes, warpgroup wg owning the chunk's rows 64 wg .. 64 wg + 63:
//      M = C B^T and dW = dy x^T (SS wgmma over the column tiles left of
//      the diagonal); W, dM, R and the column sums in registers, the mask
//      applied before the exp (cs_i - cs_j > 0 above the diagonal); then,
//      staging dM and later W in one Q x Q bf16 tile that serves a product
//      K-major and its transpose MN-major, dC = e o (dy h) + dM B, dB = w o
//      (x g) + dM^T C and dx = w o (B g^T) + W^T dy + D dy, the row scales
//      applied to the accumulators; the gradient of cs (the carried
//      state's part e_i (dy h)_i . C_i read off dC's first term, dw_j = (x
//      g)_j . B_j off dB's), the reverse cumsum and ddt, written directly,
//      with dx in bf16; dB and dC as per-head float32 partials, dA and dD
//      as per-block ones;
//   4. reduce: as the CUDA-core route's.
// The chunk pass takes P <= 64, or P <= 128 with N <= 64: its tiles (C, B,
// x, dy, h and g as hi + lo, the Q x Q tile, 210 KB at P 64, N 128) must
// fit in one block's 227 KB (at P 128, N 128 they would take 290 KB). Past
// that, bf16 runs the CUDA-core kernels, which take any P.
// Operands. x, dy, B and C are bf16 already, so M, dW and every product of
// two of them are exact in the float32 accumulators. The operands formed
// in float32 enter as bf16 hi + lo pairs (x = hi + lo to about 2^-17, two
// products each) where they feed a float32 gradient: w o x and e o dy in
// the state pass, h in dy h and g in x g (both feed ddt and dA through the
// gradient of cs and dw); one bf16 rounding of any one of them takes ddt
// or dA past the 1e-4 check. g in B g^T, dM and W feed only the bf16
// outputs dx, dB and dC, where one rounding stays within a quarter of the
// 1e-2 check, so they enter as one bf16 value each (the CPU emulation of
// both claims: tests/test_torch_ssd_bwd_tc.py).
// dB and dC over a group's heads: the chunk pass writes each head's terms
// to a float32 scratch (B, L, H, N) and the reduce sums them in head order,
// one thread per output element: no atomics, so a call gives the same bits
// on every run. One block per head keeps B x nc x H = 1,024 blocks at the
// training shape (a block per group would leave 32 for 132 SMs). The
// call's scratch there: 67 MB of chunk states, 134 MB of partials, 201 MB
// in all (the CUDA-core layout would take 236 MB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_mma.cuh"
#include "ssd_tc.cuh"

namespace {

using namespace ssd;

constexpr int NT = 256;       // threads per block
constexpr int NMAX = 128;     // largest state size
constexpr int PT3 = 32;       // rows of P per tile in passes 1 and 3
constexpr int PT4 = 16;       // columns of P per tile in pass 4

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* x;          // (B, L, H, P), x's dtype
  const float* dt;        // (B, L, H)
  const float* A;         // (H)
  const void* Bm;         // (B, L, G, N), x's dtype
  const void* Cm;         // (B, L, G, N)
  const float* D;         // (H)
  const void* dy;         // (B, L, H, P), x's dtype
  const float* dhT;       // (B, H, P, N) or null
  void* dx;               // (B, L, H, P), x's dtype
  float* ddt;             // (B, L, H)
  float* dA;              // (H)
  void* dBm;              // (B, L, G, N), x's dtype
  void* dCm;              // (B, L, G, N)
  float* dD;              // (H)
  // float32 scratch
  float* states;          // (B, H, nc, P, N): S_c, then the entering h_c
  float* gstates;         // (B, H, nc, P, N): U_c, then the leaving g_c
  float* totals;          // (B, H, nc): T_c
  float* dxs;             // (B, L, H, P): pass 3's dx term
  float* dBh;             // (B, L, H, N): per head dB
  float* dCh;             // (B, L, H, N): per head dC
  float* ddt3;            // (B, L, H): pass 3's direct ddt term
  float* dcs3;            // (B, L, H): pass 3's gradient of cs
  float* dT3;             // (B, H, nc): the gradient of T_c
  float* partA;           // (B, nc, H)
  float* partD;           // (B, nc, H)
  int B, L, H, P, G, N, Q, nc;
  int NP;                 // bf16 route: panels of 64 columns of N (1 or 2)
  int vec_x, vec_b;       // bf16 route: x, dy (B, C) rows 16-byte copies
};

// out[i] = sum of v[i..Qc-1] for i < Qc <= QMAX, by one warp
__device__ __forceinline__ void reverse_cumsum(const float* v, float* out,
                                               int Qc, int lane) {
  constexpr int PER = QMAX / 32;
  float run = 0.f;
#pragma unroll
  for (int k = PER - 1; k >= 0; --k) {
    const int i = lane * PER + k;
    run += i < Qc ? v[i] : 0.f;
  }
  float incl = run;                         // lanes >= this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += o;
  }
  float acc = incl - run;                   // lanes after this one
#pragma unroll
  for (int k = PER - 1; k >= 0; --k) {
    const int i = lane * PER + k;
    if (i < Qc) {
      acc += v[i];
      out[i] = acc;
    }
  }
}

// sum over the block (NT threads); every thread gets it. `red` holds
// NT / 32 floats; the call begins and ends with a barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
  __syncthreads();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// rows [t0, t0 + Qc) of a (B, L, G or H, cols) tensor at (b, g), as float32
// into dst (QMAX rows of ld floats, rows >= Qc and columns >= ncols zero);
// `cols` is the row length in memory, [c0, c0 + ncols) the columns taken
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t row0, size_t row_stride,
                                          int Qc, int c0, int ncols, int width,
                                          int nrows) {
  for (int e = threadIdx.x; e < nrows * width; e += NT) {
    const int i = e / width, k = e - i * width;
    dst[i * ld + k] = i < Qc && k < ncols
        ? to_f(src[row0 + i * row_stride + c0 + k]) : 0.f;
  }
}

// the chunk's dt, cs, and its block coordinates
struct Chunk {
  int c, h, b, g, t0, Qc;
  float a_h, T;
};

__device__ __forceinline__ Chunk chunk_setup(const Args& a, float* dts,
                                             float* css) {
  Chunk k;
  k.c = blockIdx.x;
  k.h = blockIdx.y;
  k.b = blockIdx.z;
  k.g = k.h / (a.H / a.G);
  k.t0 = k.c * a.Q;
  k.Qc = min(a.Q, a.L - k.t0);
  k.a_h = a.A[k.h];
  for (int i = threadIdx.x; i < QMAX; i += NT)
    dts[i] = i < k.Qc
        ? a.dt[(static_cast<size_t>(k.b) * a.L + k.t0 + i) * a.H + k.h] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, css, k.a_h, k.Qc, threadIdx.x);
  __syncthreads();
  k.T = css[k.Qc - 1];
  return k;
}

// ---------------------------------------------------------------------------
// Pass 1: S_c = sum_j w_j x_j B_j^T and U_c = sum_i exp(cs_i) dy_i C_i^T.
// Thread (pr = tid / 32, nl = tid % 32) owns rows p = pr + 8 a (a < 4) of a
// P tile and columns n = nl + 32 k (k < 4).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_state_kernel(Args a) {
  extern __shared__ float smem[];
  const int ldn = a.N + 1, ldp = PT3 + 1;
  float* Bs = smem;                        // (QMAX, ldn)
  float* Cs = Bs + QMAX * ldn;             // (QMAX, ldn)
  float* Xs = Cs + QMAX * ldn;             // (QMAX, ldp)
  float* Ys = Xs + QMAX * ldp;             // (QMAX, ldp)
  float* dts = Ys + QMAX * ldp;
  float* css = dts + QMAX;
  float* ws = css + QMAX;
  float* es = ws + QMAX;

  const Chunk k = chunk_setup(a, dts, css);
  const size_t brow = (static_cast<size_t>(k.b) * a.L + k.t0) * a.G + k.g;
  const size_t hrow = (static_cast<size_t>(k.b) * a.L + k.t0) * a.H + k.h;
  load_rows(Bs, ldn, static_cast<const T*>(a.Bm), brow * a.N,
            static_cast<size_t>(a.G) * a.N, k.Qc, 0, a.N, a.N, QMAX);
  load_rows(Cs, ldn, static_cast<const T*>(a.Cm), brow * a.N,
            static_cast<size_t>(a.G) * a.N, k.Qc, 0, a.N, a.N, QMAX);
  for (int i = threadIdx.x; i < QMAX; i += NT) {
    ws[i] = i < k.Qc ? expf(k.T - css[i]) * dts[i] : 0.f;
    es[i] = i < k.Qc ? expf(css[i]) : 0.f;
  }
  const size_t bh = static_cast<size_t>(k.b) * a.H + k.h;
  if (threadIdx.x == 0) a.totals[bh * a.nc + k.c] = k.T;

  const int pr = threadIdx.x / 32, nl = threadIdx.x % 32;
  const size_t sbase = (bh * a.nc + k.c) * static_cast<size_t>(a.P) * a.N;
  for (int p0 = 0; p0 < a.P; p0 += PT3) {
    __syncthreads();                        // the previous tile is read
    load_rows(Xs, ldp, static_cast<const T*>(a.x), hrow * a.P,
              static_cast<size_t>(a.H) * a.P, k.Qc, p0, min(PT3, a.P - p0),
              PT3, QMAX);
    load_rows(Ys, ldp, static_cast<const T*>(a.dy), hrow * a.P,
              static_cast<size_t>(a.H) * a.P, k.Qc, p0, min(PT3, a.P - p0),
              PT3, QMAX);
    __syncthreads();
    float s[4][4], u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = u[i][j] = 0.f;
    for (int j = 0; j < k.Qc; ++j) {
      float xv[4], yv[4], bv[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = ws[j] * Xs[j * ldp + pr + 8 * i];
        yv[i] = es[j] * Ys[j * ldp + pr + 8 * i];
        bv[i] = Bs[j * ldn + min(nl + 32 * i, a.N)];
        cv[i] = Cs[j * ldn + min(nl + 32 * i, a.N)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[i][q] = fmaf(xv[i], bv[q], s[i][q]);
          u[i][q] = fmaf(yv[i], cv[q], u[i][q]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + pr + 8 * i;
      if (p >= a.P) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = nl + 32 * q;
        if (n >= a.N) continue;
        a.states[sbase + static_cast<size_t>(p) * a.N + n] = s[i][q];
        a.gstates[sbase + static_cast<size_t>(p) * a.N + n] = u[i][q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: per (b, h, p, n) the forward carry (S_c -> the entering h_c) and
// the reverse one (U_c -> the gradient g_c of the leaving state).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) ssd_bwd_carry_kernel(Args a) {
  const int PN = a.P * a.N;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= PN) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * a.H + blockIdx.y;
  float* s = a.states + bh * a.nc * PN + e;
  float* u = a.gstates + bh * a.nc * PN + e;
  const float* tot = a.totals + bh * a.nc;
  // four chunks' loads go out before their stores, as the forward's carry
  float hv = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += 4) {
    float sc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sc[k] = c0 + k < a.nc ? s[static_cast<size_t>(c0 + k) * PN] : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= a.nc) break;
      s[static_cast<size_t>(c0 + k) * PN] = hv;
      hv = hv * expf(tot[c0 + k]) + sc[k];
    }
  }
  float g = a.dhT == nullptr ? 0.f : a.dhT[bh * PN + e];
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= 4) {
    float uc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      uc[k] = c0 - k >= 0 ? u[static_cast<size_t>(c0 - k) * PN] : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 - k < 0) break;
      u[static_cast<size_t>(c0 - k) * PN] = g;
      g = g * expf(tot[c0 - k]) + uc[k];
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: the carried state's terms, over P in tiles of PT3 rows.
//   dC3[i][n] = exp(cs_i) sum_p dy_i[p] h[p][n]    (thread: rows
//   dB3[j][n] = w_j sum_p x_j[p] g[p][n]            tid/16 + 16 a, columns
//                                                   tid%16 + 16 q, 8 x 8)
//   gB[j][p] = sum_n g[p][n] B_j[n]: dx3 = w_j gB, dw_j = x_j . gB
//   hC[i][p] = sum_n h[p][n] C_i[n]: dcs_i += exp(cs_i) dy_i . hC
//                                   (thread: rows tid/8 + 32 a, P columns
//                                    tid%8 + 8 q of the tile, 4 x 4)
//   dT = exp(T) <g, h> + sum_j w_j dw_j
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_inter_kernel(Args a) {
  extern __shared__ float smem[];
  const int ldn = a.N + 1, ldp = PT3 + 1;
  float* Bs = smem;                        // (QMAX, ldn)
  float* Cs = Bs + QMAX * ldn;             // (QMAX, ldn)
  float* Hs = Cs + QMAX * ldn;             // (PT3, ldn): h_c rows of a tile
  float* Gs = Hs + PT3 * ldn;              // (PT3, ldn): g_c rows
  float* Xs = Gs + PT3 * ldn;              // (QMAX, ldp)
  float* Ys = Xs + QMAX * ldp;             // (QMAX, ldp)
  float* dts = Ys + QMAX * ldp;
  float* css = dts + QMAX;
  float* ws = css + QMAX;
  float* es = ws + QMAX;
  float* dws = es + QMAX;
  float* dcs = dws + QMAX;
  float* red = dcs + QMAX;                 // NT / 32

  const Chunk k = chunk_setup(a, dts, css);
  const size_t brow = (static_cast<size_t>(k.b) * a.L + k.t0) * a.G + k.g;
  const size_t hrow = (static_cast<size_t>(k.b) * a.L + k.t0) * a.H + k.h;
  load_rows(Bs, ldn, static_cast<const T*>(a.Bm), brow * a.N,
            static_cast<size_t>(a.G) * a.N, k.Qc, 0, a.N, a.N, QMAX);
  load_rows(Cs, ldn, static_cast<const T*>(a.Cm), brow * a.N,
            static_cast<size_t>(a.G) * a.N, k.Qc, 0, a.N, a.N, QMAX);
  for (int i = threadIdx.x; i < QMAX; i += NT) {
    ws[i] = i < k.Qc ? expf(k.T - css[i]) * dts[i] : 0.f;
    es[i] = i < k.Qc ? expf(css[i]) : 0.f;
  }
  const size_t bh = static_cast<size_t>(k.b) * a.H + k.h;
  const size_t sbase = (bh * a.nc + k.c) * static_cast<size_t>(a.P) * a.N;

  const int r8 = threadIdx.x / 16, c8 = threadIdx.x % 16;   // 8 x 8 tiles
  const int r4 = threadIdx.x / 8, c4 = threadIdx.x % 8;     // 4 x 4 tiles
  float dc[8][8], db[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) dc[i][q] = db[i][q] = 0.f;
  float dw[4] = {0.f, 0.f, 0.f, 0.f}, dcp[4] = {0.f, 0.f, 0.f, 0.f};
  float gh = 0.f;                          // this thread's part of <g, h>

  for (int p0 = 0; p0 < a.P; p0 += PT3) {
    const int np = min(PT3, a.P - p0);
    __syncthreads();                        // the previous tile is read
    load_rows(Xs, ldp, static_cast<const T*>(a.x), hrow * a.P,
              static_cast<size_t>(a.H) * a.P, k.Qc, p0, np, PT3, QMAX);
    load_rows(Ys, ldp, static_cast<const T*>(a.dy), hrow * a.P,
              static_cast<size_t>(a.H) * a.P, k.Qc, p0, np, PT3, QMAX);
    for (int e = threadIdx.x; e < PT3 * a.N; e += NT) {
      const int p = e / a.N, n = e - p * a.N;
      const bool ok = p < np;
      const size_t at = sbase + static_cast<size_t>(p0 + p) * a.N + n;
      const float hv = ok ? a.states[at] : 0.f;
      const float gv = ok ? a.gstates[at] : 0.f;
      Hs[p * ldn + n] = hv;
      Gs[p * ldn + n] = gv;
      gh = fmaf(hv, gv, gh);
    }
    __syncthreads();

    // dC3 and dB3, accumulated over the tiles
    for (int p = 0; p < np; ++p) {
      float yv[8], xv[8], hv[8], gv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        yv[i] = Ys[(r8 + 16 * i) * ldp + p];
        xv[i] = Xs[(r8 + 16 * i) * ldp + p];
        const int n = min(c8 + 16 * i, a.N);
        hv[i] = Hs[p * ldn + n];
        gv[i] = Gs[p * ldn + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          dc[i][q] = fmaf(yv[i], hv[q], dc[i][q]);
          db[i][q] = fmaf(xv[i], gv[q], db[i][q]);
        }
    }

    // gB and hC over N for this tile's columns of P
    float gb[4][4], hc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) gb[i][q] = hc[i][q] = 0.f;
    for (int n = 0; n < a.N; ++n) {
      float bv[4], cv[4], gv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bv[i] = Bs[(r4 + 32 * i) * ldn + n];
        cv[i] = Cs[(r4 + 32 * i) * ldn + n];
        gv[i] = Gs[(c4 + 8 * i) * ldn + n];
        hv[i] = Hs[(c4 + 8 * i) * ldn + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          gb[i][q] = fmaf(gv[q], bv[i], gb[i][q]);
          hc[i][q] = fmaf(hv[q], cv[i], hc[i][q]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = r4 + 32 * i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = c4 + 8 * q;
        dw[i] = fmaf(Xs[j * ldp + p], gb[i][q], dw[i]);
        dcp[i] = fmaf(Ys[j * ldp + p], hc[i][q], dcp[i]);
        if (j < k.Qc && p < np)
          a.dxs[(hrow + static_cast<size_t>(j) * a.H) * a.P + p0 + p] =
              ws[j] * gb[i][q];
      }
    }
  }

  // dC3 and dB3 to the per-head scratch
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r8 + 16 * i;
    if (r >= k.Qc) continue;
    const size_t row = (hrow + static_cast<size_t>(r) * a.H) * a.N;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = c8 + 16 * q;
      if (n >= a.N) continue;
      a.dCh[row + n] = es[r] * dc[i][q];
      a.dBh[row + n] = ws[r] * db[i][q];
    }
  }
  // dw and dcs: the 8 threads of a row hold its parts
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      dw[i] += __shfl_xor_sync(0xffffffffu, dw[i], off);
      dcp[i] += __shfl_xor_sync(0xffffffffu, dcp[i], off);
    }
    if (c4 == 0) {
      dws[r4 + 32 * i] = dw[i];
      dcs[r4 + 32 * i] = dcp[i];
    }
  }
  __syncthreads();
  float wdw = 0.f;
  for (int j = threadIdx.x; j < k.Qc; j += NT) {
    const size_t at = hrow + static_cast<size_t>(j) * a.H;
    a.ddt3[at] = expf(k.T - css[j]) * dws[j];
    a.dcs3[at] = es[j] * dcs[j] - ws[j] * dws[j];
    wdw += ws[j] * dws[j];
  }
  const float dT = expf(k.T) * block_sum(gh, red) + block_sum(wdw, red);
  if (threadIdx.x == 0) a.dT3[bh * a.nc + k.c] = dT;
}

// ---------------------------------------------------------------------------
// Pass 4: the intra-chunk term. Thread (ti = tid / 16, tj = tid % 16) owns
// the pairs i = ti + 16 a, j = tj + 16 c of the Q x Q matrices (only c <= a
// holds pairs j <= i), and later the outputs (row ti + 16 a, column
// tj + 16 q) of dC and dB.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_intra_kernel(Args a) {
  extern __shared__ float smem[];
  const int ldn = a.N + 1, ldq = QMAX + 1, ldp = PT4 + 1;
  float* Ms = smem;                        // (QMAX, ldq): dM, then W
  float* Cs = Ms + QMAX * ldq;             // (QMAX, ldn)
  float* Bs = Cs + QMAX * ldn;             // (QMAX, ldn)
  float* Ys = Bs + QMAX * ldn;             // (QMAX, ldp); later column parts
  float* Xs = Ys + QMAX * ldp;             // (QMAX, ldp)
  float* dts = Xs + QMAX * ldp;
  float* css = dts + QMAX;
  float* rowR = css + QMAX;
  float* colR = rowR + QMAX;
  float* colD = colR + QMAX;
  float* dcs = colD + QMAX;
  float* da = dcs + QMAX;
  float* red = da + QMAX;                  // NT / 32

  const Chunk k = chunk_setup(a, dts, css);
  const size_t brow = (static_cast<size_t>(k.b) * a.L + k.t0) * a.G + k.g;
  const size_t hrow = (static_cast<size_t>(k.b) * a.L + k.t0) * a.H + k.h;
  load_rows(Bs, ldn, static_cast<const T*>(a.Bm), brow * a.N,
            static_cast<size_t>(a.G) * a.N, k.Qc, 0, a.N, a.N, QMAX);
  load_rows(Cs, ldn, static_cast<const T*>(a.Cm), brow * a.N,
            static_cast<size_t>(a.G) * a.N, k.Qc, 0, a.N, a.N, QMAX);
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;

  // dW = dy x^T over P in tiles, and this thread's part of sum dy x
  float dW[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dW[i][c] = 0.f;
  float dd = 0.f;
  for (int p0 = 0; p0 < a.P; p0 += PT4) {
    const int np = min(PT4, a.P - p0);
    __syncthreads();
    load_rows(Ys, ldp, static_cast<const T*>(a.dy), hrow * a.P,
              static_cast<size_t>(a.H) * a.P, k.Qc, p0, np, PT4, QMAX);
    load_rows(Xs, ldp, static_cast<const T*>(a.x), hrow * a.P,
              static_cast<size_t>(a.H) * a.P, k.Qc, p0, np, PT4, QMAX);
    __syncthreads();
    for (int e = threadIdx.x; e < QMAX * PT4; e += NT) {
      const int i = e / PT4, p = e - i * PT4;
      dd = fmaf(Ys[i * ldp + p], Xs[i * ldp + p], dd);
    }
    for (int p = 0; p < np; ++p) {
      float yv[8], xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        yv[i] = Ys[(ti + 16 * i) * ldp + p];
        xv[i] = Xs[(tj + 16 * i) * ldp + p];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c <= i; ++c) dW[i][c] = fmaf(yv[i], xv[c], dW[i][c]);
    }
  }

  // M = C B^T on the same pairs
  float m[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) m[i][c] = 0.f;
  for (int n = 0; n < a.N; ++n) {
    float cv[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cv[i] = Cs[(ti + 16 * i) * ldn + n];
      bv[i] = Bs[(tj + 16 * i) * ldn + n];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c <= i; ++c) m[i][c] = fmaf(cv[i], bv[c], m[i][c]);
  }

  // W (into m), dM (into Ms), and the sums of R = dW o W and of dW o M o E
  float rsum[8], rcol[8], dcol[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rsum[i] = rcol[i] = dcol[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ti + 16 * i;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tj + 16 * c;
      float w = 0.f, dm = 0.f;
      if (c <= i && j <= r && r < k.Qc) {
        const float E = expf(css[r] - css[j]);
        w = m[i][c] * E * dts[j];
        dm = dW[i][c] * E * dts[j];
        const float R = dW[i][c] * w;
        rsum[i] += R;
        rcol[c] += R;
        dcol[c] = fmaf(dW[i][c] * m[i][c], E, dcol[c]);
      }
      Ms[r * ldq + j] = dm;
      if (c <= i) m[i][c] = w;
    }
  }
  // row sums over the 16 threads of a row (one half-warp)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], off);
    if (tj == 0) rowR[ti + 16 * i] = rsum[i];
  }
  __syncthreads();                          // the tiles are read: reuse them
  float* partR = Ys;                        // (16, QMAX)
  float* partD = Ys + 16 * QMAX;            // (16, QMAX)
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    partR[ti * QMAX + tj + 16 * c] = rcol[c];
    partD[ti * QMAX + tj + 16 * c] = dcol[c];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < QMAX; j += NT) {
    float sr = 0.f, sd = 0.f;
    for (int t = 0; t < 16; ++t) {
      sr += partR[t * QMAX + j];
      sd += partD[t * QMAX + j];
    }
    colR[j] = sr;
    colD[j] = sd;
  }

  // dC_i = sum_j dM[i][j] B_j, dB_j = sum_i dM[i][j] C_i, each added to
  // pass 3's term in the per-head scratch
  {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
    for (int j = 0; j < k.Qc; ++j) {
      float dv[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dv[i] = Ms[(ti + 16 * i) * ldq + j];
        bv[i] = Bs[j * ldn + min(tj + 16 * i, a.N)];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(dv[i], bv[q], acc[i][q]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ti + 16 * i;
      if (r >= k.Qc) continue;
      const size_t row = (hrow + static_cast<size_t>(r) * a.H) * a.N;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tj + 16 * q;
        if (n < a.N) a.dCh[row + n] += acc[i][q];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
    for (int r = 0; r < k.Qc; ++r) {
      float dv[8], cv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dv[i] = Ms[r * ldq + ti + 16 * i];
        cv[i] = Cs[r * ldn + min(tj + 16 * i, a.N)];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(dv[i], cv[q], acc[i][q]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = ti + 16 * i;
      if (j >= k.Qc) continue;
      const size_t row = (hrow + static_cast<size_t>(j) * a.H) * a.N;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tj + 16 * q;
        if (n < a.N) a.dBh[row + n] += acc[i][q];
      }
    }
  }
  __syncthreads();                          // every read of dM is done
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      Ms[(ti + 16 * i) * ldq + tj + 16 * c] = c <= i ? m[i][c] : 0.f;

  // dx_j = sum_i W[i][j] dy_i + D dy_j + pass 3's term, over P in tiles:
  // thread (row tid / 16 + 16 a, column tid % 16 of the tile)
  const float d_h = a.D[k.h];
  for (int p0 = 0; p0 < a.P; p0 += PT4) {
    const int np = min(PT4, a.P - p0);
    __syncthreads();
    load_rows(Ys, ldp, static_cast<const T*>(a.dy), hrow * a.P,
              static_cast<size_t>(a.H) * a.P, k.Qc, p0, np, PT4, QMAX);
    __syncthreads();
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int r = 0; r < k.Qc; ++r) {
      const float yv = Ys[r * ldp + tj];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(Ms[r * ldq + ti + 16 * i], yv, acc[i]);
    }
    if (tj < np) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = ti + 16 * i;
        if (j >= k.Qc) continue;
        const size_t at = (hrow + static_cast<size_t>(j) * a.H) * a.P + p0 + tj;
        static_cast<T*>(a.dx)[at] =
            from_f<T>(acc[i] + d_h * Ys[j * ldp + tj] + a.dxs[at]);
      }
    }
  }

  // the gradient of cs, then of a = dt A by the reverse cumsum
  for (int j = threadIdx.x; j < QMAX; j += NT)
    dcs[j] = j < k.Qc
        ? a.dcs3[hrow + static_cast<size_t>(j) * a.H] + rowR[j] - colR[j]
        : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) reverse_cumsum(dcs, da, k.Qc, threadIdx.x);
  __syncthreads();
  const size_t bh = static_cast<size_t>(k.b) * a.H + k.h;
  const float dT = a.dT3[bh * a.nc + k.c];
  float sa = 0.f;
  for (int j = threadIdx.x; j < k.Qc; j += NT) {
    const size_t at = hrow + static_cast<size_t>(j) * a.H;
    const float daj = da[j] + dT;
    a.ddt[at] = a.ddt3[at] + colD[j] + k.a_h * daj;
    sa = fmaf(dts[j], daj, sa);
  }
  const float pa = block_sum(sa, red);
  const float pd = block_sum(dd, red);
  if (threadIdx.x == 0) {
    const size_t at = (static_cast<size_t>(k.b) * a.nc + k.c) * a.H + k.h;
    a.partA[at] = pa;
    a.partD[at] = pd;
  }
}

// ---------------------------------------------------------------------------
// Pass 5: dB and dC over the heads of each group, in head order, in the
// input dtype; dA and dD over their (b, chunk) partials, in order.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_reduce_kernel(Args a) {
  const size_t total = static_cast<size_t>(a.B) * a.L * a.G * a.N;
  const int hg = a.H / a.G;
  for (size_t e = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * NT) {
    const int n = static_cast<int>(e % a.N);
    const size_t bt = e / a.N / a.G;
    const int g = static_cast<int>((e / a.N) % a.G);
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < hg; ++q) {
      const size_t at = (bt * a.H + g * hg + q) * a.N + n;
      sb += a.dBh[at];
      sc += a.dCh[at];
    }
    static_cast<T*>(a.dBm)[e] = from_f<T>(sb);
    static_cast<T*>(a.dCm)[e] = from_f<T>(sc);
  }
  const int h = blockIdx.x * NT + threadIdx.x;
  if (h < a.H) {
    float sa = 0.f, sd = 0.f;
    for (int bc = 0; bc < a.B * a.nc; ++bc) {
      sa += a.partA[static_cast<size_t>(bc) * a.H + h];
      sd += a.partD[static_cast<size_t>(bc) * a.H + h];
    }
    a.dA[h] = sa;
    a.dD[h] = sd;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core route (see the header). Tiles are TQ = 128 rows of
// the chunk by 64-column panels, swizzled as in hopper_mma.cuh, rows and
// columns past Qc, N and P zero; PP = panels of P (1 or 2) and a.NP of N.
// Warpgroup wg owns the chunk's rows 64 wg .. 64 wg + 63: as i (the rows
// of M, dW and dC) and as j (the rows of dB and dx).
// ---------------------------------------------------------------------------

// row t0 of a chunk of a contiguous (B, L, heads, cols) bf16 tensor at
// (b, head)
__device__ __forceinline__ const __nv_bfloat16* chunk_rows(
    const void* t, int b, int L, int t0, int heads, int head, int cols) {
  return static_cast<const __nv_bfloat16*>(t) +
         ((static_cast<size_t>(b) * L + t0) * heads + head) * cols;
}

// the chunk's tiles C and B (TQ x 64 NP), x and dy (TQ x 64 PP), by
// cp.async where the rows allow it (the caller commits and waits), and this
// thread's dt (row threadIdx.x, 0 past Qc)
template <int PP>
__device__ __forceinline__ float load_chunk(const Args& a, int b, int h,
                                            int g, int t0, int Qc,
                                            uint8_t* sC, uint8_t* sB,
                                            uint8_t* sX, uint8_t* sY) {
  const int i = threadIdx.x;
  const float dtv = i < Qc
      ? a.dt[(static_cast<size_t>(b) * a.L + t0 + i) * a.H + h] : 0.f;
  const long long rb = static_cast<long long>(a.G) * a.N;
  const long long rx = static_cast<long long>(a.H) * a.P;
  ssd::load_rows(sC, chunk_rows(a.Cm, b, a.L, t0, a.G, g, a.N), rb, 1, Qc, a.N,
                 a.NP, a.vec_b);
  ssd::load_rows(sB, chunk_rows(a.Bm, b, a.L, t0, a.G, g, a.N), rb, 1, Qc, a.N,
                 a.NP, a.vec_b);
  ssd::load_rows(sX, chunk_rows(a.x, b, a.L, t0, a.H, h, a.P), rx, 1, Qc, a.P, PP,
                 a.vec_x);
  ssd::load_rows(sY, chunk_rows(a.dy, b, a.L, t0, a.H, h, a.P), rx, 1, Qc, a.P,
                 PP, a.vec_x);
  return dtv;
}

// shared memory of each kernel, with the 1024 bytes the swizzle's alignment
// may take
template <int PP>
inline int tc_state_smem(int NP) {
  return 2 * TQ * 128 * NP + 2 * TQ * 128 * PP + 4 * TQ * 4 + 1024;
}
constexpr int CHUNK_FLOATS = 9 * TQ + 16 * TQ + NT / 32;
template <int PP>
inline int tc_chunk_smem(int NP) {
  return 2 * TQ * 128 * NP + 2 * TQ * 128 * PP + 4 * 64 * PP * 128 * NP +
         TQ * 256 + 4 * CHUNK_FLOATS + 1024;
}

// The state pass: per (chunk, head, batch row), S_c = (w o x)^T B and U_c =
// (e o dy)^T C (P x N each, e_i = exp(cs_i)) with the forward's state
// product (ssd_tc.cuh: A from registers as bf16 hi + lo), and T_c.
template <int PP>
__global__ void __launch_bounds__(TC_NT, 1) ssd_bwd_tc_state_kernel(Args a) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sC = align1024(smem_raw);          // TQ x 64 NP
  uint8_t* sB = sC + TQ * 128 * a.NP;         // TQ x 64 NP
  uint8_t* sX = sB + TQ * 128 * a.NP;         // TQ x 64 PP
  uint8_t* sY = sX + TQ * 128 * PP;           // TQ x 64 PP: dy
  float* dts = reinterpret_cast<float*>(sY + TQ * 128 * PP);
  float* css = dts + TQ;
  float* ws = css + TQ;
  float* es = ws + TQ;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int t0 = c * a.Q, Qc = min(a.Q, a.L - t0);
  const float dtv = load_chunk<PP>(a, b, h, g, t0, Qc, sC, sB, sX, sY);
  cp_async_commit();
  store_dt_cs(dtv, a.A[h], Qc, dts, css);
  cp_async_wait_all();
  __syncthreads();
  const float T = css[Qc - 1];
  for (int j = threadIdx.x; j < TQ; j += TC_NT) {
    ws[j] = j < Qc ? expf(T - css[j]) * dts[j] : 0.f;
    es[j] = j < Qc ? expf(css[j]) : 0.f;
  }
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  if (threadIdx.x == 0) a.totals[bh * a.nc + c] = T;
  __syncthreads();

  const int ksteps = (Qc + 15) / 16, tiles = PP * a.NP;
  const size_t at = (bh * a.nc + c) * a.P * a.N;
  for (int item = threadIdx.x / 128; item < 2 * tiles; item += 2) {
    const bool u = item >= tiles;             // U_c, else S_c
    const int t = u ? item - tiles : item;
    const int pp = t / a.NP, np = t - pp * a.NP;
    float acc[32];
    scaled_state_tile(acc, u ? sY : sX, u ? es : ws, smem_u32(u ? sC : sB),
                      pp, np, ksteps);
    store_state_tile(acc, (u ? a.gstates : a.states) + at, pp, np, a.P, a.N);
  }
}

// row sums of the thread's two rows over the 4 threads of a quad
__device__ __forceinline__ void quad_sum(float (&v)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    v[hh] += __shfl_xor_sync(0xffffffffu, v[hh], 1);
    v[hh] += __shfl_xor_sync(0xffffffffu, v[hh], 2);
  }
}

// the first `tiles` 64 x 64 float32 tiles of `acc` (rows r[hh], columns
// 64 t + ..) into the chunk's rows r < Qc of a (B, L, H, N) float32 tensor
// whose first row is `base` (row stride rs = H N)
__device__ __forceinline__ void store_rows_f32(const float (&acc)[2][32],
                                               int tiles, float* base,
                                               const int (&r)[2], int Qc,
                                               size_t rs, int N) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t >= tiles) break;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = r[(e >> 1) & 1];
      const int n = 64 * t + 8 * (e >> 2) + 2 * tq;
      if (i >= Qc || n >= N) continue;
      float* o = base + i * rs + n;
      if (N % 2 == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[t][e], acc[t][e + 1]);
      } else {
        o[0] = acc[t][e];
        if (n + 1 < N) o[1] = acc[t][e + 1];
      }
    }
  }
}

// The chunk pass: per (chunk, head, batch row), every gradient of the
// chunk from its tiles and its two carried states, written directly (dx,
// ddt) or as per-head float32 partials for the reduce (dB, dC, dA, dD).
template <int PP>
__global__ void __launch_bounds__(TC_NT, 1) ssd_bwd_tc_chunk_kernel(Args a) {
  using namespace hopper;
  constexpr int HR = 64 * PP;                 // rows of the state tiles
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sC = align1024(smem_raw);          // TQ x 64 NP
  uint8_t* sB = sC + TQ * 128 * a.NP;         // TQ x 64 NP
  uint8_t* sX = sB + TQ * 128 * a.NP;         // TQ x 64 PP
  uint8_t* sY = sX + TQ * 128 * PP;           // TQ x 64 PP: dy
  uint8_t* sHhi = sY + TQ * 128 * PP;         // HR x 64 NP: h_c
  uint8_t* sHlo = sHhi + HR * 128 * a.NP;
  uint8_t* sGhi = sHlo + HR * 128 * a.NP;     // HR x 64 NP: g_c
  uint8_t* sGlo = sGhi + HR * 128 * a.NP;
  uint8_t* sS = sGlo + HR * 128 * a.NP;       // TQ x TQ: dM, then W
  float* dts = reinterpret_cast<float*>(sS + TQ * 256);
  float* css = dts + TQ;
  float* ws = css + TQ;                       // w_j = exp(T - cs_j) dt_j
  float* es = ws + TQ;                        // e_i = exp(cs_i)
  float* rowR = es + TQ;                      // sum_j R_ij
  float* dcsh = rowR + TQ;                    // e_i (dy h)_i . C_i
  float* dwv = dcsh + TQ;                     // dw_j = (x g)_j . B_j
  float* dcs = dwv + TQ;
  float* da = dcs + TQ;
  float* colR = da + TQ;                      // (8 warps, TQ): column sums
  float* colD = colR + 8 * TQ;                //   of R and of dW o M o E
  float* red = colD + 8 * TQ;                 // NT / 32

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int t0 = c * a.Q, Qc = min(a.Q, a.L - t0);
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const size_t hrow = (static_cast<size_t>(b) * a.L + t0) * a.H + h;
  // the carried states' loads go out first, the tiles' copies next, and
  // the states' hi + lo stores come after both
  const size_t sat = (bh * a.nc + c) * a.P * a.N;
  float vh[kStateChunks<HR>][8], vg[kStateChunks<HR>][8];
  fetch_state<HR>(vh, a.states + sat, a.P, a.N, a.NP);
  fetch_state<HR>(vg, a.gstates + sat, a.P, a.N, a.NP);
  const float dtv = load_chunk<PP>(a, b, h, g, t0, Qc, sC, sB, sX, sY);
  cp_async_commit();
  float gh = 0.f;                             // this thread's part of <g, h>
#pragma unroll
  for (int it = 0; it < kStateChunks<HR>; ++it)
#pragma unroll
    for (int e = 0; e < 8; ++e) gh = fmaf(vh[it][e], vg[it][e], gh);
  store_state_hilo<HR>(vh, sHhi, sHlo, a.NP);
  store_state_hilo<HR>(vg, sGhi, sGlo, a.NP);
  store_dt_cs(dtv, a.A[h], Qc, dts, css);
  cp_async_wait_all();
  __syncthreads();
  const float T = css[Qc - 1];
  for (int j = threadIdx.x; j < TQ; j += TC_NT) {
    ws[j] = j < Qc ? expf(T - css[j]) * dts[j] : 0.f;
    es[j] = j < Qc ? expf(css[j]) : 0.f;
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int r0 = 64 * wg;
  const bool active = r0 < Qc;                // the warpgroup has rows
  const int kend = (Qc + 15) / 16;            // k-steps over the chunk
  const uint32_t sCa = smem_u32(sC), sBa = smem_u32(sB), sXa = smem_u32(sX);
  const uint32_t sYa = smem_u32(sY), sSa = smem_u32(sS);
  int row[2];                                 // this thread's rows
  float cs_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = r0 + 16 * warp + gq + 8 * hh;
    cs_r[hh] = row[hh] < Qc ? css[row[hh]] : 0.f;
  }

  // 1. M = C B^T and dW = dy x^T over the causal column tiles jb <= wg
  float m[2][32], dW[2][32];
#pragma unroll
  for (int e = 0; e < 32; ++e) m[0][e] = m[1][e] = dW[0][e] = dW[1][e] = 0.f;
  if (active) {
    wgmma_fence();
#pragma unroll
    for (int jb = 0; jb < 2; ++jb) {
      if (jb > wg) break;
      for (int kk = 0; kk < 4 * a.NP; ++kk)
        wgmma_ss_n64(m[jb], kstep_kmajor<TQ>(sCa + r0 * 128, kk),
                     kstep_kmajor<TQ>(sBa + jb * 64 * 128, kk), 1);
      for (int kk = 0; kk < 4 * PP; ++kk)
        wgmma_ss_n64(dW[jb], kstep_kmajor<TQ>(sYa + r0 * 128, kk),
                     kstep_kmajor<TQ>(sXa + jb * 64 * 128, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(m[0]);
    fence_regs(m[1]);
    fence_regs(dW[0]);
    fence_regs(dW[1]);
  }

  // 2. on j <= i < Qc (masked before the exp): E = exp(cs_i - cs_j), W =
  // M o E o dt_j (into m), dM = dW o E o dt_j (into dW), R = dW o W summed
  // by rows and by columns, dW o M o E by columns (each warp's column sums
  // to colR, colD)
  float rr[2] = {0.f, 0.f};
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    float cr[16], cd[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) cr[k] = cd[k] = 0.f;
    if (active && jb <= wg) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1, k = 2 * (e >> 2) + (e & 1);
        const int i = row[hh], j = 64 * jb + 8 * (e >> 2) + 2 * tq + (e & 1);
        const float E = j <= i && i < Qc ? exp_(cs_r[hh] - css[j]) : 0.f;
        const float f = E * dts[j];
        const float w = m[jb][e] * f, R = dW[jb][e] * w;
        rr[hh] += R;
        cr[k] += R;
        cd[k] = fmaf(dW[jb][e] * m[jb][e], E, cd[k]);
        m[jb][e] = w;
        dW[jb][e] *= f;
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cr[k] += __shfl_xor_sync(0xffffffffu, cr[k], off);
        cd[k] += __shfl_xor_sync(0xffffffffu, cd[k], off);
      }
    if (gq == 0) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int j = 64 * jb + 8 * (k >> 1) + 2 * tq + (k & 1);
        colR[(threadIdx.x / 32) * TQ + j] = cr[k];
        colD[(threadIdx.x / 32) * TQ + j] = cd[k];
      }
    }
  }
  quad_sum(rr);
  if (tq == 0) {
    rowR[row[0]] = rr[0];
    rowR[row[1]] = rr[1];
  }
  // dM to the staging tile in bf16; W kept as bf16 A fragments
  uint32_t wf[2][4][4];
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (!active || jb > wg) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(m[jb], kk, wf[jb][kk]);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = row[(e >> 1) & 1], j = 64 * jb + 8 * (e >> 2) + 2 * tq;
      *reinterpret_cast<uint32_t*>(sS + swz<TQ>(i, j >> 3) + (j & 7) * 2) =
          pack_bf16(dW[jb][e], dW[jb][e + 1]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float acc[2][32];
  // 3. dC_i = e_i (dy h)_i + sum_{j <= i} dM_ij B_j (rows i); dcsh_i =
  // e_i (dy h)_i . C_i, the carried state's part of the gradient of cs_i
  if (active) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (np >= a.NP) break;
      for (int kk = 0; kk < 4 * PP; ++kk) {
        const uint64_t dA_ = kstep_kmajor<TQ>(sYa + r0 * 128, kk);
        wgmma_ss_n64<0, 1>(acc[np], dA_, kstep_mnmajor<HR>(
            smem_u32(sHhi) + np * HR * 128, kk), 1);
        wgmma_ss_n64<0, 1>(acc[np], dA_, kstep_mnmajor<HR>(
            smem_u32(sHlo) + np * HR * 128, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    float dh[2] = {0.f, 0.f};
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (np >= a.NP) break;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hh = (e >> 1) & 1, i = row[hh];
        const int n = 64 * np + 8 * (e >> 2) + 2 * tq;
        acc[np][e] *= es[i];
        acc[np][e + 1] *= es[i];
        const float2 cv = tile_pair<TQ>(sC, i, n);
        dh[hh] = fmaf(acc[np][e], cv.x, fmaf(acc[np][e + 1], cv.y, dh[hh]));
      }
    }
    quad_sum(dh);
    if (tq == 0) {
      dcsh[row[0]] = dh[0];
      dcsh[row[1]] = dh[1];
    }
    const int jend = min(4 * (wg + 1), kend);
    wgmma_fence();
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (np >= a.NP) break;
      for (int kj = 0; kj < jend; ++kj)
        wgmma_ss_n64<0, 1>(acc[np], kstep_kmajor<TQ>(sSa + r0 * 128, kj),
                           kstep_mnmajor<TQ>(sBa + np * TQ * 128, kj), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    store_rows_f32(acc, a.NP, a.dCh + hrow * a.N, row, Qc,
                   static_cast<size_t>(a.H) * a.N, a.N);
  }

  // 4. dB_j = w_j (x g)_j + sum_{i >= j} dM_ij C_i (rows j, dM^T read
  // MN-major from the staging tile); dw_j = (x g)_j . B_j
  if (active) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (np >= a.NP) break;
      for (int kk = 0; kk < 4 * PP; ++kk) {
        const uint64_t dA_ = kstep_kmajor<TQ>(sXa + r0 * 128, kk);
        wgmma_ss_n64<0, 1>(acc[np], dA_, kstep_mnmajor<HR>(
            smem_u32(sGhi) + np * HR * 128, kk), 1);
        wgmma_ss_n64<0, 1>(acc[np], dA_, kstep_mnmajor<HR>(
            smem_u32(sGlo) + np * HR * 128, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    float dwp[2] = {0.f, 0.f};
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (np >= a.NP) break;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hh = (e >> 1) & 1, j = row[hh];
        const int n = 64 * np + 8 * (e >> 2) + 2 * tq;
        const float2 bv = tile_pair<TQ>(sB, j, n);
        dwp[hh] = fmaf(acc[np][e], bv.x, fmaf(acc[np][e + 1], bv.y, dwp[hh]));
        acc[np][e] *= ws[j];
        acc[np][e + 1] *= ws[j];
      }
    }
    quad_sum(dwp);
    if (tq == 0) {
      dwv[row[0]] = dwp[0];
      dwv[row[1]] = dwp[1];
    }
    wgmma_fence();
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (np >= a.NP) break;
      for (int ki = 4 * wg; ki < kend; ++ki)
        wgmma_ss_n64<1, 1>(acc[np], kstep_mnmajor<TQ>(sSa + wg * TQ * 128, ki),
                           kstep_mnmajor<TQ>(sCa + np * TQ * 128, ki), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    store_rows_f32(acc, a.NP, a.dBh + hrow * a.N, row, Qc,
                   static_cast<size_t>(a.H) * a.N, a.N);
  }
  __syncthreads();                            // every read of dM is done
  // W to the staging tile: fragment wf[jb][kk][q] is row row[q & 1],
  // columns 64 jb + 16 kk + 8 (q >> 1) + 2 tq (+1)
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (!active || jb > wg) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 64 * jb + 16 * kk + 8 * (q >> 1) + 2 * tq;
        *reinterpret_cast<uint32_t*>(sS + swz<TQ>(row[q & 1], j >> 3) +
                                     (j & 7) * 2) = wf[jb][kk][q];
      }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // 5. dx_j = w_j (B g^T)_j + sum_{i >= j} W_ij dy_i + D dy_j (rows j)
  if (active) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int pp = 0; pp < PP; ++pp)
      for (int kk = 0; kk < 4 * a.NP; ++kk)
        wgmma_ss_n64(acc[pp], kstep_kmajor<TQ>(sBa + r0 * 128, kk),
                     kstep_kmajor<HR>(smem_u32(sGhi) + pp * 64 * 128, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int pp = 0; pp < PP; ++pp) {
      fence_regs(acc[pp]);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[pp][e] *= ws[row[(e >> 1) & 1]];
    }
    wgmma_fence();
#pragma unroll
    for (int pp = 0; pp < PP; ++pp)
      for (int ki = 4 * wg; ki < kend; ++ki)
        wgmma_ss_n64<1, 1>(acc[pp], kstep_mnmajor<TQ>(sSa + wg * TQ * 128, ki),
                           kstep_mnmajor<TQ>(sYa + pp * TQ * 128, ki), 1);
    wgmma_commit();
    wgmma_wait_all();
    const float d_h = a.D[h];
    __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(a.dx) + hrow * a.P;
#pragma unroll
    for (int pp = 0; pp < PP; ++pp) {
      fence_regs(acc[pp]);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int j = row[(e >> 1) & 1];
        const int p = 64 * pp + 8 * (e >> 2) + 2 * tq;
        if (j >= Qc || p >= a.P) continue;
        __nv_bfloat16* o = dx + static_cast<size_t>(j) * a.H * a.P + p;
        const float2 yv = tile_pair<TQ>(sY, j, p);
        const float o0 = acc[pp][e] + d_h * yv.x, o1 = acc[pp][e + 1] + d_h * yv.y;
        if (a.P % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(o0, o1);
        } else {
          o[0] = __float2bfloat16(o0);
          if (p + 1 < a.P) o[1] = __float2bfloat16(o1);
        }
      }
    }
  }
  __syncthreads();                            // rowR, dcsh, dwv, colR, colD

  // 6. the gradient of cs, then of a = dt A by the reverse cumsum (T_c adds
  // to every step); ddt; the block's dA and dD partials
  const int j = threadIdx.x;
  float cdj = 0.f, wdw = 0.f;
  if (j < TQ) {
    float cr = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) {
      cr += colR[w8 * TQ + j];
      cdj += colD[w8 * TQ + j];
    }
    const bool ok = j < Qc;
    wdw = ok ? ws[j] * dwv[j] : 0.f;
    dcs[j] = ok ? rowR[j] - cr + dcsh[j] - wdw : 0.f;
  }
  const float dT = expf(T) * block_sum(gh, red) + block_sum(wdw, red);
  if (threadIdx.x < 32) reverse_cumsum(dcs, da, Qc, threadIdx.x);
  __syncthreads();
  float sa = 0.f;
  if (j < Qc) {
    const float daj = da[j] + dT;
    a.ddt[hrow + static_cast<size_t>(j) * a.H] =
        cdj + expf(T - css[j]) * dwv[j] + a.A[h] * daj;
    sa = dts[j] * daj;
  }
  float dd = 0.f;
  for (int e = threadIdx.x; e < Qc * a.P; e += TC_NT) {
    const int i = e / a.P, p = e - i * a.P;
    dd = fmaf(tile_at<TQ>(sY, i, p), tile_at<TQ>(sX, i, p), dd);
  }
  const float pa = block_sum(sa, red);
  const float pd = block_sum(dd, red);
  if (threadIdx.x == 0) {
    const size_t at = (static_cast<size_t>(b) * a.nc + c) * a.H + h;
    a.partA[at] = pa;
    a.partD[at] = pd;
  }
}

inline size_t state_smem(int N) {
  return sizeof(float) * (2 * QMAX * (N + 1) + 2 * QMAX * (PT3 + 1) + 4 * QMAX);
}
inline size_t inter_smem(int N) {
  return sizeof(float) * (2 * QMAX * (N + 1) + 2 * PT3 * (N + 1) +
                          2 * QMAX * (PT3 + 1) + 6 * QMAX + NT / 32);
}
inline size_t intra_smem(int N) {
  return sizeof(float) * (QMAX * (QMAX + 1) + 2 * QMAX * (N + 1) +
                          2 * QMAX * (PT4 + 1) + 7 * QMAX + NT / 32);
}

int launch_carry(Args& a, cudaStream_t s) {
  ssd_bwd_carry_kernel<<<dim3((a.P * a.N + NT - 1) / NT, a.H, a.B), NT, 0,
                         s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(Args& a, cudaStream_t s) {
  const size_t total = static_cast<size_t>(a.B) * a.L * a.G * a.N;
  const int blocks = static_cast<int>(
      (total + NT - 1) / NT < 4096 ? (total + NT - 1) / NT : 4096);
  ssd_bwd_reduce_kernel<T><<<blocks > 0 ? blocks : 1, NT, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// pass 0..4 of the CUDA-core route for input type T; each kernel sets its
// shared-memory attribute once (at N = NMAX), on the device current at its
// first launch
template <typename T>
int launch_cc(int pass, Args& a, cudaStream_t s) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(state_smem(NMAX)));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssd_bwd_inter_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(inter_smem(NMAX)));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_bwd_intra_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(intra_smem(NMAX)));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 chunks(a.nc, a.H, a.B);
  switch (pass) {
    case 0:
      ssd_bwd_state_kernel<T><<<chunks, NT, state_smem(a.N), s>>>(a);
      break;
    case 1:
      return launch_carry(a, s);
    case 2:
      ssd_bwd_inter_kernel<T><<<chunks, NT, inter_smem(a.N), s>>>(a);
      break;
    case 3:
      ssd_bwd_intra_kernel<T><<<chunks, NT, intra_smem(a.N), s>>>(a);
      break;
    case 4:
      return launch_reduce<T>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core kernels' passes (5 state, 6 chunk) for P <= 64 PP; each
// sets its shared-memory attribute once, at its largest size
template <int PP>
int launch_tc(int pass, Args& a, cudaStream_t s) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_tc_state_kernel<PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc_state_smem<PP>(2));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_bwd_tc_chunk_kernel<PP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                tc_chunk_smem<PP>(PP == 1 ? 2 : 1));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 chunks(a.nc, a.H, a.B);
  if (pass == 5)
    ssd_bwd_tc_state_kernel<PP><<<chunks, TC_NT, tc_state_smem<PP>(a.NP), s>>>(a);
  else
    ssd_bwd_tc_chunk_kernel<PP><<<chunks, TC_NT, tc_chunk_smem<PP>(a.NP), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One pass of the backward, run in the route's order on one stream. The
// route follows dtype and shape:
//   tensor cores, bfloat16 (dtype 1) with P <= 64, or P <= 128 and N <= 64
//   (the chunk kernel's tiles must fit in one block's shared memory):
//   5 state, 1 carry, 6 chunk, 4 reduce;
//   CUDA cores, float32 (dtype 0) and every other bfloat16 shape: 0 state,
//   1 carry, 2 inter, 3 intra, 4 reduce.
// dtype is that of x, Bm, Cm, dy, dx, dBm and dCm; dt, A, D, dhT, ddt, dA
// and dD are float32. Every tensor is contiguous; dhT may be null (zero).
// scratch, floats, nc = ceil(L / Q): CUDA cores 2 B H nc P N + B H nc + B
// L H P + 2 B L H N + 2 B L H + B H nc + 2 B nc H, in the order of Args;
// tensor cores 2 B H nc P N (states, gstates) + 2 B L H N (dBh, dCh) + 3 B
// H nc (totals, partA, partD). Q = min(chunk, L) <= 128, N <= 128,
// H % G == 0.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// the CUDA error of the launch (0 = success).
extern "C" int repro_ssd_scan_bwd(int pass, const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* D,
                                  const void* dy, const void* dhT, void* dx,
                                  void* ddt, void* dA, void* dBm, void* dCm,
                                  void* dD, void* scratch, int dtype, int B,
                                  int L, int H, int P, int G, int N, int Q,
                                  void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > NMAX || Q <= 0 || Q > QMAX || Q > L || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tc = dtype == 1 && (P <= 64 || (P <= 128 && N <= 64));
  if ((dtype != 0 && dtype != 1) ||
      (tc && !(pass == 1 || pass == 4 || pass == 5 || pass == 6)) ||
      (!tc && (pass < 0 || pass > 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.D = static_cast<const float*>(D);
  a.dy = dy;
  a.dhT = static_cast<const float*>(dhT);
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dBm = dBm;
  a.dCm = dCm;
  a.dD = static_cast<float*>(dD);
  a.B = B;
  a.L = L;
  a.H = H;
  a.P = P;
  a.G = G;
  a.N = N;
  a.Q = Q;
  a.nc = (L + Q - 1) / Q;
  a.NP = (N + 63) / 64;
  a.vec_x = P % 8 == 0 && aligned16(x) && aligned16(dy);
  a.vec_b = N % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  const size_t st = static_cast<size_t>(B) * H * a.nc * P * N;
  const size_t lh = static_cast<size_t>(B) * L * H;
  const size_t ch = static_cast<size_t>(B) * H * a.nc;
  float* f = static_cast<float*>(scratch);
  a.states = f;
  a.gstates = a.states + st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    a.dBh = a.gstates + st;
    a.dCh = a.dBh + lh * N;
    a.totals = a.dCh + lh * N;
    a.partA = a.totals + ch;
    a.partD = a.partA + ch;
    a.dxs = a.ddt3 = a.dcs3 = a.dT3 = nullptr;
    if (pass == 1) return launch_carry(a, s);
    if (pass == 4) return launch_reduce<__nv_bfloat16>(a, s);
    return P <= 64 ? launch_tc<1>(pass, a, s) : launch_tc<2>(pass, a, s);
  }
  a.totals = a.gstates + st;
  a.dxs = a.totals + ch;
  a.dBh = a.dxs + lh * P;
  a.dCh = a.dBh + lh * N;
  a.ddt3 = a.dCh + lh * N;
  a.dcs3 = a.ddt3 + lh;
  a.dT3 = a.dcs3 + lh;
  a.partA = a.dT3 + ch;
  a.partD = a.partA + ch;
  return dtype == 1 ? launch_cc<__nv_bfloat16>(pass, a, s)
                    : launch_cc<float>(pass, a, s);
}
