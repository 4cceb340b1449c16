// Flash-attention forward for Hopper (sm_90a): the port's prefill and
// training kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention_pallas
//   (body _flash_kernel): blocked online-softmax attention forward with
//   causal (+ q_offset), sliding-window and q/kv padding masks, GQA.
//
// Two kernels, chosen by the input dtype (the wrapper states the dispatch):
//   * flash_fwd_wgmma_kernel<D, DV>, bf16: tensor cores (wgmma);
//   * flash_fwd_kernel<D, DV>, float32: CUDA-core FMAs. wgmma has no float32
//     input, and its TF32 mode keeps about three decimal digits, which would
//     break the float32 checks at 1e-4 that the port holds its kernels to.
// Both compute the same function. The TPU kernel walks a sequential grid
// (B, H, q blocks, kv blocks) and carries (m, l, acc) in VMEM scratch
// across the kv axis; here one block owns one (q tile, q head, batch row)
// and loops over the kv tiles itself, so the running state stays in
// registers. Common to both:
//   * the loop visits only kv tiles that intersect the causal/window band of
//     the q tile (the block skipping of flash_attention_triangular), so a
//     causal prompt does about half the tiles of the full rectangle;
//   * GQA: q head h reads kv head h / (H / KV), no materialised repeat;
//   * the softmax statistics and O accumulate in float32;
//   * masked scores take the finite sentinel -1e30 and l is floored at 1e-30
//     on output, as in the refs; a row with no unmasked key at all averages
//     v over all Sk keys, as the dense ref does with that sentinel, instead
//     of producing NaN.
// Head dims (D of q and k, Dv of v and o): bf16 takes (64, 64), (128, 128)
// and (192, 128); float32 those and (96, 64). (192, 128) is MLA's prefill
// (deepseek-v2-lite: q and k are nope 128 + rope 64, v is 128), (96, 64)
// its reduced config's. Every other pair is refused (cudaErrorInvalidValue),
// never computed another way. O is written in the input type. When the
// caller passes an `lse` buffer (training), each row's logsumexp of its
// scaled scores, m + log(l), is written there in float32, (B, H, Sq): the
// backward kernels (flash_attention_bwd.cu) recompute P = exp(S - lse)
// from it.
//
// Bound. At the training shape (q (2, 2048, 16, 128), causal) the forward
// does 4 D flops per unmasked (q, k) pair: 34.4 GFLOP, 0.035 ms at the
// H100's 989 TFLOP/s bf16 peak, against 0.015 ms for its 50 MB of q, k,
// v and o at 3.35 TB/s: bound by operations. At decode-like sizes (few q rows, long kv) it moves
// bytes: every K/V row is read once per q tile.
//
// The tensor-core kernel (bf16):
//   * one warpgroup (128 threads) per block owns a 64-row q tile, wgmma's
//     M. 64 rows, not 128 with two warpgroups sharing K/V: the serving
//     prefill q (1, 512, 16, 128) then makes 8 x 16 = 128 blocks for the
//     132 SMs (128-row blocks would make 64), and the training shape 1,024;
//     at 81 KB of shared memory and 148 registers a thread (ptxas, D =
//     128) two blocks share an SM, so one block's softmax overlaps the
//     other's products;
//   * Q stays in shared memory; K and V tiles of 64 rows go through a ring
//     of two stages, filled by 16-byte cp.async copies into the 128-byte
//     swizzle (hopper_mma.cuh) while the previous tile is computed;
//   * S = Q K^T is an SS wgmma (m64n64k16, both operands K-major, D / 16
//     steps); the online softmax runs in float32 on the accumulator
//     fragment (exp2 with log2(e) folded in; the row max and sum over the
//     four lanes that share a row);
//   * P goes to bf16 in registers and is the A operand of O += P V
//     (m64nDVk16, 4 steps), V MN-major (the descriptor's transpose bit).
//     At D = 192 the Q and K tiles are three 64-column panels (12 k-steps
//     of S), V two; shared memory is Q + 2 x (K + V) = 107,520 bytes and
//     ptxas gives 191 registers a thread (no spill), so two blocks still
//     share an SM. MLA's V rows lie KV Dv apart, its K
//     rows KV D apart: each tile is loaded with its own row pitch.
//     Rounding P to bf16 is the one rounding the float32 version does not
//     have: relative 2^-9 on each weight, on the chip within 5e-3 + 1e-2
//     |ref| of the float32 plain version (tests/test_torch_kernels.py
//     emulates it on the CPU); l sums the float32 weights;
//   * the mask is applied only on tiles that cross the band's edge or the
//     ragged end of kv; the grid runs the q tiles from the last, so the
//     longest rows of a causal prompt start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;      // q rows per block
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 256;     // threads per block (16 x 16)
constexpr int PAD = 4;      // row padding of the transposed tiles (floats)

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs. 256 threads as a 16 x 16 grid; thread (ty, tx)
// owns score rows ty*4..ty*4+3 and columns tx*4..tx*4+3 of the BQ x BK
// tile, and output rows ty*4.. x columns tx*4 + 64*c + (0..3). Q and K
// tiles sit transposed in shared memory ([d][row], rows padded by 4 floats)
// so each thread reads 4 rows / 4 columns as one float4; P takes part in
// the second product in float32, as in the reference.
// ---------------------------------------------------------------------------
template <int D, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal,
    int window, int q_offset, float sm_scale) {
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
    if (qi < Sq) x = q[((static_cast<size_t>(b) * Sq + qi) * H + h) * D + d];
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
      if (kj < Sk) x = k[((static_cast<size_t>(b) * Sk + kj) * KV + kvh) * D + d];
      Kt[d * (BK + PAD) + r] = x;
    }
    for (int i = tid; i < BK * DV; i += NT) {
      const int r = i / DV, d = i - r * DV, kj = k0 + r;
      float x = 0.f;
      if (kj < Sk) x = v[((static_cast<size_t>(b) * Sk + kj) * KV + kvh) * DV + d];
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
        sum += v[((static_cast<size_t>(b) * Sk + kj) * KV + kvh) * DV + c];
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
    float* orow = o + ((static_cast<size_t>(b) * Sq + qi) * H + h) * DV;
#pragma unroll
    for (int c4 = 0; c4 < DV / 64; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[c4 * 64 + tx * 4 + e] = acc[i][c4 * 4 + e] / lm;
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (see the header). TC = 64 rows per q tile and per kv
// tile; shared memory: Q, then stage s's K at TILE (1 + 2 s) and V at
// TILE (2 + 2 s).
// ---------------------------------------------------------------------------
constexpr int TC = 64;
constexpr int TC_THREADS = 128;

// Q, then each of the two stages' K and V tiles, and the swizzle's alignment
template <int D, int DV>
constexpr int wgmma_smem_bytes() { return TC * (3 * D + 2 * DV) * 2 + 1024; }

template <int D, int DV>
__global__ void __launch_bounds__(TC_THREADS) flash_fwd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal,
    int window, int q_offset, float sm_scale) {
  using namespace hopper;
  constexpr uint32_t TILE = TC * D * 2;      // a Q or K tile
  constexpr uint32_t VTILE = TC * DV * 2;    // a V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = 16 * warp + g;           // this thread's rows r_lo, r_lo + 8
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t ldq = static_cast<size_t>(H) * D, ldk = static_cast<size_t>(KV) * D;
  const size_t ldv = static_cast<size_t>(KV) * DV, ldo = static_cast<size_t>(H) * DV;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Sq * ldq + static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Sk * ldk + static_cast<size_t>(kvh) * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Sk * ldv + static_cast<size_t>(kvh) * DV;
  // stage s: K at TILE + s (TILE + VTILE), V right after it
  auto sK_of = [&](int stage) { return sQ + TILE + stage * (TILE + VTILE); };

  // kv tiles that intersect the band of this q tile
  const int q_last = min(q0 + TC, Sq) - 1;
  const int k_end = causal ? min(Sk, q_offset + q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int kt_begin = k_begin / TC;
  const int kt_end = k_end > 0 ? (k_end + TC - 1) / TC : 0;

  load_tile<D, TC>(sQ, qb, q0, Sq, ldq);
  if (kt_begin < kt_end) {
    load_tile<D, TC>(sK_of(0), kb, kt_begin * TC, Sk, ldk);
    load_tile<DV, TC>(sK_of(0) + TILE, vb, kt_begin * TC, Sk, ldv);
  }
  cp_async_commit();

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1, k0 = kt * TC;
    cp_async_wait_all();
    __syncthreads();    // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {
      load_tile<D, TC>(sK_of(st ^ 1), kb, k0 + TC, Sk, ldk);
      load_tile<DV, TC>(sK_of(st ^ 1) + TILE, vb, k0 + TC, Sk, ldv);
    }
    cp_async_commit();
    const uint32_t sK = sK_of(st), sV = sK + TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kstep_kmajor<TC>(sQ, kk), kstep_kmajor<TC>(sK, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // masks only where the tile crosses the band's edge or kv's end
    const bool edge = k0 + TC > Sk ||
                      (causal && k0 + TC - 1 > q_offset + q0) ||
                      (window > 0 && k0 <= q_offset + q0 + TC - 1 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      float x = s[e] * sm_scale;
      if (edge) {
        const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        const int qpos = q_offset + q0 + r_lo + 8 * hh;
        bool ok = kj < Sk;
        if (causal) ok = ok && qpos >= kj;
        if (window > 0) ok = ok && kj > qpos - window;
        if (!ok) x = kNegInf;
      }
      s[e] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = exp2f((m[hh] - mx[hh]) * kLog2e);
      m[hh] = mx[hh];
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      s[e] = exp2f((s[e] - m[hh]) * kLog2e);
      l[hh] += s[e];          // this lane's part of the row sum
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(s, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DV>(acc, pa[kk], kstep_mnmajor<TC>(sV, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }

  // A row with no unmasked key anywhere keeps m = -1e30: it takes the mean
  // of v over all Sk keys, summed by the whole block (as the float32 kernel)
  int any_masked = 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    any_masked |= (q0 + r_lo + 8 * hh < Sq) && (m[hh] == kNegInf);
  if (__syncthreads_or(any_masked)) {
    float* part = reinterpret_cast<float*>(smem + TILE);   // [128 / DV][DV]
    constexpr int RS = TC_THREADS / DV;                      // rows per pass
    const int c = tid % DV;
    float sum = 0.f;
    for (int kj = tid / DV; kj < Sk; kj += RS)
      sum += __bfloat162float(vb[static_cast<size_t>(kj) * ldv + c]);
    part[tid] = sum;
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (m[hh] != kNegInf) continue;
      l[hh] = static_cast<float>(Sk);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) {
        if (((i >> 1) & 1) != hh) continue;
        const int col = 8 * (i >> 2) + 2 * t + (i & 1);
        float cs = 0.f;
#pragma unroll
        for (int r = 0; r < RS; ++r) cs += part[r * DV + col];
        acc[i] = cs;
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + r_lo + 8 * hh;
    if (qi >= Sq) continue;
    const float lm = fmaxf(l[hh], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] = m[hh] + logf(lm);
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * Sq + qi) * ldo +
                          static_cast<size_t>(h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] / lm,
                                acc[4 * j + 2 * hh + 1] / lm);
  }
}

// Each launcher sets its kernel's shared-memory attribute once, on the
// device current at its first launch (the port serves on one card); the
// static's initialisation is thread-safe, so concurrent stage actors set it
// once between them.
template <int D, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
               int window, int q_offset, float sm_scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, DV>;
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (D * (BQ + PAD) + D * (BK + PAD) + BK * DV);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      KV, causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
                 int window, int q_offset, float sm_scale,
                 cudaStream_t stream) {
  auto kern = flash_fwd_wgmma_kernel<D, DV>;
  constexpr int smem = wgmma_smem_bytes<D, DV>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + TC - 1) / TC, H, B);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Sq, Sk, H, KV, causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel). Layouts (contiguous, 16-byte aligned): q (B, Sq, H, D),
// k (B, Sk, KV, D), v (B, Sk, KV, Dv), o (B, Sq, H, Dv); lse (B, H, Sq)
// float32, or null when the caller needs no backward. (D, Dv): bf16 (64,
// 64), (128, 128), (192, 128); float32 those and (96, 64); any other pair
// returns cudaErrorInvalidValue. Launches on `stream`, allocates nothing,
// does not synchronise; returns the CUDA error of the launch (0 = success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
    int causal, int window, int q_offset, float sm_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_FA_CASE(DT, HD, HDV, LAUNCH)                                   \
  if (dtype == DT && D == HD && Dv == HDV)                                   \
    return LAUNCH<HD, HDV>(q, k, v, o, l, B, Sq, Sk, H, KV, causal, window, \
                           q_offset, sm_scale, s);
  REPRO_FA_CASE(0, 64, 64, launch_f32)
  REPRO_FA_CASE(0, 128, 128, launch_f32)
  REPRO_FA_CASE(0, 192, 128, launch_f32)
  REPRO_FA_CASE(0, 96, 64, launch_f32)
  REPRO_FA_CASE(1, 64, 64, launch_wgmma)
  REPRO_FA_CASE(1, 128, 128, launch_wgmma)
  REPRO_FA_CASE(1, 192, 128, launch_wgmma)
#undef REPRO_FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
