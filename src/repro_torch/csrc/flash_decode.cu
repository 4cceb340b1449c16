// Split-KV flash decode for Hopper (sm_90a): the port's one-token kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_decode/kernel.py: flash_decode_pallas
//   (body _decode_kernel, and the split combine of its wrapper): per cache
//   split, the partial (m, l, acc) of a one-token query over the split's
//   keys, with the masks kpos <= cur_pos, kpos < k_offset + L and the
//   sliding window, then the P(max)/P(sum) combine of the splits. The
//   Pallas wrapper combines the splits outside its kernel; here the kernel
//   does, so one launch returns the cache's (m, l, acc). It also takes the
//   reference's ring caches (src/repro/kernels/flash_decode/ref.py:
//   k_positions, which its Pallas kernel lacks): an int32 table (B, L) of
//   each slot's absolute position, -1 for a slot never written, which
//   replaces kpos = k_offset + slot. A key then counts if kpos >= 0,
//   kpos <= cur_pos and, with a window, kpos > cur_pos - window.
//
// Bound. Decoding moves bytes: the K and V rows a row's mask lets through
// are read once, and every key costs 4 * D flops per q head, far below the
// card's operations-per-byte balance. A ring adds its position table, 4
// bytes a slot, and its valid slots are known only from the table. What a
// block can do about it is keep enough bytes in flight, keep the latency
// of its math off the loads, and keep every SM busy to the end.
//
// Design. A thread-block cluster per (batch row, kv head) group; its NS
// blocks are the group's splits (grid (NS, KV, B), cluster (NS, 1, 1)):
//   * the split plan: the wrapper picks NS from B * KV, L and the SM count
//     (kernel.py: split_plan), so the grid covers the card once or twice.
//     Each block takes its share of its own row's unmasked key range
//     [lo, hi] (from cur_pos, k_offset and the window), cut into NS even
//     parts on the card: a short row leaves no split idle, all splits of a
//     group carry the same work, no key past cur_pos is read, and nothing
//     syncs with the host. A ring's valid slots are no one range (after a
//     wrap two runs, in a partly filled ring holes of -1), so with
//     k_positions the blocks cut the whole cache [0, L) and mask each key
//     by its own table entry;
//   * each of a block's 4 warps takes 16 keys of every 64-key tile and
//     streams its K and V rows (and with a ring its 16 table entries)
//     through its own rows of a ring in shared memory (3 tiles for bf16, 2
//     for float32) with cp.async copies: the next tiles' copies are in
//     flight while the current one is computed, and the warps sync with
//     nothing but themselves until the last tile. (Bulk copies by the TMA
//     unit, one 256-byte request a row, were slower in a trial.) Rows are
//     padded by 16 bytes, so the fragment loads hit 32 distinct banks;
//   * the math is on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//     sums), the q heads as the 16 MMA rows: scores S = q K^T from the
//     staged K rows (bf16 q and k are exact, so S is the float32 dot
//     product); the online softmax (running max m, exp-sum l, rescale of
//     acc) runs in registers on S's fragments, which are P's A fragments
//     as they stand; acc += P V with V's fragments by ldmatrix.trans and P
//     as bf16 hi + lo, so P is carried to about 2^-16. float32 inputs
//     split q, k and v the same way (three products each). The math of a
//     tile is a few dozen MMAs a warp; one key a thread on the CUDA cores,
//     with block barriers between the phases, took several times as long.
//     A block still streams its part at a fixed rate a tile, so on a long
//     cache with uneven rows the longest row's blocks set the pace
//     (chip_smoke.py's ms_by_splits; PERF.md);
//   * the combine: after a cluster barrier (every block is done with its
//     ring) each warp stores its partial (m, l, acc) from registers into
//     the rings of the cluster's blocks (DSMEM stores): m and l to every
//     block, each acc column to the block that folds it. After a second
//     barrier, block s folds the s-th slice of the group's G * D columns
//     over the NS x 4 warp partials in (split, warp) order, from its own
//     shared memory, as kernel.py: combine_splits folds splits: m_g = max
//     of the partials' m, then l and acc summed with weights
//     exp(m - m_g). No remote loads, no scratch in device memory, no
//     fence, no atomics, no state kept between calls: the result is
//     deterministic and calls on different streams are independent;
//   * a warp that saw no key (a row with fewer keys than warps and
//     splits) leaves m = -inf, which the fold weighs 0. A key the mask
//     drops keeps the reference's finite sentinel: a row with no unmasked
//     key (by range, or every table entry masked) scores -1e30 at every
//     key of the cache and averages v; a key of a ring the table masks
//     scores -1e30, which weighs 0 beside any unmasked key.
// Inputs bf16 or float32; (m, l, acc) float32 of shapes (B, H), (B, H),
// (B, H, D). Head dims 64 or 128, Dv = D, groups of at most 16 q heads.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite mask sentinel
constexpr int NT = 128;             // threads per block (4 warps)
constexpr int NWARP = NT / 32;
constexpr int MAXG = 16;            // q heads per kv head: one MMA row tile
constexpr int MAX_SPLITS = 16;      // the largest (non-portable) cluster
constexpr int WKEYS = 16;           // keys a warp takes of each tile
constexpr int KEYS = NWARP * WKEYS; // keys a tile

// The shapes of one instantiation: K/V rows padded by 16 bytes, so that the
// MMA fragment loads (8 rows x 4 words, or ldmatrix's 8 rows x 16 bytes)
// hit 32 distinct banks; a ring of 3 tiles for bf16, 2 for float32.
template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int STAGES = F32 ? 2 : 3;
  static constexpr int ROW = D * static_cast<int>(sizeof(T));
  static constexpr int PITCH = ROW + 16;
  static constexpr int STAGE = 2 * KEYS * PITCH;   // K tile, then V tile
  static constexpr int RING = STAGES * STAGE;
  static constexpr int KSTEPS = D / 16;            // MMA steps over D
  static constexpr int NTILES = D / 8;             // 8-column tiles of acc
  // a ring cache's table entries of the staged tiles, beside the K/V ring
  static constexpr int KPOS = STAGES * KEYS * 4;
  // dynamic shared memory: the ring, which after the key loop receives
  // the cluster's warp partials (m, l, acc) for this block's columns,
  // then the table entries
  static constexpr int SMEM = RING + KPOS;
  static_assert((MAX_SPLITS * NWARP * 2 * MAXG + NWARP * (MAXG * D + 8 * MAX_SPLITS)) * 4
                <= RING, "");
};

// -inf: a key outside the split's part, whose weight must be exactly 0
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// (x, y) as bf16x2 (x in the low half) rounded, and what the rounding left
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// c += a b: m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 bytes global -> shared, in flight until cp_async_wait
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes global -> shared (a table entry), in the same commit groups
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ cur_pos, const int* __restrict__ k_positions,
    float* __restrict__ out, int L, int H, int KV, int k_offset, int window,
    float sm_scale) {
  using C = Cfg<T, D>;
  cg::cluster_group cluster = cg::this_cluster();
  const int NS = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = lane >> 2;             // MMA fragment row (q head), + 8
  const int cq = (lane & 3) * 2;        // MMA fragment column pair

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int* kring = reinterpret_cast<int*>(smem + C::RING);

  // q as the scores' A operand (rows: q heads, zero past G), per step of
  // 16 over D, read from device memory while cur_pos is on its way; a
  // float32 q is split into bf16 hi + lo
  unsigned qa[C::KSTEPS][4], ql[C::F32 ? C::KSTEPS : 1][4];
  {
    const T* qg = q + (static_cast<size_t>(b) * H + kvh * G) * D;
    const T* q0 = qg + r0 * D;
    const T* q1 = q0 + 8 * D;
    const bool ok0 = r0 < G, ok1 = r0 + 8 < G;
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* x = (e & 1 ? q1 : q0) + kk * 16 + cq + (e >> 1) * 8;
        const bool ok = e & 1 ? ok1 : ok0;
        if constexpr (C::F32) {
          const float2 f = ok ? *reinterpret_cast<const float2*>(x) : make_float2(0.f, 0.f);
          split2(f.x, f.y, qa[kk][e], ql[kk][e]);
        } else {
          qa[kk][e] = ok ? *reinterpret_cast<const unsigned*>(x) : 0u;
        }
      }
    }
  }

  // this row's unmasked local key range [lo, hi], and this block's part;
  // a ring's row takes the whole cache, each key masked by its table entry
  const int cur = cur_pos[b];
  const int* kp = k_positions ? k_positions + static_cast<size_t>(b) * L : nullptr;
  int lo = window > 0 ? max(0, cur - window + 1 - k_offset) : 0;
  int hi = min(L - 1, cur - k_offset);
  const bool masked = !kp && lo > hi;   // no unmasked key: average v
  if (masked || kp) {
    lo = 0;
    hi = L - 1;
  }
  const int n = hi - lo + 1;
  const int p0 = lo + static_cast<int>(static_cast<long long>(n) * split / NS);
  const int p1 = lo + static_cast<int>(static_cast<long long>(n) * (split + 1) / NS);
  const int ntiles = (p1 - p0 + KEYS - 1) / KEYS;

  const size_t key_bytes = static_cast<size_t>(KV) * D * sizeof(T);
  const size_t base = (static_cast<size_t>(b) * L * KV + kvh) * D;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k + base);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v + base);

  // this warp's 16 K and V rows of tile t into its rows of the ring: lane
  // copies 16-byte chunk `lane % CH` of rows lane / CH + RPI i; a row past
  // the part copies the part's last row again, so the rows stay finite
  // (their P is 0). With a ring, lanes 0-15 copy the 16 keys' table
  // entries too
  constexpr int CH = C::ROW / 16;       // 16-byte chunks a row
  constexpr int RPI = 32 / CH;          // rows a warp copies an instruction
  const int jl = lane / CH, c16 = (lane % CH) * 16;
  auto load_tile = [&](int t) {
    const int j0 = p0 + t * KEYS + warp * WKEYS;
    const int nv = min(WKEYS, p1 - j0);
    if (nv <= 0) return;                // this warp has no key in tile t
    unsigned char* dst = ring + (t % C::STAGES) * C::STAGE
                         + (warp * WKEYS + jl) * C::PITCH + c16;
#pragma unroll
    for (int i = 0; i < WKEYS / RPI; ++i) {
      const size_t off = (j0 + min(jl + i * RPI, nv - 1)) * key_bytes + c16;
      cp_async16(dst + i * RPI * C::PITCH, kg + off);
      cp_async16(dst + (KEYS + i * RPI) * C::PITCH, vg + off);
    }
    if (kp && lane < WKEYS)
      cp_async4(kring + (t % C::STAGES) * KEYS + warp * WKEYS + lane,
                kp + j0 + min(lane, nv - 1));
  };

  // the copies go out first: the ring's first STAGES - 1 tiles
#pragma unroll
  for (int t = 0; t < C::STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  // this warp's online softmax over its keys: rows r0 and r0 + 8
  float o[C::NTILES][4];
#pragma unroll
  for (int t = 0; t < C::NTILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int nv = min(WKEYS, p1 - (p0 + t * KEYS + warp * WKEYS));
    if (nv <= 0) break;                 // nor in any later tile
    cp_async_wait<C::STAGES - 2>();     // this lane's copies of tile t
    __syncwarp();                       // the warp's; tile t - 1 is done
    if (t + C::STAGES - 1 < ntiles) load_tile(t + C::STAGES - 1);
    cp_async_commit();
    const unsigned char* kt = ring + (t % C::STAGES) * C::STAGE + warp * WKEYS * C::PITCH;
    const unsigned char* vt = kt + KEYS * C::PITCH;
    const int* kpt = kring + (t % C::STAGES) * KEYS + warp * WKEYS;

    // scores S (q heads x 16 keys) = q K^T: s[h][e] is key h * 8 + cq +
    // (e & 1) of head r0 (e < 2) or r0 + 8
    // (two accumulators a half, even and odd steps: shorter MMA chains)
    float s[2][4], s2[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[h][e] = s2[h][e] = 0.f;
      const unsigned char* krow = kt + (h * 8 + r0) * C::PITCH;
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const int d = kk * 16 + cq;
        float (&acc)[4] = kk & 1 ? s2[h] : s[h];
        if constexpr (C::F32) {
          const float2 x0 = *reinterpret_cast<const float2*>(krow + d * 4);
          const float2 x1 = *reinterpret_cast<const float2*>(krow + (d + 8) * 4);
          unsigned bh0, bl0, bh1, bl1;
          split2(x0.x, x0.y, bh0, bl0);
          split2(x1.x, x1.y, bh1, bl1);
          mma(acc, qa[kk], bh0, bh1);
          mma(acc, qa[kk], bl0, bl1);
          mma(acc, ql[kk], bh0, bh1);
        } else {
          mma(acc, qa[kk], *reinterpret_cast<const unsigned*>(krow + d * 2),
              *reinterpret_cast<const unsigned*>(krow + (d + 8) * 2));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[h][e] += s2[h][e];
    }

    // online softmax: -inf past the part (weight exactly 0), the finite
    // sentinel on a row with no unmasked key and on a key its table masks
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = h * 8 + cq + (e & 1);
        bool live = !masked;
        if (kp) {
          const int pj = kpt[j];
          live = pj >= 0 && pj <= cur && (window <= 0 || pj > cur - window);
        }
        const float x = j < nv ? (live ? s[h][e] * sm_scale : kNegInf) : neg_inf();
        s[h][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float sc0 = __expf(m0 - mn0), sc1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[h][e] - (e < 2 ? mn0 : mn1));
        s[h][e] = p;
        if (e < 2) ls0 += p;
        else ls1 += p;
      }
    l0 = l0 * sc0 + ls0;
    l1 = l1 * sc1 + ls1;
    if (!__all_sync(0xffffffffu, sc0 == 1.f && sc1 == 1.f)) {
#pragma unroll
      for (int t2 = 0; t2 < C::NTILES; ++t2) {
        o[t2][0] *= sc0;
        o[t2][1] *= sc0;
        o[t2][2] *= sc1;
        o[t2][3] *= sc1;
      }
    }

    // acc += P V: P (the scores' C fragments are its A fragment) as bf16
    // hi + lo, V from the staged tile
    unsigned ph[4], pl[4];
    split2(s[0][0], s[0][1], ph[0], pl[0]);
    split2(s[0][2], s[0][3], ph[1], pl[1]);
    split2(s[1][0], s[1][1], ph[2], pl[2]);
    split2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int t2 = 0; t2 < C::NTILES; t2 += 2) {
      if constexpr (C::F32) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const unsigned char* col = vt + ((t2 + u) * 8 + r0) * 4;
          const float* v0 = reinterpret_cast<const float*>(col + cq * C::PITCH);
          const float* v1 = reinterpret_cast<const float*>(col + (cq + 1) * C::PITCH);
          const float* v8 = reinterpret_cast<const float*>(col + (cq + 8) * C::PITCH);
          const float* v9 = reinterpret_cast<const float*>(col + (cq + 9) * C::PITCH);
          unsigned bh0, bl0, bh1, bl1;
          split2(*v0, *v1, bh0, bl0);
          split2(*v8, *v9, bh1, bl1);
          mma(o[t2 + u], ph, bh0, bh1);
          mma(o[t2 + u], ph, bl0, bl1);
          mma(o[t2 + u], pl, bh0, bh1);
        }
      } else {
        // four 8x8 blocks, transposed: keys 0-7 / 8-15 x columns t2 * 8
        // and (t2 + 1) * 8; lane gives row lane & 7 of block lane >> 3
        const int blk = lane >> 3;
        unsigned bv[4];
        ldsm_x4_trans(bv, vt + ((blk & 1) * 8 + (lane & 7)) * C::PITCH
                              + (t2 * 8 + (blk >> 1) * 8) * 2);
        mma(o[t2], ph, bv[0], bv[1]);
        mma(o[t2], pl, bv[0], bv[1]);
        mma(o[t2 + 1], ph, bv[2], bv[3]);
        mma(o[t2 + 1], pl, bv[2], bv[3]);
      }
    }
  }

  // l summed over the quad of lanes that hold one row
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  cp_async_wait<0>();
  cluster.sync();                       // every block is done with its ring

  // the combine. Block s folds the s-th slice of the group's G * D
  // columns; each warp pushes its partial from registers into the rings
  // of the blocks that fold it (DSMEM stores): its (m, l) to every block,
  // each acc column to the block that folds it. Layout of a ring: m
  // (slots, MAXG), l (slots, MAXG), acc (slots, per), slot = split * 4 +
  // warp
  const int GD = G * D;
  const int per = ((GD + NS - 1) / NS + 7) & ~7;   // even: pairs stay whole
  const int slots = NS * NWARP;
  const int slot = split * NWARP + warp;
  float* rm = reinterpret_cast<float*>(ring);
  float* rl = rm + slots * MAXG;
  float* ra = rl + slots * MAXG;
  if ((lane & 3) == 0) {
    for (int s = 0; s < NS; ++s) {
      float* pm = cluster.map_shared_rank(rm, s) + slot * MAXG;
      float* pl = pm + slots * MAXG;
      pm[r0] = m0;
      pm[r0 + 8] = m1;
      pl[r0] = l0;
      pl[r0 + 8] = l1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = r0 + 8 * h;
    if (g < G) {
#pragma unroll
      for (int t2 = 0; t2 < C::NTILES; ++t2) {
        const int i = g * D + t2 * 8 + cq;
        const int s = i / per;
        float* pa = cluster.map_shared_rank(ra, s) + slot * per + (i - s * per);
        *reinterpret_cast<float2*>(pa) = make_float2(o[t2][2 * h], o[t2][2 * h + 1]);
      }
    }
  }
  cluster.sync();                       // every partial has arrived

  // fold this block's slice over the NS x 4 warp partials in (split, warp)
  // order: m_g = max of the partials' m, then l and acc summed with
  // weights exp(m - m_g); a warp that saw no key (m = -inf) weighs 0, and
  // a group that saw none leaves the finite sentinel
  const int i0 = split * per;
  const int i1 = min(GD, i0 + per);
  for (int i = i0 + tid; i < i1; i += NT) {
    const int g = i / D;
    float mg = neg_inf();
    for (int u = 0; u < slots; ++u) mg = fmaxf(mg, rm[u * MAXG + g]);
    float lg = 0.f, ag = 0.f;
    for (int u = 0; u < slots; ++u) {
      const float mu = rm[u * MAXG + g];
      const float wt = mu == neg_inf() ? 0.f : expf(mu - mg);
      lg += rl[u * MAXG + g] * wt;
      ag += ra[u * per + i - i0] * wt;
    }
    const size_t hb = static_cast<size_t>(b) * H + kvh * G + g;
    const size_t BH = static_cast<size_t>(gridDim.z) * H;
    out[2 * BH + hb * D + (i - g * D)] = ag;
    if (i - g * D == 0) {
      out[hb] = mg == neg_inf() ? kNegInf : mg;
      out[BH + hb] = lg;
    }
  }
}

// Set the kernel's attributes once per device: dynamic shared memory past
// 48 KB, and clusters of up to 16 blocks (8 is the portable limit).
template <typename T, int D>
cudaError_t prepare(int device) {
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  auto kern = flash_decode_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<T, D>::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* cur_pos, const void* k_positions, void* out,
                   int B, int L, int H,
                   int KV, int NS, int k_offset, int window, float sm_scale,
                   int device, cudaStream_t stream) {
  cudaError_t e = prepare<T, D>(device);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NS, KV, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Cfg<T, D>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_decode_kernel<T, D>,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v),
                         static_cast<const int*>(cur_pos),
                         static_cast<const int*>(k_positions),
                         static_cast<float*>(out), L, H, KV, k_offset, window,
                         sm_scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* cur_pos, const void* k_positions, void* out,
                     int B, int L, int H,
                     int KV, int NS, int k_offset, int window, float sm_scale,
                     int device, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, cur_pos, k_positions, out, B, L, H, KV,
                         NS, k_offset, window, sm_scale, device, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, cur_pos, k_positions, out, B, L, H, KV,
                          NS, k_offset, window, sm_scale, device, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t max_clusters(int* n, cudaLaunchConfig_t cfg, int device) {
  cudaError_t e = prepare<T, D>(device);
  if (e != cudaSuccess) return e;
  cfg.dynamicSmemBytes = Cfg<T, D>::SMEM;
  return cudaOccupancyMaxActiveClusters(n, flash_decode_kernel<T, D>, &cfg);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts (contiguous): q (B, H, D),
// k and v (B, L, KV, D) at 16-byte aligned addresses, cur_pos (B,) int32,
// k_positions (B, L) int32 or null (a ring cache's slot positions; it
// overrides k_offset).
// `out`: float32, B H (D + 2) floats: m (B, H), l (B, H), acc (B, H, D).
// `splits`: NS, the blocks (one cluster) per (batch row, kv head), 1-16.
// Launches on `stream` of card `device` (made current for the launch and
// restored), allocates nothing, keeps no state between calls, does not
// synchronise; returns the CUDA error of the launch (0 = success).
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const void* cur_pos,
    const void* k_positions, void* out, int dtype, int B, int L, int H,
    int KV, int D, int splits, int k_offset, int window, float sm_scale,
    int device, void* stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG ||
      splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    e = dispatch<float>(D, q, k, v, cur_pos, k_positions, out, B, L, H, KV,
                        splits, k_offset, window, sm_scale, device, s);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(D, q, k, v, cur_pos, k_positions, out, B, L,
                                H, KV, splits, k_offset, window, sm_scale,
                                device, s);
  else
    e = cudaErrorInvalidValue;
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(e);
}

// How many clusters of `splits` blocks of the kernel fit on the card at
// once (cudaOccupancyMaxActiveClusters); < 0 is minus a CUDA error. The
// split plan keeps a grid's clusters within it (kernel.py: split_plan).
extern "C" int repro_flash_decode_max_clusters(int dtype, int D, int splits,
                                               int device) {
  int prev = -1;
  if (cudaGetDevice(&prev) != cudaSuccess) return -1;
  if (prev != device && cudaSetDevice(device) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1, 1);
  cfg.blockDim = dim3(NT);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1 && D == 128) e = max_clusters<__nv_bfloat16, 128>(&n, cfg, device);
  else if (dtype == 1 && D == 64) e = max_clusters<__nv_bfloat16, 64>(&n, cfg, device);
  else if (dtype == 0 && D == 128) e = max_clusters<float, 128>(&n, cfg, device);
  else if (dtype == 0 && D == 64) e = max_clusters<float, 64>(&n, cfg, device);
  if (prev != device) cudaSetDevice(prev);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
