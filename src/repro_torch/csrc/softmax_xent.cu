// Sharded-vocab softmax cross-entropy, local statistics and their backward,
// for Hopper (sm_90a): the port's training-loss kernels.
//
// Forward replaces the Pallas TPU kernel
//   src/repro/kernels/softmax_xent/kernel.py: xent_local_stats_pallas
//   (body _xent_kernel): per row of a vocab shard (N, Vl), the max m, the
//   sum s = sum_j exp(x_j - m) and the label logit z (0 when the global label
//   falls outside [vocab_offset, vocab_offset + Vl)).
// Backward has no Pallas counterpart (the JAX model trains by autodiff of
// local_stats_ref): with m held fixed (the reference's stop_gradient),
//   dlogits[i, j] = ds_i * exp(x_ij - m_i) + dz_i * [j == label_i - offset],
// the one-hot term only where the label falls in the shard.
//
// Design. The TPU kernel walks a sequential (row block, vocab block) grid and
// carries (m, s, z) in VMEM scratch across the vocab axis. Here one block of
// 256 threads owns one row and streams it once with 16-byte loads (8 bf16 or
// 4 float32 values a thread), each thread keeping its own online (m, s) in
// float32; the block then merges the 256 pairs with warp shuffles and one
// shared-memory round. Columns >= Vl are never read, which is what the
// Pallas kernel's mask of its padded tail tile achieves. z is one read of the
// label's column by thread 0. Rows whose length in bytes is not a multiple
// of 16 (or whose base is not 16-byte aligned) take the scalar variant of the
// same loop.
//
// Bound. Both kernels move bytes and do a few operations per byte: the
// forward reads the logits once (N * Vl * 2 bytes in bf16; 1.24 GB at
// 4,096 x 151,936, about 0.37 ms at 3.35 TB/s), the backward reads them once
// and writes dlogits once (2.49 GB, about 0.74 ms). The backward is a fused
// elementwise pass for which Triton would serve as well; it is CUDA so that
// the port keeps one build path (nvcc + ctypes) and one toolchain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernel's finite sentinel
constexpr int NT = 256;             // threads per block (one row a block)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// merge (m2, s2) into (m, s): the online-softmax combine
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
struct Vec;   // one 16-byte load
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using type = float4;
  __device__ static void unpack(const float4& v, float* x) {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static float4 pack(const float* x) { return make_float4(x[0], x[1], x[2], x[3]); }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using type = uint4;
  __device__ static void unpack(const uint4& v, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* x) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return v;
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) xent_fwd_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    float* __restrict__ m_out, float* __restrict__ s_out,
    float* __restrict__ z_out, int Vl, int vocab_offset) {
  const int row = blockIdx.x, tid = threadIdx.x;
  const T* x = logits + static_cast<size_t>(row) * Vl;
  float m = kNegInf, s = 0.f;
  if (VEC) {
    using V = Vec<T>;
    const typename V::type* xv = reinterpret_cast<const typename V::type*>(x);
    const int nv = Vl / V::N;
    for (int i = tid; i < nv; i += NT) {
      float f[V::N];
      V::unpack(xv[i], f);
      float mx = f[0];
#pragma unroll
      for (int e = 1; e < V::N; ++e) mx = fmaxf(mx, f[e]);
      const float mn = fmaxf(m, mx);
      float acc = s * expf(m - mn);
#pragma unroll
      for (int e = 0; e < V::N; ++e) acc += expf(f[e] - mn);
      s = acc;
      m = mn;
    }
  } else {
    for (int j = tid; j < Vl; j += NT) {
      const float f = to_f(x[j]);
      const float mn = fmaxf(m, f);
      s = s * expf(m - mn) + expf(f - mn);
      m = mn;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float ms[NT / 32], ss[NT / 32];
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    ms[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < NT / 32; ++w) merge(m, s, ms[w], ss[w]);
    const int col = labels[row] - vocab_offset;
    m_out[row] = m;
    s_out[row] = s;
    z_out[row] = (col >= 0 && col < Vl) ? to_f(x[col]) : 0.f;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) xent_bwd_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ m_in, const float* __restrict__ ds_in,
    const float* __restrict__ dz_in, T* __restrict__ dlogits, int Vl,
    int vocab_offset) {
  const int row = blockIdx.x, tid = threadIdx.x;
  const size_t base = static_cast<size_t>(row) * Vl;
  const float m = m_in[row], ds = ds_in[row], dz = dz_in[row];
  const int col = labels[row] - vocab_offset;   // the one-hot column, if any
  if (VEC) {
    using V = Vec<T>;
    const typename V::type* xv = reinterpret_cast<const typename V::type*>(logits + base);
    typename V::type* yv = reinterpret_cast<typename V::type*>(dlogits + base);
    const int nv = Vl / V::N;
    for (int i = tid; i < nv; i += NT) {
      float f[V::N];
      V::unpack(xv[i], f);
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        const int j = i * V::N + e;
        f[e] = ds * expf(f[e] - m) + (j == col ? dz : 0.f);
      }
      yv[i] = V::pack(f);
    }
  } else {
    for (int j = tid; j < Vl; j += NT)
      store(&dlogits[base + j], ds * expf(to_f(logits[base + j]) - m) + (j == col ? dz : 0.f));
  }
}

template <typename T>
bool vectorizable(const void* a, const void* b, int Vl) {
  const uintptr_t mask = 15;
  return (static_cast<size_t>(Vl) * sizeof(T)) % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(a) & mask) == 0 &&
         (b == nullptr || (reinterpret_cast<uintptr_t>(b) & mask) == 0);
}

template <typename T>
int fwd(const void* logits, const int* labels, float* m, float* s, float* z,
        int N, int Vl, int off, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  if (vectorizable<T>(logits, nullptr, Vl))
    xent_fwd_kernel<T, true><<<N, NT, 0, stream>>>(x, labels, m, s, z, Vl, off);
  else
    xent_fwd_kernel<T, false><<<N, NT, 0, stream>>>(x, labels, m, s, z, Vl, off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* logits, const int* labels, const float* m,
        const float* ds, const float* dz, void* dlogits, int N, int Vl,
        int off, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  T* y = static_cast<T*>(dlogits);
  if (vectorizable<T>(logits, dlogits, Vl))
    xent_bwd_kernel<T, true><<<N, NT, 0, stream>>>(x, labels, m, ds, dz, y, Vl, off);
  else
    xent_bwd_kernel<T, false><<<N, NT, 0, stream>>>(x, labels, m, ds, dz, y, Vl, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. logits (N, Vl) contiguous, labels (N,)
// int32 global ids, m/s/z (N,) float32. Launches on `stream`, allocates
// nothing, does not synchronise; returns the CUDA error of the launch.
extern "C" int repro_xent_local_stats_fwd(const void* logits, const void* labels,
                                          void* m, void* s, void* z, int dtype,
                                          int N, int Vl, int vocab_offset,
                                          void* stream) {
  if (N <= 0 || Vl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(labels);
  float* mf = static_cast<float*>(m);
  float* sf = static_cast<float*>(s);
  float* zf = static_cast<float*>(z);
  if (dtype == 0) return fwd<float>(logits, lb, mf, sf, zf, N, Vl, vocab_offset, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(logits, lb, mf, sf, zf, N, Vl, vocab_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: m, ds, dz (N,) float32 in, dlogits (N, Vl) out in the
// logits' dtype.
extern "C" int repro_xent_local_stats_bwd(const void* logits, const void* labels,
                                          const void* m, const void* ds,
                                          const void* dz, void* dlogits, int dtype,
                                          int N, int Vl, int vocab_offset,
                                          void* stream) {
  if (N <= 0 || Vl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(labels);
  const float* mf = static_cast<const float*>(m);
  const float* dsf = static_cast<const float*>(ds);
  const float* dzf = static_cast<const float*>(dz);
  if (dtype == 0)
    return bwd<float>(logits, lb, mf, dsf, dzf, dlogits, N, Vl, vocab_offset, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(logits, lb, mf, dsf, dzf, dlogits, N, Vl, vocab_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
