// RG-LRU linear recurrence for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU Pallas kernel `rglru` of src/repro/kernels/rglru_scan.py.
// Plain version: src/repro_torch/kernels/ref.py (`rglru`); Python wrapper:
// kernels/rglru_scan.py.
//
// What it computes: for x, a [B, T, W] (fp32 or bf16, one dtype) and an
// optional h0 [B, W] (fp32), per (b, w) the recurrence
//     h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,   h_{-1} = h0 or 0,
// carried in fp32 over the whole sequence (the TPU kernel's fp32 carry
// row), each h_t stored in x's dtype as out[b, t, w]. The final state h_T
// is out[:, -1], already rounded to x's dtype, as in the TPU kernel; the
// wrapper returns that view. Each step is the plain version's sequence of
// IEEE operations (a * a, 1 - that, clamp, sqrt, times x, a * h, sum),
// written with round-to-nearest intrinsics so that nvcc does not contract
// them into FMAs: the fp32 result is the plain version's.
//
// What bounds it on the card: it reads x and a and writes out once, some
// 6 fp32 operations per element against 6 (bf16) or 12 (fp32) bytes: far
// below the H100's balance, so bytes bound it (about 0.06 ms for the
// recurrentgemma-9b prefill's [4, 2048, 4096] bf16 at 3.35 TB/s). But
// every step depends on the one before, so a walk along T is bound by the
// latency of its loads unless many are in flight.
//
// Design (simple and right first): one thread per (b, w) channel walks
// t = 0 .. T-1; neighbouring threads take neighbouring channels, so each
// warp's loads and stores along W are coalesced. The walk goes in chunks
// of kUnroll steps: the chunk's x and a are loaded into registers first
// (2 * kUnroll independent loads in flight per thread), then the chunk's
// recurrence runs on them. Chunked parallel scans over T (for small
// B * W) and wider loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;    // steps whose loads are issued together
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one step, in the plain version's order of IEEE operations
__device__ __forceinline__ float step(float h, float a, float x) {
  const float one_minus = __fsub_rn(1.0f, __fmul_rn(a, a));
  const float gain = sqrtf(fmaxf(one_minus, 0.0f));
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(gain, x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ a,
             const float* __restrict__ h0, T* __restrict__ out, int T_len,
             int W, int64_t channels) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= channels) return;
  const int64_t b = c / W;
  const int64_t w = c - b * W;
  const int64_t base = b * static_cast<int64_t>(T_len) * W + w;
  float h = h0 != nullptr ? h0[c] : 0.0f;
  int t = 0;
  for (; t + kUnroll <= T_len; t += kUnroll) {
    float xs[kUnroll], as[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t off = base + static_cast<int64_t>(t + i) * W;
      xs[i] = to_f32(x[off]);
      as[i] = to_f32(a[off]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = step(h, as[i], xs[i]);
      out[base + static_cast<int64_t>(t + i) * W] = from_f32<T>(h);
    }
  }
  for (; t < T_len; ++t) {  // the ragged tail
    const int64_t off = base + static_cast<int64_t>(t) * W;
    h = step(h, to_f32(a[off]), to_f32(x[off]));
    out[off] = from_f32<T>(h);
  }
}

template <typename T>
int launch(const void* x, const void* a, const float* h0, void* out, int B,
           int T_len, int W, cudaStream_t stream) {
  const int64_t channels = static_cast<int64_t>(B) * W;
  const int64_t blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return kErrShape;
  rglru_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), h0,
      static_cast<T*>(out), T_len, W, channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (x, a and out alike); h0 is fp32 [B, W] or
// null for zeros. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for an unknown kind, or kErrShape for a
// shape beyond the kernel's limits (B, T or W below 1, or more than
// 2^31 - 1 blocks). The Python wrapper turns kErrShape into a ValueError.
extern "C" int xbof_rglru(int kind, const void* x, const void* a,
                          const void* h0, void* out, int B, int T, int W,
                          void* stream) {
  if (B < 1 || T < 1 || W < 1) return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  switch (kind) {
    case 0: return launch<float>(x, a, h, out, B, T, W, s);
    case 1: return launch<__nv_bfloat16>(x, a, h, out, B, T, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
