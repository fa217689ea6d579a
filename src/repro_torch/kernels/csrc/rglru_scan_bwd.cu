// The RG-LRU recurrence's backward pass for Hopper (sm_90a), with a plain C
// interface.
//
// No TPU kernel behind it: the reference trains through XLA's autodiff of
// its jnp oracle (src/repro/kernels/ref.py, `rglru`), and this kernel
// stands for that gradient beside the forward kernel of csrc/rglru_scan.cu.
// Plain version: src/repro_torch/kernels/ref.py (`rglru_bwd`); Python
// wrapper: kernels/rglru_scan.py (`rglru_bwd`, and `RGLRU`, the autograd
// Function that launches it).
//
// What it computes: for x, a [B, T, W] (fp32 or bf16, one dtype), the
// optional h0 [B, W] (fp32) and the cotangent dout [B, T, W] of the
// forward's out (h_t = a_t h_{t-1} + s_t x_t, s_t = sqrt(max(1 - a_t^2,
// 0))), walking t from T - 1 down to 0 per (b, w):
//     g_t  = dout_t + a_{t+1} g_{t+1}                (g_{T-1} = dout_{T-1})
//     dx_t = g_t s_t
//     da_t = 2 (-(g_t x_t / (2 s_t)) [1 - a_t^2 >= 0]) a_t + g_t h_{t-1}
//     dh0  = a_0 g_0
// with h_{-1} = h0 (or 0). These are the plain gradient's IEEE operations
// in its order (PyTorch's autograd of the plain forward: the sqrt's
// backward grad / (2 s), the clamp's mask where 1 - a^2 >= 0, the two
// halves of a * a's product summed before a * h's term), written with
// round-to-nearest intrinsics so that nvcc contracts nothing into an FMA:
// dx, da and dh0 are the plain gradient's, value for value, NaN where it
// has NaN. At |a| = 1, s = 0 and da is -inf or +inf (NaN where x = 0),
// what the reference's autodiff gives there too; bf16 rounds an a near 1
// to exactly 1, so these values do occur in training.
//
// The walk needs h_{t-1} in fp32, as the forward carried it (the saved
// out holds it rounded to x's dtype). A forward pass over the sequence
// keeps h at the start of every chunk of kC steps in an fp32 workspace;
// the reverse pass takes the chunks last to first, recomputes each
// chunk's h from its checkpoint into registers, then walks it backwards.
//
// What bounds it on the card: bytes. It must read x, a and dout and write
// dx and da: 10 bytes an element in bf16 (20 in fp32); it reads x and a
// twice (14 bytes, plus 4 bytes per chunk of kC steps for the
// checkpoints), with some 20 fp32 operations an element. The walk is a
// chain per channel: one thread per (b, w) channel, nothing shared and
// no reduction, warps of 32 consecutive channels (coalesced along W), a
// block a warp so that a batch row of 4096 channels spreads over 128 SMs.
// Each chunk's loads are issued together ahead of its chain. A simple
// kernel: with one warp an SM, load latency and not bytes sets its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;        // steps per chunk (registers per array)
constexpr int kThreads = 32;  // channels per block
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the forward's step, in its IEEE operations (csrc/rglru_scan.cu)
__device__ __forceinline__ float step(float a, float x, float h) {
  const float s = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f));
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(s, x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const float* __restrict__ h0, const T* __restrict__ dout,
                 T* __restrict__ dx, T* __restrict__ da, float* __restrict__ dh0,
                 float* __restrict__ ckpt, int T_len, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const int n_chunks = (T_len + kC - 1) / kC;
  const int64_t base = static_cast<int64_t>(b) * T_len * W + w;   // (b, 0, w)
  float* ck = ckpt + static_cast<int64_t>(b) * n_chunks * W + w;  // [B, n_chunks, W]

  // ---- forward: h at the start of each chunk (the last chunk's walk is
  // the reverse pass's first recomputation)
  float h = h0 ? h0[static_cast<int64_t>(b) * W + w] : 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    ck[static_cast<int64_t>(c) * W] = h;
    if (c == n_chunks - 1) break;
    const int64_t off = base + static_cast<int64_t>(c) * kC * W;
    float xs[kC], as[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      xs[i] = to_f32(x[off + static_cast<int64_t>(i) * W]);
      as[i] = to_f32(a[off + static_cast<int64_t>(i) * W]);
    }
#pragma unroll
    for (int i = 0; i < kC; ++i) h = step(as[i], xs[i], h);
  }

  // ---- reverse, chunk by chunk
  float g_next = 0.0f, a_next = 0.0f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kC;
    const int n = min(kC, T_len - t0);
    const int64_t off = base + static_cast<int64_t>(t0) * W;
    float xs[kC], as[kC], ds[kC], hs[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      if (i < n) {
        const int64_t at = off + static_cast<int64_t>(i) * W;
        xs[i] = to_f32(x[at]);
        as[i] = to_f32(a[at]);
        ds[i] = to_f32(dout[at]);
      }
    }
    float hh = ck[static_cast<int64_t>(c) * W];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      if (i < n) {
        hs[i] = hh;                       // h_{t-1} of step t = t0 + i
        hh = step(as[i], xs[i], hh);
      }
    }
#pragma unroll
    for (int i = kC - 1; i >= 0; --i) {
      if (i < n) {
        const float ai = as[i], xi = xs[i];
        const float g = __fadd_rn(ds[i], __fmul_rn(g_next, a_next));
        const float u = __fsub_rn(1.0f, __fmul_rn(ai, ai));
        const float s = sqrtf(fmaxf(u, 0.0f));
        const float gc = __fdiv_rn(__fmul_rn(g, xi), __fmul_rn(2.0f, s));
        const float t1 = __fmul_rn(-(u >= 0.0f ? gc : 0.0f), ai);
        const int64_t at = off + static_cast<int64_t>(i) * W;
        dx[at] = from_f32<T>(__fmul_rn(g, s));
        da[at] = from_f32<T>(__fadd_rn(__fadd_rn(t1, t1), __fmul_rn(g, hs[i])));
        g_next = g;
        a_next = ai;
      }
    }
  }
  if (dh0) dh0[static_cast<int64_t>(b) * W + w] = __fmul_rn(g_next, a_next);
}

template <typename T>
int launch(const void* x, const void* a, const float* h0, const void* dout, void* dx,
           void* da, float* dh0, float* ckpt, int B, int T_len, int W,
           cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), h0, static_cast<const T*>(dout),
      static_cast<T*>(dx), static_cast<T*>(da), dh0, ckpt, T_len, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Workspace floats the C entry needs in ``ckpt`` for [B, T, W]: one fp32
// state per (b, chunk of kC steps, w).
extern "C" int64_t xbof_rglru_bwd_workspace(int B, int T, int W) {
  return static_cast<int64_t>(B) * ((T + kC - 1) / kC) * W;
}

// kind: 0 = fp32, 1 = bf16 (x, a, dout, dx and da alike); h0 is fp32 [B, W]
// or null for zeros, and dh0 (fp32 [B, W]) is written when it is given;
// ckpt holds xbof_rglru_bwd_workspace(B, T, W) floats. Returns
// cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an unknown kind, or kErrShape for a shape
// beyond the kernel's limits (B, T or W below 1, B above 65535). The
// Python wrapper turns kErrShape into a ValueError.
extern "C" int xbof_rglru_bwd(int kind, const void* x, const void* a, const void* h0,
                              const void* dout, void* dx, void* da, void* dh0, void* ckpt,
                              int B, int T, int W, void* stream) {
  if (B < 1 || T < 1 || W < 1 || B > 65535) return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  float* dh = static_cast<float*>(dh0);
  float* ck = static_cast<float*>(ckpt);
  switch (kind) {
    case 0: return launch<float>(x, a, h, dout, dx, da, dh, ck, B, T, W, s);
    case 1: return launch<__nv_bfloat16>(x, a, h, dout, dx, da, dh, ck, B, T, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
