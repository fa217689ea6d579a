// RWKV6 WKV recurrence for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU Pallas kernel `rwkv6_wkv` of src/repro/kernels/rwkv6_scan.py,
// and computes the whole of the reference oracle's signature
// (`repro.kernels.ref.rwkv6_wkv`): an optional initial state s0 and an
// optional final state, so that the prefill, which needs the final state,
// runs it too. Plain version: src/repro_torch/kernels/ref.py (`rwkv6_wkv`);
// Python wrapper: kernels/rwkv6_scan.py.
//
// What it computes: per (batch b, head h) a state S [K, V] in fp32, from
// s0 (fp32 [B, H, K, V]) or zeros; for t = 0 .. T-1, with r, k, w [B, T,
// H, K], v [B, T, H, V] and the bonus u [H, K] (fp32),
//     out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j]),
//     S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j],
// out [B, T, H, V] stored in r's dtype and, when asked, the final S stored
// in r's dtype (the oracle's `S_f.astype(r.dtype)`). Inputs are fp32 or
// bf16, one dtype; K = V, one of 16, 32, 64, 128.
//
// What bounds it on the card: the function needs 5 * K * V fp32
// operations per step and head (r . S, and w * S + k v^T), plus 3 K + 2 V
// for the bonus, which factors as (sum_i r_i u_i k_i) * v_j; against
// 2 * (3 K + 2 V) bytes (bf16) that is some 33 operations per byte at
// K = V = 64, above the fp32 balance of the CUDA cores (67 TFLOP/s over
// 3.35 TB/s = 20), so operations bound it (about 0.10 ms for the
// rwkv6-3b prefill's [4, 2048, 40, 64]). The walk along T is sequential
// per head, so with B * H = 160 heads it is bound by each step's latency
// long before that. This kernel does not factor the bonus: it spends 7
// operations per (i, j) pair where 5 would do.
//
// Design (simple and right first): one block of V threads per (b, h);
// thread j owns column j of S, K fp32 values in registers. Each step
// stages r_t, k_t and w_t (thread i loads element i of each) in shared
// memory, which is double-buffered so that one barrier per step suffices,
// and thread j keeps v_t[j] in a register. The next step's four values
// are loaded into registers before this step's barrier, so their latency
// overlaps this step's arithmetic. Then thread j computes out_t[j] from
// the old S and updates its column. Chunked (matrix-product) forms of the
// recurrence and the tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int K>
__global__ void __launch_bounds__(K)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ out, T* __restrict__ s_out, int T_len, int H) {
  __shared__ float sr[2][K], sk[2][K], sw[2][K], su[K];
  const int j = threadIdx.x;                 // column of S, element of r/k/w
  const int bh = blockIdx.x;                 // b * H + h
  const int h = bh % H;
  const int64_t b = bh / H;
  const int64_t step = static_cast<int64_t>(H) * K;           // one t
  const int64_t base = (b * T_len * H + h) * K + j;           // (b, 0, h, j)
  const int64_t state = static_cast<int64_t>(bh) * K * K;     // S of (b, h)

  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    S[i] = s0 != nullptr ? s0[state + static_cast<int64_t>(i) * K + j] : 0.0f;
  }
  su[j] = u[h * K + j];
  float rn = to_f32(r[base]), kn = to_f32(k[base]);
  float wn = to_f32(w[base]), vn = to_f32(v[base]);

  for (int t = 0; t < T_len; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    const float vj = vn;
    if (t + 1 < T_len) {  // the next step's values, in flight during this one
      const int64_t off = base + (t + 1) * step;
      rn = to_f32(r[off]);
      kn = to_f32(k[off]);
      wn = to_f32(w[off]);
      vn = to_f32(v[off]);
    }
    __syncthreads();
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float kv = sk[buf][i] * vj;
      acc += sr[buf][i] * (S[i] + su[i] * kv);
      S[i] = sw[buf][i] * S[i] + kv;
    }
    out[base + t * step] = from_f32<T>(acc);
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      s_out[state + static_cast<int64_t>(i) * K + j] = from_f32<T>(S[i]);
    }
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* out, void* s_out, int B,
           int T_len, int H, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * H;
  if (blocks > 2147483647LL) return kErrShape;
  rwkv6_kernel<T, K><<<static_cast<unsigned>(blocks), K, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(out), static_cast<T*>(s_out), T_len, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k(const void* r, const void* k, const void* v, const void* w,
               const float* u, const float* s0, void* out, void* s_out,
               int B, int T_len, int H, int K, cudaStream_t s) {
  switch (K) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, s_out, B, T_len, H, s);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, s_out, B, T_len, H, s);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, s_out, B, T_len, H, s);
    case 128: return launch<T, 128>(r, k, v, w, u, s0, out, s_out, B, T_len, H, s);
    default: return kErrShape;
  }
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (r, k, v, w, out and s_out alike); u is fp32
// [H, K]; s0 is fp32 [B, H, K, K] or null for zeros; s_out is [B, H, K, K]
// in the inputs' dtype or null when the final state is not wanted.
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an unknown kind, or kErrShape for a shape
// beyond the kernel's limits (K != V, K not one of 16, 32, 64, 128, B, T
// or H below 1, or more than 2^31 - 1 blocks). The Python wrapper turns
// kErrShape into a ValueError.
extern "C" int xbof_rwkv6_wkv(int kind, const void* r, const void* k,
                              const void* v, const void* w, const void* u,
                              const void* s0, void* out, void* s_out, int B,
                              int T, int H, int K, int V, void* stream) {
  if (B < 1 || T < 1 || H < 1 || K != V) return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  switch (kind) {
    case 0: return dispatch_k<float>(r, k, v, w, uf, s0f, out, s_out, B, T, H, K, s);
    case 1:
      return dispatch_k<__nv_bfloat16>(r, k, v, w, uf, s0f, out, s_out, B, T, H, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
