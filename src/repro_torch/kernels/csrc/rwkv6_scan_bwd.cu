// The RWKV6 WKV recurrence's backward pass for Hopper (sm_90a), with a
// plain C interface.
//
// No TPU kernel behind it: the reference trains through XLA's autodiff of
// its jnp oracle (src/repro/kernels/ref.py, `rwkv6_wkv`), and this kernel
// stands for that gradient beside the forward kernel of
// csrc/rwkv6_scan.cu. Plain version: src/repro_torch/kernels/ref.py
// (`rwkv6_wkv_bwd`); Python wrapper: kernels/rwkv6_scan.py (`rwkv6_wkv_bwd`,
// and `RWKV6WKV`, the autograd Function that launches it).
//
// What it computes: the forward keeps per (b, h) a state S [K, V] in fp32,
// out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(w_t) S_{t-1} +
// k_t v_t^T from S_{-1} = s0. Given the cotangents dout [B, T, H, V] of
// out and dS_T [B, H, K, V] of the final state (zeros when none comes),
// the reverse walk is
//     dS_{t-1} = diag(w_t) dS_t + r_t dout_t^T
//     dr_t[k]  = sum_v (S_{t-1}[k,v] + u[k] k_t[k] v_t[v]) dout_t[v]
//     dkv_t    = diag(u) r_t dout_t^T + dS_t
//     dk_t[k]  = sum_v dkv_t[k,v] v_t[v],  dv_t[v] = sum_k dkv_t[k,v] k_t[k]
//     dw_t[k]  = sum_v dS_t[k,v] S_{t-1}[k,v]
//     du[k]    = sum_{b,t} r_t[k] k_t[k] (v_t . dout_t),   ds0 = dS_{-1}.
// Inputs fp32 or bf16, one dtype (dout in it too); u, s0 and dS_T fp32;
// dr, dk, dv, dw written in the inputs' dtype, du and ds0 in fp32. K = V,
// one of 16, 32, 64, 128. Everything is summed in fp32 on the CUDA cores.
//
// What bounds it on the card: per (b, t, h) some 10 K V operations (the
// state's recomputation and dS's walk, 2 each per (k, v); dr, dk, dv and
// dw, one multiply-add each) against 18 bytes an element in bf16 (r, k, v,
// w and dout read, dr, dk, dv and dw written): at 67 TFLOP/s fp32 the
// operations bound it, 0.10 ms for a [1, 4096, 40, 64] microbatch. A walk
// along T is a chain of dependent steps; the kernel takes the chain's
// length in chunks and runs what does not depend on it in parallel.
//
// Design. dw needs S_{t-1} at every step of the reverse walk and w = 0
// occurs in bf16, so S cannot be recovered backwards as (S_t - k v^T) /
// w_t; storing every state would take B T H K V 4 bytes (5.4 GB at [2,
// 4096, 40, 64]). Instead:
// - A block takes one (b, h) and a slice of VS columns of S (VS = 16,
//   8 at K = 128: V / VS blocks a head, so a [1, 4096, 40, 64] microbatch
//   makes 160 blocks and not 40), one thread per (k, v) element of the
//   slice (K VS threads): columns of S are independent across v.
// - A forward walk over T keeps S at the start of every chunk of kC = 8
//   steps in an fp32 workspace (each thread its own element; it reads them
//   back itself, so no barrier guards them).
// - The reverse pass takes the chunks last to first. Per chunk the
//   inputs' rows come into shared memory; each thread recomputes its
//   element of S_{t-1} for the chunk's steps from the checkpoint and walks
//   dS backwards, storing both per step ([kC][K][VS + 1]: the pad keeps a
//   row's reads by threads of consecutive k on distinct banks). After a
//   barrier the sums run in parallel over the chunk: a thread per (t, k)
//   sums dr, dk and dw over the slice's v (and v . dout for du), a thread
//   per (t, v) sums dv over all K. Each sum runs in a fixed order.
// - dr, dk and dw are partial over the slices; du over slices and
//   batches. They go to an fp32 workspace per slice, and a second kernel
//   sums them in slice order (then batch order for du) and writes the
//   outputs: no atomics, so a repeated call gives the same bits (the
//   trainer's restart compares losses to rtol 1e-6).
// The recomputed S repeats the forward's fp32 operations in its order
// (the plain version's: w * S, plus k * v).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 8;  // steps per chunk
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

// columns of S a block takes
template <int K>
__host__ __device__ constexpr int slice_cols() { return K == 128 ? 8 : 16; }

template <int K>
constexpr size_t smem_floats() {
  constexpr int VS = slice_cols<K>();
  return 2 * kC * K * (VS + 1) + 3 * kC * K + 2 * kC * VS + K;
}

template <int K>
int64_t workspace_floats(int B, int T, int H) {
  constexpr int NS = K / slice_cols<K>();
  const int64_t n = static_cast<int64_t>(B) * T * H * K;     // elements of r
  const int64_t chunks = (T + kC - 1) / kC;
  return static_cast<int64_t>(B) * H * K * K * chunks      // checkpoints
         + 3 * NS * n                                       // dr, dk, dw partials
         + static_cast<int64_t>(NS) * B * H * K;            // du partials
}

template <typename T, int K>
__global__ void __launch_bounds__(K * slice_cols<K>())
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, const T* __restrict__ dout,
               const float* __restrict__ dsT, T* __restrict__ dv, float* __restrict__ ds0,
               float* __restrict__ ckpt, float* __restrict__ part,
               float* __restrict__ du_part, int B, int Tn, int H) {
  constexpr int VS = slice_cols<K>();
  constexpr int NS = K / VS;
  constexpr int NT = K * VS;
  constexpr int P = VS + 1;
  static_assert(NT >= kC * K, "a thread per (t, k) item of a chunk");
  extern __shared__ float sm[];
  float* sS = sm;                  // [kC][K][P]  S_{t-1}
  float* sdS = sS + kC * K * P;    // [kC][K][P]  dS_t
  float* sr = sdS + kC * K * P;    // [kC][K]
  float* sk = sr + kC * K;
  float* sw = sk + kC * K;
  float* sv = sw + kC * K;         // [kC][VS]
  float* sd = sv + kC * VS;        // [kC][VS]  dout
  float* su = sd + kC * VS;        // [K]

  const int bh = blockIdx.x, sl = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int kk = tid / VS, vv = tid % VS;
  const int v0 = sl * VS;
  const int n_chunks = (Tn + kC - 1) / kC;
  const int64_t n_el = static_cast<int64_t>(B) * Tn * H * K;
  // element (b, t, h, i) of r, k, w (and of v, dout: V = K)
  auto at = [&](int t, int i) -> int64_t {
    return (static_cast<int64_t>(b) * Tn + t) * H * K + static_cast<int64_t>(h) * K + i;
  };
  const int64_t state = (static_cast<int64_t>(bh) * K + kk) * K + v0 + vv;
  float* ck = ckpt + (static_cast<int64_t>(bh) * NS + sl) * n_chunks * NT + tid;

  // ---- forward: S at the start of every chunk
  float S = s0 ? s0[state] : 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    ck[static_cast<int64_t>(c) * NT] = S;
    if (c == n_chunks - 1) break;
    const int t0 = c * kC;
    __syncthreads();
    for (int i = tid; i < kC * K; i += NT) {
      sw[i] = to_f32(w[at(t0 + i / K, i % K)]);
      sk[i] = to_f32(k[at(t0 + i / K, i % K)]);
    }
    for (int i = tid; i < kC * VS; i += NT) sv[i] = to_f32(v[at(t0 + i / VS, v0 + i % VS)]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      S = __fadd_rn(__fmul_rn(sw[j * K + kk], S), __fmul_rn(sk[j * K + kk], sv[j * VS + vv]));
    }
  }

  // ---- reverse, chunk by chunk
  for (int i = tid; i < K; i += NT) su[i] = u[static_cast<int64_t>(h) * K + i];
  float dS = dsT ? dsT[state] : 0.0f;
  float du_acc = 0.0f;   // this thread's (t, k) item: t = t0 + tid / K, k = tid % K
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kC;
    const int n = min(kC, Tn - t0);
    __syncthreads();
    for (int i = tid; i < kC * K; i += NT) {
      const bool in = i / K < n;
      const int64_t src = in ? at(t0 + i / K, i % K) : 0;
      sr[i] = in ? to_f32(r[src]) : 0.0f;
      sk[i] = in ? to_f32(k[src]) : 0.0f;
      sw[i] = in ? to_f32(w[src]) : 0.0f;
    }
    for (int i = tid; i < kC * VS; i += NT) {
      const bool in = i / VS < n;
      const int64_t src = in ? at(t0 + i / VS, v0 + i % VS) : 0;
      sv[i] = in ? to_f32(v[src]) : 0.0f;
      sd[i] = in ? to_f32(dout[src]) : 0.0f;
    }
    __syncthreads();
    float s = ck[static_cast<int64_t>(c) * NT];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      if (j < n) {
        sS[(j * K + kk) * P + vv] = s;
        s = __fadd_rn(__fmul_rn(sw[j * K + kk], s), __fmul_rn(sk[j * K + kk], sv[j * VS + vv]));
      }
    }
#pragma unroll
    for (int j = kC - 1; j >= 0; --j) {
      if (j < n) {
        sdS[(j * K + kk) * P + vv] = dS;
        dS = __fadd_rn(__fmul_rn(sw[j * K + kk], dS), __fmul_rn(sr[j * K + kk], sd[j * VS + vv]));
      }
    }
    __syncthreads();
    // a thread per (t, k): dr, dk, dw over the slice's v; v . dout for du
    if (tid < kC * K && tid / K < n) {
      const int j = tid / K, q = tid % K;
      const float rq = sr[j * K + q], kq = sk[j * K + q], uq = su[q];
      const float* s_row = sS + (j * K + q) * P;
      const float* ds_row = sdS + (j * K + q) * P;
      float ar = 0.0f, ak = 0.0f, aw = 0.0f, avd = 0.0f;
#pragma unroll
      for (int x = 0; x < VS; ++x) {
        const float vx = sv[j * VS + x], dx = sd[j * VS + x];
        const float sx = s_row[x], dsx = ds_row[x];
        ar += (sx + uq * (kq * vx)) * dx;
        ak += (uq * (rq * dx) + dsx) * vx;
        aw += dsx * sx;
        avd += vx * dx;
      }
      const int64_t o = at(t0 + j, q);
      part[(0 * NS + sl) * n_el + o] = ar;
      part[(1 * NS + sl) * n_el + o] = ak;
      part[(2 * NS + sl) * n_el + o] = aw;
      du_acc += (rq * kq) * avd;
    }
    // a thread per (t, v): dv over all K
    for (int i = tid; i < n * VS; i += NT) {
      const int j = i / VS, x = i % VS;
      const float dx = sd[j * VS + x];
      float acc = 0.0f;
#pragma unroll 8
      for (int q = 0; q < K; ++q) {
        acc += (su[q] * (sr[j * K + q] * dx) + sdS[(j * K + q) * P + x]) * sk[j * K + q];
      }
      dv[at(t0 + j, v0 + x)] = from_f32<T>(acc);
    }
  }
  if (ds0) ds0[state] = dS;
  // du's partial of this (slice, b, h): the (t, k) items' sums over t, in order
  __syncthreads();
  if (tid < kC * K) sS[tid] = du_acc;
  __syncthreads();
  if (tid < K) {
    float acc = 0.0f;
    for (int j = 0; j < kC; ++j) acc += sS[j * K + tid];
    du_part[((static_cast<int64_t>(sl) * B + b) * H + h) * K + tid] = acc;
  }
}

// dr, dk, dw: the slices' partials summed in slice order; du [H, K]: its
// partials summed over slices, then batches, in order
template <typename T>
__global__ void __launch_bounds__(256)
wkv_bwd_sum_kernel(const float* __restrict__ part, const float* __restrict__ du_part,
                   T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dw,
                   float* __restrict__ du, int NS, int64_t n_el, int B, int HK) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_el;
       i += stride) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int s = 0; s < NS; ++s) {
      a0 += part[(0 * static_cast<int64_t>(NS) + s) * n_el + i];
      a1 += part[(1 * static_cast<int64_t>(NS) + s) * n_el + i];
      a2 += part[(2 * static_cast<int64_t>(NS) + s) * n_el + i];
    }
    dr[i] = from_f32<T>(a0);
    dk[i] = from_f32<T>(a1);
    dw[i] = from_f32<T>(a2);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < HK) {
    float acc = 0.0f;
    for (int s = 0; s < NS; ++s)
      for (int bb = 0; bb < B; ++bb) acc += du_part[(static_cast<int64_t>(s) * B + bb) * HK + i];
    du[i] = acc;
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           const float* s0, const void* dout, const float* dsT, void* dr, void* dk,
           void* dv, void* dw, float* du, float* ds0, float* ws, int B, int Tn, int H,
           cudaStream_t stream) {
  constexpr int VS = slice_cols<K>();
  constexpr int NS = K / VS;
  if (static_cast<int64_t>(B) * H > 2147483647LL) return kErrShape;
  const int64_t n_el = static_cast<int64_t>(B) * Tn * H * K;
  const int64_t chunks = (Tn + kC - 1) / kC;
  float* ckpt = ws;
  float* part = ckpt + static_cast<int64_t>(B) * H * K * K * chunks;
  float* du_part = part + 3 * NS * n_el;
  constexpr size_t smem = smem_floats<K>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_kernel<T, K><<<dim3(static_cast<unsigned>(B * H), NS), K * VS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, s0, static_cast<const T*>(dout), dsT, static_cast<T*>(dv),
      ds0, ckpt, part, du_part, B, Tn, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (n_el + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  const int hk = H * K;
  const int blocks_hk = (hk + 255) / 256;
  wkv_bwd_sum_kernel<T><<<blocks > blocks_hk ? blocks : blocks_hk, 256, 0, stream>>>(
      part, du_part, static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dw), du, NS,
      n_el, B, hk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int K, const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* s0, const void* dout, const float* dsT, void* dr,
             void* dk, void* dv, void* dw, float* du, float* ds0, float* ws, int B, int Tn,
             int H, cudaStream_t s) {
  switch (K) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, ws, B, Tn, H,
                           s);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, ws, B, Tn, H,
                           s);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, ws, B, Tn, H,
                           s);
    case 128:
      return launch<T, 128>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, ws, B, Tn, H,
                           s);
    default: return kErrShape;
  }
}

}  // namespace

// Workspace floats the C entry needs in ``ws`` for r [B, T, H, K]: the
// chunk checkpoints, the slices' partials of dr, dk and dw, and du's; -1
// for a K the kernel does not take.
extern "C" int64_t xbof_rwkv6_wkv_bwd_workspace(int B, int T, int H, int K) {
  switch (K) {
    case 16: return workspace_floats<16>(B, T, H);
    case 32: return workspace_floats<32>(B, T, H);
    case 64: return workspace_floats<64>(B, T, H);
    case 128: return workspace_floats<128>(B, T, H);
    default: return -1;
  }
}

// kind: 0 = fp32, 1 = bf16 (r, k, v, w, dout, dr, dk, dv and dw alike); u
// fp32 [H, K]; s0 fp32 [B, H, K, K] or null for zeros; dsT, the final
// state's cotangent, fp32 [B, H, K, K] or null for zeros; du fp32 [H, K]
// is written, and ds0 fp32 [B, H, K, K] when it is given; ws holds
// xbof_rwkv6_wkv_bwd_workspace(B, T, H, K) floats. Returns
// cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unknown kind, or kErrShape for a shape
// beyond the kernel's limits (K != V, K not one of 16, 32, 64, 128, B, T
// or H below 1, or more than 2^31 - 1 blocks). The Python wrapper turns
// kErrShape into a ValueError.
extern "C" int xbof_rwkv6_wkv_bwd(int kind, const void* r, const void* k, const void* v,
                                  const void* w, const void* u, const void* s0,
                                  const void* dout, const void* dsT, void* dr, void* dk,
                                  void* dv, void* dw, void* du, void* ds0, void* ws, int B,
                                  int T, int H, int K, int V, void* stream) {
  if (B < 1 || T < 1 || H < 1 || K != V) return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  const float* dsf = static_cast<const float*>(dsT);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  float* wsf = static_cast<float*>(ws);
  switch (kind) {
    case 0:
      return dispatch<float>(K, r, k, v, w, uf, s0f, dout, dsf, dr, dk, dv, dw, duf, ds0f,
                             wsf, B, T, H, s);
    case 1:
      return dispatch<__nv_bfloat16>(K, r, k, v, w, uf, s0f, dout, dsf, dr, dk, dv, dw, duf,
                                     ds0f, wsf, B, T, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
