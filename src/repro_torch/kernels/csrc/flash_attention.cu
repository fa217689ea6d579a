// Prefill flash attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention.py. Plain version:
// src/repro_torch/kernels/ref.py (`attention`, `attention_dense`,
// `attention_chunked`); Python wrapper: kernels/flash_attention.py.
//
// What it computes: grouped-query attention of q [B, S, H, D] over
// k, v [B, T, KV, D] (group = H / KV, query head h reads KV head
// h / group), fp32 or bf16 in, q's dtype out. Query row i sits at key
// position i + T - S. Scores are dot(q, k) * scale; under `causal` a key
// past the row's position is masked, and with a `window` so is a key at or
// below position - window. Masked scores take the finite NEG_INF = -1e30,
// so a row with no valid key (causal with S > T) averages V over all T
// keys, as the plain version does. fp32 online softmax; for bf16 inputs
// the weights p are rounded to bf16 before the P.V product (the TPU
// kernel's `p.astype(v.dtype)`), while the denominator sums them in fp32;
// out = acc / max(l, 1e-30).
//
// What bounds it on the card: at the main path's shapes (qwen3-14b
// prefill, S = T = 2048, D = 128) it does about 2 * D flops per (q, k)
// pair and head twice over, some 850 flops per byte it must move, far
// above the H100's ~295 flops per byte of bf16 balance: it is bound by
// tensor-core flops. This first kernel does its math in fp32 on the CUDA
// cores (no mma.sync / wgmma, TMA or warp specialisation yet: later
// work), so it runs well below that bound.
//
// Design (simple and right first): one block of 128 threads per
// (batch, query head, tile of BQ = 64 query rows). The TPU grid's
// sequential key axis, which carried m / l / acc in VMEM scratch, becomes
// a loop inside the block over key tiles of BK = 64. Each iteration stages
// the tile's K (transposed) and V rows of the block's KV head in shared
// memory as fp32, computes the 64 x 64 scores with each thread owning a
// 4 x 8 register tile (rows 4 * ty + i, columns tx + 8 * j), updates the
// online softmax with row reductions over the 8 threads of a row group
// (warp shuffles), writes the weights over the K tile, and accumulates
// P.V with each thread owning 4 rows x D / 8 columns (tx + 8 * j) of the
// output in registers. Ragged edges are masked here, not padded: a key
// column >= T gets weight exactly 0 (-inf score), a query row >= S is
// computed but never stored. Key tiles wholly outside every row's causal
// band or window are skipped, which is exact for rows that have a valid
// key (their masked terms are exp(NEG_INF - m) = 0); a tile holding a row
// with no valid key walks every key tile, so that row gets the plain
// version's uniform average.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kRows = 4;         // query rows per thread (16 row groups)
constexpr int kCols = 8;         // threads per row group
constexpr int kPad = kBQ + 1;    // padded stride of the transposed tiles
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

static_assert(kBQ == kBK, "Q^T and K^T / P share one padded stride");
static_assert((kThreads / kCols) * kRows == kBQ, "row groups cover the tile");

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

// the weight as the P.V product sees it: bf16-rounded for bf16 inputs
template <typename T>
__device__ __forceinline__ float weight(float p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(p));
  } else {
    return p;
  }
}

// rows of the region that holds K^T [D][kPad] and then P [kBQ][kPad]
__host__ __device__ constexpr int kt_rows(int d) { return d > kBQ ? d : kBQ; }

// max / sum over the 8 consecutive lanes of a row group
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < kCols; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < kCols; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int Tk, int H, int KV, int causal, int window,
                       float scale) {
  constexpr int kDC = D / kCols;  // output columns per thread
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % kCols;     // column slot (lane within the row group)
  const int ty = tid / kCols;     // row group: rows 4 * ty .. 4 * ty + 3

  extern __shared__ float smem[];
  float* qt = smem;               // [D][kPad] Q^T of the block's rows
  float* kt = qt + D * kPad;      // [D][kPad] K^T of the tile, then P [kBQ][kPad]
  float* vs = kt + kt_rows(D) * kPad;  // [kBK][D] V of the tile
  float* ps = kt;

  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t k_row = static_cast<size_t>(KV) * D;
  const T* qb = q + (static_cast<size_t>(b) * S) * q_row + static_cast<size_t>(h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Tk) * k_row + static_cast<size_t>(kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Tk) * k_row + static_cast<size_t>(kvh) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    qt[d * kPad + r] = q0 + r < S ? to_f32(qb[(q0 + r) * q_row + d]) : 0.f;
  }

  // the key tiles this block walks
  const int offset = Tk - S;                      // key position of row 0
  const int pos_first = q0 + offset;
  const int pos_last = min(q0 + kBQ, S) - 1 + offset;
  int k_lo = 0, k_hi = Tk - 1;
  if (causal && pos_first >= 0) {                 // every row has a valid key
    k_hi = min(Tk - 1, pos_last);
    if (window > 0) k_lo = max(0, pos_first - window + 1);
  }
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi / kBK;

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's P and V are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D;
      const int d = e - c * D;
      const bool in = k0 + c < Tk;
      const size_t off = static_cast<size_t>(k0 + c) * k_row + d;
      kt[d * kPad + c] = in ? to_f32(kb[off]) : 0.f;
      vs[c * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qt[d * kPad + ty * kRows + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = kt[d * kPad + tx + kCols * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();  // K^T is read; its space takes P

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int pos = q0 + r + offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = k0 + tx + kCols * j;
        float x;
        if (c >= Tk) {
          x = -INFINITY;  // not a key: weight exactly 0
        } else if ((causal && c > pos) || (window > 0 && c <= pos - window)) {
          x = kNegInf;
        } else {
          x = s[i][j] * scale;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[r * kPad + tx + kCols * j] = weight<T>(p);
      }
      sum = group_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * kPad + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const float x = vs[c * D + tx + kCols * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], x, acc[i][j]);
      }
    }
  }

  T* ob = out + (static_cast<size_t>(b) * S) * q_row + static_cast<size_t>(h) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      ob[static_cast<size_t>(r) * q_row + tx + kCols * j] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  // Q^T and K^T (later P) at the padded stride, and V
  const size_t smem = sizeof(float) * (static_cast<size_t>(D + kt_rows(D)) * kPad +
                                       static_cast<size_t>(kBK) * D);
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(optin)) return kErrShape;
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, KV, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Tk, int H, int KV, int D, int causal, int window,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, s);
    case 80: return launch<T, 80>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, s);
    case 96: return launch<T, 96>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, s);
    default: return kErrShape;
  }
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (q, k, v and out alike). Returns
// cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an unknown kind, or kErrShape for a shape
// beyond the kernel's limits: head_dim not one of 16, 32, 64, 80, 96, 128,
// 256; H not a multiple of KV; S or T below 1; more than 65535 heads or
// batches (grid y / z); a window without causal (the reference's forms
// disagree there); or shared memory beyond what one block may opt in to.
// The Python wrapper turns kErrShape into a ValueError.
extern "C" int xbof_flash_attention(int kind, const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int T, int H, int KV, int D, int causal,
                                    int window, float scale, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || H > 65535 ||
      B > 65535 || window < 0 || (window > 0 && !causal)) {
    return kErrShape;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return dispatch_d<float>(q, k, v, out, B, S, T, H, KV, D, causal, window, scale, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, D, causal, window,
                                       scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
