// Paged decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU Pallas kernel `paged_attention` of
// src/repro/kernels/paged_attention.py (its fp32/bf16 pool form and its
// int8 form with per-page k/v scales). Plain version:
// src/repro_torch/kernels/ref.py (`paged_attention`,
// `paged_attention_quant`); Python wrapper: kernels/paged_attention.py.
//
// What it computes: one decode token per sequence b attends over the KV
// pages listed in page_table[b] (-1 = hole) up to lengths[b] tokens;
// grouped-query attention (group = H / KV), scale D^-0.5, fp32 softmax;
// out = acc / max(l, 1e-30) in q's dtype. Masked scores take the finite
// NEG_INF = -1e30 and holes read page 0, so a row with no valid slot
// averages V over every gathered row, exactly as the plain version does.
//
// What bounds it on the card: it reads each live K/V page once per KV head
// and does 4 * group * D flops per token and head, far below the H100's
// ~20 flops per byte of fp32 balance, so it is bandwidth-bound on the
// live K/V bytes (plus q and out).
//
// Design (simple and right first; wgmma, TMA and split-page decoding are
// later work): one block per (sequence, KV head). The block loads its
// `group` query rows once and walks the columns of page_table[b] in a loop
// — the loop takes the place of the TPU grid's sequential page axis that
// carried m / l / acc in VMEM scratch. Per page it stages the head's K and
// V rows in shared memory as fp32 (times the page scale in the int8
// form), computes the scores a warp per (query row, token), updates the
// online softmax a warp per query row, and accumulates p.V with each
// thread owning fixed (row, dim) outputs in registers. The TPU kernel's
// 128-lane page blocking and table padding are TPU artefacts and are gone.
// Columns that hold no slot below the length, and holes, contribute
// exp(NEG_INF - m) = 0 once a row has any valid slot, so the loop skips
// them. A row with no valid slot (length 0: every inactive engine slot)
// gives the plain version's uniform average of V over all gathered rows,
// summed directly without q, K or scores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// accumulators per thread: group * D <= kMaxAcc * kThreads (the C entry
// refuses larger shapes)
constexpr int kMaxAcc = 32;
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// KV_T: storage type of the pool (float, __nv_bfloat16, int8_t);
// Q_T: type of q and out (float for the int8 pool).
template <typename KV_T, typename Q_T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Q_T* __restrict__ q,
                       const KV_T* __restrict__ k_pool,
                       const KV_T* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       Q_T* __restrict__ out,
                       int H, int KV, int D, int P, int page, int mp,
                       float scale) {
  constexpr bool kQuant = std::is_same<KV_T, int8_t>::value;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int group = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_out = group * D;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [group][D]
  float* k_s = q_s + n_out;          // [page][D]
  float* v_s = k_s + page * D;       // [page][D]
  float* p_s = v_s + page * D;       // [group][page] scores, then weights
  float* m_s = p_s + group * page;   // [group] running max
  float* l_s = m_s + group;          // [group] running sum
  float* a_s = l_s + group;          // [group] this page's rescale factor

  const int len = lengths[b];
  const int* row = page_table + static_cast<size_t>(b) * mp;
  const int live_cols = min(mp, (max(len, 0) + page - 1) / page);
  int mapped = 0;
  for (int j = tid; j < live_cols; j += kThreads) mapped |= row[j] >= 0;
  const bool any_valid = __syncthreads_or(mapped) != 0;
  const size_t page_stride = static_cast<size_t>(page) * KV * D;
  Q_T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * group) * D;

  if (!any_valid) {
    // Every slot is masked, so every weight is exp(NEG_INF - NEG_INF) = 1:
    // the walk reduces to l = mp * page and acc = the sum of V over every
    // gathered row (holes read page 0). Sum it directly — no q, K or scores —
    // in the walk's order (a page's rows, then across pages), which gives
    // the walk's result bit for bit. Inactive engine slots take this path.
    for (int d = tid; d < D; d += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < mp; ++j) {
        const int safe = min(max(row[j], 0), P - 1);
        const size_t base = static_cast<size_t>(safe) * page_stride + static_cast<size_t>(kvh) * D + d;
        float vs = 1.f;
        if constexpr (kQuant) vs = v_scale[safe];
        float pv = 0.f;
        for (int t = 0; t < page; ++t) {
          float vx = to_f32(v_pool[base + static_cast<size_t>(t) * KV * D]);
          if constexpr (kQuant) vx *= vs;
          pv += vx;
        }
        acc += pv;
      }
      const float o = acc / fmaxf(static_cast<float>(mp * page), 1e-30f);
      for (int g = 0; g < group; ++g) ob[g * D + d] = from_f32<Q_T>(o);
    }
    return;
  }

  // the block's query rows: heads kvh*group .. kvh*group + group - 1 (a
  // row with no valid slot returned above without reading them)
  const Q_T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * group) * D;
  for (int e = tid; e < n_out; e += kThreads) q_s[e] = to_f32(qb[e]);
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int j = 0; j < live_cols; ++j) {
    const int pid = row[j];
    if (pid < 0) continue;  // a hole: uniform across the block
    const int safe = min(pid, P - 1);
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = k_scale[safe];
      vs = v_scale[safe];
    }
    // stage this head's K / V rows of the page as fp32
    const size_t base = static_cast<size_t>(safe) * page_stride + static_cast<size_t>(kvh) * D;
    for (int e = tid; e < page * D; e += kThreads) {
      const int t = e / D;
      const size_t off = base + static_cast<size_t>(t) * KV * D + (e - t * D);
      float kx = to_f32(k_pool[off]);
      float vx = to_f32(v_pool[off]);
      if constexpr (kQuant) {
        kx *= ks;
        vx *= vs;
      }
      k_s[e] = kx;
      v_s[e] = vx;
    }
    __syncthreads();

    // scores, one warp per (query row, token)
    for (int pr = warp; pr < group * page; pr += kWarps) {
      const int g = pr / page;
      const int t = pr - g * page;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += q_s[g * D + d] * k_s[t * D + d];
      s = warp_sum(s);
      if (lane == 0) p_s[pr] = j * page + t < len ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < group; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p_s[g * page + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float w = expf(p_s[g * page + t] - m_new);
        p_s[g * page + t] = w;
        sum += w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V, each thread on its fixed (row, dim) outputs
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_out) {
        const int g = e / D;
        const int d = e - g * D;
        float pv = 0.f;
        for (int t = 0; t < page; ++t) pv += p_s[g * page + t] * v_s[t * D + d];
        acc[i] = acc[i] * a_s[g] + pv;
      }
    }
    __syncthreads();  // k_s / v_s / p_s are rewritten by the next page
  }

#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_out) ob[e] = from_f32<Q_T>(acc[i] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename KV_T, typename Q_T>
void launch(const void* q, const void* k, const void* v, const float* k_scale,
            const float* v_scale, const int* page_table, const int* lengths,
            void* out, int B, int H, int KV, int D, int P, int page, int mp,
            float scale, size_t smem, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<KV_T, Q_T>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<B * KV, kThreads, smem, stream>>>(
      static_cast<const Q_T*>(q), static_cast<const KV_T*>(k),
      static_cast<const KV_T*>(v), k_scale, v_scale, page_table, lengths,
      static_cast<Q_T*>(out), H, KV, D, P, page, mp, scale);
}

}  // namespace

// kind: 0 = fp32 pool and q, 1 = bf16 pool and q, 2 = int8 pool + fp32
// scales with fp32 q. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for an unknown kind, or kErrShape when
// group * D exceeds kThreads * kMaxAcc or the block's shared memory exceeds
// what the device lets one block opt in to. These are the kernel's only
// limits; the Python wrapper turns kErrShape into a ValueError.
extern "C" int xbof_paged_attention(int kind, const void* q, const void* k,
                                    const void* v, const float* k_scale,
                                    const float* v_scale,
                                    const int* page_table, const int* lengths,
                                    void* out, int B, int H, int KV, int D,
                                    int P, int page, int mp, float scale,
                                    void* stream) {
  const int group = H / KV;
  if (group * D > kThreads * kMaxAcc) return kErrShape;
  // fp32 q rows, one page of K and V, the page's scores, and the running
  // max / sum / rescale per query row
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(group) * D + 2 * static_cast<size_t>(page) * D +
       static_cast<size_t>(group) * page + 3 * static_cast<size_t>(group));
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(optin)) return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      launch<float, float>(q, k, v, k_scale, v_scale, page_table, lengths, out,
                           B, H, KV, D, P, page, mp, scale, smem, s);
      break;
    case 1:
      launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, k_scale, v_scale,
                                           page_table, lengths, out, B, H, KV,
                                           D, P, page, mp, scale, smem, s);
      break;
    case 2:
      launch<int8_t, float>(q, k, v, k_scale, v_scale, page_table, lengths,
                            out, B, H, KV, D, P, page, mp, scale, smem, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
