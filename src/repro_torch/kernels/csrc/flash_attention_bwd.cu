// Backward of prefill flash attention for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces no TPU kernel: the reference has no backward kernel (no
// custom_vjp anywhere in src/repro). Its training gradient is XLA's
// autodiff of the jnp oracle `attention` (src/repro/kernels/ref.py), and
// that gradient is what this kernel computes: plain version
// `kernels.ref.attention_bwd` (torch.autograd.grad of `ref.attention`);
// Python wrapper: kernels/flash_attention.py (`flash_attention_bwd`, and
// the autograd Function `FlashAttention` whose backward launches it).
//
// What it computes: for q [B, S, H, D], k and v [B, T, KV, D] (group =
// H / KV, query head h reads KV head h / group), the forward's output o
// and its cotangent dO (both [B, S, H, D]), fp32 or bf16 alike, it returns
// dq, dk and dv in the inputs' dtype, summed in fp32. The mask is the
// forward's (csrc/flash_attention.cu): query row i sits at key position
// pos = i + T - S; under `causal` a key c > pos is masked, with a `window`
// so is a key c <= pos - window; a masked score is the finite NEG_INF =
// -1e30, so a row with no valid key (causal, S > T) spreads weight 1 / T
// over all T keys; a window without causal is refused. With x the masked
// scaled score, m and l the row's max and sum of exp(x - m):
//   P = exp(x - m) / l,  dP = dO . v,  delta = rowsum(dO * o),
//   dS = P * (dP - delta) on unmasked pairs and 0 on masked ones (the
//   gradient of a `where` does not reach its constant branch),
//   dv = sum_rows P dO,  dk = scale * sum_rows dS q,  dq = scale * sum_keys dS k.
//
// What bounds it on the card: 10 * D flops per unmasked (query, key) pair
// and head (the recomputed q.k, dO.v, and the three products), above the
// H100's balance of flops per byte at the model zoo's shapes: it is bound
// by operations (989 TFLOP/s bf16 on the tensor cores). This first form
// runs on the CUDA cores in fp32 (67 TFLOP/s), so it stays well above that
// bound: a tensor-core form is later work.
//
// Design: two kernels a call, each output element owned by one thread and
// summed in a fixed order (no atomics), so a call repeats bit for bit.
// - `dq_kernel`, one block per (tile of 64 query rows, query head, batch):
//   delta of its rows; a first pass over the row's key tiles for the
//   softmax statistics (running max and sum, as the forward's online
//   softmax; the forward is left as it is and saves none); m, 1 / l and
//   delta go to a [3, B, H, S] scratch; a second pass recomputes S and dP
//   per key tile, forms dS in shared memory and adds dS . K into dq.
// - `dkdv_kernel`, one block per (tile of BK keys, KV head, batch): the
//   group's query heads and the 64-row query tiles that can see the key
//   tile, in order; per tile S^T = K Q^T and dP^T = V dO^T, then P and dS
//   through one shared buffer into dv += P^T dO and dk += dS^T Q, held in
//   registers across the walk.
// Tiles are fp32 in shared memory (bf16 inputs are widened as they are
// loaded); the head dim is padded with zeros to DP, the next of 32, 64,
// 80, 96, 128, 160, 192 and 256 (any multiple of 8 up to 256 is taken).
// 256 threads: 16 row groups x 16 lanes, each thread a 4 x (BK / 16) tile
// of scores and a 4 x (DP / 16) tile of the output; rows read as one
// vector from transposed tiles, columns strided by 16 from tiles whose row
// pitch is odd (DP + 1), so neither read has a bank conflict. BK = 64 keys
// for DP <= 128, 32 above, so that a DP = 256 block fits 227 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kErrShape = -1;     // the C entry's code for a shape it refuses
constexpr int kThreads = 256;
constexpr int kLanes = 16;        // lanes of a row group
constexpr int kBQ = 64;           // query rows per tile
constexpr int kRows = 4;          // query rows per thread in dq_kernel
constexpr int kQS = kBQ + 4;      // pitch of the tiles read as row vectors

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// sum / max over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float lane_max(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The forward's masked scaled score of key c for a row at position pos:
// -inf for a key past T (weight exactly 0), NEG_INF for a masked key.
__device__ __forceinline__ float masked(float s, int c, int pos, int Tk, int causal, int window,
                                       float scale, bool* live) {
  if (c >= Tk) {
    *live = false;
    return -INFINITY;
  }
  if ((causal && c > pos) || (window > 0 && c <= pos - window)) {
    *live = false;
    return kNegInf;
  }
  *live = true;
  return s * scale;
}

// a row vector of N floats from shared memory (N = 2 or 4, aligned)
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  }
}

template <int DP, int BK>
struct DqSmem {  // floats
  static constexpr int kKP = DP + 1;               // pitch of K and V rows
  static constexpr int kQT = 0;                    // Q^T [DP][kQS]
  static constexpr int kDoT = kQT + DP * kQS;      // dO^T [DP][kQS]
  static constexpr int kK = kDoT + DP * kQS;       // K [BK][kKP]
  static constexpr int kV = kK + BK * kKP;         // V [BK][kKP]
  static constexpr int kDsT = kV + BK * kKP;       // dS^T [BK][kQS]
  static constexpr int kFloats = kDsT + BK * kQS;
  static constexpr int kBytes = kFloats * 4;
};

template <int DP, int BK>
struct DkdvSmem {  // floats
  static constexpr int kKT = BK + 4;               // pitch of K^T, V^T and the P / dS buffer
  static constexpr int kQP = DP + 1;               // pitch of Q and dO rows
  static constexpr int kKTo = 0;                   // K^T [DP][kKT]
  static constexpr int kVTo = kKTo + DP * kKT;     // V^T [DP][kKT]
  static constexpr int kQ = kVTo + DP * kKT;       // Q [kBQ][kQP]
  static constexpr int kDo = kQ + kBQ * kQP;       // dO [kBQ][kQP]
  static constexpr int kBuf = kDo + kBQ * kQP;     // P, then dS [kBQ][kKT] (query-major)
  static constexpr int kStat = kBuf + kBQ * kKT;   // m, 1 / l, delta [3][kBQ]
  static constexpr int kFloats = kStat + 3 * kBQ;
  static constexpr int kBytes = kFloats * 4;
};

// ====================================================================
// dq_kernel: softmax statistics, delta, dq
// ====================================================================
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ stats, int B, int S, int Tk, int H, int KV, int D, int causal,
          int window, float scale) {
  using L = DqSmem<DP, BK>;
  constexpr int NJ = BK / kLanes;   // keys per thread
  constexpr int ND = DP / kLanes;   // dq columns per thread
  extern __shared__ float smem[];
  float* qT = smem + L::kQT;
  float* doT = smem + L::kDoT;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* dsT = smem + L::kDsT;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t k_row = static_cast<size_t>(KV) * D;
  const size_t q_base = static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * D;
  const size_t k_base = static_cast<size_t>(b) * Tk * k_row + static_cast<size_t>(kvh) * D;

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP;
    const int d = e - r * DP;
    const bool in = q0 + r < S && d < D;
    const size_t off = q_base + static_cast<size_t>(q0 + r) * q_row + d;
    qT[d * kQS + r] = in ? to_f(q[off]) : 0.f;
    doT[d * kQS + r] = in ? to_f(dout[off]) : 0.f;
  }
  // delta = rowsum(dO * o) of the thread's rows, summed over its row group
  float delta[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    float acc = 0.f;
    if (r < S) {
      const size_t row = q_base + static_cast<size_t>(r) * q_row;
      for (int d = tx; d < D; d += kLanes) acc += to_f(dout[row + d]) * to_f(o[row + d]);
    }
    delta[i] = lane_sum(acc);
  }

  // the key tiles this block walks (the forward's rule)
  const int offset = Tk - S;
  const int pos_first = q0 + offset;
  const int pos_last = min(q0 + kBQ, S) - 1 + offset;
  int k_lo = 0, k_hi = Tk - 1;
  if (causal && pos_first >= 0) {
    k_hi = min(Tk - 1, pos_last);
    if (window > 0) k_lo = max(0, pos_first - window + 1);
  }
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi / BK;

  auto load_tile = [&](int k0, bool with_v) {
    for (int e = tid; e < BK * DP; e += kThreads) {
      const int c = e / DP;
      const int d = e - c * DP;
      const bool in = k0 + c < Tk && d < D;
      const size_t off = k_base + static_cast<size_t>(k0 + c) * k_row + d;
      ks[c * L::kKP + d] = in ? to_f(k[off]) : 0.f;
      if (with_v) vs[c * L::kKP + d] = in ? to_f(v[off]) : 0.f;
    }
  };

  // ---- pass 1: the rows' max and sum of exp over their keys
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) m[i] = kNegInf, l[i] = 0.f;
  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    load_tile(k0, false);
    __syncthreads();
    float s[kRows][NJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[kRows];
      load_vec<kRows>(qT + d * kQS + ty * kRows, qv);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[(tx + kLanes * j) * L::kKP + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pos = q0 + ty * kRows + i + offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        bool live;
        s[i][j] = masked(s[i][j], k0 + tx + kLanes * j, pos, Tk, causal, window, scale, &live);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], lane_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + lane_sum(sum);
      m[i] = m_new;
    }
  }
  float il[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    il[i] = 1.f / l[i];
    const int r = q0 + ty * kRows + i;
    if (tx == 0 && r < S) {
      const size_t at = (static_cast<size_t>(b) * H + h) * S + r;
      const size_t plane = static_cast<size_t>(B) * H * S;
      stats[at] = m[i];
      stats[plane + at] = il[i];
      stats[2 * plane + at] = delta[i];
    }
  }

  // ---- pass 2: dS per key tile, dq += dS . K
  float acc[kRows][ND];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's K and dS are consumed
    load_tile(k0, true);
    __syncthreads();
    float s[kRows][NJ], dp[kRows][NJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f, dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; ++d) {
      float qv[kRows], gv[kRows];
      load_vec<kRows>(qT + d * kQS + ty * kRows, qv);
      load_vec<kRows>(doT + d * kQS + ty * kRows, gv);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[(tx + kLanes * j) * L::kKP + d];
        const float vv = vs[(tx + kLanes * j) * L::kKP + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][j] = fmaf(qv[i], kv, s[i][j]);
          dp[i][j] = fmaf(gv[i], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int pos = q0 + ty * kRows + i + offset;
        bool live;
        const float x = masked(s[i][j], k0 + tx + kLanes * j, pos, Tk, causal, window, scale,
                               &live);
        const float p = expf(x - m[i]) * il[i];
        ds[i] = live ? p * (dp[i][j] - delta[i]) : 0.f;
      }
      store_vec<kRows>(dsT + (tx + kLanes * j) * kQS + ty * kRows, ds);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[kRows];
      load_vec<kRows>(dsT + c * kQS + ty * kRows, dsv);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float kv = ks[c * L::kKP + tx + kLanes * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= S) continue;
    T* row = dq + q_base + static_cast<size_t>(r) * q_row;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + kLanes * j;
      if (d < D) from_f(row + d, acc[i][j] * scale);
    }
  }
}

// ====================================================================
// dkdv_kernel: dk and dv of one key tile over the group's query heads
// ====================================================================
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ stats, T* __restrict__ dk,
            T* __restrict__ dv, int B, int S, int Tk, int H, int KV, int D, int causal,
            int window, float scale) {
  using L = DkdvSmem<DP, BK>;
  constexpr int RK = BK / kLanes;   // keys per thread
  constexpr int NQ = kBQ / kLanes;  // query rows per thread
  constexpr int ND = DP / kLanes;   // output columns per thread
  extern __shared__ float smem[];
  float* kT = smem + L::kKTo;
  float* vT = smem + L::kVTo;
  float* qs = smem + L::kQ;
  float* dos = smem + L::kDo;
  float* buf = smem + L::kBuf;
  float* st = smem + L::kStat;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t k_row = static_cast<size_t>(KV) * D;
  const size_t k_base = static_cast<size_t>(b) * Tk * k_row + static_cast<size_t>(kvh) * D;
  const size_t plane = static_cast<size_t>(B) * H * S;

  for (int e = tid; e < BK * DP; e += kThreads) {
    const int c = e / DP;
    const int d = e - c * DP;
    const bool in = k0 + c < Tk && d < D;
    const size_t off = k_base + static_cast<size_t>(k0 + c) * k_row + d;
    kT[d * L::kKT + c] = in ? to_f(k[off]) : 0.f;
    vT[d * L::kKT + c] = in ? to_f(v[off]) : 0.f;
  }

  // the query rows that can see a key of this tile: a causal row at
  // position pos sees keys up to pos (and above pos - window); rows with
  // no valid key (S > T) see every key with weight 1 / T
  const int offset = Tk - S;
  int r_lo = 0, r_hi = S - 1;
  if (causal) {
    r_lo = offset < 0 ? 0 : max(0, k0 - offset);
    if (window > 0) r_hi = min(S - 1, k0 + BK - 1 + window - 1 - offset);
  }
  const int qt_lo = r_lo / kBQ;
  const int qt_hi = r_hi < r_lo ? qt_lo - 1 : r_hi / kBQ;

  float dkacc[RK][ND], dvacc[RK][ND];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dkacc[i][j] = 0.f, dvacc[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t q_base = static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * D;
    const size_t s_base = (static_cast<size_t>(b) * H + h) * S;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's Q, dO and dS are consumed
      for (int e = tid; e < kBQ * DP; e += kThreads) {
        const int r = e / DP;
        const int d = e - r * DP;
        const bool in = q0 + r < S && d < D;
        const size_t off = q_base + static_cast<size_t>(q0 + r) * q_row + d;
        qs[r * L::kQP + d] = in ? to_f(q[off]) : 0.f;
        dos[r * L::kQP + d] = in ? to_f(dout[off]) : 0.f;
      }
      if (tid < kBQ) {
        const bool in = q0 + tid < S;
        st[tid] = in ? stats[s_base + q0 + tid] : 0.f;
        st[kBQ + tid] = in ? stats[plane + s_base + q0 + tid] : 0.f;
        st[2 * kBQ + tid] = in ? stats[2 * plane + s_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: keys ty * RK + i, query rows tx + 16 j
      float s[RK][NQ], dp[RK][NQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < NQ; ++j) s[i][j] = 0.f, dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DP; ++d) {
        float kv[RK], vv[RK];
        load_vec<RK>(kT + d * L::kKT + ty * RK, kv);
        load_vec<RK>(vT + d * L::kKT + ty * RK, vv);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float qv = qs[(tx + kLanes * j) * L::kQP + d];
          const float gv = dos[(tx + kLanes * j) * L::kQP + d];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            s[i][j] = fmaf(kv[i], qv, s[i][j]);
            dp[i][j] = fmaf(vv[i], gv, dp[i][j]);
          }
        }
      }
      // P (kept in s) and dS (kept in dp)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int rl = tx + kLanes * j;
        const bool row_in = q0 + rl < S;
        const int pos = q0 + rl + offset;
        const float mr = st[rl], ilr = st[kBQ + rl], dr = st[2 * kBQ + rl];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          bool live;
          const float x = masked(s[i][j], k0 + ty * RK + i, pos, Tk, causal, window, scale,
                                 &live);
          const float p = row_in ? expf(x - mr) * ilr : 0.f;
          s[i][j] = p;
          dp[i][j] = live && row_in ? p * (dp[i][j] - dr) : 0.f;
        }
      }
      // dv += P^T dO
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float col[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) col[i] = s[i][j];
        store_vec<RK>(buf + (tx + kLanes * j) * L::kKT + ty * RK, col);
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kBQ; ++c) {
        float pv[RK];
        load_vec<RK>(buf + c * L::kKT + ty * RK, pv);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const float x = dos[c * L::kQP + tx + kLanes * j];
#pragma unroll
          for (int i = 0; i < RK; ++i) dvacc[i][j] = fmaf(pv[i], x, dvacc[i][j]);
        }
      }
      __syncthreads();  // P is consumed; the buffer takes dS
      // dk += dS^T Q
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float col[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) col[i] = dp[i][j];
        store_vec<RK>(buf + (tx + kLanes * j) * L::kKT + ty * RK, col);
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kBQ; ++c) {
        float dsv[RK];
        load_vec<RK>(buf + c * L::kKT + ty * RK, dsv);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const float x = qs[c * L::kQP + tx + kLanes * j];
#pragma unroll
          for (int i = 0; i < RK; ++i) dkacc[i][j] = fmaf(dsv[i], x, dkacc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = k0 + ty * RK + i;
    if (c >= Tk) continue;
    const size_t row = k_base + static_cast<size_t>(c) * k_row;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + kLanes * j;
      if (d < D) {
        from_f(dk + row + d, dkacc[i][j] * scale);
        from_f(dv + row + d, dvacc[i][j]);
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* stats, int B, int S, int Tk, int H, int KV,
           int D, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BK = DP <= 128 ? 64 : 32;
  using LQ = DqSmem<DP, BK>;
  using LK = DkdvSmem<DP, BK>;
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (LQ::kBytes > optin || LK::kBytes > optin) return kErrShape;
  auto k1 = dq_kernel<T, DP, BK>;
  auto k2 = dkdv_kernel<T, DP, BK>;
  cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::kBytes);
  cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, LK::kBytes);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  k1<<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, LQ::kBytes, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), stats, B, S, Tk, H, KV, D,
      causal, window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3((Tk + BK - 1) / BK, KV, B), kThreads, LK::kBytes, stream>>>(
      qt, kt, vt, dot, stats, static_cast<T*>(dk), static_cast<T*>(dv), B, S, Tk, H, KV, D,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             void* dq, void* dk, void* dv, float* stats, int B, int S, int Tk, int H, int KV,
             int D, int causal, int window, float scale, cudaStream_t s) {
#define XBOF_BWD(DP)                                                                          \
  if (D <= DP)                                                                               \
    return launch<T, DP>(q, k, v, o, dout, dq, dk, dv, stats, B, S, Tk, H, KV, D, causal, \
                         window, scale, s);
  XBOF_BWD(32)
  XBOF_BWD(64)
  XBOF_BWD(80)
  XBOF_BWD(96)
  XBOF_BWD(128)
  XBOF_BWD(160)
  XBOF_BWD(192)
  XBOF_BWD(256)
#undef XBOF_BWD
  return kErrShape;
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (q, k, v, o, dout and the three gradients
// alike); stats: a float32 scratch of 3 * B * H * S. Launches dq_kernel
// then dkdv_kernel on `stream` and returns cudaGetLastError() after them
// (0 on success), cudaErrorInvalidValue for an unknown kind, or kErrShape
// for a shape it refuses: head_dim not a multiple of 8 in 8..256, H not a
// multiple of KV, S or T below 1, more than 65535 heads or batches, or a
// window without causal. The Python wrapper turns kErrShape into a
// ValueError.
extern "C" int xbof_flash_attention_bwd(int kind, const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, void* dq, void* dk,
                                        void* dv, void* stats, int B, int S, int T, int H,
                                        int KV, int D, int causal, int window, float scale,
                                        void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || H > 65535 || B > 65535 || D < 8 ||
      D > 256 || D % 8 != 0 || window < 0 || (window > 0 && !causal)) {
    return kErrShape;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (kind) {
    case 0:
      return dispatch<float>(q, k, v, o, dout, dq, dk, dv, st, B, S, T, H, KV, D, causal, window,
                             scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, st, B, S, T, H, KV, D, causal,
                                     window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
