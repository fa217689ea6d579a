// Backward of prefill flash attention for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces no TPU kernel: the reference has no backward kernel (no
// custom_vjp anywhere in src/repro). Its training gradient is XLA's
// autodiff of the jnp oracle `attention` (src/repro/kernels/ref.py:25),
// and that gradient is what this kernel computes: plain version
// `kernels.ref.attention_bwd` (torch.autograd.grad of `ref.attention`);
// Python wrapper: kernels/flash_attention.py (`flash_attention_bwd`, and
// the autograd Function `FlashAttention` whose backward launches it).
//
// What it computes: for q [B, S, H, D], k and v [B, T, KV, D] (group =
// H / KV, query head h reads KV head h / group), the forward's output o
// and its cotangent dO (both [B, S, H, D]), fp32 or bf16 alike, and the
// forward's softmax statistics (fp32 [2, B, H, S]: each row's m and l in
// natural units, csrc/flash_attention.cu), it returns dq, dk and dv in
// the inputs' dtype, summed in fp32. The mask is the forward's: query row
// i sits at key position pos = i + T - S; under `causal` a key c > pos is
// masked, with a `window` so is a key c <= pos - window; a masked score is
// the finite NEG_INF = -1e30, so a row with no valid key (causal, S > T)
// has m = NEG_INF, l = T and spreads weight 1 / T over all T keys; a
// window without causal is refused. With x the masked scaled score:
//   P = exp(x - m) / l,  dP = dO . v,  delta = rowsum(dO * o),
//   dS = P * (dP - delta) on unmasked pairs and 0 on masked ones (the
//   gradient of a `where` does not reach its constant branch),
//   dv = sum_rows P dO,  dk = scale * sum_rows dS q,  dq = scale * sum_keys dS k.
//
// What bounds it on the card: 10 * D flops per unmasked (query, key) pair
// and head (q.k, dO.v and the three products), some 1000 flops per byte
// it must move at the model zoo's training shapes, far above the H100's
// ~295 of bf16 balance: it is bound by tensor-core operations (989
// TFLOP/s bf16).
//
// Every output element is owned by one block, or by a fixed set of
// blocks whose sums one kernel adds in a fixed order (no atomics), so a
// call repeats bit for bit. That takes two passes over the pairs: one
// owns dk and dv, the other dq, and both recompute S and dP, 14 * D flops
// a pair against FlashAttention-3's 10 * D with atomic adds into dq: the
// price of determinism.
//
// bf16: on wgmma and TMA, three to five kernels a call.
// - `prep_kernel`, a warp a row: delta from o and dO, and the row's
//   log-sum-exp in base 2, lse = m * log2(e) + log2(l), into an fp32
//   scratch [2, B, H, Sp] (Sp: S rounded up to 128; rows past S hold
//   lse = +inf, so their weights are exactly 0). A row with no valid key
//   stores lse = log2(l) (its m counted as 0) and the kernels give its
//   masked scores the logit 0: its weights 2^(0 - log2 T) = 1 / T, where
//   one stored NEG_INF + log2(T) would round to NEG_INF and give 1.
// - `dq_hopper`, a block per (128 query rows, query head, batch), and
//   `dkdv_hopper`, a block per (128 keys, KV head, batch), each of 384
//   threads as the forward (csrc/flash_attention.cu): warpgroup 0 gives
//   up its registers (setmaxnreg 24) and one thread issues the TMA loads,
//   warpgroups 1 and 2 (setmaxnreg 240) own 64 rows of the block's tile
//   each. The block's own tile pair (Q and dO for dq, K and V for dk and
//   dv) loads once; the other side streams through a ring of kStages = 3
//   stages of BN rows (64; 32 at D = 256, so that 227 KB holds the own
//   tiles and the ring) with full / empty mbarriers (and, for dk and dv,
//   the rows' lse and delta by bulk copy). Tiles stay bf16 in shared
//   memory in the forward's boxes and swizzles (CHUNK columns a box).
// - dkdv_hopper walks the group's query heads and the query tiles that
//   see its keys (rows with no valid key see every key); per tile S^T = K
//   Q^T and dP^T = V dO^T are wgmma m64nBNk16 with both operands K-major
//   in shared memory; P^T = 2^(S^T * scale * log2(e) - lse) and dS^T =
//   P^T * (dP^T - delta) run in registers on the accumulator fragments and
//   are rounded to bf16 in place, as the forward rounds P: the fragment is
//   the A operand of dV += P^T dO and dK += dS^T Q (wgmma m64nDk16, B = dO
//   or Q read MN-major), accumulated in fp32 registers over the walk. At D
//   = 256 dV and dK would take 256 fp32 registers a thread, so dk and dv
//   are two walks (the dv walk skips dP), 16 * D flops a pair in all.
//   dq_hopper walks the key tiles of the forward's band for its rows and
//   forms S, dP and dS the same way into dQ += dS K.
// - With few KV heads a dk / dv grid leaves SMs idle (qwen2-vl-2b's 2,
//   recurrentgemma-9b's 1: 64 and 32 blocks at T = 4096), and under a
//   causal mask its blocks' walks differ up to the whole group's rows. The
//   caller then cuts each walk into n_split equal runs of steps, a block
//   each, that write fp32 sums; `sum_kernel` adds the runs in split order,
//   so the result stays the same bit for bit from call to call.
// - Masks apply only on a tile that crosses the causal diagonal or the
//   window's lower edge (dq: or T); keys past T and rows past S arrive as
//   zeros from TMA, and their products land in rows that are never
//   stored, or carry weight 0. No wgmma or wait sits under a runtime
//   condition and the roles come from a warp-uniform shuffle (the
//   forward's rules against ptxas serializing every wgmma).
// - Any head dim that is a multiple of 8 runs at DP, the next of 16, 32,
//   64, 80, 96, 128 and 256, with DP's box width: TMA fills the columns
//   past D with zeros (D = 8 and 40 of the sweep, say), and they are not
//   stored. Inputs must start on 16 bytes (TMA).
//
// fp32: two SIMT kernels on the CUDA cores (a tensor-core fp32 form would
// need TF32, which the fp32 checks do not allow). `dq_kernel`, one block
// per (64 query rows, query head, batch): delta of its rows into a [B, H,
// S] scratch, then per key tile S and dP, dS in shared memory and dq +=
// dS . K. `dkdv_kernel`, one block per (BK keys, KV head, batch): the
// group's query heads and the 64-row query tiles that can see the key
// tile; per tile S^T = K Q^T and dP^T = V dO^T, then P and dS through one
// shared buffer into dv += P^T dO and dk += dS^T Q, held in registers
// across the walk. The head dim is padded with zeros to DP, the next of
// 32, 64, 80, 96, 128, 160, 192 and 256. 256 threads: 16 row groups x 16
// lanes, each thread a 4 x (BK / 16) tile of scores and a 4 x (DP / 16)
// tile of the output; rows read as one vector from transposed tiles,
// columns strided by 16 from tiles whose row pitch is odd (DP + 1), so
// neither read has a bank conflict. BK = 64 keys for DP <= 128, 32 above,
// so that a DP = 256 block fits 227 KB.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kErrShape = -1;     // the C entry's code for a shape it refuses

// ====================================================================
// fp32: SIMT
// ====================================================================
constexpr int kThreads = 256;
constexpr int kLanes = 16;        // lanes of a row group
constexpr int kBQ = 64;           // query rows per tile
constexpr int kRows = 4;          // query rows per thread in dq_kernel
constexpr int kQS = kBQ + 4;      // pitch of the tiles read as row vectors


// sum / max over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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

// --------------------------------------------------------------------
// dq_kernel: delta, dq
// --------------------------------------------------------------------
template <int DP, int BK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ stats,
          float* __restrict__ dq, float* __restrict__ delta_out, int B, int S, int Tk, int H, int KV,
          int D, int causal, int window, float scale) {
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
    qT[d * kQS + r] = in ? q[off] : 0.f;
    doT[d * kQS + r] = in ? dout[off] : 0.f;
  }
  // delta = rowsum(dO * o) of the thread's rows, summed over its row group
  float delta[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    float acc = 0.f;
    if (r < S) {
      const size_t row = q_base + static_cast<size_t>(r) * q_row;
      for (int d = tx; d < D; d += kLanes) acc += dout[row + d] * o[row + d];
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
      ks[c * L::kKP + d] = in ? k[off] : 0.f;
      if (with_v) vs[c * L::kKP + d] = in ? v[off] : 0.f;
    }
  };

  // the forward's statistics of the thread's rows; delta to the scratch
  // that dkdv_kernel reads
  const size_t plane = static_cast<size_t>(B) * H * S;
  float m[kRows], il[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    const size_t at = (static_cast<size_t>(b) * H + h) * S + r;
    m[i] = r < S ? stats[at] : 0.f;
    il[i] = r < S ? 1.f / stats[plane + at] : 0.f;
    if (tx == 0 && r < S) delta_out[at] = delta[i];
  }

  // dS per key tile, dq += dS . K
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
    float* row = dq + q_base + static_cast<size_t>(r) * q_row;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + kLanes * j;
      if (d < D) row[d] = acc[i][j] * scale;
    }
  }
}

// --------------------------------------------------------------------
// dkdv_kernel: dk and dv of one key tile over the group's query heads
// --------------------------------------------------------------------
template <int DP, int BK>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ stats,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int B, int S,
            int Tk, int H, int KV, int D, int causal, int window, float scale) {
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
    kT[d * L::kKT + c] = in ? k[off] : 0.f;
    vT[d * L::kKT + c] = in ? v[off] : 0.f;
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
        qs[r * L::kQP + d] = in ? q[off] : 0.f;
        dos[r * L::kQP + d] = in ? dout[off] : 0.f;
      }
      if (tid < kBQ) {
        const bool in = q0 + tid < S;
        st[tid] = in ? stats[s_base + q0 + tid] : 0.f;
        st[kBQ + tid] = in ? 1.f / stats[plane + s_base + q0 + tid] : 0.f;
        st[2 * kBQ + tid] = in ? delta[s_base + q0 + tid] : 0.f;
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
        dk[row + d] = dkacc[i][j] * scale;
        dv[row + d] = dvacc[i][j];
      }
    }
  }
}

// ====================================================================
// bf16: wgmma + TMA, warp-specialised
// ====================================================================
constexpr int kHopperThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;     // setmaxnreg: 128 * 24 + 256 * 240 <= 65536
constexpr int kConsumerRegs = 240;
constexpr int kStages = 3;            // depth of the streamed ring
constexpr int kBlockRows = 128;       // a block's own tile: two warpgroups of 64 rows
constexpr float kLog2e = 1.4426950408889634f;
// what a dk / dv block accumulates: both (D <= 128), or one of them in
// each of two walks (D = 256, where both would take 256 registers a thread)
enum Part { kBoth = 0, kDvOnly = 1, kDkOnly = 2 };

// Shared memory of either kernel: the block's two own tiles of 128 rows,
// kStages stages of two streamed tiles of BN rows, kStages x (lse, delta)
// of BN rows (dkdv_hopper), and 1 + 2 * kStages mbarriers. Each tile is
// DP / CHUNK boxes of [rows][CHUNK] bf16, loaded as TMA boxes of BN rows,
// swizzled by CHUNK * 2 bytes; boxes start on 1024.
template <int DP, int CHUNK, int BN>
struct BwdTiles {
  static_assert(DP % CHUNK == 0 && (CHUNK == 16 || CHUNK == 32 || CHUNK == 64), "boxes");
  static_assert(BN == 32 || BN == 64, "streamed rows");
  static constexpr int kNch = DP / CHUNK;
  static constexpr int kRowBytes = CHUNK * 2;            // one row of a box: the swizzle span
  static constexpr int kAtom = 8 * kRowBytes;            // 8 rows: one swizzle atom
  static constexpr int kBoxS = BN * kRowBytes;           // a box of a streamed tile
  static constexpr int kBoxO = kBlockRows * kRowBytes;   // a box of an own tile
  static constexpr int kTileS = kNch * kBoxS;
  static constexpr int kTileO = kNch * kBoxO;
  static constexpr int kSmem = 1024 + 2 * kTileO + 2 * kStages * kTileS +
                               kStages * 2 * BN * 4 + 8 * (1 + 2 * kStages);
  static_assert(kBoxS % 1024 == 0, "boxes start on 1024 bytes");
};

// acc[64 x BN] = A[64 x DP] . B[BN x DP]^T, both K-major in shared memory
// (A a warpgroup's 64 rows of an own tile, B a streamed tile): DP / 16
// K-steps, each inside one box
template <int DP, int CHUNK, int BN>
__device__ __forceinline__ void gemm_nt(float (&acc)[BN / 2], uint32_t a, uint32_t b) {
  using L = BwdTiles<DP, CHUNK, BN>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t box = kk * 16 / CHUNK, in = (kk * 16 % CHUNK) * 2;
    wgmma_ss<BN>(acc, make_desc<CHUNK>(a + box * L::kBoxO + in, 16, L::kAtom),
                 make_desc<CHUNK>(b + box * L::kBoxS + in, 16, L::kAtom), kk > 0);
  }
}

// acc[64 x DP] += F[64 x BN] . B[BN x DP]: F the bf16 A fragment packed
// from a 64 x BN accumulator, B a streamed tile read MN-major (the stride
// byte offset steps 8 rows inside a box, the leading one box to box)
template <int DP, int CHUNK, int BN>
__device__ __forceinline__ void gemm_nn(float (&acc)[DP / 2], const uint32_t (&f)[BN / 4],
                                        uint32_t b) {
  using L = BwdTiles<DP, CHUNK, BN>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3]};
    wgmma_rs<DP>(acc, a, make_desc<CHUNK>(b + kk * 16 * L::kRowBytes, L::kBoxS, L::kAtom));
  }
}

// a 64 x BN fp32 accumulator to bf16 in place: its fragment is the A
// fragment of the next product (key step j / 2 takes {(r, k), (r + 8, k),
// (r, k + 8), (r + 8, k + 8)})
template <int BN>
__device__ __forceinline__ void pack_frag(uint32_t (&f)[BN / 4], const float (&x)[BN / 2]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) f[2 * j + hr] = pack_bf16(x[4 * j + 2 * hr], x[4 * j + 2 * hr + 1]);
  }
}

// an own tile of 128 rows from row r0, or a streamed tile of BN rows:
// per box, TMA boxes of BN rows
template <int DP, int CHUNK, int BN, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int head, int r0, int b) {
  using L = BwdTiles<DP, CHUNK, BN>;
#pragma unroll
  for (int c = 0; c < L::kNch; ++c) {
#pragma unroll
    for (int part = 0; part < ROWS / BN; ++part) {
      tma_load(dst + c * ROWS * L::kRowBytes + part * L::kBoxS, map, bar, c * CHUNK, head,
               r0 + part * BN, b);
    }
  }
}

// delta = rowsum(dO * o) and the row's lse in base 2 (see the note), a
// warp a row of [B, H, Sp]; rows past S get lse = +inf and delta = 0
__global__ void __launch_bounds__(256)
prep_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ stats, float* __restrict__ work, int B, int S, int Sp,
            int H, int D) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const long long rows = static_cast<long long>(B) * H * Sp;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                       // a whole warp
  const int bh = static_cast<int>(row / Sp);
  const int r = static_cast<int>(row % Sp);
  float lse = INFINITY, delta = 0.f;
  if (r < S) {
    const int b = bh / H, h = bh % H;
    const size_t at = ((static_cast<size_t>(b) * S + r) * H + h) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) {
      acc += __bfloat162float(o[at + d]) * __bfloat162float(dout[at + d]);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
    delta = acc;
    const size_t st = static_cast<size_t>(bh) * S + r;
    const float m = stats[st];
    const float l = stats[static_cast<size_t>(B) * H * S + st];
    lse = (m == kNegInf ? 0.f : m * kLog2e) + log2f(l);
  }
  if (lane == 0) {
    work[row] = lse;
    work[rows + row] = delta;
  }
}

// ---- dk and dv: a block per (128 keys, KV head and split, batch). The
// walk over the group's query heads and the query tiles that see the
// keys is cut into n_split equal runs of steps; with n_split > 1 each
// block writes its fp32 sums to `part` and `sum_kernel` adds the runs in
// order.
template <int DP, int CHUNK, int BN, int PART>
__global__ void __launch_bounds__(kHopperThreads, 1)
dkdv_hopper(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
            const float* __restrict__ work, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int n_split, int B, int S,
            int Sp, int Tk, int H, int KV, int D, int causal, int window, float scale,
            float scale_log2) {
  using L = BwdTiles<DP, CHUNK, BN>;
  constexpr bool kDv = PART != kDkOnly, kDk = PART != kDvOnly;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* vs = ks + L::kTileO;
  uint8_t* qs = vs + L::kTileO;                  // kStages Q tiles
  uint8_t* gs = qs + kStages * L::kTileS;        // kStages dO tiles
  float* lse_s = reinterpret_cast<float*>(gs + kStages * L::kTileS);  // [kStages][BN]
  float* dl_s = lse_s + kStages * BN;                                 // [kStages][BN]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + kStages * BN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  const int k0 = blockIdx.x * kBlockRows;
  const int kvh = blockIdx.y / n_split;
  const int split = blockIdx.y % n_split;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int tid = threadIdx.x;
  const int offset = Tk - S;                      // key position of query row 0

  // the query tiles that see a key of this tile: a causal row at position
  // pos sees keys up to pos (and above pos - window); rows with no valid
  // key (S > T) see every key with weight 1 / T
  int r_lo = 0, r_hi = S - 1;
  if (causal) {
    r_lo = offset < 0 ? 0 : max(0, k0 - offset);
    if (window > 0) r_hi = min(S - 1, k0 + kBlockRows - 1 + window - 1 - offset);
  }
  const int qt_lo = r_lo / BN;
  const int n_qt = r_hi < r_lo ? 0 : r_hi / BN - qt_lo + 1;
  const int per = (group * n_qt + n_split - 1) / n_split;
  const int i0 = split * per;                     // this block's run of steps
  const int n_steps = max(0, min(group * n_qt, i0 + per) - i0);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);                 // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg_index = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg_index == 0) {
    // ---- producer: K (and V) once, then Q, dO, lse and delta per step
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      const size_t plane = static_cast<size_t>(B) * H * Sp;
      mbar_expect_tx(kv_full, (kDk ? 2 : 1) * L::kTileO);
      load_tile<DP, CHUNK, BN, kBlockRows>(ks, &kmap, kv_full, kvh, k0, b);
      if (kDk) load_tile<DP, CHUNK, BN, kBlockRows>(vs, &vmap, kv_full, kvh, k0, b);
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % kStages;
        const int h = kvh * group + (i0 + i) / n_qt;
        const int q0 = (qt_lo + (i0 + i) % n_qt) * BN;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(&full[st], 2 * L::kTileS + 2 * BN * 4);
        load_tile<DP, CHUNK, BN, BN>(qs + st * L::kTileS, &qmap, &full[st], h, q0, b);
        load_tile<DP, CHUNK, BN, BN>(gs + st * L::kTileS, &gmap, &full[st], h, q0, b);
        const size_t row = (static_cast<size_t>(b) * H + h) * Sp + q0;
        bulk_load(lse_s + st * BN, work + row, BN * 4, &full[st]);
        bulk_load(dl_s + st * BN, work + plane + row, BN * 4, &full[st]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys kw0 .. kw0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = wg_index - 1;
  const int lane = tid % 32;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * ((tid / 32) % 4) + lane / 4;  // keys key0 and key0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t k_base = smem_u32(ks) + wg * 64 * L::kRowBytes;
  const uint32_t v_base = smem_u32(vs) + wg * 64 * L::kRowBytes;
  float acc[kDv && kDk ? 2 : 1][DP / 2];          // dv then dk, or the one of them
#pragma unroll
  for (int a = 0; a < (kDv && kDk ? 2 : 1); ++a)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[a][i] = 0.f;
  float s[BN / 2], dp[BN / 2];                    // S^T then P^T; dP^T then dS^T
  uint32_t pf[BN / 4], df[BN / 4];                // P^T and dS^T in bf16: A fragments

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    const int q0 = (qt_lo + (i0 + i) % n_qt) * BN;
    const uint32_t q_st = smem_u32(qs + st * L::kTileS);
    const uint32_t g_st = smem_u32(gs + st * L::kTileS);
    mbar_wait(&full[st], (i / kStages) & 1);
    wgmma_fence();
    gemm_nt<DP, CHUNK, BN>(s, k_base, q_st);      // S^T = K Q^T
    if constexpr (kDk) gemm_nt<DP, CHUNK, BN>(dp, v_base, g_st);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BN / 2>(s);
    if constexpr (kDk) fence_regs<BN / 2>(dp);
    // P^T and dS^T: column 8 j + col0 + e of the fragment is query row q0
    // + 8 j + col0 + e, whose lse and delta sit in the stage
    const float* lse = lse_s + st * BN;
    const float* dl = dl_s + st * BN;
    const int p0 = q0 + offset;                   // key position of the tile's first row
    if ((causal && kw0 + 63 > p0) || (window > 0 && kw0 <= p0 + BN - 1 - window)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(lse + 8 * j + col0);
        const float2 ds = *reinterpret_cast<const float2*>(dl + 8 * j + col0);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hr + e;
            const int c = key0 + 8 * hr;
            const int pos = p0 + 8 * j + col0 + e;
            const bool off = (causal && c > pos) || (window > 0 && c <= pos - window);
            // a masked score: NEG_INF, or 0 in a row with no valid key
            const float logit = off ? (pos < 0 ? 0.f : kNegInf) : s[x] * scale_log2;
            const float p = ex2(logit - (e ? ls.y : ls.x));
            s[x] = p;
            if constexpr (kDk) dp[x] = off ? 0.f : p * (dp[x] - (e ? ds.y : ds.x));
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(lse + 8 * j + col0);
        const float2 ds = *reinterpret_cast<const float2*>(dl + 8 * j + col0);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hr + e;
            const float p = ex2(fmaf(s[x], scale_log2, -(e ? ls.y : ls.x)));
            s[x] = p;
            if constexpr (kDk) dp[x] = p * (dp[x] - (e ? ds.y : ds.x));
          }
        }
      }
    }
    if constexpr (kDv) pack_frag<BN>(pf, s);
    if constexpr (kDk) pack_frag<BN>(df, dp);
    wgmma_fence();
    if constexpr (kDv) gemm_nn<DP, CHUNK, BN>(acc[0], pf, g_st);          // dV += P^T dO
    if constexpr (kDk) gemm_nn<DP, CHUNK, BN>(acc[kDv ? 1 : 0], df, q_st);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < (kDv && kDk ? 2 : 1); ++a) fence_regs<DP / 2>(acc[a]);
    mbar_arrive(&empty[st]);
  }

  // dk = scale * the sum, dv the sum, in bf16, or the fp32 sums of this
  // split into part [n_split][2 (dk, dv)][B][T][KV][D]; keys >= T and
  // columns >= D are not stored
  const size_t plane = static_cast<size_t>(B) * Tk * KV * D;
#pragma unroll
  for (int a = 0; a < (kDv && kDk ? 2 : 1); ++a) {
    const bool is_dv = kDv && a == 0;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = key0 + 8 * hr;
      if (c >= Tk) continue;
      const size_t row = ((static_cast<size_t>(b) * Tk + c) * KV + kvh) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int d = 8 * j + col0;
        if (d >= D) continue;
        const float x0 = acc[a][4 * j + 2 * hr], x1 = acc[a][4 * j + 2 * hr + 1];
        if (n_split > 1) {
          *reinterpret_cast<float2*>(part + (2 * split + is_dv) * plane + row + d) =
              make_float2(x0, x1);
        } else if (is_dv) {
          *reinterpret_cast<__nv_bfloat162*>(dv + row + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dk + row + d) =
              __floats2bfloat162_rn(x0 * scale, x1 * scale);
        }
      }
    }
  }
}

// the splits' fp32 sums of dk and dv added in split order, to bf16 (dk
// times scale); n = B * T * KV * D, a thread an element pair of each
__global__ void __launch_bounds__(256)
sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, long long n, int n_split, float scale) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (i >= n) return;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float2 k2 = *reinterpret_cast<const float2*>(part + 2 * s * n + i);
    const float2 v2 = *reinterpret_cast<const float2*>(part + (2 * s + 1) * n + i);
    sk.x += k2.x, sk.y += k2.y, sv.x += v2.x, sv.y += v2.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + i) = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  *reinterpret_cast<__nv_bfloat162*>(dv + i) = __floats2bfloat162_rn(sv.x, sv.y);
}

// ---- dq: a block per (128 query rows, query head, batch)
template <int DP, int CHUNK, int BN>
__global__ void __launch_bounds__(kHopperThreads, 1)
dq_hopper(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
          const float* __restrict__ work, __nv_bfloat16* __restrict__ dq, int B, int S, int Sp,
          int Tk, int H, int KV, int D, int causal, int window, float scale, float scale_log2) {
  using L = BwdTiles<DP, CHUNK, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* gs = qs + L::kTileO;
  uint8_t* ks = gs + L::kTileO;                  // kStages K tiles
  uint8_t* vs = ks + kStages * L::kTileS;        // kStages V tiles
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(vs + kStages * L::kTileS +
                                                  kStages * 2 * BN * 4);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + kStages;
  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int offset = Tk - S;

  // the key tiles of the forward's band for these rows (every key tile
  // when a row has no valid key: its dS is 0 throughout)
  const int pos_first = q0 + offset;
  const int pos_last = min(q0 + kBlockRows, S) - 1 + offset;
  int k_lo = 0, k_hi = Tk - 1;
  if (causal && pos_first >= 0) {
    k_hi = min(Tk - 1, pos_last);
    if (window > 0) k_lo = max(0, pos_first - window + 1);
  }
  const int t_lo = k_lo / BN;
  const int n_tiles = k_hi / BN - t_lo + 1;

  if (tid == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg_index = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg_index == 0) {
    // ---- producer: Q and dO once, then K and V per key tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(qg_full, 2 * L::kTileO);
      load_tile<DP, CHUNK, BN, kBlockRows>(qs, &qmap, qg_full, h, q0, b);
      load_tile<DP, CHUNK, BN, kBlockRows>(gs, &gmap, qg_full, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int kt0 = (t_lo + i) * BN;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kTileS);
        load_tile<DP, CHUNK, BN, BN>(ks + st * L::kTileS, &kmap, &full[st], kvh, kt0, b);
        load_tile<DP, CHUNK, BN, BN>(vs + st * L::kTileS, &vmap, &full[st], kvh, kt0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = wg_index - 1;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;  // rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_base = smem_u32(qs) + wg * 64 * L::kRowBytes;
  const uint32_t g_base = smem_u32(gs) + wg * 64 * L::kRowBytes;
  const int p_first = q0 + 64 * wg + offset;    // key position of the warpgroup's first row
  const size_t at = (static_cast<size_t>(b) * H + h) * Sp + row0;
  const size_t plane = static_cast<size_t>(B) * H * Sp;
  const float lse[2] = {work[at], work[at + 8]};
  const float dl[2] = {work[plane + at], work[plane + at + 8]};
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
  float s[BN / 2], dp[BN / 2];                    // S; dP then dS
  uint32_t df[BN / 4];                            // dS in bf16: the A fragment

  mbar_wait(qg_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int kt0 = (t_lo + i) * BN;
    const uint32_t k_st = smem_u32(ks + st * L::kTileS);
    const uint32_t v_st = smem_u32(vs + st * L::kTileS);
    mbar_wait(&full[st], (i / kStages) & 1);
    wgmma_fence();
    gemm_nt<DP, CHUNK, BN>(s, q_base, k_st);      // S = Q K^T
    gemm_nt<DP, CHUNK, BN>(dp, g_base, v_st);     // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BN / 2>(s);
    fence_regs<BN / 2>(dp);
    // dS: column 8 j + col0 + e of the fragment is key kt0 + 8 j + col0 + e
    if (kt0 + BN > Tk || (causal && kt0 + BN - 1 > p_first) ||
        (window > 0 && kt0 <= p_first + 63 - window)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hr + e;
            const int c = kt0 + 8 * j + col0 + e;
            const int pos = row0 + 8 * hr + offset;
            const bool off =
                c >= Tk || (causal && c > pos) || (window > 0 && c <= pos - window);
            const float p = ex2(fmaf(s[x], scale_log2, -lse[hr]));
            dp[x] = off ? 0.f : p * (dp[x] - dl[hr]);
          }
        }
      }
    } else {
#pragma unroll
      for (int x = 0; x < BN / 2; ++x) {
        const int hr = (x >> 1) & 1;
        dp[x] = ex2(fmaf(s[x], scale_log2, -lse[hr])) * (dp[x] - dl[hr]);
      }
    }
    pack_frag<BN>(df, dp);
    wgmma_fence();
    gemm_nn<DP, CHUNK, BN>(dq_acc, df, k_st);     // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dq_acc);
    mbar_arrive(&empty[st]);
  }

  // dq = scale * the sum in bf16; rows >= S and columns >= D not stored
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + 8 * hr;
    if (r >= S) continue;
    __nv_bfloat16* out = dq + ((static_cast<size_t>(b) * S + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + col0;
      if (d >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + d) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * hr] * scale, dq_acc[4 * j + 2 * hr + 1] * scale);
    }
  }
}

template <int DP, int CHUNK, int BN, int PART>
int launch_dkdv(const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
                const CUtensorMap& gmap, const float* work, void* dk, void* dv, float* part,
                int n_split, int B, int S, int Sp, int Tk, int H, int KV, int D, int causal,
                int window, float scale, cudaStream_t stream) {
  using L = BwdTiles<DP, CHUNK, BN>;
  auto kernel = dkdv_hopper<DP, CHUNK, BN, PART>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  kernel<<<dim3((Tk + kBlockRows - 1) / kBlockRows, KV * n_split, B), kHopperThreads, L::kSmem,
           stream>>>(qmap, kmap, vmap, gmap, work, static_cast<__nv_bfloat16*>(dk),
                     static_cast<__nv_bfloat16*>(dv), part, n_split, B, S, Sp, Tk, H, KV, D,
                     causal, window, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// prep_kernel, dq_hopper, dkdv_hopper (one walk for both, or one each
// for dv and dk above D = 128) and, with n_split > 1, sum_kernel
template <int DP, int CHUNK, int BN>
int launch_hopper(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* stats, void* dq, void* dk, void* dv, float* work, int B, int S,
                  int Tk, int H, int KV, int D, int causal, int window, int n_split, float scale,
                  cudaStream_t stream) {
  using L = BwdTiles<DP, CHUNK, BN>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qmap, kmap, vmap, gmap;             // boxes of [1, BN, 1, CHUNK]
  if (!encode_map(fn, &qmap, q, D, H, S, B, CHUNK, BN) ||
      !encode_map(fn, &kmap, k, D, KV, Tk, B, CHUNK, BN) ||
      !encode_map(fn, &vmap, v, D, KV, Tk, B, CHUNK, BN) ||
      !encode_map(fn, &gmap, dout, D, H, S, B, CHUNK, BN)) {
    return kErrShape;
  }
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (L::kSmem > optin || n_split < 1 || static_cast<long long>(KV) * n_split > 65535) {
    return kErrShape;
  }
  const int Sp = (S + kBlockRows - 1) / kBlockRows * kBlockRows;
  const long long prep_threads = static_cast<long long>(B) * H * Sp * 32;
  if (prep_threads / 256 + 1 > 0x7fffffff) return kErrShape;
  prep_kernel<<<static_cast<unsigned>((prep_threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), stats, work,
      B, S, Sp, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kq = dq_hopper<DP, CHUNK, BN>;
  cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  kq<<<dim3((S + kBlockRows - 1) / kBlockRows, H, B), kHopperThreads, L::kSmem, stream>>>(
      qmap, kmap, vmap, gmap, work, static_cast<__nv_bfloat16*>(dq), B, S, Sp, Tk, H, KV, D,
      causal, window, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the splits' sums after the rows' lse and delta
  float* part = work + 2 * static_cast<size_t>(B) * H * Sp;
  int rc;
  if constexpr (DP <= 128) {
    rc = launch_dkdv<DP, CHUNK, BN, kBoth>(qmap, kmap, vmap, gmap, work, dk, dv, part, n_split, B,
                                            S, Sp, Tk, H, KV, D, causal, window, scale, stream);
  } else {
    rc = launch_dkdv<DP, CHUNK, BN, kDvOnly>(qmap, kmap, vmap, gmap, work, dk, dv, part, n_split,
                                              B, S, Sp, Tk, H, KV, D, causal, window, scale,
                                              stream);
    if (rc == 0) {
      rc = launch_dkdv<DP, CHUNK, BN, kDkOnly>(qmap, kmap, vmap, gmap, work, dk, dv, part,
                                                n_split, B, S, Sp, Tk, H, KV, D, causal, window,
                                                scale, stream);
    }
  }
  if (rc != 0 || n_split == 1) return rc;
  const long long n = static_cast<long long>(B) * Tk * KV * D;
  sum_kernel<<<static_cast<unsigned>((n / 2 + 255) / 256), 256, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_simt(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* stats, void* dq, void* dk, void* dv, float* work, int B, int S,
                int Tk, int H, int KV, int D, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr int BK = DP <= 128 ? 64 : 32;
  using LQ = DqSmem<DP, BK>;
  using LK = DkdvSmem<DP, BK>;
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (LQ::kBytes > optin || LK::kBytes > optin) return kErrShape;
  auto k1 = dq_kernel<DP, BK>;
  auto k2 = dkdv_kernel<DP, BK>;
  cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::kBytes);
  cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, LK::kBytes);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  k1<<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, LQ::kBytes, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), dot, stats, static_cast<float*>(dq), work, B, S, Tk, H,
      KV, D, causal, window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3((Tk + BK - 1) / BK, KV, B), kThreads, LK::kBytes, stream>>>(
      qt, kt, vt, dot, stats, work, static_cast<float*>(dk), static_cast<float*>(dv), B, S, Tk, H, KV, D,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

#define XBOF_BWD_ARGS q, k, v, o, dout, stats, dq, dk, dv, work, B, S, Tk, H, KV, D, causal, window

int dispatch_fp32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* stats, void* dq, void* dk, void* dv, float* work, int B, int S,
                  int Tk, int H, int KV, int D, int causal, int window, float scale,
                  cudaStream_t s) {
  if (D <= 32) return launch_simt<32>(XBOF_BWD_ARGS, scale, s);
  if (D <= 64) return launch_simt<64>(XBOF_BWD_ARGS, scale, s);
  if (D <= 80) return launch_simt<80>(XBOF_BWD_ARGS, scale, s);
  if (D <= 96) return launch_simt<96>(XBOF_BWD_ARGS, scale, s);
  if (D <= 128) return launch_simt<128>(XBOF_BWD_ARGS, scale, s);
  if (D <= 160) return launch_simt<160>(XBOF_BWD_ARGS, scale, s);
  if (D <= 192) return launch_simt<192>(XBOF_BWD_ARGS, scale, s);
  return launch_simt<256>(XBOF_BWD_ARGS, scale, s);
}

// bf16: (padded head dim, box columns, streamed rows) of each wgmma
// instantiation, the forward's boxes; 32 streamed rows at D = 256, so that
// the own tiles and two stages fit 227 KB
int dispatch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* stats, void* dq, void* dk, void* dv, float* work, int B, int S,
                  int Tk, int H, int KV, int D, int causal, int window, int n_split, float scale,
                  cudaStream_t s) {
  if (D <= 16) return launch_hopper<16, 16, 64>(XBOF_BWD_ARGS, n_split, scale, s);
  if (D <= 32) return launch_hopper<32, 32, 64>(XBOF_BWD_ARGS, n_split, scale, s);
  if (D <= 64) return launch_hopper<64, 64, 64>(XBOF_BWD_ARGS, n_split, scale, s);
  if (D <= 80) return launch_hopper<80, 16, 64>(XBOF_BWD_ARGS, n_split, scale, s);
  if (D <= 96) return launch_hopper<96, 32, 64>(XBOF_BWD_ARGS, n_split, scale, s);
  if (D <= 128) return launch_hopper<128, 64, 64>(XBOF_BWD_ARGS, n_split, scale, s);
  return launch_hopper<256, 64, 32>(XBOF_BWD_ARGS, n_split, scale, s);
}
#undef XBOF_BWD_ARGS

}  // namespace

// kind: 0 = fp32, 1 = bf16 (q, k, v, o, dout and the three gradients
// alike); stats: the forward's fp32 [2, B, H, S] (m, l); work: an fp32
// scratch of 2 * B * H * Sp (Sp = S rounded up to 128), and for bf16 with
// n_split > 1 another 2 * n_split * B * T * KV * D after it; n_split: the
// runs each bf16 dk / dv block's walk is cut into (1 for fp32). Launches
// the kind's kernels in order on `stream` and returns cudaGetLastError()
// after them (0 on success), cudaErrorInvalidValue for an unknown kind,
// cudaErrorNotSupported when the driver offers no cuTensorMapEncodeTiled,
// or kErrShape for a shape it refuses: head_dim not a multiple of 8 in
// 8..256, H not a multiple of KV, S or T below 1, more than 65535 heads,
// batches or KV heads x splits, a window without causal, or (bf16) q, k,
// v, dout or work not starting on 16 bytes (TMA). The Python wrapper
// turns kErrShape into a ValueError.
extern "C" int xbof_flash_attention_bwd(int kind, const void* q, const void* k, const void* v,
                                        const void* o, const void* stats, const void* dout,
                                        void* dq, void* dk, void* dv, void* work, int B, int S,
                                        int T, int H, int KV, int D, int causal, int window,
                                        int n_split, float scale, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || H > 65535 || B > 65535 || D < 8 ||
      D > 256 || D % 8 != 0 || window < 0 || (window > 0 && !causal) || n_split < 1) {
    return kErrShape;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* w = static_cast<float*>(work);
  switch (kind) {
    case 0:
      return dispatch_fp32(q, k, v, o, dout, st, dq, dk, dv, w, B, S, T, H, KV, D, causal, window,
                           scale, s);
    case 1:
      if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
           reinterpret_cast<uintptr_t>(work)) % 16 != 0) {
        return kErrShape;
      }
      return dispatch_bf16(q, k, v, o, dout, st, dq, dk, dv, w, B, S, T, H, KV, D, causal, window,
                           n_split, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
