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
// What bounds it on the card: per step and head the function needs 5 K V
// operations (r . S, and w * S + k v^T) plus 3 K + 2 V for the bonus,
// which factors as (sum_i r_i u_i k_i) * v_j, against 2 (3 K + 2 V) bytes
// in bf16. On the CUDA cores (67 TFLOP/s fp32) that is above the card's
// balance and operations would bound it (0.10 ms for the rwkv6-3b
// prefill's [4, 2048, 40, 64]); as matrix products on the tensor cores
// (989 TFLOP/s bf16) bytes bound it: about 211 MB in and out, 0.063 ms at
// 3.35 TB/s. A walk along T one step at a time is bound by each step's
// latency long before either.
//
// bf16: a chunked kernel on the tensor cores (`wkv_chunk_kernel`). One
// block of 4 K threads per (b, h) walks T in chunks of C = 16 rows. Write
// c for a chunk's first row and D(s, t) = prod_{s < m < t} w_m per key
// channel (1 when the range is empty). Then, for t in the chunk,
//   out_t = (r_t * D(c-1, t)) . S_c + sum_{s < t in chunk} A[t][s] v_s
//           + (sum_i r_t[i] u[i] k_t[i]) v_t,
//   A[t][s] = sum_i r_t[i] k_s[i] D(s, t)[i],
//   S_{c+C} = diag(D(c-1, c+C)) S_c + sum_s (k_s * D(s, c+C))^T v_s,
// so that a chunk costs three matrix products (the decayed r times S, A
// times V, the decayed k's transpose times V) and the 16 x 16 matrix A,
// whose diagonal holds the bonus (factored: 3 K operations per row).
// - The decay is never a logarithm: every factor is a running product of
//   w over a range of the chunk, anchored at the chunk's first row (the
//   decayed r), at its last (the decayed k, the state's decay) or at the
//   pair's own rows (A). With 0 <= w <= 1, the model's range (w =
//   exp(-exp(x)) rounded to bf16 gives w = 0 and w = 1 exactly), each
//   factor lies in [0, 1]: nothing overflows, w = 0 is an exact 0 and no
//   log floor is needed. The anchored forms `exp(L_t - L_s)` of a log-space
//   chunked scan overflow fp32 once the decay over a chunk passes e^88,
//   and log 0 makes NaN; products do neither. Outside [0, 1] the kernel
//   still computes the same recurrence, but only [0, 1] is tested.
// - Warp roles. The first 2 K threads run the "diagonal phase" in fp32 on
//   the CUDA cores: thread (s, g) owns row s and 8 key channels and walks
//   the 8 rows t of s's half of the chunk, keeping r_t . (k_s D(s, t)) for
//   t > s, the half's prefix product for t < s and the product of w over
//   the other half; the K / 8 threads of a row sum their channels by
//   recursive halving (each lane ends with the sums of 8 / (K / 8) rows
//   t). Some 16 x 8 x K x 4 operations a chunk, 10 % of the serial walk's
//   16 x 5 K V at K = V = 64. The same threads make the copies. The other
//   K / 16 warps take the products, warp js owning columns [16 js, 16 js
//   + 16) of S. A's quadrant across the halves (t in 8 .. 15, s in 0 ..
//   7) is a product on the tensor cores, anchored at row 8: X_t . X_s with
//   X_s = k_s D(s, 8) in the first half and X_t = r_t D(7, t) in the
//   second, taken by the product warps. The diagonal phase runs one chunk
//   ahead of the products, on two buffers, handed over by named barriers
//   (full: A, X and the decayed r and k are written; empty: the products
//   are done), so the two overlap.
// - Products: warp-level `mma.sync.m16n8k16` bf16 with fp32 sums. A warp
//   keeps its columns of S as S^T in fp32 accumulators (K / 2 per thread),
//   whose fragments are, as they stand, the B operand of out = rd . S, so
//   S never goes through shared memory, and out leaves the registers as
//   bf16 pairs straight to device memory. Every operand that is not bf16
//   already (the state, the decayed r and k, X, A) is split into two bf16
//   halves, x = hi + lo, and each product is taken as hi hi + hi lo + lo hi:
//   three MMAs instead of one, for errors near one rounding of the fp32
//   result. With one bf16 operand each, the CPU emulation of this
//   arithmetic (tests/test_torch_wkv_chunked.py) comes close to the bf16
//   gate at K = 128.
// - Loads: the chunk's r, k, v, w tiles go through a 4-stage ring of
//   `cp.async` copies, two chunks ahead of the diagonal phase. Rows past T
//   are written as r = k = v = 0 and w = 1, which leaves the state
//   unchanged (ragged T, T < C). No atomics: `out` is the same bits from
//   call to call, with or without the final state.
// - What bounds it: one block per head (160 blocks on 132 SMs at the
//   prefill's shape, so 28 SMs hold two), each a chain of T / 16 chunks;
//   on an SM with two blocks the two phases contend for issue slots and
//   shared memory more than they overlap. Tried on the card and dropped:
//   both phases in the same warps, r and w staged in fp32, per-step
//   branches (the loads lose their hoisting) and 4 channels per diagonal
//   thread (spills), each slower; loads more than two chunks ahead, no
//   gain.
// - Why not wgmma and TMA: the products, split operands included, come to
//   224 MMAs of 16 x 8 x 16 a chunk and head, 18.8 GFLOP at the prefill's
//   shape, 0.019 ms at the bf16 peak against 0.063 ms of bytes; the
//   tensor cores' extra rate buys nothing here.
// - Why one block per (b, h) and not a split of V over blocks: each block
//   would redo the diagonal phase.
// Needs r, k, v, w on 16 bytes (`cp.async`); a view that is not takes the
// serial kernel below.
//
// fp32: the serial kernel (`rwkv6_kernel`): one block of V threads per
// (b, h); thread j owns column j of S, K fp32 values in registers, and
// walks T one step at a time, staging r_t, k_t and w_t in double-buffered
// shared memory (one barrier per step). The fp32 gate (1e-4 of 1 + |want|)
// leaves no room for TF32 products.
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

// ------------------------------------------------ the chunked bf16 kernel
using bf16 = __nv_bfloat16;

constexpr int kC = 16;       // rows per chunk
constexpr int kStages = 4;   // chunks in the load ring
constexpr int kAhead = 2;    // chunks loaded ahead of the diagonal phase
// named barriers (0 is __syncthreads'): the diagonal-phase warps among
// themselves; buffer x full (its diagonal phase done) and empty (its
// products done), x = chunk & 1
constexpr int kBarDiag = 1, kBarFull = 2, kBarEmpty = 4;

// A block of 4 K threads per (b, h): 2 K diagonal-phase threads (row s of
// the chunk, 8 key channels each, G = K / 8 per row), which also make the
// copies, and K / 16 product warps, warp js owning columns [16 js, 16 js +
// 16) of S with all K of its rows.
template <int K>
struct Chunk {
  static constexpr int ND = 2 * K;   // diagonal-phase threads
  static constexpr int G = K / 8;    // of them per row
  static constexpr int NT = 4 * K;   // threads
  static constexpr int LD = K + 8;   // bf16 row stride of a [16, K] tile: rows 16
                                     // bytes apart in the banks, so ldmatrix's
                                     // eight rows never collide
  static constexpr int LDA = kC + 8;               // of the [16, 16] matrix A
  static constexpr int TILE = kC * LD;
  static constexpr int ATILE = kC * LDA;
  // the ring (kStages x r, k, v, w), then two buffers (chunks c and c + 1)
  // of the decayed r and k, the half-anchored X and A (hi and lo each) in
  // bf16, and two of the chunk's decay in fp32
  static constexpr int RING = kStages * 4 * TILE;
  static constexpr int BUF = 6 * TILE + 2 * ATILE;
  static constexpr int BYTES = 2 * (RING + 2 * BUF) + 4 * 2 * K;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&d)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}

// d += a . b: a 16 x 16 (row major), b 16 x 8 (column major), bf16; d fp32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two bf16 pairs: hi = bf16(x, y), lo = bf16 of what hi misses
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 8 bf16 (16 bytes of shared memory) as fp32, exactly
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(wd[i] << 16);
    f[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
  }
}

// 8 fp32 as hi and lo bf16 halves, 16 bytes each
__device__ __forceinline__ void store8_split(const float (&f)[8], bf16* hi, bf16* lo) {
  uint4 h, l;
  split2(f[0], f[1], h.x, l.x);
  split2(f[2], f[3], h.y, l.y);
  split2(f[4], f[5], h.z, l.z);
  split2(f[6], f[7], h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// Sums of v[0 .. LEN) over the G adjacent lanes of a row, and of beta. At
// each level a lane keeps half of its rows and sends the other half to the
// lane O = G / 2 away, which keeps the opposite half; t0 counts the rows
// skipped. With fewer than two rows left, both lanes keep the one row.
template <int G, int LEN>
__device__ __forceinline__ void sum_rows(float (&v)[kC], float& beta, int lane, int& t0) {
  if constexpr (G > 1) {
    constexpr int O = G / 2;
    beta += __shfl_xor_sync(0xffffffffu, beta, O);
    if constexpr (LEN >= 2) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < LEN / 2; ++i) {
        const float send = up ? v[i] : v[i + LEN / 2];
        const float keep = up ? v[i + LEN / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      t0 += up ? LEN / 2 : 0;
      sum_rows<O, LEN / 2>(v, beta, lane, t0);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      sum_rows<O, 1>(v, beta, lane, t0);
    }
  }
}

// The diagonal phase of one chunk, thread (row s, channels c0 .. c0 + 7),
// on s's half of the chunk (rows h0 .. h0 + 7, h0 = 0 or 8): A[t][s] for t
// in that half (the bonus at t = s), and the products of w it needs, from
// which the decayed r_s = r_s * D(c-1, s), the decayed k_s = k_s * D(s,
// c+C), row s of X (k_s * D(s, 8) in the first half, r_s * D(7, s) in the
// second, the operands of A's cross-half quadrant) and, from row 15, the
// chunk's decay D(c-1, c+C); fp32, split into bf16 halves for the products.
template <int K>
__device__ __forceinline__ void diag_phase(const bf16* st, const float (&uu)[8], int s, int c0,
                                           int lane, bf16* rd_hi, bf16* rd_lo, bf16* kd_hi,
                                           bf16* kd_lo, bf16* x_hi, bf16* x_lo, bf16* a_hi,
                                           bf16* a_lo, float* decay) {
  using L = Chunk<K>;
  constexpr int HALF = kC / 2;
  const bf16* sr = st;
  const bf16* sk = st + L::TILE;
  const bf16* sw = st + 3 * L::TILE;
  const int h0 = s & HALF;  // first row of s's half
  float rs[8], ks[8];
  load8(sr + s * L::LD + c0, rs);
  load8(sk + s * L::LD + c0, ks);
  float beta = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) beta = fmaf(rs[c] * uu[c], ks[c], beta);
  float P[8], D[8], Go[8], v[kC];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    P[c] = 1.0f;   // D(h0 - 1, s): w over the rows of the half before s
    D[c] = 0.0f;   // k_s D(s, t) once t > s
    Go[c] = 1.0f;  // w over the other half
  }
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const int t = h0 + i;
    float rt[8], wt[8], wo[8];
    load8(sr + t * L::LD + c0, rt);
    load8(sw + t * L::LD + c0, wt);
    load8(sw + ((t + HALF) % kC) * L::LD + c0, wo);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; c += 2) {
      a0 = fmaf(rt[c], D[c], a0);
      a1 = fmaf(rt[c + 1], D[c + 1], a1);
    }
    v[i] = a0 + a1;
    const bool before = t < s, at = t == s;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      P[c] = before ? P[c] * wt[c] : P[c];
      D[c] = at ? ks[c] : D[c] * wt[c];
      Go[c] *= wo[c];
    }
    if (i == HALF - 1 && s == kC - 1) {  // D(c-1, c+C): both halves' w
#pragma unroll
      for (int c = 0; c < 8; ++c) decay[c0 + c] = P[c] * wt[c] * Go[c];
    }
  }
  // Sum over the G threads of row s (adjacent lanes), by recursive
  // halving: this lane ends with the sums of rows h0 + t0 .. h0 + t0 + NL - 1.
  int t0 = 0;
  sum_rows<L::G, HALF>(v, beta, lane, t0);
  constexpr int NL = HALF / L::G > 1 ? HALF / L::G : 1;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int t = h0 + t0 + i;
    const float a = t > s ? v[i] : (t == s ? beta : 0.0f);
    const bf16 hi = __float2bfloat16(a);
    a_hi[t * L::LDA + s] = hi;
    a_lo[t * L::LDA + s] = __float2bfloat16(a - __bfloat162float(hi));
  }
  // the first half's rows reach the chunk's end through the second half's
  // w, the second half's rows come from its start through the first's
  float rd[8], kd[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    rs[c] *= P[c];
    rd[c] = h0 ? rs[c] * Go[c] : rs[c];
    kd[c] = h0 ? D[c] : D[c] * Go[c];
  }
  store8_split(rd, rd_hi + s * L::LD + c0, rd_lo + s * L::LD + c0);
  store8_split(kd, kd_hi + s * L::LD + c0, kd_lo + s * L::LD + c0);
  if (h0) {
    store8_split(rs, x_hi + s * L::LD + c0, x_lo + s * L::LD + c0);
  } else {
    store8_split(D, x_hi + s * L::LD + c0, x_lo + s * L::LD + c0);
  }
}

// The products of one chunk for the warp owning columns [j0, j0 + 16) of
// S, whose S^T fragments (fp32 accumulators) are S's B operand as they
// stand: out = rd . S + A . v, stored from registers for the chunk's n
// rows, then S^T <- S^T diag(decay) + v^T . kd.
template <int K>
__device__ __forceinline__ void products(float (&S)[K / 8][4], const bf16* sv,
                                         const bf16* rd_hi, const bf16* rd_lo,
                                         const bf16* kd_hi, const bf16* kd_lo,
                                         const bf16* x_hi, const bf16* x_lo,
                                         const bf16* a_hi, const bf16* a_lo,
                                         const float* decay, bf16* out, int64_t row_stride,
                                         int n, int lane, int j0) {
  using L = Chunk<K>;
  const int g = lane >> 2, q = lane & 3;
  const int mr = lane & 7, mi = lane >> 3;  // ldmatrix: row of matrix mi
  // an A operand [16 t, 16] from its rows: matrices (t 0-7 | 8-15) x (col 0-7 | 8-15)
  const int a_row = mr + 8 * (mi & 1), a_col = 8 * (mi >> 1);
  // two sums per tile of 8 columns (hi hi; lo hi + hi lo) keep chains short
  float O[2][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t ah[4], al[4], bh[2][2], bl[2][2];
    ldmatrix_x4(ah, rd_hi + a_row * L::LD + 16 * kk + a_col);
    ldmatrix_x4(al, rd_lo + a_row * L::LD + 16 * kk + a_col);
    // S[n][e] is S^T[j = j0 + g + 8 (e >> 1)][i = 8 n + 2 q + (e & 1)]: for
    // columns j0 + g (m = 0) and j0 + 8 + g (m = 1), rows 16 kk + 2 q (+8)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      split2(S[2 * kk][2 * m], S[2 * kk][2 * m + 1], bh[m][0], bl[m][0]);
      split2(S[2 * kk + 1][2 * m], S[2 * kk + 1][2 * m + 1], bh[m][1], bl[m][1]);
      mma(O[0][m], ah, bh[m][0], bh[m][1]);
      mma(O[1][m], al, bh[m][0], bh[m][1]);
      mma(O[1][m], ah, bl[m][0], bl[m][1]);
    }
  }
  // v [16 s, 16 j] by 8 x 8 blocks, transposed: vb[0], vb[1] are the B
  // operand of columns j0 .. j0 + 7, vb[2], vb[3] of j0 + 8 .. j0 + 15
  uint32_t vb[4];
  ldmatrix_x4_trans(vb, sv + (mr + 8 * (mi & 1)) * L::LD + j0 + 8 * (mi >> 1));
  // A's cross-half quadrant, rows t = 8 .. 15 by columns s = 0 .. 7: rows 8
  // .. 15 of X times rows 0 .. 7 of X, transposed (Cx's rows 0 .. 7 are
  // not used)
  float Cx[2][4] = {};
  const int xb_off = mr * L::LD + 8 * (mi & 1);  // ldmatrix x2: rows s, two column blocks
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    ldmatrix_x4(ah, x_hi + a_row * L::LD + 16 * kk + a_col);
    ldmatrix_x4(al, x_lo + a_row * L::LD + 16 * kk + a_col);
    ldmatrix_x2(bh, x_hi + xb_off + 16 * kk);
    ldmatrix_x2(bl, x_lo + xb_off + 16 * kk);
    mma(Cx[0], ah, bh[0], bh[1]);
    mma(Cx[1], al, bh[0], bh[1]);
    mma(Cx[1], ah, bl[0], bl[1]);
  }
  {  // + A . v: the chunk's own rows and the bonus
    uint32_t ah[4], al[4];
    ldmatrix_x4(ah, a_hi + a_row * L::LDA + a_col);
    ldmatrix_x4(al, a_lo + a_row * L::LDA + a_col);
    // the fragment of rows 8 .. 15, columns 0 .. 7 is the cross-half
    // quadrant; rows 0 .. 7, columns 8 .. 15 lie above the diagonal
    split2(Cx[0][2] + Cx[1][2], Cx[0][3] + Cx[1][3], ah[1], al[1]);
    ah[2] = 0u;
    al[2] = 0u;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma(O[0][m], ah, vb[2 * m], vb[2 * m + 1]);
      mma(O[1][m], al, vb[2 * m], vb[2 * m + 1]);
    }
  }
  // O[.][m][e] is out[t = g + 8 (e >> 1)][j = j0 + 8 m + 2 q + (e & 1)]
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = g + 8 * hf;
      if (t < n) {
        *reinterpret_cast<__nv_bfloat162*>(out + t * row_stride + j0 + 8 * m + 2 * q) =
            __floats2bfloat162_rn(O[0][m][2 * hf] + O[1][m][2 * hf],
                                  O[0][m][2 * hf + 1] + O[1][m][2 * hf + 1]);
      }
    }
  }
  // the state; v^T [16 j, 16 s] as an A operand is the same four blocks
  const uint32_t va[4] = {vb[0], vb[2], vb[1], vb[3]};
#pragma unroll
  for (int nn = 0; nn < K / 8; ++nn) {
    const float2 d = *reinterpret_cast<const float2*>(decay + 8 * nn + 2 * q);
    S[nn][0] *= d.x;
    S[nn][1] *= d.y;
    S[nn][2] *= d.x;
    S[nn][3] *= d.y;
  }
  const int kd_off = (mr + 8 * (mi & 1)) * L::LD + 8 * (mi >> 1);
#pragma unroll
  for (int nn = 0; nn < K / 8; nn += 2) {
    uint32_t bh[4], bl[4];
    ldmatrix_x4_trans(bh, kd_hi + kd_off + 8 * nn);
    ldmatrix_x4_trans(bl, kd_lo + kd_off + 8 * nn);
    mma(S[nn], va, bh[0], bh[1]);
    mma(S[nn + 1], va, bh[2], bh[3]);
    mma(S[nn], va, bl[0], bl[1]);
    mma(S[nn + 1], va, bl[2], bl[3]);
  }
}

template <int K>
__global__ void __launch_bounds__(Chunk<K>::NT)
wkv_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 bf16* __restrict__ out, bf16* __restrict__ s_out, int T_len, int H) {
  using L = Chunk<K>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* tiles = ring + L::RING;                                   // 2 x BUF
  float* decays = reinterpret_cast<float*>(tiles + 2 * L::BUF);   // 2 x K

  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.x, h = bh % H;
  const int64_t b = bh / H;
  const int64_t row_stride = static_cast<int64_t>(H) * K;
  const int64_t base = (b * T_len * H + h) * K;               // (b, 0, h, 0)
  const int64_t state = static_cast<int64_t>(bh) * K * K;     // S of (b, h)
  const int n_chunks = (T_len + kC - 1) / kC;

  if (tid < L::ND) {
    // ---- the diagonal phase, one chunk ahead of the products; thread (row
    // s, channels c0 .. c0 + 7) also copies those 8 channels of row s of
    // r, k, v and w
    const int s = tid / L::G, c0 = 8 * (tid % L::G);
    float uu[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) uu[c] = u[h * K + c0 + c];
    auto load_chunk = [&](int c) {
      if (c >= n_chunks) return;
      bf16* st = ring + (c % kStages) * 4 * L::TILE + s * L::LD + c0;
      const int t = c * kC + s;
      if (t < T_len) {
        const int64_t off = base + t * row_stride + c0;
        cp_async16(st, r + off);
        cp_async16(st + L::TILE, k + off);
        cp_async16(st + 2 * L::TILE, v + off);
        cp_async16(st + 3 * L::TILE, w + off);
      } else {  // past T: r = k = v = 0, w = 1 leave the state as it is
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(st) = zero;
        *reinterpret_cast<uint4*>(st + L::TILE) = zero;
        *reinterpret_cast<uint4*>(st + 2 * L::TILE) = zero;
        *reinterpret_cast<uint4*>(st + 3 * L::TILE) =
            make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
      }
    };
#pragma unroll
    for (int p = 0; p < kAhead; ++p) {
      load_chunk(p);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int x = c & 1;
      // buffer x and ring stage (c + kAhead) % kStages held chunk c - 2
      if (c >= 2) bar_sync(kBarEmpty + x, L::NT);
      load_chunk(c + kAhead);
      cp_async_commit();
      cp_async_wait<kAhead>();
      bar_sync(kBarDiag, L::ND);  // every copy of chunk c has landed
      bf16* buf = tiles + x * L::BUF;
      diag_phase<K>(ring + (c % kStages) * 4 * L::TILE, uu, s, c0, lane, buf, buf + L::TILE,
                    buf + 2 * L::TILE, buf + 3 * L::TILE, buf + 4 * L::TILE,
                    buf + 5 * L::TILE, buf + 6 * L::TILE, buf + 6 * L::TILE + L::ATILE,
                    decays + x * K);
      bar_arrive(kBarFull + x, L::NT);
    }
  } else {
    // ---- the products, warp js: columns [16 js, 16 js + 16) of S
    const int j0 = 16 * ((tid - L::ND) >> 5), g = lane >> 2, q = lane & 3;
    float S[K / 8][4];
#pragma unroll
    for (int nn = 0; nn < K / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nn + 2 * q + (e & 1), j = j0 + g + 8 * (e >> 1);
        S[nn][e] = s0 != nullptr ? s0[state + static_cast<int64_t>(i) * K + j] : 0.0f;
      }
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int x = c & 1;
      bar_sync(kBarFull + x, L::NT);
      const bf16* buf = tiles + x * L::BUF;
      products<K>(S, ring + (c % kStages) * 4 * L::TILE + 2 * L::TILE, buf, buf + L::TILE,
                  buf + 2 * L::TILE, buf + 3 * L::TILE, buf + 4 * L::TILE, buf + 5 * L::TILE,
                  buf + 6 * L::TILE, buf + 6 * L::TILE + L::ATILE, decays + x * K,
                  out + base + static_cast<int64_t>(c) * kC * row_stride, row_stride,
                  T_len - c * kC, lane, j0);
      if (c + 2 < n_chunks) bar_arrive(kBarEmpty + x, L::NT);
    }
    if (s_out != nullptr) {
#pragma unroll
      for (int nn = 0; nn < K / 8; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * nn + 2 * q + (e & 1), j = j0 + g + 8 * (e >> 1);
          s_out[state + static_cast<int64_t>(i) * K + j] = __float2bfloat16(S[nn][e]);
        }
      }
    }
  }
}

template <int K>
int launch_chunked(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* s0, void* out, void* s_out, int B,
                   int T_len, int H, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * H;
  if (blocks > 2147483647LL) return kErrShape;
  constexpr int bytes = Chunk<K>::BYTES;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv_chunk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wkv_chunk_kernel<K><<<static_cast<unsigned>(blocks), Chunk<K>::NT, bytes, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(w), u, s0,
      static_cast<bf16*>(out), static_cast<bf16*>(s_out), T_len, H);
  return static_cast<int>(cudaGetLastError());
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

int dispatch_chunked(const void* r, const void* k, const void* v, const void* w,
                     const float* u, const float* s0, void* out, void* s_out, int B,
                     int T_len, int H, int K, cudaStream_t s) {
  switch (K) {
    case 16: return launch_chunked<16>(r, k, v, w, u, s0, out, s_out, B, T_len, H, s);
    case 32: return launch_chunked<32>(r, k, v, w, u, s0, out, s_out, B, T_len, H, s);
    case 64: return launch_chunked<64>(r, k, v, w, u, s0, out, s_out, B, T_len, H, s);
    case 128: return launch_chunked<128>(r, k, v, w, u, s0, out, s_out, B, T_len, H, s);
    default: return kErrShape;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// kind: 0 = fp32, 1 = bf16 (r, k, v, w, out and s_out alike); u is fp32
// [H, K]; s0 is fp32 [B, H, K, K] or null for zeros; s_out is [B, H, K, K]
// in the inputs' dtype or null when the final state is not wanted. bf16
// runs the chunked kernel when r, k, v and w start on 16 bytes, else the
// serial one. Returns cudaGetLastError() after the launch (0 on success),
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
      if (aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w)) {
        return dispatch_chunked(r, k, v, w, uf, s0f, out, s_out, B, T, H, K, s);
      }
      return dispatch_k<bf16>(r, k, v, w, uf, s0f, out, s_out, B, T, H, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
