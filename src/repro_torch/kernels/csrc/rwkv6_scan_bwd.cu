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
//     dr_t[k]  = sum_v S_{t-1}[k,v] dout_t[v] + u[k] k_t[k] rho_t
//     dk_t[k]  = sum_v dS_t[k,v] v_t[v] + u[k] r_t[k] rho_t
//     dv_t[v]  = sum_k dS_t[k,v] k_t[k] + dout_t[v] sigma_t
//     dw_t[k]  = sum_v dS_t[k,v] S_{t-1}[k,v]
//     du[k]    = sum_{b,t} r_t[k] k_t[k] rho_t,   ds0 = dS_{-1},
// with rho_t = v_t . dout_t and sigma_t = sum_k u[k] r_t[k] k_t[k].
// Inputs fp32 or bf16, one dtype (dout in it too); u, s0 and dS_T fp32;
// dr, dk, dv, dw written in the inputs' dtype, du and ds0 in fp32. K = V,
// one of 16, 32, 64, 128. Everything is summed in fp32 on the CUDA cores.
//
// What bounds it on the card: per (b, t, h) some 10 K V operations (the
// state's recomputation and dS's walk, 2 each per (k, v); dr, dk, dv and
// dw, one multiply-add each) against 18 bytes an element in bf16 (r, k, v,
// w and dout read, dr, dk, dv and dw written): at 67 TFLOP/s fp32 the
// operations bound it, 0.10 ms for a [1, 4096, 40, 64] microbatch. Only
// the two state recurrences are chains along T; everything else is
// independent across rows, so the design keeps the chains short of work
// and runs the rest in parallel.
//
// Design. dw needs S_{t-1} at every step of the reverse walk and w = 0
// occurs in bf16, so S cannot be recovered backwards as (S_t - k v^T) /
// w_t. Three kernels:
// - Phase A, the two chains (`wkv_bwd_chains`, one launch). A block of NW
//   warps (up to 4) walks one chain for one (b, h) and a tile of 16 rows by
//   NW * 16 columns of the state, each lane 4 rows by 2 columns: half the
//   blocks walk S forward from s0 (or zeros) and write S at the start of
//   every group of G rows (G = 64, 32 at K = 128) into an fp32 workspace;
//   the other half walk dS backward from dS_T (or zeros) and write dS at
//   the end of every group. The block's rows come into shared memory
//   through one cp.async ring of kStages stages of kRingRows rows,
//   kStages - 1 stages ahead of the walk, each thread's copies at places
//   fixed once (the sources move kRingRows rows a stage); bf16 rows are
//   converted to fp32 once a stage. A full stage's steps run with no
//   branch between them: snapshots fall on stage edges (dS's walk starts
//   pad rows into its first stage). A step is the chain's three fp32
//   operations per element and three shared-memory loads a lane.
// - Phase B, the groups (`wkv_bwd_groups`): a block (a cluster of K / VS
//   blocks at K = 128, VS columns each) per (b, h, group). The group's
//   rows come in at once, every thread's loads issued before its stores,
//   as fp32 in shared memory. Each thread owns a tile of TR x TC elements
//   of the state (4 x 4; 2 x 2 at K = 16): it walks S forward from the
//   group's snapshot through all but the last sub-chunk of kC = 8 rows,
//   keeping S at each sub-chunk's start in shared memory (its own slots:
//   no barrier guards them); then per sub-chunk, last to first, it walks
//   S forward from that checkpoint keeping S_{t-1} of each row in
//   registers, and walks dS backward from the group's end snapshot (a
//   full sub-chunk with no branch between its rows). Per row, its partial
//   sums over its own columns (dr, dk, dw) and rows (dv) meet the other
//   lanes' by shuffle trees that halve the values a lane holds at each
//   level; the warps' sums meet in shared memory, one buffer a sub-chunk,
//   and are added in warp order (at K = 128 the cluster's blocks are added
//   in rank order through distributed shared memory, each block finishing
//   a quarter of the rows). dr, dk, dv and dw are written once, in the
//   inputs' dtype; the group's block writes ds0 (group 0) and its rows' du
//   partial, sum_t r k rho in row order.
// - `wkv_bwd_du_kernel` sums the du partials [B, groups, H, K] in group
//   order, then batch order.
// No atomics: a repeated call gives the same bits (the trainer's restart
// compares losses to rtol 1e-6). S and dS repeat the forward's and the
// reverse walk's fp32 operations in their order (w * S + k * v and w * dS
// + r * dout, each product and sum rounded on its own), so every S_{t-1}
// and dS_t is the same value as a straight walk's. The workspace holds the
// two snapshot arrays, 2 B H ceil(T / G) K V floats (84 MB at [1, 4096,
// 40, 64]), and the du partials, B H K ceil(T / G).
//
// No tensor cores. The per-row sums are matrix-vector products against a
// state that changes every row; only the chunked algebra (products with
// the chunk's start state and end cotangent, dw through triangular sums of
// products of w that leave one step out, with no division since bf16
// gives w = 0 exactly) would make them matrix products. The split of the
// chains from the work comes first in either design.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kC = 8;           // rows of a phase B sub-chunk
constexpr int kRingRows = 32;   // rows of a phase A ring stage
constexpr int kStages = 3;      // phase A ring stages
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

// rows of a group: the snapshots' spacing
template <int K>
__host__ __device__ constexpr int group_rows() { return K == 128 ? 32 : 64; }

// phase A: a block of NW warps walks one chain for RW rows by BW columns
// of the state, sharing its ring: a warp RW rows by CW columns, each lane
// TR rows (lane / LC) by TC columns (lane % LC)
template <int K>
struct ChainGeo {
  static constexpr int TR = 4, TC = 2, RW = 16, LC = 32 * TR / RW, CW = LC * TC;
  static constexpr int NW = K / CW < 4 ? K / CW : 4;
  static constexpr int BW = NW * CW;
  static constexpr int BLOCKS = (K / RW) * (K / BW);   // blocks a (b, h, chain)
  static constexpr int ROW = 2 * RW + BW;   // a ring row: w, then k or r, then v or dout
};

// phase B: a block takes VS columns of a (b, h, group); a thread TR rows
// by TC columns, lanes 8 down (lane / 4) by 4 across (lane % 4), warps WR
// down by WC across
template <int K>
struct GroupGeo {
  static constexpr int VS = K == 128 ? 32 : K;
  static constexpr int NS = K / VS;         // blocks of a cluster
  static constexpr int TR = K == 16 ? 2 : 4;
  static constexpr int TC = K == 16 ? 2 : 4;
  static constexpr int WR = K / (8 * TR), WC = VS / (4 * TC);
  static constexpr int NT = 32 * WR * WC;
  static constexpr int E = TR * TC;
  static constexpr int G = group_rows<K>();
  static constexpr int NSUB = G / kC;
  static constexpr int KR = K / NS;         // rows whose dr, dk, dw and du a block writes
};

// phase A, a block's shared memory: its ring of raw rows and, for bf16,
// the current stage converted to fp32
template <typename T, int K>
__host__ __device__ constexpr size_t chain_smem() {
  constexpr int ROW = ChainGeo<K>::ROW;
  return kStages * kRingRows * ROW * sizeof(T) +
         (sizeof(T) == 4 ? 0 : kRingRows * ROW * sizeof(float));
}

template <int K>
constexpr size_t group_smem() {
  using Geo = GroupGeo<K>;
  return 5 * Geo::G * K * sizeof(float)                    // r, k, w, v, dout rows
         + (K + 2 * Geo::G) * sizeof(float)                // u, rho, sigma
         + (Geo::NSUB - 1) * Geo::E * Geo::NT * sizeof(float)   // S checkpoints
         + kC * 3 * Geo::WC * K * sizeof(float)            // warps' dr, dk, dw sums
         + kC * Geo::WR * Geo::VS * sizeof(float);         // warps' dv sums
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 16 bytes global -> shared: cp.async when the inputs start on 16 bytes,
// else element by element (a view off 16 bytes; plain loads, so the
// copy is done when it returns)
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, bool vec) {
  if (vec) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < static_cast<int>(16 / sizeof(T)); ++e) dst[e] = src[e];
  }
}

// 16 bytes from global memory: one load when the inputs start on 16 bytes,
// else element by element (a view off 16 bytes)
template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  T e[16 / sizeof(T)];
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(T)); ++i) e[i] = p[i];
  uint4 x;
  memcpy(&x, e, 16);
  return x;
}

// N consecutive fp32 values (N = 2 or a multiple of 4)
template <int N>
__device__ __forceinline__ void ld(const float* p, float* o) {
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      o[i] = x.x, o[i + 1] = x.y, o[i + 2] = x.z, o[i + 3] = x.w;
    }
  }
}
// the low and high bf16 of a 32-bit word as fp32
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// N fp32 values to global or shared memory (N = 2 or a multiple of 4)
template <int N>
__device__ __forceinline__ void st(float* p, const float* x) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

// the first N values of a[] summed with the lane that differs in bit m of
// the lane index; the lower lane keeps the sums of the first half, the
// upper lane those of the second, in a[0, N / 2). Each sum is one
// addition of two values, the same whichever lane makes it.
template <int N>
__device__ __forceinline__ void fold_half(float* a, int m, int lane) {
  const bool up = (lane & m) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float lo = a[i], hi = a[i + N / 2];
    const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, m);
    a[i] = (up ? hi : lo) + got;
  }
}
// the first N values of a[] summed with the lane that differs in bit m
template <int N>
__device__ __forceinline__ void fold_all(float* a, int m) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], m);
}

// ---- phase A: the two chains
template <typename T, int K>
__global__ void __launch_bounds__(32 * ChainGeo<K>::NW)
wkv_bwd_chains(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ w, const T* __restrict__ dout,
               const float* __restrict__ s0, const float* __restrict__ dsT,
               float* __restrict__ snap_s, float* __restrict__ snap_ds, int B, int Tn, int H,
               bool vec) {
  using Geo = ChainGeo<K>;
  constexpr int TR = Geo::TR, TC = Geo::TC, LC = Geo::LC, RW = Geo::RW, CW = Geo::CW,
                BW = Geo::BW, ROW = Geo::ROW, NT = 32 * Geo::NW;
  constexpr int G = group_rows<K>();
  constexpr int EPC = 16 / sizeof(T);   // elements of a 16-byte chunk
  constexpr int CPR = ROW / EPC;        // chunks of a ring row
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* ring = reinterpret_cast<T*>(smem);
  float* fst = reinterpret_cast<float*>(ring + kStages * kRingRows * ROW);   // bf16 only

  int id = blockIdx.x;
  const bool fwd = (id & 1) == 0;   // S forward, or dS backward
  id >>= 1;
  const int tile = id % Geo::BLOCKS, bh = id / Geo::BLOCKS;
  const int b = bh / H, h = bh % H;
  const int kb = tile / (K / BW) * RW;   // the block's first row
  const int bb = tile % (K / BW) * BW;   // and first column
  const int lr = lane / LC, lc = lane % LC;
  const int k0 = kb + lr * TR, c0 = bb + warp * CW + lc * TC;
  const int NG = (Tn + G - 1) / G;
  // walk steps: S through every group but the last; dS back through every
  // group but the first
  const int L = fwd ? (NG - 1) * G : (NG > 1 ? Tn - G : 0);
  // the ring's stages hold walk steps j = i + pad: dS's walk starts pad
  // steps into its first stage, so that every group's edge falls on a
  // stage's edge (G is a multiple of kRingRows)
  const int pad = fwd ? 0 : (kRingRows - Tn % kRingRows) % kRingRows;
  const int J = L > 0 ? L + pad : 0;
  const T* xa = w;
  const T* xb = fwd ? k : r;
  const T* xc = fwd ? v : dout;
  float* snap = fwd ? snap_s : snap_ds;
  const float* init = fwd ? s0 : dsT;

  float S[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j)
      S[i][j] = init ? init[(static_cast<int64_t>(bh) * K + k0 + i) * K + c0 + j] : 0.0f;

  auto store = [&](int g) {
    float* p = snap + ((static_cast<int64_t>(bh) * NG + g) * K + k0) * K + c0;
#pragma unroll
    for (int i = 0; i < TR; ++i) st<TC>(p + i * K, S[i]);
  };
  // the thread's 16-byte chunks of a stage: fixed places in the ring's
  // rows, and sources that move kRingRows rows a stage
  constexpr int PERT = (kRingRows * CPR + NT - 1) / NT;
  const T* src[PERT];
  int dst[PERT], rows[PERT];
#pragma unroll
  for (int p = 0; p < PERT; ++p) {
    const int x = tid + p * NT, rr = x / CPR, e = x % CPR * EPC;
    const int t = fwd ? rr : Tn - 1 - (rr - pad);   // the row of walk step rr
    const int64_t at = (static_cast<int64_t>(b) * Tn + t) * H * K + static_cast<int64_t>(h) * K;
    src[p] = e < RW ? xa + at + kb + e
             : e < 2 * RW ? xb + at + kb + e - RW : xc + at + bb + e - 2 * RW;
    dst[p] = rr * ROW + e;
    rows[p] = x < kRingRows * CPR ? rr : J;   // a slot past the stage copies nothing
  }
  const int64_t stride = (fwd ? kRingRows : -kRingRows) * static_cast<int64_t>(H) * K;
  auto load = [&](int q) {
    T* stage = ring + (q % kStages) * kRingRows * ROW;
#pragma unroll
    for (int p = 0; p < PERT; ++p) {
      const int j = q * kRingRows + rows[p];
      if (j >= pad && j < J) copy16(stage + dst[p], src[p] + q * stride, vec);
    }
  };

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    load(q);
    cp_async_commit();
  }
  if (!fwd) store(NG - 1);   // dS_T, the last group's end
  const int nq = (J + kRingRows - 1) / kRingRows;
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage q landed for every thread; stage q - 1 read by every thread
    load(q + kStages - 1);
    cp_async_commit();
    const T* raw = ring + (q % kStages) * kRingRows * ROW;
    const float* stage;   // the stage's rows in fp32
    if constexpr (kBf16) {
      // converted once here, not by each lane that reads a value
      for (int x = tid; x < kRingRows * ROW / 8; x += NT) {
        const uint4 c = reinterpret_cast<const uint4*>(raw)[x];
        float4* d = reinterpret_cast<float4*>(fst) + 2 * x;
        d[0] = make_float4(bf16_lo(c.x), bf16_hi(c.x), bf16_lo(c.y), bf16_hi(c.y));
        d[1] = make_float4(bf16_lo(c.z), bf16_hi(c.z), bf16_lo(c.w), bf16_hi(c.w));
      }
      __syncthreads();
      stage = fst;
    } else {
      stage = reinterpret_cast<const float*>(raw);
    }
    const int j0 = q * kRingRows, i0 = j0 - pad;
    // a snapshot falls only on a stage's first row: S at a group's first
    // row, dS at a group's last
    if (i0 > 0 || (fwd && i0 == 0)) {
      if (fwd ? i0 % G == 0 : (Tn - i0) % G == 0) store((fwd ? i0 : Tn - 1 - i0) / G);
    }
    auto step = [&](int rr) {
      const float* row = stage + rr * ROW;
      float a[TR], x[TR], c[TC];
      ld<TR>(row + lr * TR, a);
      ld<TR>(row + RW + lr * TR, x);
      ld<TC>(row + 2 * RW + c0 - bb, c);
#pragma unroll
      for (int ii = 0; ii < TR; ++ii)
#pragma unroll
        for (int jj = 0; jj < TC; ++jj)
          S[ii][jj] = __fadd_rn(__fmul_rn(a[ii], S[ii][jj]), __fmul_rn(x[ii], c[jj]));
    };
    const int lo = max(pad - j0, 0), hi = min(kRingRows, J - j0);
    if (lo == 0 && hi == kRingRows) {
#pragma unroll
      for (int rr = 0; rr < kRingRows; ++rr) step(rr);   // no branch between the steps
    } else {
      for (int rr = lo; rr < hi; ++rr) step(rr);
    }
  }
  store(fwd ? NG - 1 : 0);   // S at the last group's start, dS at the first's end
}

// the warps' (and at K = 128 the cluster's) sums meet: a barrier of the
// block, or of the cluster
template <int NS>
__device__ __forceinline__ void unit_sync() {
  if constexpr (NS > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// ---- phase B: the groups
template <typename T, int K>
__global__ void __launch_bounds__(GroupGeo<K>::NT, 1)
wkv_bwd_groups(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ w, const float* __restrict__ u,
               const T* __restrict__ dout, const float* __restrict__ snap_s,
               const float* __restrict__ snap_ds, T* __restrict__ dr, T* __restrict__ dk,
               T* __restrict__ dv, T* __restrict__ dw, float* __restrict__ ds0,
               float* __restrict__ du_part, int B, int Tn, int H, bool vec) {
  using Geo = GroupGeo<K>;
  constexpr int VS = Geo::VS, NS = Geo::NS, TR = Geo::TR, TC = Geo::TC, WR = Geo::WR,
                WC = Geo::WC, NT = Geo::NT, E = Geo::E, G = Geo::G, NSUB = Geo::NSUB,
                KR = Geo::KR;
  constexpr int EPC = 16 / sizeof(T);   // elements of a 16-byte chunk
  constexpr int CH = K / EPC;           // chunks of a row of one input
  constexpr int PER = 5 * G * CH / NT;  // chunks a thread loads
  static_assert(5 * G * CH % NT == 0, "the group's rows split evenly over the threads");
  extern __shared__ __align__(16) unsigned char smem[];
  float* sin = reinterpret_cast<float*>(smem);    // [5][G][K]: r, k, w, v, dout in fp32
  float* su = sin + 5 * G * K;                    // [K]
  float* srho = su + K;                           // [G]
  float* ssig = srho + G;                         // [G]
  float4* sck = reinterpret_cast<float4*>(ssig + G);        // [NSUB - 1][E / 4][NT]
  float* rowbuf = reinterpret_cast<float*>(sck + (NSUB - 1) * (E / 4) * NT);  // [kC][3][WC][K]
  float* dvbuf = rowbuf + kC * 3 * WC * K;        // [kC][WR][VS]

  const int NG = (Tn + G - 1) / G;
  int id = blockIdx.x;
  const int s = id % NS;   // the block's rank in its cluster
  id /= NS;
  const int g = id % NG, bh = id / NG;
  const int b = bh / H, h = bh % H;
  const int t0 = g * G, n = min(G, Tn - t0), nsc = (n + kC - 1) / kC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % WR, wc = warp / WR, lr = lane >> 2, lc = lane & 3;
  const int k0 = (wr * 8 + lr) * TR;          // the thread's first row
  const int cl = (wc * 4 + lc) * TC;          // its first column in the block's slice
  const int c0 = s * VS + cl;                 // and in the state
  auto at = [&](int t) -> int64_t {           // element (b, t, h, 0) of an input
    return (static_cast<int64_t>(b) * Tn + t) * H * K + static_cast<int64_t>(h) * K;
  };

  // the group's rows in fp32: every thread's loads issued before its
  // first store
  {
    uint4 raw[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int x = tid + i * NT, a = x / (G * CH), tl = x / CH % G, e = x % CH * EPC;
      const T* src = (a == 0 ? r : a == 1 ? k : a == 2 ? w : a == 3 ? v : dout) + at(t0 + tl) + e;
      raw[i] = tl < n ? ld16(src, vec) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int x = tid + i * NT;
      float4* d = reinterpret_cast<float4*>(sin + x * EPC);
      if constexpr (EPC == 4) {
        d[0] = make_float4(__uint_as_float(raw[i].x), __uint_as_float(raw[i].y),
                           __uint_as_float(raw[i].z), __uint_as_float(raw[i].w));
      } else {
        d[0] = make_float4(bf16_lo(raw[i].x), bf16_hi(raw[i].x), bf16_lo(raw[i].y),
                           bf16_hi(raw[i].y));
        d[1] = make_float4(bf16_lo(raw[i].z), bf16_hi(raw[i].z), bf16_lo(raw[i].w),
                           bf16_hi(raw[i].w));
      }
    }
  }
  for (int i = tid; i < K; i += NT) su[i] = u[static_cast<int64_t>(h) * K + i];

  float S[TR][TC], dS[TR][TC];
  {
    const int64_t o = ((static_cast<int64_t>(bh) * NG + g) * K + k0) * K + c0;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      ld<TC>(snap_s + o + i * K, S[i]);
      ld<TC>(snap_ds + o + i * K, dS[i]);
    }
  }
  auto row = [&](int a, int tl) { return sin + (a * G + tl) * K; };
  auto step_s = [&](int tl) {   // S <- diag(w) S + k v^T for row tl
    float wv[TR], kv[TR], vv[TC];
    ld<TR>(row(2, tl) + k0, wv);
    ld<TR>(row(1, tl) + k0, kv);
    ld<TC>(row(3, tl) + c0, vv);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j)
        S[i][j] = __fadd_rn(__fmul_rn(wv[i], S[i][j]), __fmul_rn(kv[i], vv[j]));
  };
  auto ck = [&](int slot, int q) -> float4& { return sck[(slot * (E / 4) + q) * NT + tid]; };
  auto el = [&](int e) -> float& { return S[e / TC][e % TC]; };   // the thread's e-th element

  __syncthreads();
  // S at the start of every sub-chunk but the last
  for (int sc = 0; sc + 1 < nsc; ++sc) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      ck(sc, q) = make_float4(el(4 * q), el(4 * q + 1), el(4 * q + 2), el(4 * q + 3));
#pragma unroll 2
    for (int j = 0; j < kC; ++j) step_s(sc * kC + j);
  }
  // rho_t = v . dout and sigma_t = sum_k u r k, a warp a row
  for (int tl = warp; tl < n; tl += NT / 32) {
    float a[2] = {0.0f, 0.0f};
    for (int i = lane; i < K; i += 32) {
      a[0] += row(3, tl)[i] * row(4, tl)[i];
      a[1] += su[i] * (row(0, tl)[i] * row(1, tl)[i]);
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) fold_all<2>(a, m);
    if (lane == 0) srho[tl] = a[0], ssig[tl] = a[1];
  }
  __syncthreads();

  for (int sc = nsc - 1; sc >= 0; --sc) {
    if (sc + 1 < nsc) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const float4 x = ck(sc, q);
        el(4 * q) = x.x, el(4 * q + 1) = x.y, el(4 * q + 2) = x.z, el(4 * q + 3) = x.w;
      }
    }
    const int nj = min(kC, n - sc * kC);
    // the walks through the sub-chunk; a full one (every sub-chunk but
    // maybe the last group's last) runs with no branch between its rows
    auto walk = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      // S_{t-1} of the sub-chunk's rows
      float sp[kC][TR][TC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        if (FULL || j < nj) {
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int c = 0; c < TC; ++c) sp[j][i][c] = S[i][c];
          if (j + 1 < (FULL ? kC : nj)) step_s(sc * kC + j);
        }
      }
      // dS back through the sub-chunk; each row's partial sums
#pragma unroll
      for (int j = kC - 1; j >= 0; --j) {
        if (FULL || j < nj) {
          const int tl = sc * kC + j;
          float rv[TR], kv[TR], wv[TR], vv[TC], dd[TC];
          ld<TR>(row(0, tl) + k0, rv);
          ld<TR>(row(1, tl) + k0, kv);
          ld<TR>(row(2, tl) + k0, wv);
          ld<TC>(row(3, tl) + c0, vv);
          ld<TC>(row(4, tl) + c0, dd);
          float pa[3 * TR], pv[TC];   // dr, dk, dw of the rows; dv of the columns
#pragma unroll
          for (int i = 0; i < 3 * TR; ++i) pa[i] = 0.0f;
#pragma unroll
          for (int c = 0; c < TC; ++c) pv[c] = 0.0f;
#pragma unroll
          for (int i = 0; i < TR; ++i) {
#pragma unroll
            for (int c = 0; c < TC; ++c) {
              const float sx = sp[j][i][c], dx = dS[i][c];
              pa[i] += sx * dd[c];
              pa[TR + i] += dx * vv[c];
              pa[2 * TR + i] += dx * sx;
              pv[c] += dx * kv[i];
              dS[i][c] = __fadd_rn(__fmul_rn(wv[i], dx), __fmul_rn(rv[i], dd[c]));
            }
          }
          // the row sums over the warp's 4 column lanes (lane bits 0, 1)
          int base;
          bool writer;
          fold_half<3 * TR>(pa, 1, lane);
          if constexpr (TR == 4) {
            fold_half<6>(pa, 2, lane);   // 3 values a lane
            base = (lc & 1) * 6 + (lc >> 1) * 3;
            writer = true;
          } else {
            fold_all<3>(pa, 2);
            base = (lc & 1) * 3;
            writer = (lc & 2) == 0;
          }
          if (writer) {
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const int x = base + i, q = x / TR, rr = x % TR;
              rowbuf[((j * 3 + q) * WC + wc) * K + k0 + rr] = pa[i];
            }
          }
          // the column sums over the warp's 8 row lanes (lane bits 2, 3, 4)
          fold_half<TC>(pv, 16, lane);
          if constexpr (TC == 4) {
            fold_half<2>(pv, 8, lane);
            fold_all<1>(pv, 4);
            base = ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
            writer = (lane & 4) == 0;
          } else {
            fold_all<1>(pv, 8);
            fold_all<1>(pv, 4);
            base = (lane >> 4) & 1;
            writer = (lane & 12) == 0;
          }
          if (writer) dvbuf[(j * WR + wr) * VS + cl + base] = pv[0];
        }
      }
    };
    if (nj == kC) {
      walk(std::true_type{});
    } else {
      walk(std::false_type{});
    }
    unit_sync<NS>();
    // the sub-chunk's outputs: the warps' sums in order, the cluster's in
    // rank order, then the bonus terms
    for (int x = tid; x < nj * KR; x += NT) {
      const int j = x / KR, kq = s * KR + x % KR, tl = sc * kC + j;
      float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s2 = 0; s2 < NS; ++s2) {
        const float* buf = rowbuf;
        if constexpr (NS > 1) buf = cg::this_cluster().map_shared_rank(rowbuf, s2);
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int c = 0; c < WC; ++c) acc[q] += buf[((j * 3 + q) * WC + c) * K + kq];
      }
      const float uq = su[kq], rho = srho[tl];
      const int64_t o = at(t0 + tl) + kq;
      dr[o] = from_f32<T>(acc[0] + uq * (row(1, tl)[kq] * rho));
      dk[o] = from_f32<T>(acc[1] + uq * (row(0, tl)[kq] * rho));
      dw[o] = from_f32<T>(acc[2]);
    }
    for (int x = tid; x < nj * VS; x += NT) {
      const int j = x / VS, c = x % VS, tl = sc * kC + j;
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < WR; ++q) acc += dvbuf[(j * WR + q) * VS + c];
      dv[at(t0 + tl) + s * VS + c] =
          from_f32<T>(acc + row(4, tl)[s * VS + c] * ssig[tl]);
    }
    unit_sync<NS>();   // the buffers are free for the next sub-chunk
  }
  if (g == 0 && ds0) {
    float* p = ds0 + (static_cast<int64_t>(bh) * K + k0) * K + c0;
#pragma unroll
    for (int i = 0; i < TR; ++i) st<TC>(p + i * K, dS[i]);
  }
  // du's partial of (b, group, h) for the block's rows, in row order
  for (int x = tid; x < KR; x += NT) {
    const int kq = s * KR + x;
    float acc = 0.0f;
    for (int tl = 0; tl < n; ++tl)
      acc += (row(0, tl)[kq] * row(1, tl)[kq]) * srho[tl];
    du_part[((static_cast<int64_t>(b) * NG + g) * H + h) * K + kq] = acc;
  }
}

// du [H, K]: the partials [B, groups, H, K] summed in group order, then
// batch order
__global__ void __launch_bounds__(256)
wkv_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B, int NG,
                  int HK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HK) return;
  float acc = 0.0f;
  for (int bb = 0; bb < B; ++bb) {
    float ab = 0.0f;
    for (int g = 0; g < NG; ++g) ab += du_part[(static_cast<int64_t>(bb) * NG + g) * HK + i];
    acc += ab;
  }
  du[i] = acc;
}

template <int K>
int64_t workspace_floats(int B, int T, int H) {
  const int64_t groups = (T + group_rows<K>() - 1) / group_rows<K>();
  const int64_t bh = static_cast<int64_t>(B) * H;
  return 2 * bh * groups * K * K   // S and dS snapshots
         + bh * groups * K;        // du partials
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           const float* s0, const void* dout, const float* dsT, void* dr, void* dk,
           void* dv, void* dw, float* du, float* ds0, float* ws, int B, int Tn, int H,
           cudaStream_t stream) {
  using Geo = GroupGeo<K>;
  const int64_t NG = (Tn + Geo::G - 1) / Geo::G;
  const int64_t bh = static_cast<int64_t>(B) * H;
  const int64_t chain_blocks = 2 * bh * ChainGeo<K>::BLOCKS;
  const int64_t group_blocks = Geo::NS * NG * bh;
  if (chain_blocks > 2147483647LL || group_blocks > 2147483647LL ||
      static_cast<int64_t>(H) * K > 2147483647LL)
    return kErrShape;
  float* snap_s = ws;
  float* snap_ds = snap_s + bh * NG * K * K;
  float* du_part = snap_ds + bh * NG * K * K;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  const T* dt = static_cast<const T*>(dout);
  auto on16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = on16(r) && on16(k) && on16(v) && on16(w) && on16(dout);

  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_chains<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(chain_smem<T, K>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_chains<T, K><<<static_cast<unsigned>(chain_blocks), 32 * ChainGeo<K>::NW,
                         chain_smem<T, K>(), stream>>>(rt, kt, vt, wt, dt, s0, dsT, snap_s,
                                                       snap_ds, B, Tn, H, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem = group_smem<K>();
  err = cudaFuncSetAttribute(wkv_bwd_groups<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  T* drt = static_cast<T*>(dr);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  T* dwt = static_cast<T*>(dw);
  if constexpr (Geo::NS > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(group_blocks));
    cfg.blockDim = dim3(Geo::NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Geo::NS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, wkv_bwd_groups<T, K>, rt, kt, vt, wt, u, dt,
                             static_cast<const float*>(snap_s),
                             static_cast<const float*>(snap_ds), drt, dkt, dvt, dwt, ds0,
                             du_part, B, Tn, H, vec);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    wkv_bwd_groups<T, K><<<static_cast<unsigned>(group_blocks), Geo::NT, smem, stream>>>(
        rt, kt, vt, wt, u, dt, snap_s, snap_ds, drt, dkt, dvt, dwt, ds0, du_part, B, Tn, H,
        vec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int hk = H * K;
  wkv_bwd_du_kernel<<<(hk + 255) / 256, 256, 0, stream>>>(du_part, du, B,
                                                          static_cast<int>(NG), hk);
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

// Workspace floats the C entry needs in ``ws`` for r [B, T, H, K]: the S
// and dS snapshots at the groups' edges and du's partials; -1 for a K the
// kernel does not take.
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
