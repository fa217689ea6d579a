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
// NEG_INF = -1e30 and holes read page 0 (a page id is clamped to P - 1),
// so a row with no valid slot averages V over all mp * page gathered rows,
// exactly as the plain version does. The int8 form multiplies each code by
// its page's scale in registers (scores: (q . codes) * (k_scale * D^-0.5);
// weights: p * v_scale), fp32 math, fp32 q and out; bf16 loads bf16,
// computes in fp32 and writes bf16.
//
// What bounds it on the card: bytes, by the count of PERF.md's bound (the
// K and V rows of the tokens below each row's length). A live token costs
// 4 * group * D flops against 2 * D stored K/V elements (2.5 flops a byte
// in fp32), far below the H100's balance. The serving engine's step
// (qwen3-14b's width: q [640, 40, 128], pools [384, 16, 8, 128], 32
// steps) hands it short rows: 640 rows of which 359 (fp32) or 512 (int8)
// have length 0 and the rest one page of at most 16 tokens; the 13.1 MB
// out write is 31 % (fp32) and 70 % (int8) of the bound's bytes. At these
// inputs the time is set by the launch over 1280 blocks (a fill's fixed
// cost is about 5 us) and the instructions of the live rows more than by
// the bytes (PERF.md, section 6).
//
// Design. The unit of work is (row b, KV head, slice of up to kHeads = 8
// query heads of its group, 128-dim block of the output); a unit is run by
// nw warps (1, 2 or 4; the host picks 1 when the units fill the card twice
// over, as on the engine's step with 5120 units, and splits a unit's tokens
// over 2 or 4 warps when there are few units, as for a handful of long
// rows: on 8 to 40 rows of 16 full pages, 4 warps take 0.3 to 0.54 of one
// warp's time, PERF.md). Blocks are 4 warps: 4 / nw units, consecutive KV
// heads of a row, whose K rows of a token lie side by side in the pool; 3
// blocks per SM (at most 168 registers, none spilled). Chosen over a block
// per row with a warp per KV head because that ties the block's size to KV
// (1 to 64 warps), and over a block per (row, KV head) with fixed token
// warps because on the engine's short rows it would leave 3 of 4 warps
// idle and cut the units in flight by 4.
// - Rows with a valid slot: lane 4h + j holds head h of the slice and
//   segment j (32 dims) of the 128-dim block: q and acc in registers (8 +
//   8 float4), so a score is the lane's 32-dim product and two shuffles,
//   and the online softmax (m, l, acc) runs in the head's 4 lanes with no
//   exchange. A warp walks its share of the row's tokens (chunks of tc
//   tokens, chunk c to warp c mod nw) through a private 2-stage ring in
//   shared memory: the next chunk's K rows and V block are in flight
//   (cp.async, 16-byte copies) before the current chunk is computed; tc is
//   what fits 4 KB of K + V (4 tokens fp32, 8 bf16, 16 int8 at D = 128:
//   a 16-token int8 page is one stage), 32 KB a block in every form. No
//   block-wide barrier per chunk: only the warp's own __syncwarp around
//   its ring slots. Tokens go in groups of 4: four independent products,
//   one rescale of acc; the ring starts zeroed, so a hole, a slot past
//   the length or the padding past D reads 0 and gets weight 0 (exactly
//   what exp(NEG_INF - m) gives once a slot is valid) without a branch.
//   Shared memory is read in 16-byte units, a segment's unit u at slot (u
//   + j) % units, so the 4 segments' reads of a row fall in distinct
//   banks. At the end one warp writes out = acc / max(l, 1e-30) from its
//   registers; nw warps put m, l and acc in shared memory and merge them in
//   warp order 0 .. nw - 1 (one barrier).
// - Rows with no valid slot (every length-0 engine slot): no q, no K. The
//   warps split the mp columns (column j to warp j mod nw); per column
//   the lanes sum the page's V rows with 16-byte loads, rows_per_pass
//   rows at once (lanes = row slot x 16-byte chunk), rows in order; a
//   column whose clamped page id equals the warp's previous column's
//   reuses that column's sum, which is bit for bit what reading it again
//   gives (an all-hole table reads page 0 once, not mp times). The row
//   slots are summed by a fixed halving tree, the warps in warp order, and
//   the mean written to every head of the unit. A repeated call gives the
//   same bits: every sum has a fixed order, and nothing is atomic.
// - Any D, page size and mp: D is cut into 128-dim output blocks (one unit
//   each; the scores of a block need all of D, so K is staged whole and q
//   is reloaded per block for D > 128, the only case that reloads it).
//   The copy width VB (16, 8, 4, 2 or 1 bytes) is a template parameter,
//   the widest that the pool pointers and the row pitch D * sizeof allow.
//   Shared memory is 2 stages of tc tokens per warp, at most 33 KB a warp
//   (D = 4096 fp32, tc = 1), whatever the page size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 8;                // query heads per unit: 4 lanes each
constexpr int kBlockDims = 128;          // output dims per unit: 32 per lane
constexpr int kStageBytes = 4096;        // K + V bytes a ring stage holds
constexpr int kMaxTc = 32;               // tokens per stage: one per lane at most
constexpr int kMaxGroupDims = 4096;      // group * D, the C entry's limit
constexpr int kWarpsPerSm = 12;          // warps in flight per SM: at most 168 registers
constexpr int kUnitsPerSm = 2 * kWarpsPerSm;  // unit warps per SM beyond which nw = 1
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

struct Params {
  const void* q;
  const unsigned char* k;
  const unsigned char* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* lengths;
  void* out;
  int H, KV, D, P, page, mp;
  float scale;
  int group, n_hs, n_db, units, nw, tc;
  int k_pitch, v_pitch, warp_bytes;  // shared-memory row pitches and region, bytes
  int q_vec;                         // q rows allow one vector load per quad
  int o_vec;                         // out rows allow one vector store per quad
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 4 / sizeof(T) values of a 32-bit word (bf16 -> fp32 and int8 -> fp32
// are exact)
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* x) {
  if constexpr (std::is_same<T, float>::value) {
    x[0] = __uint_as_float(w);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
  }
}

// load VB bytes (VB / sizeof(T) values) from global memory as fp32
template <typename T, int VB>
__device__ __forceinline__ void load_vals(const unsigned char* src, float* x) {
  constexpr int kPer = 4 / sizeof(T) > 0 ? 4 / sizeof(T) : 1;
  if constexpr (VB == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
    unpack<T>(u.x, x);
    unpack<T>(u.y, x + kPer);
    unpack<T>(u.z, x + 2 * kPer);
    unpack<T>(u.w, x + 3 * kPer);
  } else if constexpr (VB == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    unpack<T>(u.x, x);
    unpack<T>(u.y, x + kPer);
  } else if constexpr (VB == 4) {
    unpack<T>(__ldg(reinterpret_cast<const unsigned int*>(src)), x);
  } else if constexpr (VB == 2) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned short*>(src));
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      x[0] = __uint_as_float(w << 16);
    } else {
      x[0] = static_cast<float>(static_cast<int>(w << 24) >> 24);
      x[1] = static_cast<float>(static_cast<int>(w << 16) >> 24);
    }
  } else {
    x[0] = static_cast<float>(static_cast<int8_t>(__ldg(reinterpret_cast<const char*>(src))));
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy VB bytes global -> shared: cp.async for 16, 8 and 4 bytes, a plain
// load and store for the 2- and 1-byte widths of odd views
template <int VB>
__device__ __forceinline__ void copy(void* dst, const unsigned char* src) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else if constexpr (VB == 8 || VB == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(VB) : "memory");
  } else if constexpr (VB == 2) {
    *static_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  } else {
    *static_cast<uint8_t*>(dst) = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the unit's warps meet: named barrier 1 + (unit within the block), or the
// warp alone
__device__ __forceinline__ void unit_sync(int unit_in_block, int nw) {
  if (nw == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + unit_in_block), "r"(32 * nw) : "memory");
  }
}

// a ring slot's tokens: lane tt < tc holds token tt's pool row (page id *
// page + slot; -1 for a hole or a slot past the length) and, int8, its
// page's scales
struct Tokens {
  int prow;
  float ks, vs;
};

// q of head hl of the unit's slice for the lane's segment j (32 dims) of the
// 128-dim block at dim dblk, in the order the segment is read from shared
// memory: 16-byte units of kEL = 16 / sizeof(KV_T) values, unit u at slot
// (u + j) % kNL; register r holds quad r % kQL of the unit in slot r / kQL
template <typename KV_T, typename Q_T>
__device__ __forceinline__ void load_q(const Params& p, const Q_T* qrow, bool has_head,
                                       int dblk, int j, float4 (&q)[8]) {
  constexpr int kEL = 16 / sizeof(KV_T), kQL = kEL / 4, kNL = 8 / kQL;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int d = dblk + 32 * j + kEL * ((r / kQL + j) % kNL) + 4 * (r % kQL);
    const int n = p.D - d;  // dims of this quad that exist
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (has_head && n > 0) {
      const Q_T* src = qrow + d;
      if (p.q_vec) {
        if constexpr (std::is_same<Q_T, float>::value) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src));
          x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
        } else {
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
          unpack<Q_T>(u.x, x);
          unpack<Q_T>(u.y, x + 2);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < n) {
            if constexpr (std::is_same<Q_T, float>::value) x[e] = __ldg(src + e);
            else x[e] = __bfloat162float(src[e]);
          }
        }
      }
    }
    q[r] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// a 16-byte unit of a shared-memory row: 16 / sizeof(T) values as fp32
template <typename T>
__device__ __forceinline__ void smem_unit(const unsigned char* p, float4* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<T, float>::value) {
    x[0] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                       __uint_as_float(u.w));
  } else {
    constexpr int kPer = 4 / sizeof(T);  // values per word
    float v[16 / sizeof(T)];
    unpack<T>(u.x, v);
    unpack<T>(u.y, v + kPer);
    unpack<T>(u.z, v + 2 * kPer);
    unpack<T>(u.w, v + 3 * kPer);
#pragma unroll
    for (int i = 0; i < 4 / static_cast<int>(sizeof(T)); ++i)
      x[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// store n values of x (n <= 4: a quad; vec: one 16- or 8-byte store)
template <typename Q_T>
__device__ __forceinline__ void store_quad(Q_T* dst, float4 x, int n, bool vec) {
  if (vec && n == 4) {
    if constexpr (std::is_same<Q_T, float>::value) {
      *reinterpret_cast<float4*>(dst) = x;
    } else {
      const __nv_bfloat16 b[4] = {__float2bfloat16(x.x), __float2bfloat16(x.y),
                                  __float2bfloat16(x.z), __float2bfloat16(x.w)};
      uint2 u;
      u.x = static_cast<uint32_t>(reinterpret_cast<const uint16_t&>(b[0])) |
            static_cast<uint32_t>(reinterpret_cast<const uint16_t&>(b[1])) << 16;
      u.y = static_cast<uint32_t>(reinterpret_cast<const uint16_t&>(b[2])) |
            static_cast<uint32_t>(reinterpret_cast<const uint16_t&>(b[3])) << 16;
      *reinterpret_cast<uint2*>(dst) = u;
    }
  } else {
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) dst[i] = from_f32<Q_T>(v[i]);
  }
}

// KV_T: storage type of the pool (float, __nv_bfloat16, int8_t); Q_T: type
// of q and out (float for the int8 pool); VB: copy width in bytes.
template <typename KV_T, typename Q_T, int VB>
__global__ void __launch_bounds__(kThreads, kWarpsPerSm / kWarps)
paged_decode_kernel(const Params p) {
  constexpr bool kQuant = std::is_same<KV_T, int8_t>::value;
  constexpr int kSz = sizeof(KV_T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int unit = gw / p.nw;
  if (unit >= p.units) return;  // a unit's warps share a block: all return
  const int w = gw - unit * p.nw;             // warp within the unit
  const int uib = warp / p.nw;                // unit within the block
  unsigned char* my = smem + warp * p.warp_bytes;
  const unsigned char* unit_smem = smem + uib * p.nw * p.warp_bytes;

  int r = unit;
  const int ob = r % p.n_db;
  r /= p.n_db;
  const int hs = r % p.n_hs;
  r /= p.n_hs;
  const int kvh = r % p.KV;
  const int b = r / p.KV;
  const int head0 = kvh * p.group + hs * kHeads;
  const int nh = min(kHeads, p.group - hs * kHeads);
  const int d0 = ob * kBlockDims;
  const int nd = min(kBlockDims, p.D - d0);  // output dims of this unit
  const size_t tok_stride = static_cast<size_t>(p.KV) * p.D * kSz;  // bytes per pool row
  const size_t head_off = static_cast<size_t>(kvh) * p.D * kSz;
  Q_T* out = static_cast<Q_T*>(p.out) + (static_cast<size_t>(b) * p.H + head0) * p.D + d0;

  // the length and the table's first 32 columns, loaded together; lane j
  // keeps column j
  const int* row = p.table + static_cast<size_t>(b) * p.mp;
  const int tcol = lane < p.mp ? __ldg(row + lane) : -1;
  const int len = max(__ldg(p.lengths + b), 0);
  const int live = min(p.mp, len / p.page + (len % p.page != 0));
  bool mapped = lane < live && tcol >= 0;
  for (int j = 32 + lane; j < live; j += 32) mapped |= __ldg(row + j) >= 0;
  float* merge = reinterpret_cast<float*>(my);  // [kHeads][128] acc, m, l (or 128 sums)

  if (__any_sync(kFull, mapped)) {
    // ---- a row with a valid slot: this warp's chunks of tc tokens
    const int n_tok = min(len, p.mp * p.page);
    const int tc = p.tc;
    const int n_chunks = (n_tok + tc - 1) / tc;
    const int mine = w < n_chunks ? (n_chunks - w + p.nw - 1) / p.nw : 0;
    const int crk = p.D * kSz / VB;   // copies per K row (all of D)
    const int crv = nd * kSz / VB;    // copies per V row (this unit's block)
    const int per_tok = crk + crv;
    const int slot_bytes = tc * (p.k_pitch + p.v_pitch);
    // this lane's first copy (token tt0, copy rr0) and the step of 32 copies
    const int tt0 = lane / per_tok, rr0 = lane - tt0 * per_tok;
    const int dtt = 32 / per_tok, drr = 32 - dtt * per_tok;

    // issue chunk k of this warp into ring slot k & 1 (an empty group past
    // the warp's last chunk keeps the wait counts uniform)
    auto issue = [&](int k) -> Tokens {
      Tokens t{-1, 1.f, 1.f};
      if (k < mine) {
        const int i = (w + k * p.nw) * tc + lane;   // lane tt < tc: token i
        const int j = lane < tc && i < n_tok ? i / p.page : 0;
        int pid = __shfl_sync(kFull, tcol, j & 31);
        if (j >= 32) pid = __ldg(row + j);
        if (lane < tc && i < n_tok && pid >= 0) {
          const int safe = min(pid, p.P - 1);
          t.prow = safe * p.page + (i - j * p.page);
          if constexpr (kQuant) {
            t.ks = __ldg(p.k_scale + safe);
            t.vs = __ldg(p.v_scale + safe);
          }
        }
        unsigned char* ks_dst = my + (k & 1) * slot_bytes;
        unsigned char* vs_dst = ks_dst + tc * p.k_pitch;
        const int total = tc * per_tok;
        int tt = tt0, rr = rr0;
        for (int base = 0; base < total; base += 32) {
          const int prow = __shfl_sync(kFull, t.prow, min(tt, tc - 1));
          if (base + lane < total && prow >= 0) {
            const unsigned char* src = p.k + prow * tok_stride + head_off;
            if (rr < crk) {
              copy<VB>(ks_dst + tt * p.k_pitch + rr * VB, src + rr * VB);
            } else {
              const int cv = rr - crk;
              copy<VB>(vs_dst + tt * p.v_pitch + cv * VB,
                       p.v + prow * tok_stride + head_off +
                           static_cast<size_t>(d0) * kSz + cv * VB);
            }
          }
          tt += dtt;
          rr += drr;
          if (rr >= per_tok) {
            rr -= per_tok;
            ++tt;
          }
        }
      }
      cp_async_commit();
      return t;
    };

    // the ring starts zeroed: rows that no copy fills (holes, slots past the
    // length, the padding past D) read as 0, and a row refilled later
    // holds finite values, so a group's 4 tokens run without branches
    for (int e = 16 * lane; e < 2 * slot_bytes; e += 16 * 32)
      *reinterpret_cast<uint4*>(my + e) = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
    Tokens cur = issue(0);
    Tokens nxt = issue(1);
    // lanes: head hl = lane / 4 of the unit's slice, segment j = lane % 4 of
    // the 128-dim block (32 dims, kNL 16-byte units); unit u of a segment
    // is read at slot (u + j) % kNL, so the 4 segments' reads of a row fall
    // in distinct banks
    constexpr int kEL = 16 / kSz, kQL = kEL / 4, kNL = 8 / kQL;
    const int hl = lane >> 2, j = lane & 3;
    const bool has_head = hl < nh;
    const Q_T* qrow = static_cast<const Q_T*>(p.q) +
                      (static_cast<size_t>(b) * p.H + head0 + (has_head ? hl : 0)) * p.D;
    float4 q[8], acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.n_db == 1) load_q<KV_T, Q_T>(p, qrow, has_head, 0, j, q);
    float m_run = kNegInf, l_run = 0.f;  // this head's online softmax
    for (int k = 0; k < mine; ++k) {
      cp_async_wait<1>();
      __syncwarp();
      const unsigned char* kslot = my + (k & 1) * slot_bytes;
      const unsigned char* vslot = kslot + tc * p.k_pitch;
      for (int g0 = 0; g0 < tc; g0 += 4) {
        // the group's 4 tokens (uniform): pool row (-1: none), scales; a
        // token past the chunk reads the chunk's last row, weight 0
        bool ok[4];
        int rw[4];
        float f[4], vsc[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int src = __shfl_sync(kFull, cur.prow, (g0 + t) & 31);
          ok[t] = g0 + t < tc && src >= 0;
          rw[t] = min(g0 + t, tc - 1);
          f[t] = p.scale;
          vsc[t] = 1.f;
          if constexpr (kQuant) {
            f[t] = __shfl_sync(kFull, cur.ks, (g0 + t) & 31) * p.scale;
            vsc[t] = __shfl_sync(kFull, cur.vs, (g0 + t) & 31);
          }
        }
        if (!(ok[0] || ok[1] || ok[2] || ok[3])) continue;
        // scores: the lane's 32-dim partial of each token (two chains), then
        // the head's 4 lanes
        float s0[4], s1[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) s0[t] = s1[t] = 0.f;
        for (int db = 0; db < p.n_db; ++db) {
          if (p.n_db > 1) load_q<KV_T, Q_T>(p, qrow, has_head, db * kBlockDims, j, q);
#pragma unroll
          for (int u = 0; u < kNL; ++u) {
            const int d = db * kBlockDims + 32 * j + kEL * ((u + j) % kNL);
            if (d < p.D) {
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                float4 kq[kQL];
                smem_unit<KV_T>(kslot + rw[t] * p.k_pitch + d * kSz, kq);
#pragma unroll
                for (int c = 0; c < kQL; ++c) {
                  if ((u * kQL + c) & 1) s1[t] = dot4(q[u * kQL + c], kq[c], s1[t]);
                  else s0[t] = dot4(q[u * kQL + c], kq[c], s0[t]);
                }
              }
            }
          }
        }
        float sc[4], mx = kNegInf;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float x = s0[t] + s1[t];
          x += __shfl_xor_sync(kFull, x, 1);
          x += __shfl_xor_sync(kFull, x, 2);
          sc[t] = ok[t] ? x * f[t] : kNegInf;
          mx = fmaxf(mx, sc[t]);
        }
        const float mn = fmaxf(m_run, mx);
        const float alpha = __expf(m_run - mn);
        float pw[4], ps = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          pw[t] = ok[t] ? __expf(sc[t] - mn) : 0.f;
          ps += pw[t];
          pw[t] *= vsc[t];
        }
        l_run = l_run * alpha + ps;
        m_run = mn;
        // acc = acc * alpha + sum over the group's tokens of p * V
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
        }
#pragma unroll
        for (int u = 0; u < kNL; ++u) {
          const int d = 32 * j + kEL * ((u + j) % kNL);
          if (d < nd) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              float4 vq[kQL];
              smem_unit<KV_T>(vslot + rw[t] * p.v_pitch + d * kSz, vq);
#pragma unroll
              for (int c = 0; c < kQL; ++c) {
                float4& x = acc[u * kQL + c];
                x.x = fmaf(pw[t], vq[c].x, x.x);
                x.y = fmaf(pw[t], vq[c].y, x.y);
                x.z = fmaf(pw[t], vq[c].z, x.z);
                x.w = fmaf(pw[t], vq[c].w, x.w);
              }
            }
          }
        }
      }
      __syncwarp();  // every lane is done with the slot before it is refilled
      const Tokens nn = issue(k + 2);
      cur = nxt;
      nxt = nn;
    }
    cp_async_wait<0>();
    __syncwarp();
    if (p.nw == 1) {
      // one warp: out = acc / max(l, 1e-30) straight from the registers
      if (has_head) {
        const float lh = fmaxf(l_run, 1e-30f);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int d = 32 * j + kEL * ((r / kQL + j) % kNL) + 4 * (r % kQL);
          if (d < nd) {
            const float4 x = make_float4(acc[r].x / lh, acc[r].y / lh, acc[r].z / lh,
                                         acc[r].w / lh);
            store_quad<Q_T>(out + static_cast<size_t>(hl) * p.D + d, x, min(nd - d, 4),
                            p.o_vec);
          }
        }
      }
      return;
    }
    // this warp's (m, l, acc) into its region (the ring is drained), then
    // the unit's warps merge in warp order
    if (has_head) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int d = 32 * j + kEL * ((r / kQL + j) % kNL) + 4 * (r % kQL);
        if (d < nd) *reinterpret_cast<float4*>(merge + hl * kBlockDims + d) = acc[r];
      }
      if (j == 0) {
        merge[kHeads * kBlockDims + hl] = m_run;
        merge[kHeads * kBlockDims + kHeads + hl] = l_run;
      }
    }
    unit_sync(uib, p.nw);
    for (int e = w * 32 + lane; e < nh * nd; e += 32 * p.nw) {
      const int h = e / nd;
      const int d = e - h * nd;
      float mx = kNegInf;
      for (int ww = 0; ww < p.nw; ++ww) {
        const float* g = reinterpret_cast<const float*>(unit_smem + ww * p.warp_bytes);
        mx = fmaxf(mx, g[kHeads * kBlockDims + h]);
      }
      float lsum = 0.f, a = 0.f;
      for (int ww = 0; ww < p.nw; ++ww) {
        const float* g = reinterpret_cast<const float*>(unit_smem + ww * p.warp_bytes);
        const float c = __expf(g[kHeads * kBlockDims + h] - mx);
        lsum = fmaf(g[kHeads * kBlockDims + kHeads + h], c, lsum);
        a = fmaf(g[h * kBlockDims + d], c, a);
      }
      out[static_cast<size_t>(h) * p.D + d] = from_f32<Q_T>(a / fmaxf(lsum, 1e-30f));
    }
    return;
  }

  // ---- a row with no valid slot: the mean of V over every gathered row.
  // Lanes are (row slot rs, 16-byte chunk cc of the 128-dim block); a
  // chunk holds kE values, kCb chunks a block row; kRpw rows per pass, or
  // kKch chunks per lane when a block row has more than 32 chunks.
  constexpr int kE = VB / kSz;
  constexpr int kCb = kBlockDims / kE;
  constexpr int kKch = kCb > 32 ? kCb / 32 : 1;
  constexpr int kRpw = kCb < 32 ? 32 / kCb : 1;
  const int rs = kCb < 32 ? lane / kCb : 0;
  const int cc = kCb < 32 ? lane - rs * kCb : lane;
  float acc[kKch][kE], part[kKch][kE];
#pragma unroll
  for (int c = 0; c < kKch; ++c)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[c][e] = part[c][e] = 0.f;
  const unsigned char* vbase = p.v + head_off + static_cast<size_t>(d0) * kSz;
  int prev = -1;
  for (int j = w; j < p.mp; j += p.nw) {
    int pid = __shfl_sync(kFull, tcol, j & 31);
    if (j >= 32) pid = __ldg(row + j);
    const int safe = min(max(pid, 0), p.P - 1);
    if (safe != prev) {  // else: the previous column's sum, the same bits
#pragma unroll
      for (int c = 0; c < kKch; ++c)
#pragma unroll
        for (int e = 0; e < kE; ++e) part[c][e] = 0.f;
      const unsigned char* pg = vbase + static_cast<size_t>(safe) * p.page * tok_stride;
#pragma unroll 8
      for (int t = rs; t < p.page; t += kRpw) {
#pragma unroll
        for (int c = 0; c < kKch; ++c) {
          const int dim = (cc + 32 * c) * kE;
          if (dim < nd) {
            float x[kE];
            load_vals<KV_T, VB>(pg + t * tok_stride + dim * kSz, x);
#pragma unroll
            for (int e = 0; e < kE; ++e) part[c][e] += x[e];
          }
        }
      }
      if constexpr (kQuant) {
        const float vs = __ldg(p.v_scale + safe);
#pragma unroll
        for (int c = 0; c < kKch; ++c)
#pragma unroll
          for (int e = 0; e < kE; ++e) part[c][e] *= vs;
      }
      prev = safe;
    }
#pragma unroll
    for (int c = 0; c < kKch; ++c)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[c][e] += part[c][e];
  }
  // the row slots, by a fixed halving tree: every slot's lanes end with
  // the same sums (each step adds two values, in either order the same bits)
#pragma unroll
  for (int o = kRpw / 2; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < kKch; ++c)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[c][e] += __shfl_xor_sync(kFull, acc[c][e], o * kCb);
  const float n_rows = fmaxf(static_cast<float>(p.mp) * static_cast<float>(p.page), 1e-30f);
  if (p.nw == 1) {
    // one warp: the mean straight from the registers into every head, row
    // slot rs writing heads rs, rs + kRpw, ...
    {
#pragma unroll
      for (int c = 0; c < kKch; ++c) {
        const int dim = (cc + 32 * c) * kE;
#pragma unroll
        for (int e = 0; e < kE; e += 4) {
          if (dim + e < nd) {
            float x4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) x4[i] = acc[c][e + i < kE ? e + i : 0] / n_rows;
            const float4 x = make_float4(x4[0], x4[1], x4[2], x4[3]);
            const int n = min(min(kE - e, 4), nd - dim - e);
            for (int h = rs; h < nh; h += kRpw)
              store_quad<Q_T>(out + static_cast<size_t>(h) * p.D + dim + e, x, n,
                              p.o_vec && kE >= 4);
          }
        }
      }
    }
    return;
  }
  if (rs == 0) {
#pragma unroll
    for (int c = 0; c < kKch; ++c) {
      const int dim = (cc + 32 * c) * kE;
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (dim + e < nd) merge[dim + e] = acc[c][e];
    }
  }
  unit_sync(uib, p.nw);
  for (int e = w * 32 + lane; e < nh * nd; e += 32 * p.nw) {
    const int h = e / nd;
    const int d = e - h * nd;
    float sum = 0.f;
    for (int ww = 0; ww < p.nw; ++ww)
      sum += reinterpret_cast<const float*>(unit_smem + ww * p.warp_bytes)[d];
    out[static_cast<size_t>(h) * p.D + d] = from_f32<Q_T>(sum / n_rows);
  }
}

template <typename KV_T, typename Q_T, int VB>
int launch(const Params& p, int blocks, size_t smem, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<KV_T, Q_T, VB>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the widest copy width that the pools' pointers and row pitch allow
template <typename KV_T, typename Q_T>
int launch_width(int vb, const Params& p, int blocks, size_t smem, cudaStream_t s) {
  switch (vb) {
    case 16: return launch<KV_T, Q_T, 16>(p, blocks, smem, s);
    case 8: return launch<KV_T, Q_T, 8>(p, blocks, smem, s);
    case 4: return launch<KV_T, Q_T, 4>(p, blocks, smem, s);
    default: break;
  }
  if constexpr (sizeof(KV_T) <= 2) {
    if (vb == 2) return launch<KV_T, Q_T, 2>(p, blocks, smem, s);
  }
  if constexpr (sizeof(KV_T) == 1) {
    if (vb == 1) return launch<KV_T, Q_T, 1>(p, blocks, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int round16(int x) { return (x + 15) / 16 * 16; }

}  // namespace

// kind: 0 = fp32 pool and q, 1 = bf16 pool and q, 2 = int8 pool + fp32
// scales with fp32 q. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for an unknown kind, or kErrShape when
// group * D exceeds 4096 or the block's shared memory exceeds what the
// device lets one block opt in to. These are the kernel's only limits; the
// Python wrapper turns kErrShape into a ValueError.
extern "C" int xbof_paged_attention(int kind, const void* q, const void* k,
                                    const void* v, const float* k_scale,
                                    const float* v_scale,
                                    const int* page_table, const int* lengths,
                                    void* out, int B, int H, int KV, int D,
                                    int P, int page, int mp, float scale,
                                    void* stream) {
  const int group = H / KV;
  if (group * D > kMaxGroupDims) return kErrShape;
  const int sz = kind == 0 ? 4 : kind == 1 ? 2 : kind == 2 ? 1 : 0;
  if (sz == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int qsz = kind == 1 ? 2 : 4;
  Params p;
  p.q = q;
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.table = page_table;
  p.lengths = lengths;
  p.out = out;
  p.H = H;
  p.KV = KV;
  p.D = D;
  p.P = P;
  p.page = page;
  p.mp = mp;
  p.scale = scale;
  p.group = group;
  p.n_hs = (group + kHeads - 1) / kHeads;
  p.n_db = (D + kBlockDims - 1) / kBlockDims;
  const int dq = (D + 3) / 4 * 4;  // D in whole quads
  const int vdims = dq < kBlockDims ? dq : kBlockDims;
  p.k_pitch = round16(dq * sz);
  p.v_pitch = round16(vdims * sz);
  const int tc = kStageBytes / (D * sz + vdims * sz);
  p.tc = tc < 1 ? 1 : tc > kMaxTc ? kMaxTc : tc;
  const int ring = 2 * p.tc * (p.k_pitch + p.v_pitch);
  const int merge = static_cast<int>(sizeof(float)) * (kHeads * kBlockDims + 2 * kHeads);
  p.warp_bytes = round16(ring > merge ? ring : merge);
  p.q_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % (4 * qsz) == 0;
  p.o_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * qsz) == 0;
  const long long units = static_cast<long long>(B) * KV * p.n_hs * p.n_db;
  int device = 0, optin = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t smem = static_cast<size_t>(kWarps) * p.warp_bytes;
  if (smem > static_cast<size_t>(optin)) return kErrShape;
  // warps per unit: 1 when the units alone fill the card twice over, else
  // up to 4, each taking a share of the unit's tokens
  int nw = kWarps;
  while (nw > 1 && units * nw > static_cast<long long>(kUnitsPerSm) * sms) nw /= 2;
  p.nw = nw;
  p.units = static_cast<int>(units);
  const int blocks = static_cast<int>((units * nw + kWarps - 1) / kWarps);
  // the copy width: the widest of 16, 8, 4, 2, 1 bytes dividing both pool
  // pointers and the row pitch D * sizeof
  int vb = 16;
  while (vb > sz && (reinterpret_cast<uintptr_t>(k) % vb != 0 ||
                     reinterpret_cast<uintptr_t>(v) % vb != 0 || (D * sz) % vb != 0)) {
    vb /= 2;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch_width<float, float>(vb, p, blocks, smem, s);
    case 1: return launch_width<__nv_bfloat16, __nv_bfloat16>(vb, p, blocks, smem, s);
    default: return launch_width<int8_t, float>(vb, p, blocks, smem, s);
  }
}
