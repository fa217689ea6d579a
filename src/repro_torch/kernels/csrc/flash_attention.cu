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
// The softmax statistics, for the backward (csrc/flash_attention_bwd.cu):
// given a non-null `stats`, fp32 [2, B, H, S], both forms store each row's
// m (stats[0]) and l (stats[1]) in natural units: m the row's max of the
// masked scaled scores x (x = s * scale, or NEG_INF where masked), l =
// sum over the T keys of exp(x - m). The bf16 form keeps m in base 2 and
// stores m * ln 2, except that a row with no valid key keeps m = NEG_INF
// exactly (its l is T): m and l stay apart because in fp32 NEG_INF +
// log(T) rounds to NEG_INF, and one log-sum-exp would give those rows
// weight 1 where the plain version gives 1 / T. Plain version:
// `ref.attention_stats`. A null `stats` (serving) stores nothing.
//
// What bounds it on the card: at the model zoo's prefill shapes (S = T =
// 2048 and more, D 80 to 256) it does 4 * D flops per unmasked (query,
// key) pair and head, some 850 flops per byte it must move, far above the
// H100's ~295 flops per byte of bf16 balance: it is bound by tensor-core
// flops (989 TFLOP/s bf16).
//
// bf16: FlashAttention-3's forward pass on wgmma and TMA. A work item is
// (batch, query head, tile of kBM = 128 query rows); items run from the
// last query tile (the longest under a causal mask) to the first, and a
// persistent grid of one 384-thread block per SM walks them in rounds,
// so one item's epilogue overlaps the next one's loads.
// - Warpgroup 0 is the producer. It gives up its registers (setmaxnreg
//   24) and one thread issues the TMA loads: an item's Q once the
//   consumers' last S = Q.K^T of the previous item is done, then K and V
//   of its KV head tile by tile into a ring of kStages = 2 stages, each
//   with full barriers for K and V and empty barriers the consumers
//   release. Tiles stay bf16 in shared memory, in the swizzle the wgmma
//   descriptors name: the D axis is cut into boxes of CHUNK columns (64
//   with a 128-byte swizzle for D = 64, 128, 256; 32 with a 64-byte
//   swizzle for D = 32, 96; 16 with a 32-byte swizzle for D = 16 and 80,
//   whose 160-byte rows span no whole 128-byte swizzle), stored box after
//   box, so each 16-column K-step of Q.K^T reads inside one box.
// - Warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 query rows
//   each. S = Q.K^T is wgmma m64nBNk16 with both operands K-major in
//   shared memory, fp32 accumulate. The masks apply only on tiles that
//   cross T, the causal diagonal or the window's lower edge; the online
//   softmax runs in registers (a row of the accumulator fragment lies on
//   the 4 lanes of a quad: two shuffles), in base 2, with scale * log2(e)
//   folded into the exponent of unmasked scores only, so a masked score
//   stays exactly NEG_INF. P is rounded to bf16 in place: the S
//   accumulator's fragment is the A-register fragment of the next
//   product. O += P.V is one wgmma m64nDk16 per 16 keys with A = P from
//   registers and B = V [keys, D] read MN-major (the transpose bit).
//   FlashAttention-3's two overlaps: tile i's S and tile i - 1's P.V are
//   in flight together and tile i's softmax runs while P.V does; and the
//   two consumer warpgroups take turns to issue their products (named
//   barriers), so one's softmax runs while the other's products keep the
//   tensor cores busy.
// Key tiles are BN = 128 keys for D <= 128; at D = 256, 80 keys, so that Q
// (64 KB), two stages of K and V (160 KB) and the consumers' registers (O
// 128, S 40, P 20 a thread) fit. No wgmma or wait sits under a condition
// (the loop over key tiles is peeled), the roles come from a warp-uniform
// shuffle, and the epilogue divides with a MUFU reciprocal (a division
// calls a slow path): otherwise ptxas serializes every wgmma (its C7510 to
// C7520 reports) and each product waits for the one before. A ragged edge costs no branch in the loads: TMA fills
// rows past S or T with zeros; a key column >= T gets a -inf score
// (weight exactly 0), a query row >= S is never stored. Key tiles wholly
// outside every row's causal band or window are skipped, which is exact
// for rows that have a valid key (their masked terms are exp(NEG_INF - m)
// = 0); an item holding a row with no valid key walks every key tile, so
// that row gets the plain version's uniform average. Inputs must start
// on 16 bytes (TMA); rows are D * 2 bytes, a multiple of 16 for every
// head dim taken.
//
// fp32: the first kernel, on the CUDA cores. One block of 128 threads per
// (batch, query head, tile of 64 query rows); key tiles of 64 staged in
// shared memory as fp32 (K transposed); each thread owns a 4 x 8 tile of
// scores and 4 rows x D / 8 columns of the output. A tensor-core fp32
// form would need TF32, which the fp32 checks do not allow.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

// ====================================================================
// fp32: the SIMT kernel
// ====================================================================

constexpr int kThreads = 128;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kRows = 4;         // query rows per thread (16 row groups)
constexpr int kCols = 8;         // threads per row group
constexpr int kPad = kBQ + 1;    // padded stride of the transposed tiles

static_assert(kBQ == kBK, "Q^T and K^T / P share one padded stride");
static_assert((kThreads / kCols) * kRows == kBQ, "row groups cover the tile");

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
template <int D>
__global__ void __launch_bounds__(kThreads)
simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out,
            float* __restrict__ stats, int B, int S, int Tk, int H, int KV, int causal,
            int window, float scale) {
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
  const float* qb = q + (static_cast<size_t>(b) * S) * q_row + static_cast<size_t>(h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Tk) * k_row + static_cast<size_t>(kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Tk) * k_row + static_cast<size_t>(kvh) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    qt[d * kPad + r] = q0 + r < S ? qb[(q0 + r) * q_row + d] : 0.f;
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
      kt[d * kPad + c] = in ? kb[off] : 0.f;
      vs[c * D + d] = in ? vb[off] : 0.f;
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
        ps[r * kPad + tx + kCols * j] = p;
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

  float* ob = out + (static_cast<size_t>(b) * S) * q_row + static_cast<size_t>(h) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= S) continue;
    if (stats != nullptr && tx == 0) {  // the row's statistics (the note above)
      const size_t at = (static_cast<size_t>(b) * H + h) * S + r;
      stats[at] = m[i];
      stats[static_cast<size_t>(B) * H * S + at] = l[i];
    }
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      ob[static_cast<size_t>(r) * q_row + tx + kCols * j] = acc[i][j] / denom;
    }
  }
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* out, float* stats,
                int B, int S, int Tk, int H, int KV, int causal, int window, float scale,
                cudaStream_t stream) {
  // Q^T and K^T (later P) at the padded stride, and V
  const size_t smem = sizeof(float) * (static_cast<size_t>(D + kt_rows(D)) * kPad +
                                       static_cast<size_t>(kBK) * D);
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(optin)) return kErrShape;
  auto kernel = simt_kernel<D>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), stats, B, S, Tk, H, KV,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ====================================================================
// bf16: wgmma + TMA, warp-specialised
// ====================================================================

constexpr int kBM = 128;              // query rows per work item: two consumer warpgroups of 64
constexpr int kStages = 2;            // depth of the K / V ring
constexpr int kHopperThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;     // setmaxnreg: 128 * 24 + 256 * 240 <= 65536
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory layout of one block. Every tile is stored as D / CHUNK
// boxes of [rows][CHUNK] bf16 (one TMA box each, swizzled by CHUNK * 2
// bytes); each box starts on 1024 bytes.
template <int D, int CHUNK, int BN>
struct Tiles {
  static_assert(D % CHUNK == 0 && (CHUNK == 16 || CHUNK == 32 || CHUNK == 64), "boxes");
  static_assert(BN % 16 == 0 && BN <= 256, "key tile");
  static constexpr int kNch = D / CHUNK;         // boxes along D
  static constexpr int kRowBytes = CHUNK * 2;    // one row of a box: the swizzle span
  static constexpr int kAtom = 8 * kRowBytes;    // 8 rows: one swizzle atom
  static constexpr int kQBox = kBM * kRowBytes;  // one box of the Q tile
  static constexpr int kKVBox = BN * kRowBytes;  // one box of a K or V tile
  static constexpr int kQBytes = kNch * kQBox;
  static constexpr int kKVBytes = kNch * kKVBox;
  // alignment slack, Q, the K and V rings, 2 + 4 * kStages mbarriers
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (2 + 4 * kStages);
  static_assert(kQBox % 1024 == 0 && kKVBox % 1024 == 0, "boxes start on 1024 bytes");
};


// The online softmax of one key tile in base 2, for the accumulator
// fragment's columns col (+ 8 * j, + 1) and its rows at key positions
// pos0 (+ 8). With kMask a score becomes scale * log2(e) * s where valid,
// NEG_INF where masked and -inf past T (weight exactly 0); without it
// every score of the tile is valid and the scale folds into the exponent
// (scale_log2 >= 0). Leaves the weights in s, the new row maxima in m,
// this thread's share of the row sums in l, and the factor that rescales
// the old O in alpha.
template <bool kMask, int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2, int col,
                                               int pos0, int Tk, int causal, int window) {
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float& x = s[4 * j + i];
        const int c = col + 8 * j + (i & 1);
        const int pos = pos0 + 8 * (i >> 1);
        if (c >= Tk) {
          x = -INFINITY;
        } else if ((causal && c > pos) || (window > 0 && c <= pos - window)) {
          x = kNegInf;
        } else {
          x *= scale_log2;
        }
      }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = s[2 * hr];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if constexpr (!kMask) mx *= scale_log2;
    const float m_new = fmaxf(m[hr], mx);
    // with kMask the exponent is x - m_new, else s * scale_log2 - m_new
    const float mul = kMask ? 1.f : scale_log2;
    alpha[hr] = ex2(m[hr] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * hr + e];
        x = ex2(fmaf(x, mul, -m_new));
        sum += x;
      }
    }
    l[hr] = l[hr] * alpha[hr] + sum;
    m[hr] = m_new;
  }
}


// S = Q.K^T for one key tile: D / 16 K-steps, each inside one box
template <int D, int CHUNK, int BN>
__device__ __forceinline__ void gemm_qk(float (&s)[BN / 2], uint32_t q_base, uint32_t k_base) {
  using L = Tiles<D, CHUNK, BN>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = kk * 16 / CHUNK, in = (kk * 16 % CHUNK) * 2;
    wgmma_ss<BN>(s, make_desc<CHUNK>(q_base + box * L::kQBox + in, 16, L::kAtom),
                 make_desc<CHUNK>(k_base + box * L::kKVBox + in, 16, L::kAtom), kk > 0);
  }
}

// O += P.V for one key tile: one wgmma across all of D per 16 keys. V
// [keys][D] is the MN-major B operand: the stride byte offset steps 8
// keys inside a box, the leading byte offset from one box of D to the next.
template <int D, int CHUNK, int BN>
__device__ __forceinline__ void gemm_pv(float (&o)[D / 2], const uint32_t (&p)[BN / 4],
                                        uint32_t v_base) {
  using L = Tiles<D, CHUNK, BN>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs<D>(o, a, make_desc<CHUNK>(v_base + kk * 16 * L::kRowBytes, L::kKVBox, L::kAtom));
  }
}


// One query tile of the grid's work: its rows, head, batch and the key
// tiles it walks. Work items go from the last query tile (the longest
// under a causal mask) to the first, over all heads and batches, a KV
// head's query heads side by side.
struct Work {
  int q0, h, b, t_lo, n_tiles;
};

// The block's next work item after w: rounds of gridDim.x items, taken in
// block order in even rounds and in reverse in odd ones, so that a block
// that draws the longer item of one round draws the shorter of the next.
__device__ __forceinline__ int next_work(int w) {
  const int round = w / gridDim.x;
  const int bid = round & 1 ? gridDim.x - 1 - w % gridDim.x : w % gridDim.x;
  const int next = round + 1;
  return next * gridDim.x + (next & 1 ? gridDim.x - 1 - bid : bid);
}

template <int BN>
__device__ __forceinline__ Work work_item(int w, int B, int S, int Tk, int H, int causal,
                                          int window) {
  Work t;
  const int bh = w % (H * B);
  t.q0 = ((S + kBM - 1) / kBM - 1 - w / (H * B)) * kBM;
  t.h = bh % H;
  t.b = bh / H;
  // skip key tiles wholly outside every row's causal band or window,
  // unless a row has no valid key (it averages V over all T keys)
  const int offset = Tk - S;
  const int pos_first = t.q0 + offset;
  const int pos_last = min(t.q0 + kBM, S) - 1 + offset;
  int k_lo = 0, k_hi = Tk - 1;
  if (causal && pos_first >= 0) {
    k_hi = min(Tk - 1, pos_last);
    if (window > 0) k_lo = max(0, pos_first - window + 1);
  }
  t.t_lo = k_lo / BN;
  t.n_tiles = k_hi / BN - t.t_lo + 1;
  return t;
}

template <int D, int CHUNK, int BN>
__global__ void __launch_bounds__(kHopperThreads, 1)
hopper_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
              float* __restrict__ stats, int B, int S, int Tk, int H, int KV, int causal,
              int window, float scale_log2) {
  using L = Tiles<D, CHUNK, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + L::kQBytes;                 // kStages K tiles
  uint8_t* vs = ks + kStages * L::kKVBytes;      // kStages V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * L::kKVBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  const int tid = threadIdx.x;
  const int n_work = (S + kBM - 1) / kBM * H * B;
  const int offset = Tk - S;                      // key position of query row 0

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);                      // every consumer thread
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 256);
      mbar_init(&v_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, known to the compiler to be the same across a
  // warp (a role taken from a divergent branch would make ptxas serialize
  // every wgmma)
  const int wg_index = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg_index == 0) {
    // ---- producer warpgroup: one thread issues every TMA load. The K / V
    // ring runs on across the block's work items, and the next item's Q
    // loads as soon as the consumers' last S = Q.K^T of this one is done.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      int g = 0;                                  // K / V tiles loaded so far
      int n = 0;                                  // work items so far
      for (int w = blockIdx.x; w < n_work; w = next_work(w), ++n) {
        const Work t = work_item<BN>(w, B, S, Tk, H, causal, window);
        const int kvh = t.h / (H / KV);
        mbar_wait(q_empty, (n & 1) ^ 1);          // the first round passes
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int c = 0; c < L::kNch; ++c) {
          tma_load(qs + c * L::kQBox, &qmap, q_full, c * CHUNK, t.h, t.q0, t.b);
        }
        for (int it = 0; it < t.n_tiles; ++it, ++g) {
          const int st = g % kStages;
          const uint32_t parity = ((g / kStages) & 1) ^ 1;
          const int k0 = (t.t_lo + it) * BN;
          mbar_wait(&k_empty[st], parity);
          mbar_expect_tx(&k_full[st], L::kKVBytes);
#pragma unroll
          for (int c = 0; c < L::kNch; ++c) {
            tma_load(ks + st * L::kKVBytes + c * L::kKVBox, &kmap, &k_full[st], c * CHUNK,
                     kvh, k0, t.b);
          }
          mbar_wait(&v_empty[st], parity);
          mbar_expect_tx(&v_full[st], L::kKVBytes);
#pragma unroll
          for (int c = 0; c < L::kNch; ++c) {
            tma_load(vs + st * L::kKVBytes + c * L::kKVBox, &vmap, &v_full[st], c * CHUNK,
                     kvh, k0, t.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups 1 and 2: 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = wg_index - 1;
  const int lane = tid % 32;
  const int row0 = 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;  // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_base = smem_u32(qs) + wg * 64 * L::kRowBytes;
  float o[D / 2];
  float m[2], l[2];                               // l: this thread's columns only
  float s[BN / 2];                                // scores, then logits, then weights
  uint32_t p[BN / 4];                             // weights in bf16: P.V's A fragment

  int g = 0;                                      // K / V tiles consumed so far
  int n = 0;                                      // work items so far
  for (int w = blockIdx.x; w < n_work; w = next_work(w), ++n) {
    const Work t = work_item<BN>(w, B, S, Tk, H, causal, window);
    const int pos0 = t.q0 + row0 + offset;        // key position of row row0
    // key positions of the warpgroup's first and last row below S
    const int wg_first = t.q0 + 64 * wg + offset;
    const int wg_last = min(t.q0 + 64 * wg + 64, S) - 1 + offset;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;

    // masks only on a tile that crosses T, the diagonal or the window's
    // lower edge (or under a negative scale, which the folded form does
    // not take); the weights stay in s
    auto softmax = [&](int it, float (&alpha)[2]) {
      const int k0 = (t.t_lo + it) * BN;
      if (k0 + BN > Tk || (causal && k0 + BN - 1 > wg_first) ||
          (window > 0 && k0 <= wg_last - window) || scale_log2 < 0.f) {
        online_softmax<true, BN>(s, m, l, alpha, scale_log2, k0 + col0, pos0, Tk, causal,
                                 window);
      } else {
        online_softmax<false, BN>(s, m, l, alpha, scale_log2, k0 + col0, pos0, Tk, causal,
                                  window);
      }
    };
    // the weights to bf16 in place: the S accumulator's fragment is the A
    // fragment of P.V (key step j / 2 takes {(r, k), (r + 8, k), (r, k + 8),
    // (r + 8, k + 8)})
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          p[2 * j + hr] = pack_bf16(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]);
        }
      }
    };

    // The tile loop is peeled so that no wgmma or wait sits under a
    // condition: ptxas serializes every wgmma when it cannot prove that a
    // read of an accumulator comes after the wait that covers it. The two
    // warpgroups take turns to issue their products (named barriers 1 and
    // 2), so that one's softmax runs while the other's products keep the
    // tensor cores busy; warpgroup 0 takes the first turn of each item.
    mbar_wait(q_full, n & 1);
    mbar_wait(&k_full[g % kStages], (g / kStages) & 1);
    if (wg == 1) named_arrive(1, 256);
    named_sync(1 + wg, 256);
    wgmma_fence();
    gemm_qk<D, CHUNK, BN>(s, q_base, smem_u32(ks + (g % kStages) * L::kKVBytes));
    wgmma_commit();
    named_arrive(2 - wg, 256);
    wgmma_wait<0>();
    fence_regs<BN / 2>(s);
    mbar_arrive(&k_empty[g % kStages]);
    if (t.n_tiles == 1) mbar_arrive(q_empty);     // the last S of this item
    {
      float alpha[2];
      softmax(0, alpha);
      pack();
    }
    for (int it = 1; it < t.n_tiles; ++it) {
      // S of tile it and P.V of tile it - 1 in flight together; the
      // softmax of tile it runs while P.V still does
      const int st = (g + it) % kStages;
      const int pst = (g + it - 1) % kStages;
      mbar_wait(&k_full[st], ((g + it) / kStages) & 1);
      mbar_wait(&v_full[pst], ((g + it - 1) / kStages) & 1);
      named_sync(1 + wg, 256);
      wgmma_fence();
      gemm_qk<D, CHUNK, BN>(s, q_base, smem_u32(ks + st * L::kKVBytes));
      wgmma_commit();
      gemm_pv<D, CHUNK, BN>(o, p, smem_u32(vs + pst * L::kKVBytes));
      wgmma_commit();
      named_arrive(2 - wg, 256);
      wgmma_wait<1>();
      fence_regs<BN / 2>(s);
      mbar_arrive(&k_empty[st]);
      if (it == t.n_tiles - 1) mbar_arrive(q_empty);
      float alpha[2];
      softmax(it, alpha);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      mbar_arrive(&v_empty[pst]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack();
    }
    const int last = (g + t.n_tiles - 1) % kStages;
    mbar_wait(&v_full[last], ((g + t.n_tiles - 1) / kStages) & 1);
    named_sync(1 + wg, 256);
    wgmma_fence();
    gemm_pv<D, CHUNK, BN>(o, p, smem_u32(vs + last * L::kKVBytes));
    wgmma_commit();
    if (wg == 0) named_arrive(2, 256);            // warpgroup 1's last turn
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    mbar_arrive(&v_empty[last]);
    g += t.n_tiles;

    // out = acc / max(l, 1e-30) in bf16; rows >= S are not stored
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[hr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      // a reciprocal in one MUFU op: an IEEE division would call a slow
      // path, and a call makes ptxas serialize every wgmma of the kernel
      float inv;
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(fmaxf(lt, 1e-30f)));
      const int r = t.q0 + row0 + 8 * hr;
      if (r >= S) continue;
      if (stats != nullptr && col0 == 0) {        // the row's statistics, natural units
        const size_t at = (static_cast<size_t>(t.b) * H + t.h) * S + r;
        stats[at] = m[hr] == kNegInf ? kNegInf : m[hr] * kLn2;
        stats[static_cast<size_t>(B) * H * S + at] = lt;
      }
      __nv_bfloat16* orow = out + ((static_cast<size_t>(t.b) * S + r) * H + t.h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
            __floats2bfloat162_rn(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
      }
    }
  }
}


template <int D, int CHUNK, int BN>
int launch_hopper(const void* q, const void* k, const void* v, void* out, float* stats, int B,
                  int S, int Tk, int H, int KV, int causal, int window, float scale,
                  cudaStream_t stream) {
  using L = Tiles<D, CHUNK, BN>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(fn, &qmap, q, D, H, S, B, CHUNK, kBM) ||
      !encode_map(fn, &kmap, k, D, KV, Tk, B, CHUNK, BN) ||
      !encode_map(fn, &vmap, v, D, KV, Tk, B, CHUNK, BN)) {
    return kErrShape;
  }
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (L::kSmem > optin) return kErrShape;
  auto kernel = hopper_kernel<D, CHUNK, BN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  // persistent: one block per SM walks the work items (next_work)
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long n_work = static_cast<long long>((S + kBM - 1) / kBM) * H * B;
  if (n_work > 0x7fffffff) return kErrShape;
  const dim3 grid(static_cast<unsigned>(n_work < sms ? n_work : sms));
  kernel<<<grid, kHopperThreads, L::kSmem, stream>>>(qmap, kmap, vmap,
                                                      static_cast<__nv_bfloat16*>(out), stats, B,
                                                      S, Tk, H, KV, causal, window,
                                                      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// (head dim, box columns, keys per tile) of each bf16 instantiation
int dispatch_bf16(const void* q, const void* k, const void* v, void* out, float* stats, int B,
                  int S, int Tk, int H, int KV, int D, int causal, int window, float scale,
                  cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_hopper<16, 16, 128>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 32:
      return launch_hopper<32, 32, 128>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 64:
      return launch_hopper<64, 64, 128>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 80:
      return launch_hopper<80, 16, 128>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 96:
      return launch_hopper<96, 32, 128>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 128:
      return launch_hopper<128, 64, 128>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 256:
      return launch_hopper<256, 64, 80>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    default: return kErrShape;
  }
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* out, float* stats, int B,
                  int S, int Tk, int H, int KV, int D, int causal, int window, float scale,
                  cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_simt<16>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 32:
      return launch_simt<32>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 64:
      return launch_simt<64>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 80:
      return launch_simt<80>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 96:
      return launch_simt<96>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 128:
      return launch_simt<128>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    case 256:
      return launch_simt<256>(q, k, v, out, stats, B, S, Tk, H, KV, causal, window, scale, s);
    default: return kErrShape;
  }
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (q, k, v and out alike). Returns
// cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an unknown kind, cudaErrorNotSupported when
// the driver offers no cuTensorMapEncodeTiled, or kErrShape for a shape
// beyond the kernel's limits: head_dim not one of 16, 32, 64, 80, 96, 128,
// 256; H not a multiple of KV; S or T below 1; more than 65535 heads or
// batches (grid y / z); a window without causal (the reference's forms
// disagree there); bf16 q, k or v not starting on 16 bytes (TMA); or
// shared memory beyond what one block may opt in to. The Python wrapper
// turns kErrShape into a ValueError.
extern "C" int xbof_flash_attention(int kind, const void* q, const void* k,
                                    const void* v, void* out, void* stats, int B,
                                    int S, int T, int H, int KV, int D, int causal,
                                    int window, float scale, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || H > 65535 ||
      B > 65535 || window < 0 || (window > 0 && !causal)) {
    return kErrShape;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (kind) {
    case 0:
      return dispatch_fp32(q, k, v, out, st, B, S, T, H, KV, D, causal, window, scale, s);
    case 1:
      if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) % 16 != 0) {
        return kErrShape;
      }
      return dispatch_bf16(q, k, v, out, st, B, S, T, H, KV, D, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
