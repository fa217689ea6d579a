// MoE top-k router for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU Pallas kernel `topk_router` of
// src/repro/kernels/moe_router.py. Plain version:
// src/repro_torch/kernels/ref.py (`topk_router`); Python wrapper:
// kernels/moe_router.py.
//
// What it computes: for scores [T, E] fp32 and an optional bias [E] fp32,
// per token row the k experts with the largest sel = scores + bias,
// largest first, ties to the lowest index (the order of the plain
// version's stable sort and of the TPU kernel's k argmax passes; -0.0 and
// +0.0 are a tie); and their weights, the UNBIASED scores of the picked
// experts over max(their sum, 1e-9). Writes w [T, k] fp32 and idx [T, k]
// int32. The bias is added with a plain IEEE add (`__fadd_rn`), so the
// selection is the plain version's bit for bit; the sum of the k picked
// scores runs in pick order, so a weight may differ from the plain
// version's by an ulp. Scores are finite (a softmax or a sigmoid): NaN is
// outside the contract.
//
// What bounds it on the card: it reads T * E * 4 bytes of scores and
// writes T * k * 8; a few operations per score and pick. Bytes bound it
// on paper (0.0013 ms for the DeepSeek-v3 prefill's [4096, 256] at 3.35
// TB/s), but one warp's k picks are a chain of dependent cross-lane
// steps, the prefill is a single wave and a decode step's [4, E] a single
// block: latency, not bytes, sets its time.
//
// Design: one warp per token row, 4 rows a block. The row comes into a
// per-warp shared-memory stage: with 16-byte loads where E % 4 == 0 and
// the scores start on 16 bytes, else one coalesced 4-byte load per lane
// and slot; the bias is loaded first, so that both trips to memory
// overlap. Lane l takes the row's experts l, l + 32, l + 64, ... (kPerLane
// slots: exactly ceil(E / 32) for DeepSeek's 160 and 256 experts, a power
// of two otherwise, padded past E). Each sel becomes an order-preserving
// uint32 key (`sort_key`: -0.0 folded onto +0.0 first, then the sign bit
// of a positive flipped and every bit of a negative), packed with the
// expert's index into 64 bits (`rank`), and each lane sorts its slots
// once, best first, in registers (Batcher's networks for 8 and 5 slots,
// odd-even transposition otherwise): the head of its list is its cached
// best. A pick is two warp reductions, `__reduce_max_sync` over the heads'
// keys and `__reduce_min_sync` over the indices of the lanes that hold
// that maximum (the tie to the lowest index); the owner lane (index & 31)
// moves its list on by one, so no lane rescans, and every lane reads the
// winner's unbiased score back from the stage: a pick's critical path is
// the two `redux.sync`. Weights: the picked scores summed in pick order
// with `__fadd_rn`, then `__fdiv_rn(w, fmaxf(sum, 1e-9f))`.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // token rows per block
constexpr int kMaxExperts = 1024;    // 32 scores per lane
constexpr int kMaxK = 16;
constexpr unsigned kFull = 0xffffffffu;
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

// An order-preserving key of a finite float: a < b as floats exactly when
// key(a) < key(b) as unsigned integers, with -0.0 and +0.0 one key. Every
// finite float's key is above 0, the key of a slot past E.
__device__ __forceinline__ uint32_t sort_key(float x) {
  const uint32_t u = __float_as_uint(__fadd_rn(x, 0.0f));  // -0.0 + 0.0 = +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key, index) as one integer that ranks in top-k order: a larger key, or
// the same key at a lower index, is a larger value
__device__ __forceinline__ uint64_t rank(uint32_t key, int index) {
  return static_cast<uint64_t>(key) << 32 | static_cast<uint32_t>(~index);
}

// a compare-exchange: the larger of the two first
__device__ __forceinline__ void ce(uint64_t& a, uint64_t& b) {
  const bool swap = a < b;
  const uint64_t hi = swap ? b : a;
  b = swap ? a : b;
  a = hi;
}

// sort, largest first, in registers: odd-even transposition (N rounds of
// compare-exchanges between neighbours, unrolled) for any N ...
template <int N>
__device__ __forceinline__ void sort_desc(uint64_t (&c)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int i = r & 1; i + 1 < N; i += 2) ce(c[i], c[i + 1]);
}

// ... and shorter networks for DeepSeek's slot counts: Batcher's
// odd-even merge sort for 8 (19 compare-exchanges in 6 layers, not 28)
// and a 9-exchange network for 5 (E = 256 and 160)
template <>
__device__ __forceinline__ void sort_desc<8>(uint64_t (&c)[8]) {
  ce(c[0], c[1]); ce(c[2], c[3]); ce(c[4], c[5]); ce(c[6], c[7]);
  ce(c[0], c[2]); ce(c[1], c[3]); ce(c[4], c[6]); ce(c[5], c[7]);
  ce(c[1], c[2]); ce(c[5], c[6]);
  ce(c[0], c[4]); ce(c[1], c[5]); ce(c[2], c[6]); ce(c[3], c[7]);
  ce(c[2], c[4]); ce(c[3], c[5]);
  ce(c[1], c[2]); ce(c[3], c[4]); ce(c[5], c[6]);
}

template <>
__device__ __forceinline__ void sort_desc<5>(uint64_t (&c)[5]) {
  ce(c[0], c[1]); ce(c[3], c[4]);
  ce(c[2], c[4]);
  ce(c[2], c[3]); ce(c[1], c[4]);
  ce(c[0], c[3]);
  ce(c[0], c[2]); ce(c[1], c[3]);
  ce(c[1], c[2]);
}

template <int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
router_kernel(const float* __restrict__ scores, const float* __restrict__ bias,
              float* __restrict__ w_out, int* __restrict__ idx_out, int T,
              int E, int k, int vec) {
  __shared__ __align__(16) float stage[kWarps][32 * kPerLane];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= T) return;  // whole warps leave together
  const float* s_row = scores + row * E;
  float* st = stage[warp];
  // the bias first, so that its loads overlap the scores'
  float b[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    b[j] = bias != nullptr && j * 32 + lane < E ? bias[j * 32 + lane] : 0.0f;
  if (vec) {  // E % 4 == 0 and the scores on 16 bytes: 16-byte loads
    const float4* src = reinterpret_cast<const float4*>(s_row);
#pragma unroll
    for (int i = 0; i < (8 * kPerLane + 31) / 32; ++i) {
      const int v = i * 32 + lane;
      if (v < E / 4) reinterpret_cast<float4*>(st)[v] = src[v];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (j * 32 + lane < E) st[j * 32 + lane] = s_row[j * 32 + lane];
  }
  __syncwarp();
  // this lane's slots ranked, best first (a slot past E ranks 0)
  uint64_t c[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = j * 32 + lane;
    const float s = st[e < E ? e : 0];
    c[j] = e < E ? rank(sort_key(bias != nullptr ? __fadd_rn(s, b[j]) : s), e) : 0u;
  }
  sort_desc(c);

  float w_sum = 0.0f;
  float w_keep = 0.0f;   // lane p keeps the p-th pick's score
  int i_keep = 0;
  for (int p = 0; p < k; ++p) {
    // k <= E real slots, each with a key above 0, so top > 0 and only
    // lanes with an unpicked real slot match it
    const uint32_t key = static_cast<uint32_t>(c[0] >> 32);
    const uint32_t top = __reduce_max_sync(kFull, key);
    const uint32_t mine = key == top ? ~static_cast<uint32_t>(c[0]) : kFull;
    const int win = static_cast<int>(__reduce_min_sync(kFull, mine));
    if ((win & 31) == lane) {  // the owner drops the winner: its next best
#pragma unroll
      for (int j = 0; j + 1 < kPerLane; ++j) c[j] = c[j + 1];
      c[kPerLane - 1] = 0u;
    }
    const float score = st[win];  // the unbiased score, from the stage
    w_sum = __fadd_rn(w_sum, score);
    if (lane == p) {
      w_keep = score;
      i_keep = win;
    }
  }
  if (lane < k) {
    const float denom = fmaxf(w_sum, 1e-9f);
    w_out[row * k + lane] = __fdiv_rn(w_keep, denom);
    idx_out[row * k + lane] = i_keep;
  }
}

template <int kPerLane>
int launch(const float* scores, const float* bias, float* w, int* idx, int T,
           int E, int k, cudaStream_t stream) {
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  const int blocks = T / kWarps + (T % kWarps != 0);
  router_kernel<kPerLane><<<blocks, kWarps * 32, 0, stream>>>(
      scores, bias, w, idx, T, E, k, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scores [T, E] fp32, bias [E] fp32 or null for none; w [T, k] fp32 and
// idx [T, k] int32 are written. Returns cudaGetLastError() after the
// launch (0 on success; 0 without a launch for T = 0), or kErrShape for a
// shape beyond the kernel's limits (T below 0, E below 1 or above 1024,
// k below 1 or above min(E, 16)). The Python wrapper turns kErrShape into
// a ValueError.
extern "C" int xbof_topk_router(const void* scores, const void* bias, void* w,
                                void* idx, int T, int E, int k, void* stream) {
  if (T < 0 || E < 1 || E > kMaxExperts || k < 1 || k > kMaxK || k > E)
    return kErrShape;
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scores);
  const float* bp = static_cast<const float*>(bias);
  float* wp = static_cast<float*>(w);
  int* ip = static_cast<int*>(idx);
  const int per_lane = (E + 31) / 32;
  if (per_lane == 5) return launch<5>(sp, bp, wp, ip, T, E, k, s);  // E = 160
  if (per_lane <= 1) return launch<1>(sp, bp, wp, ip, T, E, k, s);
  if (per_lane <= 2) return launch<2>(sp, bp, wp, ip, T, E, k, s);
  if (per_lane <= 4) return launch<4>(sp, bp, wp, ip, T, E, k, s);
  if (per_lane <= 8) return launch<8>(sp, bp, wp, ip, T, E, k, s);  // E = 256
  if (per_lane <= 16) return launch<16>(sp, bp, wp, ip, T, E, k, s);
  return launch<32>(sp, bp, wp, ip, T, E, k, s);
}
