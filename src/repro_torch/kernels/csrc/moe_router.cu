// MoE top-k router for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU Pallas kernel `topk_router` of
// src/repro/kernels/moe_router.py. Plain version:
// src/repro_torch/kernels/ref.py (`topk_router`); Python wrapper:
// kernels/moe_router.py.
//
// What it computes: for scores [T, E] fp32 and an optional bias [E] fp32,
// per token row the k experts with the largest sel = scores + bias,
// largest first, ties to the lowest index (the order of `lax.top_k` and of
// the TPU kernel's k argmax passes); and their weights, the UNBIASED
// scores of the picked experts over max(their sum, 1e-9). Writes w [T, k]
// fp32 and idx [T, k] int32. The bias is added with a plain IEEE add
// (`__fadd_rn`), so the selection is the plain version's bit for bit;
// the sum of the k picked scores runs in pick order, so a weight may
// differ from the plain version's by an ulp.
//
// What bounds it on the card: it reads T * E * 4 bytes of scores and
// writes T * k * 8; a few comparisons per score and pass. Bytes bound it:
// 0.0013 ms for the DeepSeek-v3 prefill's [4096, 256] at 3.35 TB/s. A
// decode step's [4, E] is one block, bound by launch latency.
//
// Design (simple and right first): one warp per token row. Lane l holds
// the row's scores l, l + 32, l + 64, ... in registers (kPerLane of them,
// padded past E), so each warp's loads are coalesced. Each of the k passes
// takes every lane's best not-yet-picked (sel, index) and reduces them
// across the warp with `__shfl_xor_sync`, ties to the lower index; the
// lane that owns the winner marks it picked in a bit mask (the TPU kernel
// overwrites the winner with -1e30 instead; the mask gives top-k's order
// whatever the values). The unbiased score rides along in the reduction.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // token rows per block
constexpr int kMaxExperts = 1024;    // 32 scores per lane
constexpr int kMaxK = 16;
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

struct Best {
  float sel;    // scores + bias, what ranks
  float score;  // the unbiased score, what weighs
  int idx;
};

// a beats b: larger sel, or the same sel at a lower index
__device__ __forceinline__ bool beats(const Best& a, const Best& b) {
  return a.sel > b.sel || (a.sel == b.sel && a.idx < b.idx);
}

template <int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
router_kernel(const float* __restrict__ scores, const float* __restrict__ bias,
              float* __restrict__ w_out, int* __restrict__ idx_out, int T,
              int E, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;  // whole warps leave together
  const float* s_row = scores + row * E;
  float sel[kPerLane], sc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = j * 32 + lane;
    sc[j] = e < E ? s_row[e] : 0.0f;
    sel[j] = e < E && bias != nullptr ? __fadd_rn(sc[j], bias[e]) : sc[j];
  }
  uint32_t picked = 0;  // bit j: this lane's score j is taken (or past E)
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (j * 32 + lane >= E) picked |= 1u << j;

  float w_sum = 0.0f;
  float w_keep = 0.0f;   // lane p keeps the p-th pick's score
  int i_keep = 0;
  for (int p = 0; p < k; ++p) {
    Best best{-INFINITY, 0.0f, INT32_MAX};
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const Best cand{sel[j], sc[j], j * 32 + lane};
      if (!(picked >> j & 1u) && beats(cand, best)) best = cand;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Best other;
      other.sel = __shfl_xor_sync(0xffffffffu, best.sel, off);
      other.score = __shfl_xor_sync(0xffffffffu, best.score, off);
      other.idx = __shfl_xor_sync(0xffffffffu, best.idx, off);
      if (beats(other, best)) best = other;
    }
    // every lane now holds the winner; its owner marks it taken
    if (best.idx < E && (best.idx & 31) == lane) picked |= 1u << (best.idx >> 5);
    w_sum = __fadd_rn(w_sum, best.score);
    if (lane == p) {
      w_keep = best.score;
      i_keep = best.idx;
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
  const int blocks = T / kWarps + (T % kWarps != 0);
  router_kernel<kPerLane><<<blocks, kWarps * 32, 0, stream>>>(
      scores, bias, w, idx, T, E, k);
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
  if (per_lane <= 1) return launch<1>(sp, bp, wp, ip, T, E, k, s);
  if (per_lane <= 2) return launch<2>(sp, bp, wp, ip, T, E, k, s);
  if (per_lane <= 4) return launch<4>(sp, bp, wp, ip, T, E, k, s);
  if (per_lane <= 8) return launch<8>(sp, bp, wp, ip, T, E, k, s);
  if (per_lane <= 16) return launch<16>(sp, bp, wp, ip, T, E, k, s);
  return launch<32>(sp, bp, wp, ip, T, E, k, s);
}
