// The MoE top-k router's backward pass for Hopper (sm_90a), with a plain C
// interface.
//
// No TPU kernel behind it: the reference trains through XLA's autodiff of
// its jnp oracle (src/repro/kernels/ref.py, `topk_router`), and this kernel
// stands for that gradient beside the forward kernel of csrc/moe_router.cu.
// Plain version: src/repro_torch/kernels/ref.py (`topk_router_bwd`); Python
// wrapper: kernels/moe_router.py (`topk_router_bwd`, and `TopKRouter`, the
// autograd Function that launches it).
//
// What it computes: the forward's weights are w_j = p_j / c, p_j =
// scores[t, idx_j] (the unbiased picked scores), s = sum_j p_j, c = max(s,
// 1e-9); the selection idx has no gradient and the bias only selects. For
// the cotangent dw [T, k] the gradient of the scores [T, E] fp32 is zero
// outside the picks and, at column idx_j of row t,
//     d p_j = dw_j / c + [s >= 1e-9] sum_i -dw_i ((p_i / c) / c),
// the plain gradient's operations (PyTorch's division backward, per pick,
// the clamp's mask, the sum's broadcast), with the two sums over the picks
// taken in pick order (the forward's order for s; PyTorch's reduction may
// sum the second in another). The forward kernel's indices are read back,
// not recomputed.
//
// What bounds it on the card: bytes, the T E * 4 of the written gradient
// above all (plus T k * 12 read: idx, dw and the picked scores); a few
// operations per pick. Design: one warp per token row, 4 rows a block.
// Lane j < k reads its pick's index, weight cotangent and score; every lane
// takes s and the dc sum from the lanes by shuffles in pick order, then
// every pick's (index, gradient); the warp writes the row once, each lane
// its columns l, l + 32, ..., a column taking the value of the pick that
// names it, else 0 (a row's indices are
// distinct, so no column is written twice and nothing is atomic).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // token rows per block
constexpr int kMaxExperts = 1024;
constexpr int kMaxK = 16;
constexpr unsigned kFull = 0xffffffffu;
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

__global__ void __launch_bounds__(kWarps * 32)
router_bwd_kernel(const float* __restrict__ scores, const int* __restrict__ idx,
                  const float* __restrict__ dw, float* __restrict__ dscores, int T, int E,
                  int k) {
  const int lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;   // a whole warp leaves together
  int e = -1;
  float p = 0.0f, g = 0.0f;
  if (lane < k) {
    e = idx[t * k + lane];
    g = dw[t * k + lane];
    p = scores[t * E + e];
  }
  // s and the clamp's c, then the division backward's per-pick terms
  // summed in pick order
  float s = 0.0f;
  for (int j = 0; j < k; ++j) s = __fadd_rn(s, __shfl_sync(kFull, p, j));
  const float c = fmaxf(s, 1e-9f);
  const float term = __fmul_rn(-g, __fdiv_rn(__fdiv_rn(p, c), c));
  float dc = 0.0f;
  for (int j = 0; j < k; ++j) dc = __fadd_rn(dc, __shfl_sync(kFull, term, j));
  const float ds = s >= 1e-9f ? dc : 0.0f;
  const float dp = __fadd_rn(__fdiv_rn(g, c), ds);
  // every lane holds the picks (a lane past k holds e = -1, no column)
  int ej[kMaxK];
  float dj[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    ej[j] = __shfl_sync(kFull, e, j);
    dj[j] = __shfl_sync(kFull, dp, j);
  }
  float* row = dscores + t * E;
  for (int col = lane; col < E; col += 32) {
    float out = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) out = ej[j] == col ? dj[j] : out;
    row[col] = out;
  }
}

}  // namespace

// scores [T, E] fp32, idx [T, k] int32 (the forward's selection), dw [T, k]
// fp32; dscores [T, E] fp32 is written. Returns cudaGetLastError() after
// the launch (0 on success; 0 without a launch for T = 0), or kErrShape
// for a shape beyond the kernel's limits (T below 0, E below 1 or above
// 1024, k below 1 or above min(E, 16)). The Python wrapper turns kErrShape
// into a ValueError.
extern "C" int xbof_topk_router_bwd(const void* scores, const void* idx, const void* dw,
                                    void* dscores, int T, int E, int k, void* stream) {
  if (T < 0 || E < 1 || E > kMaxExperts || k < 1 || k > kMaxK || k > E) return kErrShape;
  if (T == 0) return 0;
  const int blocks = T / kWarps + (T % kWarps != 0);
  router_bwd_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(idx),
      static_cast<const float*>(dw), static_cast<float*>(dscores), T, E, k);
  return static_cast<int>(cudaGetLastError());
}
