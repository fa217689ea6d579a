// SHARDS window scan for Hopper (sm_90a), with a plain C interface.
//
// Stands for the reference's `lax.scan` over a window of references
// (src/repro/core/shards_mrc.py:115, vmapped over nodes by
// src/repro/telemetry/windows.py:90); no TPU kernel backs it there, XLA
// compiles the scan into one device loop. Plain version:
// src/repro_torch/kernels/ref.py (`shards_window`); Python wrapper:
// kernels/shards_window.py.
//
// What it computes, per node, in reference order: fixed-size SHARDS over
// one window. The node's table holds K sampled addresses (uint32, all ones
// = empty) with their last-access times, and a B-bucket reuse-distance
// histogram, a cold-miss count and a reference total (float32). A masked
// reference changes nothing; a valid one advances the clock; it is sampled
// iff hash(a) % sample_mod < sample_thresh, hash(a) = h ^ (h >> 16) with
// h = a * 2654435761 (mod 2^32). A sampled reference looks up its row (the
// first matching one), its previous time my_last (the largest last_seen
// among matches, -1 on a miss) and its distance (non-empty rows with
// last_seen > my_last); a hit adds inv_rate to bucket clip(int(dist *
// scale), 0, B - 1), a miss adds it to cold, both to total; then the row
// (on a miss the first row of least last_seen) takes the address and the
// clock. `scale` and `inv_rate` come from the wrapper as float32, the
// factors the reference's compiled code uses.
//
// What bounds it on the card: each sampled reference depends on the table
// the one before it left, so a node is one serial chain of dependent warp
// reductions; bytes (the window read once, the state read and written
// once) are a few KB a node. It is latency-bound.
//
// Design (simple and right first): one warp per node (a block of 32
// threads). The table and the histogram sit in shared memory (opted in
// past 48 KB, up to the card's limit per block); lane l
// holds rows l, l + 32, ... The window is read 32 references at a time,
// one per lane: each lane hashes its own, and two ballots give the valid
// and the sampled lanes. The clock at the i-th reference of the chunk is
// the clock before it plus the valid references ahead of it (a popcount),
// so unsampled references cost nothing more. The sampled ones are taken
// in order: the address is broadcast, one pass over the rows finds each
// lane's first match, its largest matching last_seen and its first least
// last_seen, redux.sync (min, max) merges them; a second pass counts the
// newer rows (redux.sync add). Lane 0 then does the float32 adds in
// reference order (__fadd_rn, __fmul_rn: no contraction) and writes the
// row. Every lane runs every reduction: the loops are warp-uniform.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmpty = 0xffffffffu;
constexpr unsigned kHashMult = 2654435761u;
constexpr int kNone = 0x7fffffff;
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;
// shared memory a block may take without opting in
constexpr int64_t kDefaultShared = 48 * 1024;

__global__ void __launch_bounds__(32)
shards_window_kernel(const int64_t* __restrict__ addrs_in,
                     const int* __restrict__ last_in,
                     const int* __restrict__ clock_in,
                     const float* __restrict__ hist_in,
                     const float* __restrict__ cold_in,
                     const float* __restrict__ total_in,
                     const int64_t* __restrict__ refs,
                     const unsigned char* __restrict__ mask,
                     int64_t* __restrict__ addrs_out, int* __restrict__ last_out,
                     int* __restrict__ clock_out, float* __restrict__ hist_out,
                     float* __restrict__ cold_out, float* __restrict__ total_out,
                     int K, int B, int A, unsigned sample_mod,
                     unsigned sample_thresh, float scale, float inv_rate) {
  extern __shared__ unsigned smem[];
  unsigned* tab = smem;                                      // [K] addresses
  int* seen = reinterpret_cast<int*>(smem + K);              // [K] last_seen
  float* hist = reinterpret_cast<float*>(smem + 2 * K);      // [B]
  const int lane = threadIdx.x;
  const int64_t node = blockIdx.x;

  for (int i = lane; i < K; i += 32) {
    tab[i] = static_cast<unsigned>(addrs_in[node * K + i]);
    seen[i] = last_in[node * K + i];
  }
  for (int i = lane; i < B; i += 32) hist[i] = hist_in[node * B + i];
  int clock = clock_in[node];
  float cold = cold_in[node];
  float total = total_in[node];
  __syncwarp();

  for (int base = 0; base < A; base += 32) {
    const int j = base + lane;
    bool valid = false;
    unsigned a = 0;
    if (j < A) {
      valid = mask[node * A + j] != 0;
      a = static_cast<unsigned>(refs[node * A + j]);
    }
    unsigned h = a * kHashMult;
    h ^= h >> 16;
    const bool sampled = valid && (h % sample_mod) < sample_thresh;
    const unsigned vball = __ballot_sync(kFull, valid);
    unsigned sball = __ballot_sync(kFull, sampled);
    while (sball) {
      const int src = __ffs(sball) - 1;
      sball &= sball - 1;
      const unsigned ar = __shfl_sync(kFull, a, src);
      const int clk = clock + __popc(vball & ((1u << src) - 1u));
      // pass 1: first match, largest matching last_seen, first least
      // last_seen (the eviction candidate)
      int first = kNone, mx = -1, least = kNone, least_at = kNone;
      for (int i = lane; i < K; i += 32) {
        const int s = seen[i];
        if (tab[i] == ar) {
          first = min(first, i);
          mx = max(mx, s);
        }
        if (s < least) {
          least = s;
          least_at = i;
        }
      }
      const int hit_row = static_cast<int>(
          __reduce_min_sync(kFull, static_cast<unsigned>(first)));
      const bool hit = hit_row != kNone;
      const int my_last = hit ? __reduce_max_sync(kFull, mx) : -1;
      const int least_all = __reduce_min_sync(kFull, least);
      const int evict = static_cast<int>(__reduce_min_sync(
          kFull, static_cast<unsigned>(least == least_all ? least_at : kNone)));
      // pass 2: the distance, non-empty rows seen after my_last
      unsigned newer = 0;
      for (int i = lane; i < K; i += 32)
        newer += (seen[i] > my_last && tab[i] != kEmpty) ? 1u : 0u;
      const unsigned dist = __reduce_add_sync(kFull, newer);
      if (lane == 0) {
        if (hit) {
          int b = __float2int_rz(__fmul_rn(static_cast<float>(dist), scale));
          b = min(max(b, 0), B - 1);
          hist[b] = __fadd_rn(hist[b], inv_rate);
        }
        const int row = hit ? hit_row : evict;
        tab[row] = ar;
        seen[row] = clk;
      }
      if (!hit) cold = __fadd_rn(cold, inv_rate);
      total = __fadd_rn(total, inv_rate);
      __syncwarp();
    }
    clock += __popc(vball);
  }

  for (int i = lane; i < K; i += 32) {
    addrs_out[node * K + i] = static_cast<int64_t>(tab[i]);
    last_out[node * K + i] = seen[i];
  }
  for (int i = lane; i < B; i += 32) hist_out[node * B + i] = hist[i];
  if (lane == 0) {
    clock_out[node] = clock;
    cold_out[node] = cold;
    total_out[node] = total;
  }
}

}  // namespace

// State in: addrs [n, K] int64 (values in [0, 2^32)), last_seen [n, K]
// int32, clock [n] int32, hist [n, B], cold [n], total [n] float32; the
// window: refs [n, A] int64 (taken mod 2^32), mask [n, A] bool (one byte).
// The same state out, into separate buffers. Returns cudaGetLastError()
// after the launch (0 on success; 0 without a launch for n = 0), or
// kErrShape for a shape beyond the kernel's limits (n or A below 0, K or B
// below 1, sample_mod below 1, a table and histogram, (2K + B) * 4 bytes,
// past the card's opt-in shared memory per block — 227 KB on an H100, so
// K <= 29,048 with B = 16 — or n past 2^31 - 1 blocks). Past 48 KB the
// entry opts the kernel into more shared memory first. The Python wrapper
// turns kErrShape into a ValueError.
extern "C" int xbof_shards_window(
    const void* addrs_in, const void* last_in, const void* clock_in,
    const void* hist_in, const void* cold_in, const void* total_in,
    const void* refs, const void* mask, void* addrs_out, void* last_out,
    void* clock_out, void* hist_out, void* cold_out, void* total_out,
    int64_t n, int K, int B, int A, int sample_mod, int sample_thresh,
    float scale, float inv_rate, void* stream) {
  if (n < 0 || A < 0 || K < 1 || B < 1 || sample_mod < 1) return kErrShape;
  const int64_t shared = (2 * static_cast<int64_t>(K) + B) * 4;
  if (n > 2147483647LL) return kErrShape;
  if (shared > kDefaultShared) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (shared > optin) return kErrShape;
    e = cudaFuncSetAttribute(shards_window_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n == 0) return 0;
  // a threshold below 0 samples nothing; the unsigned compare needs 0
  const unsigned thresh = sample_thresh < 0 ? 0u : static_cast<unsigned>(sample_thresh);
  shards_window_kernel<<<static_cast<unsigned>(n), 32, static_cast<size_t>(shared),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(addrs_in), static_cast<const int*>(last_in),
      static_cast<const int*>(clock_in), static_cast<const float*>(hist_in),
      static_cast<const float*>(cold_in), static_cast<const float*>(total_in),
      static_cast<const int64_t*>(refs), static_cast<const unsigned char*>(mask),
      static_cast<int64_t*>(addrs_out), static_cast<int*>(last_out),
      static_cast<int*>(clock_out), static_cast<float*>(hist_out),
      static_cast<float*>(cold_out), static_cast<float*>(total_out), K, B, A,
      static_cast<unsigned>(sample_mod), thresh, scale, inv_rate);
  return static_cast<int>(cudaGetLastError());
}
