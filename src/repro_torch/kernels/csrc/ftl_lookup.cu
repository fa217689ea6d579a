// FTL address translation for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU Pallas kernel `ftl_lookup` of
// src/repro/kernels/ftl_lookup.py. Plain version:
// src/repro_torch/kernels/ref.py (`ftl_lookup`); Python wrapper:
// kernels/ftl_lookup.py.
//
// What it computes: batched LPN -> PPN translation through a segment
// directory and the cached mapping pages. Per LPN,
//     seg = lpn // entries,  off = lpn % entries  (both floored),
//     slot = directory[seg], ppn = mapping_cache[slot, off],
// and a slot of -1 is a miss: ppn -1, hit false. lpns [N], directory
// [n_seg] and mapping_cache [n_slots, entries] are int32; ppn [N] int32
// and hit [N] bool (one byte) are written. Out-of-range indices follow the
// reference's jnp gathers (`ref.ftl_lookup`): a negative segment wraps
// once and is then clamped into [0, n_seg), and the slot is clamped into
// [0, n_slots). The result is exact int32. The TPU kernel instead walks
// both tables with one-hot matmuls through fp32, which rounds PPNs of 2^24
// and above (a 4 TB SSD has some 2^30 slices), and gives an out-of-range
// segment slot 0 and a hit, since no one-hot column matches it.
//
// What bounds it on the card: per LPN it reads the LPN, one directory
// entry and one mapping entry and writes a PPN and a hit, 17 bytes, and
// does a few integer operations: bytes bound it. But the two reads are
// random gathers, each of which pulls a whole 32-byte sector for its 4
// bytes: the cache-line traffic is up to 64 + 9 bytes per LPN, and the
// directory (7.4 KB for a 4 TB SSD) stays in L2.
//
// Design (simple and right first): one thread per LPN, a directory
// gather, a mapping-cache gather (skipped on a miss), the miss test.
// Neighbouring threads take neighbouring LPNs, so the LPN loads and the
// PPN and hit stores are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

__global__ void __launch_bounds__(kThreads)
ftl_kernel(const int* __restrict__ lpns, const int* __restrict__ directory,
           const int* __restrict__ cache, int* __restrict__ ppn_out,
           unsigned char* __restrict__ hit_out, int64_t N, int n_seg,
           int n_slots, int entries) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  const int lpn = lpns[i];
  // floored division and remainder, as jnp's // and % on int32
  int seg = lpn / entries;
  int off = lpn % entries;
  if (off < 0) {
    off += entries;
    seg -= 1;
  }
  if (seg < 0) seg += n_seg;                   // a negative index wraps once
  seg = min(max(seg, 0), n_seg - 1);           // then clamps
  const int slot = directory[seg];
  const bool hit = slot >= 0;
  int ppn = -1;
  if (hit) {
    const int s = min(slot, n_slots - 1);
    ppn = cache[static_cast<int64_t>(s) * entries + off];
  }
  ppn_out[i] = ppn;
  hit_out[i] = hit ? 1 : 0;
}

}  // namespace

// lpns [N], directory [n_seg], mapping_cache [n_slots, entries], all
// int32; ppn [N] int32 and hit [N] bool (one byte each) are written.
// Returns cudaGetLastError() after the launch (0 on success; 0 without a
// launch for N = 0), or kErrShape for a shape beyond the kernel's limits
// (N below 0, n_seg, n_slots or entries below 1, or more than 2^31 - 1
// blocks). The Python wrapper turns kErrShape into a ValueError.
extern "C" int xbof_ftl_lookup(const void* lpns, const void* directory,
                               const void* mapping_cache, void* ppn, void* hit,
                               int64_t N, int n_seg, int n_slots, int entries,
                               void* stream) {
  if (N < 0 || n_seg < 1 || n_slots < 1 || entries < 1) return kErrShape;
  if (N == 0) return 0;
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return kErrShape;
  ftl_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lpns), static_cast<const int*>(directory),
      static_cast<const int*>(mapping_cache), static_cast<int*>(ppn),
      static_cast<unsigned char*>(hit), N, n_seg, n_slots, entries);
  return static_cast<int>(cudaGetLastError());
}
