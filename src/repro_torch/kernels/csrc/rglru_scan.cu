// RG-LRU linear recurrence for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU Pallas kernel `rglru` of src/repro/kernels/rglru_scan.py.
// Plain version: src/repro_torch/kernels/ref.py (`rglru`); Python wrapper:
// kernels/rglru_scan.py.
//
// What it computes: for x, a [B, T, W] (fp32 or bf16, one dtype) and an
// optional h0 [B, W] (fp32), per (b, w) the recurrence
//     h_t = a_t * h_{t-1} + g_t,  g_t = sqrt(max(1 - a_t^2, 0)) * x_t,
// from h_{-1} = h0 or 0, carried in fp32 over the whole sequence (the TPU
// kernel's fp32 carry row), each h_t stored in x's dtype as out[b, t, w].
// The final state h_T is out[:, -1], already rounded to x's dtype, as in
// the TPU kernel; the wrapper returns that view. Every operation is the
// plain version's IEEE operation, in its order (a * a, 1 - that, clamp,
// sqrt, times x; a * h, plus g), written with round-to-nearest intrinsics
// so that nvcc contracts nothing into an FMA: the result is the plain
// version's bit for bit, in both dtypes.
//
// What bounds it on the card: it reads x and a and writes out once, 7 fp32
// operations per element against 6 (bf16) or 12 (fp32) bytes, far below
// the H100's balance, so bytes bound it (about 0.06 ms for the
// recurrentgemma-9b prefill's [4, 2048, 4096] bf16 at 3.35 TB/s). The
// recurrence itself is one multiply and one add per step, some 8 cycles:
// 2048 steps take about 10 us, well under the byte bound. What keeps a
// plain walk from the bound is load latency (too few bytes in flight) and
// per-element work that does not overlap the loads.
//
// Design: split the work, not the order. A block takes kC = 64 channels of
// one batch row (a 128-byte bf16 row) and walks all of T in chunks of kTc
// = 32 steps, so [4, 2048, 4096] makes 256 blocks, about two per SM.
// - Producer warps (4) copy each chunk's x and a tiles into a ring of
//   kRawStages shared-memory stages with cp.async, kRawStages - 1 chunks
//   ahead (24 KB in flight per bf16 block). Each thread copies 4-channel
//   quads and later reads back only what it copied itself, so the ring
//   needs no barrier. For each element they compute, in fp32, a and g and
//   store them into an (a, g) stage, in [t][channel] planes.
// - Consumer threads, one per channel (2 warps), walk the stage's steps:
//   h = a * h + g, stored in x's dtype at every step, coalesced along W.
// - The (a, g) ring has kAgStages stages, handed over with mbarriers: a
//   `full` barrier per stage that the producers arrive on, an `empty` one
//   that the consumers arrive on; chunk k waits on parity (k / kAgStages)
//   & 1.
// Any B, T >= 1 and W >= 1 are taken: a ragged last chunk (rows past T are
// zero-filled and not walked), a ragged last channel tile (channels past W
// zero-filled and not stored), and views whose rows do not start on 16
// bytes: the copy width kVB (bytes) is the widest that the pointers and the
// row pitch allow, down to a plain 2-byte load for an odd bf16 offset.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                 // channels per block, one per consumer thread
constexpr int kTc = 32;                // steps per chunk
constexpr int kProducers = 128;        // producer threads (4 warps)
constexpr int kThreads = kC + kProducers;
constexpr int kRawStages = 4;          // x, a tiles: kRawStages - 1 chunks in flight
constexpr int kAgStages = 2;           // (a, g) tiles handed to the consumers
constexpr int kQuads = kTc * kC / 4 / kProducers;  // 4-channel quads per producer and chunk
constexpr int kBarBytes = 128;         // the mbarriers, ahead of the tiles
static_assert(kC % 32 == 0 && (kTc * kC / 4) % kProducers == 0, "tile shape");
// returned by the C entry for a shape beyond the kernel's limits
constexpr int kErrShape = -1;

template <typename T>
constexpr size_t smem_bytes() {
  return kBarBytes + 2 * kAgStages * kTc * kC * sizeof(float) +
         2 * kRawStages * kTc * kC * sizeof(T);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 4 values of a quad in shared memory, as fp32 (bf16 -> fp32 is exact)
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// g = sqrt(max(1 - a * a, 0)) * x, in the plain version's IEEE operations
__device__ __forceinline__ float gain_x(float a, float x) {
  return __fmul_rn(sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f)), x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy kVB bytes global -> shared, or write zeros when !in (src is then
// never read). 16, 8 and 4 bytes go by cp.async; 2 bytes (a bf16 view on
// an odd element) by a plain load and store.
template <int kVB>
__device__ __forceinline__ void copy(void* dst, const void* src, bool in) {
  if constexpr (kVB == 2) {
    *static_cast<uint16_t*>(dst) = in ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  } else if constexpr (kVB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(kVB), "r"(in ? kVB : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

template <typename T, int kVB>
__global__ void __launch_bounds__(kThreads, 2)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ a,
             const float* __restrict__ h0, T* __restrict__ out, int T_len, int W,
             int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kAgStages;
  float* a_s = reinterpret_cast<float*>(smem + kBarBytes);  // [kAgStages][kTc][kC]
  float* g_s = a_s + kAgStages * kTc * kC;
  T* x_raw = reinterpret_cast<T*>(g_s + kAgStages * kTc * kC);  // [kRawStages][kTc][kC]
  T* a_raw = x_raw + kRawStages * kTc * kC;

  const int b = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - b * tiles) * kC;
  const int n_chunks = (T_len + kTc - 1) / kTc;
  const int64_t row0 = static_cast<int64_t>(b) * T_len;  // row of (b, t = 0)

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAgStages; ++s) {
      bar_init(&full[s], kProducers);
      bar_init(&empty[s], kC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (warp < kC / 32) {
    // ---- consumer: one channel, the recurrence in fp32
    const int c = c0 + threadIdx.x;
    const bool live = c < W;
    float h = (h0 != nullptr && live) ? h0[static_cast<int64_t>(b) * W + c] : 0.0f;
    T* o = out + row0 * W + c;
    for (int k = 0; k < n_chunks; ++k) {
      const int s = k % kAgStages;
      bar_wait(&full[s], (k / kAgStages) & 1);
      const float* as = a_s + s * kTc * kC + threadIdx.x;
      const float* gs = g_s + s * kTc * kC + threadIdx.x;
      const int n = min(kTc, T_len - k * kTc);
      if (n == kTc) {
#pragma unroll
        for (int i = 0; i < kTc; ++i) {
          h = __fadd_rn(__fmul_rn(as[i * kC], h), gs[i * kC]);
          if (live) o[static_cast<int64_t>(i) * W] = from_f32<T>(h);
        }
      } else {  // the ragged last chunk
        for (int i = 0; i < n; ++i) {
          h = __fadd_rn(__fmul_rn(as[i * kC], h), gs[i * kC]);
          if (live) o[static_cast<int64_t>(i) * W] = from_f32<T>(h);
        }
      }
      bar_arrive(&empty[s]);
      o += static_cast<int64_t>(kTc) * W;
    }
    return;
  }

  // ---- producers: chunk tiles in, (a, g) out
  const int tp = threadIdx.x - kC;
  constexpr int kPer = kVB / static_cast<int>(sizeof(T));  // elements per copy
  static_assert(kPer >= 1 && 4 % kPer == 0, "a copy is 1, 2 or 4 elements of a quad");
  // copy chunk k's quads of this thread into raw stage k % kRawStages
  auto load_chunk = [&](int k) {
    const int stage = (k % kRawStages) * kTc * kC;
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int q = tp + i * kProducers;
      const int r = q / (kC / 4), col = (q % (kC / 4)) * 4;
      const int t = k * kTc + r;
      const int64_t off = (row0 + t) * W + c0 + col;
#pragma unroll
      for (int j = 0; j < 4; j += kPer) {
        const bool in = t < T_len && c0 + col + j < W;
        const int64_t src = in ? off + j : 0;
        copy<kVB>(x_raw + stage + r * kC + col + j, x + src, in);
        copy<kVB>(a_raw + stage + r * kC + col + j, a + src, in);
      }
    }
  };
#pragma unroll
  for (int k = 0; k < kRawStages - 1; ++k) {
    if (k < n_chunks) load_chunk(k);
    cp_async_commit();
  }
  for (int k = 0; k < n_chunks; ++k) {
    if (k + kRawStages - 1 < n_chunks) load_chunk(k + kRawStages - 1);
    cp_async_commit();
    cp_async_wait<kRawStages - 1>();  // this thread's copies of chunk k have landed
    const int s = k % kAgStages;
    if (k >= kAgStages) bar_wait(&empty[s], ((k / kAgStages) + 1) & 1);
    const int stage = (k % kRawStages) * kTc * kC;
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int q = tp + i * kProducers;
      const int r = q / (kC / 4), col = (q % (kC / 4)) * 4;
      const float4 xv = load_quad(x_raw + stage + r * kC + col);
      const float4 av = load_quad(a_raw + stage + r * kC + col);
      const float4 gv = make_float4(gain_x(av.x, xv.x), gain_x(av.y, xv.y),
                                    gain_x(av.z, xv.z), gain_x(av.w, xv.w));
      const int at = (s * kTc + r) * kC + col;
      *reinterpret_cast<float4*>(a_s + at) = av;
      *reinterpret_cast<float4*>(g_s + at) = gv;
    }
    bar_arrive(&full[s]);
  }
  cp_async_wait<0>();
}

template <typename T, int kVB>
int launch_vb(const void* x, const void* a, const float* h0, void* out, int B,
              int T_len, int W, cudaStream_t stream) {
  const int64_t tiles = (static_cast<int64_t>(W) + kC - 1) / kC;
  const int64_t blocks = static_cast<int64_t>(B) * tiles;
  if (blocks > 2147483647LL) return kErrShape;
  constexpr size_t smem = smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_kernel<T, kVB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_kernel<T, kVB><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), h0, static_cast<T*>(out), T_len, W,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// the widest copy (bytes, at most a quad of 4 elements) that x's and a's
// addresses and the row pitch W * sizeof(T) are all aligned to
template <typename T>
int launch(const void* x, const void* a, const float* h0, void* out, int B, int T_len,
           int W, cudaStream_t stream) {
  const uint64_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a) |
                        static_cast<uint64_t>(W) * sizeof(T);
  if constexpr (sizeof(T) == 4) {
    if (bits % 16 == 0) return launch_vb<T, 16>(x, a, h0, out, B, T_len, W, stream);
    if (bits % 8 == 0) return launch_vb<T, 8>(x, a, h0, out, B, T_len, W, stream);
    return launch_vb<T, 4>(x, a, h0, out, B, T_len, W, stream);
  } else {
    if (bits % 8 == 0) return launch_vb<T, 8>(x, a, h0, out, B, T_len, W, stream);
    if (bits % 4 == 0) return launch_vb<T, 4>(x, a, h0, out, B, T_len, W, stream);
    return launch_vb<T, 2>(x, a, h0, out, B, T_len, W, stream);
  }
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (x, a and out alike); h0 is fp32 [B, W] or
// null for zeros. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for an unknown kind, or kErrShape for a
// shape beyond the kernel's limits (B, T or W below 1, or more than
// 2^31 - 1 blocks). The Python wrapper turns kErrShape into a ValueError.
extern "C" int xbof_rglru(int kind, const void* x, const void* a,
                          const void* h0, void* out, int B, int T, int W,
                          void* stream) {
  if (B < 1 || T < 1 || W < 1) return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  switch (kind) {
    case 0: return launch<float>(x, a, h, out, B, T, W, s);
    case 1: return launch<__nv_bfloat16>(x, a, h, out, B, T, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
