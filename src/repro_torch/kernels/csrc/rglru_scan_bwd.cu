// The RG-LRU recurrence's backward pass for Hopper (sm_90a), with a plain C
// interface.
//
// No TPU kernel behind it: the reference trains through XLA's autodiff of
// its jnp oracle (src/repro/kernels/ref.py, `rglru`), and these kernels
// stand for that gradient beside the forward kernel of csrc/rglru_scan.cu.
// Plain version: src/repro_torch/kernels/ref.py (`rglru_bwd`); Python
// wrapper: kernels/rglru_scan.py (`rglru_bwd`, and `RGLRU`, the autograd
// Function that launches it).
//
// What it computes: for x, a [B, T, W] (fp32 or bf16, one dtype), the
// optional h0 [B, W] (fp32) and the cotangent dout [B, T, W] of the
// forward's out (h_t = a_t h_{t-1} + s_t x_t, s_t = sqrt(max(1 - a_t^2,
// 0))), walking t from T - 1 down to 0 per (b, w):
//     g_t  = dout_t + a_{t+1} g_{t+1}                (g_{T-1} = dout_{T-1})
//     dx_t = g_t s_t
//     da_t = 2 (-(g_t x_t / (2 s_t)) [1 - a_t^2 >= 0]) a_t + g_t h_{t-1}
//     dh0  = a_0 g_0
// with h_{-1} = h0 (or 0). These are the plain gradient's IEEE operations
// in its order (PyTorch's autograd of the plain forward: the sqrt's
// backward grad / (2 s), the clamp's mask where 1 - a^2 >= 0, the two
// halves of a * a's product summed before a * h's term), written with
// round-to-nearest intrinsics so that nvcc contracts nothing into an FMA:
// dx, da and dh0 are the plain gradient's, value for value, NaN where it
// has NaN. At |a| = 1, s = 0 and da is -inf or +inf (NaN where x = 0),
// what the reference's autodiff gives there too; bf16 rounds an a near 1
// to exactly 1, so these values do occur in training.
//
// What bounds it on the card: bytes. The gradient must read x, a and dout
// and write dx and da: 10 bytes an element in bf16 (20 in fp32), with some
// 20 fp32 operations an element, two of them IEEE (a sqrt, a division).
// Only two things in it are sequential: the state chain h_t = a_t h_{t-1}
// + s_t x_t and the cotangent chain g_t = dout_t + a_{t+1} g_{t+1}, one
// float a channel each, two dependent operations a step. Everything else
// is independent across (t, w) once h_{t-1} and g_t are known.
//
// Design: the chains split from the work, in two launches on the stream.
// - Phase A, `rglru_bwd_chains`: a block walks one chain over all of T for
//   kC = 32 channels of one batch row; the state chain's blocks and the
//   cotangent chain's alternate in the grid, so [1, T, 4096] makes 256
//   blocks, about two an SM (64 channels would leave half the SMs idle).
//   Producer warps (8) stream chunks of kTc = 64 rows into a 64 KB
//   shared-memory ring with cp.async (x and a for the state chain, dout
//   and a for the cotangent chain, kRaw - 1 chunks ahead: 56 KB in flight
//   a bf16 block, 48 KB fp32), each thread the same 4-channel quads of
//   every chunk, as the forward kernel does, and turn each element into
//   its fp32 terms (a and s x, or a and dout) in an (a, v) stage handed
//   over with mbarriers. One consumer warp, a thread a channel, loads a
//   stage into registers, hands it back and walks it: the chain's two
//   dependent operations a step and nothing else. The state chain keeps
//   the fp32 h at the start of every group of kG = 8 rows (h_{t0-1} of
//   the group's first row t0) in ck_h [B, ceil(T / kG), W]; the cotangent
//   chain, walking back from the last row, keeps the carry that enters
//   every group's last row, a_{t1+1} g_{t1+1} for its last row t1 (+0 for
//   the last group, the 0 * 0 of a walk that starts at T - 1), in ck_g of
//   the same shape, and writes dh0 = a_0 g_0, the carry out of row 0.
// - Phase B, `rglru_bwd_groups`: a thread a (b, group, channel), 128
//   channels a block, every group at once (512 x 4096 walks of kG rows at
//   [1, 4096, 4096]). It loads the group's rows of x, a and dout together
//   (24 loads in flight a thread, 58 registers, 8 blocks an SM), walks h
//   forward from the group's state snapshot keeping h_{t-1} and s of every
//   row in registers (one sqrt an element), then walks g back from the
//   group's carry, writing dx and da once. It reads x, a and dout and
//   writes dx and da, the kernel's 10 bytes an element, plus the snapshots
//   (1 byte an element).
// - sqrtf and the IEEE division each check their operands and send what
//   their fast path cannot take to a slow path, a call that the whole warp
//   takes when one lane needs it. |a| = 1 (s = 0: a sqrt of 0, a divisor
//   of 0) and x = 0 (a dividend of 0) would send nearly every warp there
//   (bf16 rounds an a near 1 to 1); both phases take those values by
//   selects that give the same IEEE results (`gain`, the quotient in
//   `rglru_bwd_groups`).
// Measured on an H100 (scripts/rglru_bwd_bench.py, PERF.md): a group of
// 16 rows held 99 registers, 4 blocks an SM, and left phase B
// latency-bound; 8 rows run it at about the card's memory rate. 4
// producer warps, or a walk that read its operands from shared memory
// step by step, left phase A waiting on its producers.
// Every h_{t-1} and every g_t is the same bits as a straight walk's: both
// phases repeat the forward step (a * h + s * x) and the cotangent step
// (dout + g * a) in the same operations and order, and each snapshot is
// the very float the straight walk carries across the group's edge. No
// atomics and no reduction: two calls give the same bits.
//
// Any B (up to 65535, the grid's y), T >= 1 and W >= 1 are taken: a ragged
// last group and chunk (rows past T zero-filled and not walked), a ragged
// last channel tile (channels past W walked on zeros and not stored), T <
// kG. The wrapper takes any contiguous view: phase A's copy width kVB
// (bytes) is the widest that x's, a's and dout's addresses and the row
// pitch allow, down to a plain 2-byte load for an odd bf16 offset; phase B
// loads element by element, any alignment.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG = 8;                  // rows a group: the snapshots' spacing, phase B's walk
// ---- phase A
constexpr int kC = 32;                 // channels a chain block, one consumer thread each
constexpr int kTc = 64;                // rows a chunk
constexpr int kProducers = 256;        // producer threads (8 warps)
constexpr int kThreads = kC + kProducers;
constexpr int kAgStages = 2;           // (a, v) stages handed to the consumers
constexpr int kRawBytes = 65536;       // the raw ring: 8 bf16 stages, 4 fp32
constexpr int kQuads = kTc * kC / 4 / kProducers;  // 4-channel quads a producer and chunk
constexpr int kBarBytes = 128;         // the mbarriers, ahead of the tiles
static_assert(kC == 32 && (kTc * kC / 4) % kProducers == 0, "tile shape");
static_assert(kTc % kG == 0, "a chunk holds whole groups");
// ---- phase B
constexpr int kGThreads = 128;         // channels a group block
// returned by the C entry for a shape beyond the kernels' limits
constexpr int kErrShape = -1;

template <typename T>
__host__ __device__ constexpr int raw_stages() {
  return kRawBytes / (2 * kTc * kC * static_cast<int>(sizeof(T)));
}

template <typename T>
constexpr size_t smem_bytes() {
  return kBarBytes + 2 * kAgStages * kTc * kC * sizeof(float) +
         2 * raw_stages<T>() * kTc * kC * sizeof(T);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// s = sqrt(max(1 - a * a, 0)) and its argument u = 1 - a * a, in the
// plain version's IEEE operations (the forward's `gain_x` times x). sqrtf
// sends an operand of 0 to its slow path (a call, which the whole warp
// then takes), and u = 0 wherever |a| = 1 (bf16 rounds an a near 1 to
// 1): such an operand takes sqrtf(1) and a select gives sqrt(0) = 0.
__device__ __forceinline__ float one_minus_sq(float a) {
  return __fsub_rn(1.0f, __fmul_rn(a, a));
}
__device__ __forceinline__ float gain(float u) {
  const float m = fmaxf(u, 0.0f);
  const float r = sqrtf(m > 0.0f ? m : 1.0f);
  return m > 0.0f ? r : 0.0f;
}
__device__ __forceinline__ float gain_x(float a, float x) {
  return __fmul_rn(gain(one_minus_sq(a)), x);
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

// Phase A. Grid (2 * tiles, B): even blocks walk the state chain of
// channel tile blockIdx.x / 2, odd ones its cotangent chain.
template <typename T, int kVB>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_chains(const T* __restrict__ x, const T* __restrict__ a,
                 const float* __restrict__ h0, const T* __restrict__ dout,
                 float* __restrict__ dh0, float* __restrict__ ck_h, float* __restrict__ ck_g,
                 int T_len, int W) {
  constexpr int kRaw = raw_stages<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kAgStages;
  float* a_s = reinterpret_cast<float*>(smem + kBarBytes);  // [kAgStages][kTc][kC]
  float* v_s = a_s + kAgStages * kTc * kC;                  // s x, or dout
  T* v_raw = reinterpret_cast<T*>(v_s + kAgStages * kTc * kC);  // [kRaw][kTc][kC]: x or dout
  T* a_raw = v_raw + kRaw * kTc * kC;

  const bool state = (blockIdx.x & 1) == 0;  // uniform in the block
  const int c0 = (blockIdx.x >> 1) * kC;
  const int b = blockIdx.y;
  const int n_chunks = (T_len + kTc - 1) / kTc;
  const int n_groups = (T_len + kG - 1) / kG;
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

  if (warp == 0) {
    // ---- consumer: one channel's chain in fp32. Chunk k of the walk is
    // stage k % kAgStages; the state chain takes the chunks first to last,
    // the cotangent chain last to first.
    const int c = c0 + threadIdx.x;
    const bool live = c < W;
    float* ck = (state ? ck_h : ck_g) + static_cast<int64_t>(b) * n_groups * W + c;
    if (state) {
      float h = (h0 != nullptr && live) ? h0[static_cast<int64_t>(b) * W + c] : 0.0f;
      for (int k = 0; k < n_chunks; ++k) {
        const int s = k % kAgStages;
        bar_wait(&full[s], (k / kAgStages) & 1);
        const float* as = a_s + s * kTc * kC + threadIdx.x;
        const float* vs = v_s + s * kTc * kC + threadIdx.x;
        float* ckk = ck + static_cast<int64_t>(k) * (kTc / kG) * W;
        const int n = min(kTc, T_len - k * kTc);
        if (n == kTc) {
          // the stage into registers first, so that its loads issue back to
          // back and the stage goes back to the producers before the walk
          float ar[kTc], vr[kTc];
#pragma unroll
          for (int i = 0; i < kTc; ++i) {
            ar[i] = as[i * kC];
            vr[i] = vs[i * kC];
          }
          bar_arrive(&empty[s]);
          float snap[kTc / kG];  // stored after the walk, which then holds no store
#pragma unroll
          for (int i = 0; i < kTc; ++i) {
            if (i % kG == 0) snap[i / kG] = h;
            h = __fadd_rn(__fmul_rn(ar[i], h), vr[i]);
          }
          if (live) {
#pragma unroll
            for (int j = 0; j < kTc / kG; ++j) ckk[static_cast<int64_t>(j) * W] = snap[j];
          }
        } else {  // the ragged last chunk
          for (int i = 0; i < n; ++i) {
            if (i % kG == 0 && live) ckk[static_cast<int64_t>(i / kG) * W] = h;
            h = __fadd_rn(__fmul_rn(as[i * kC], h), vs[i * kC]);
          }
          bar_arrive(&empty[s]);
        }
      }
    } else {
      float carry = 0.0f;  // a_{t+1} g_{t+1}: 0 * 0 past the last row
      for (int k = 0; k < n_chunks; ++k) {
        const int chunk = n_chunks - 1 - k;
        const int s = k % kAgStages;
        bar_wait(&full[s], (k / kAgStages) & 1);
        const float* as = a_s + s * kTc * kC + threadIdx.x;
        const float* vs = v_s + s * kTc * kC + threadIdx.x;
        float* ckk = ck + static_cast<int64_t>(chunk) * (kTc / kG) * W;
        const int n = min(kTc, T_len - chunk * kTc);
        if (n == kTc) {
          float ar[kTc], vr[kTc];
#pragma unroll
          for (int i = 0; i < kTc; ++i) {
            ar[i] = as[i * kC];
            vr[i] = vs[i * kC];
          }
          bar_arrive(&empty[s]);
          float snap[kTc / kG];
#pragma unroll
          for (int i = kTc - 1; i >= 0; --i) {
            if (i % kG == kG - 1) snap[i / kG] = carry;
            carry = __fmul_rn(__fadd_rn(vr[i], carry), ar[i]);
          }
          if (live) {
#pragma unroll
            for (int j = 0; j < kTc / kG; ++j) ckk[static_cast<int64_t>(j) * W] = snap[j];
          }
        } else {  // the ragged last chunk, walked first
          for (int i = n - 1; i >= 0; --i) {
            if ((i % kG == kG - 1 || i == n - 1) && live)
              ckk[static_cast<int64_t>(i / kG) * W] = carry;
            carry = __fmul_rn(__fadd_rn(vs[i * kC], carry), as[i * kC]);
          }
          bar_arrive(&empty[s]);
        }
      }
      if (dh0 != nullptr && live) dh0[static_cast<int64_t>(b) * W + c] = carry;
    }
    return;
  }

  // ---- producers: chunk tiles in, (a, v) out. Quad i of a stage (row
  // r, channels col..col + 3) is this thread's in every chunk, so its
  // offsets and its channel mask are fixed once.
  const int tp = threadIdx.x - kC;
  const T* v_src = state ? x : dout;
  constexpr int kPer = kVB / static_cast<int>(sizeof(T));  // elements a copy
  static_assert(kPer >= 1 && 4 % kPer == 0, "a copy is 1, 2 or 4 elements of a quad");
  int rows[kQuads], tile_at[kQuads];
  int64_t src_at[kQuads];
  bool col_in[kQuads][4 / kPer];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int q = tp + i * kProducers;
    const int r = q / (kC / 4), col = (q % (kC / 4)) * 4;
    rows[i] = r;
    tile_at[i] = r * kC + col;
    src_at[i] = (row0 + r) * W + c0 + col;
#pragma unroll
    for (int j = 0; j < 4; j += kPer) col_in[i][j / kPer] = c0 + col + j < W;
  }
  // copy the quads of this thread of the walk's chunk k into raw stage k % kRaw
  auto load_chunk = [&](int k) {
    const int chunk = state ? k : n_chunks - 1 - k;
    const int64_t step = static_cast<int64_t>(chunk) * kTc * W;
    const int stage = (k % kRaw) * kTc * kC;
    const int rows_in = T_len - chunk * kTc;  // rows of the chunk inside T
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
#pragma unroll
      for (int j = 0; j < 4; j += kPer) {
        const bool in = rows[i] < rows_in && col_in[i][j / kPer];
        const int64_t src = in ? src_at[i] + step + j : 0;
        copy<kVB>(v_raw + stage + tile_at[i] + j, v_src + src, in);
        copy<kVB>(a_raw + stage + tile_at[i] + j, a + src, in);
      }
    }
  };
#pragma unroll
  for (int k = 0; k < kRaw - 1; ++k) {
    if (k < n_chunks) load_chunk(k);
    cp_async_commit();
  }
  for (int k = 0; k < n_chunks; ++k) {
    if (k + kRaw - 1 < n_chunks) load_chunk(k + kRaw - 1);
    cp_async_commit();
    cp_async_wait<kRaw - 1>();  // this thread's copies of chunk k have landed
    const int s = k % kAgStages;
    if (k >= kAgStages) bar_wait(&empty[s], ((k / kAgStages) + 1) & 1);
    const int stage = (k % kRaw) * kTc * kC;
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const float4 vv = load_quad(v_raw + stage + tile_at[i]);
      const float4 av = load_quad(a_raw + stage + tile_at[i]);
      const int at = s * kTc * kC + tile_at[i];
      *reinterpret_cast<float4*>(a_s + at) = av;
      *reinterpret_cast<float4*>(v_s + at) =
          state ? make_float4(gain_x(av.x, vv.x), gain_x(av.y, vv.y), gain_x(av.z, vv.z),
                              gain_x(av.w, vv.w))
                : vv;
    }
    bar_arrive(&full[s]);
  }
  cp_async_wait<0>();
}

// Phase B. Grid (n_groups * wtiles, B): block (j * wtiles + tile, b) takes
// group j's rows of channels tile * kGThreads onwards, a thread a channel.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 8)
rglru_bwd_groups(const T* __restrict__ x, const T* __restrict__ a,
                 const T* __restrict__ dout, const float* __restrict__ ck_h,
                 const float* __restrict__ ck_g, T* __restrict__ dx, T* __restrict__ da,
                 int T_len, int W, int wtiles) {
  const int j = blockIdx.x / wtiles;
  const int w = (blockIdx.x - j * wtiles) * kGThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const int n_groups = (T_len + kG - 1) / kG;
  const int t0 = j * kG;
  const int n = min(kG, T_len - t0);
  const int64_t off = (static_cast<int64_t>(b) * T_len + t0) * W + w;  // (b, t0, w)
  const int64_t snap = (static_cast<int64_t>(b) * n_groups + j) * W + w;
  float h = ck_h[snap];
  float carry = ck_g[snap];

  float xs[kG], as[kG], ds[kG], ss[kG], hs[kG];
  if (n == kG) {
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int64_t at = off + static_cast<int64_t>(i) * W;
      xs[i] = to_f32(x[at]);
      as[i] = to_f32(a[at]);
      ds[i] = to_f32(dout[at]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (i < n) {
        const int64_t at = off + static_cast<int64_t>(i) * W;
        xs[i] = to_f32(x[at]);
        as[i] = to_f32(a[at]);
        ds[i] = to_f32(dout[at]);
      }
    }
  }
  // the states: h_{t-1} and s of every row, from the group's snapshot
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    if (i < n) {
      hs[i] = h;
      ss[i] = gain(one_minus_sq(as[i]));
      h = __fadd_rn(__fmul_rn(as[i], h), __fmul_rn(ss[i], xs[i]));
    }
  }
  // the cotangents, last row first, from the carry into the group's last row
#pragma unroll
  for (int i = kG - 1; i >= 0; --i) {
    if (i < n) {
      const float ai = as[i], xi = xs[i], si = ss[i];
      const float g = __fadd_rn(ds[i], carry);
      const float u = one_minus_sq(ai);
      // g x / (2 s), IEEE. A divisor or a dividend of 0 would send the
      // division to its slow path (a call the whole warp then takes), and
      // |a| = 1 gives s = 0, x = 0 a dividend of 0: such quotients are
      // taken without dividing. 0 / den is 0 with the dividend's sign (den
      // > 0); num / +0 is num times +inf (+-inf, NaN where num is 0 or NaN).
      const float num = __fmul_rn(g, xi), den = __fmul_rn(2.0f, si);
      const bool plain = den > 0.0f && num != 0.0f;
      const float q = __fdiv_rn(plain ? num : 1.0f, plain ? den : 1.0f);
      const float gc = plain ? q
                     : den > 0.0f ? num
                                  : __fmul_rn(num, __int_as_float(0x7f800000));
      const float t1 = __fmul_rn(-(u >= 0.0f ? gc : 0.0f), ai);
      const int64_t at = off + static_cast<int64_t>(i) * W;
      dx[at] = from_f32<T>(__fmul_rn(g, si));
      da[at] = from_f32<T>(__fadd_rn(__fadd_rn(t1, t1), __fmul_rn(g, hs[i])));
      carry = __fmul_rn(g, ai);
    }
  }
}

template <typename T, int kVB>
int launch_vb(const void* x, const void* a, const float* h0, const void* dout, void* dx,
              void* da, float* dh0, float* ws, int B, int T_len, int W,
              cudaStream_t stream) {
  const int tiles = (W + kC - 1) / kC;
  const int wtiles = (W + kGThreads - 1) / kGThreads;
  const int64_t n_groups = (static_cast<int64_t>(T_len) + kG - 1) / kG;
  if (n_groups * wtiles > 2147483647LL) return kErrShape;
  float* ck_h = ws;
  float* ck_g = ws + static_cast<int64_t>(B) * n_groups * W;
  constexpr size_t smem = smem_bytes<T>();
  const cudaError_t err =
      cudaFuncSetAttribute(rglru_bwd_chains<T, kVB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_bwd_chains<T, kVB><<<dim3(2 * tiles, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), h0, static_cast<const T*>(dout),
      dh0, ck_h, ck_g, T_len, W);
  const cudaError_t chains = cudaGetLastError();
  if (chains != cudaSuccess) return static_cast<int>(chains);
  rglru_bwd_groups<T><<<dim3(static_cast<unsigned>(n_groups * wtiles), B), kGThreads, 0,
                        stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(dout), ck_h,
      ck_g, static_cast<T*>(dx), static_cast<T*>(da), T_len, W, wtiles);
  return static_cast<int>(cudaGetLastError());
}

// the widest copy (bytes, at most a quad of 4 elements) that x's, a's and
// dout's addresses and the row pitch W * sizeof(T) are all aligned to
template <typename T>
int launch(const void* x, const void* a, const float* h0, const void* dout, void* dx,
           void* da, float* dh0, float* ws, int B, int T_len, int W, cudaStream_t stream) {
  const uint64_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(dout) |
                        static_cast<uint64_t>(W) * sizeof(T);
  if constexpr (sizeof(T) == 4) {
    if (bits % 16 == 0)
      return launch_vb<T, 16>(x, a, h0, dout, dx, da, dh0, ws, B, T_len, W, stream);
    if (bits % 8 == 0)
      return launch_vb<T, 8>(x, a, h0, dout, dx, da, dh0, ws, B, T_len, W, stream);
    return launch_vb<T, 4>(x, a, h0, dout, dx, da, dh0, ws, B, T_len, W, stream);
  } else {
    if (bits % 8 == 0)
      return launch_vb<T, 8>(x, a, h0, dout, dx, da, dh0, ws, B, T_len, W, stream);
    if (bits % 4 == 0)
      return launch_vb<T, 4>(x, a, h0, dout, dx, da, dh0, ws, B, T_len, W, stream);
    return launch_vb<T, 2>(x, a, h0, dout, dx, da, dh0, ws, B, T_len, W, stream);
  }
}

}  // namespace

// Workspace floats the C entry needs in ``ckpt`` for [B, T, W]: the two
// chains' snapshots, one fp32 state and one fp32 carry per (b, group of
// kG rows, w).
extern "C" int64_t xbof_rglru_bwd_workspace(int B, int T, int W) {
  return 2 * static_cast<int64_t>(B) * ((static_cast<int64_t>(T) + kG - 1) / kG) * W;
}

// kind: 0 = fp32, 1 = bf16 (x, a, dout, dx and da alike); h0 is fp32 [B, W]
// or null for zeros, and dh0 (fp32 [B, W]) is written when it is given;
// ckpt holds xbof_rglru_bwd_workspace(B, T, W) floats. Launches the two
// phases on ``stream``, in order. Returns cudaGetLastError() after the
// launches (0 on success), cudaErrorInvalidValue for an unknown kind, or
// kErrShape for a shape beyond the kernels' limits (B, T or W below 1, B
// above 65535, or more than 2^31 - 1 group blocks, which no shape that
// fits on a card reaches). The Python wrapper turns kErrShape into a
// ValueError.
extern "C" int xbof_rglru_bwd(int kind, const void* x, const void* a, const void* h0,
                              const void* dout, void* dx, void* da, void* dh0, void* ckpt,
                              int B, int T, int W, void* stream) {
  if (B < 1 || T < 1 || W < 1 || B > 65535) return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  float* dh = static_cast<float*>(dh0);
  float* ws = static_cast<float*>(ckpt);
  switch (kind) {
    case 0: return launch<float>(x, a, h, dout, dx, da, dh, ws, B, T, W, s);
    case 1: return launch<__nv_bfloat16>(x, a, h, dout, dx, da, dh, ws, B, T, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
