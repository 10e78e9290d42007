// Mamba2 (SSD) inter-chunk state recurrence for Hopper.
//
// Replaces the TPU kernel `mamba2_chunk_scan_pallas`
// (src/repro/kernels/mamba2_scan.py, pl.pallas_call at :56).
//
//   s_0 = 0;  states[c] = s_c;  s_{c+1} = decay[c, h] * s_c + inc[c, h, f]
//   final = s_C
// with decay (C, H) float32, inc (C, H, F) float32 or bfloat16, all
// contiguous; states (C, H, F) and final (H, F) have inc's type.
//
// Design. The recurrence is sequential in C and independent across
// (h, f): one thread per (h, f) element walks the chunks with its carry
// in a float32 register, so neighbouring threads read and write
// neighbouring addresses (coalesced). The TPU kernel's sequential grid
// becomes this in-thread loop; nothing is carried between blocks. The
// update is a rounded multiply, then a rounded add (no FMA
// contraction), as the plain version computes it.
//
// Bound on the card: bytes. inc is read once and states written once:
// at C=8, H=256, F=4096, float32 that is 33.6 + 33.6 + 4.2 MB, 21 us at
// 3.35 TB/s; 2 operations per element are far below the float32 rate.
//
// Backward (`mamba2_scan_bwd_kernel`; no TPU counterpart: the JAX
// package differentiates its plain scan). The adjoint runs the same
// recurrence in reverse, from the forward's saved states:
//   lam = g_final;  for c = C-1 .. 0:
//     g_inc[c] = lam;  g_decay[c, h] = sum_f lam[h, f] * states[c, h, f];
//     lam = decay[c, h] * lam + g_states[c]
// (a null g_states or g_final reads as zeros). Bound: bytes. states and
// g_states are read once, g_inc written once: at C=8, H=256, F=4096,
// float32 that is 3 x 33.6 MB + 4.2 MB, 31 us at 3.35 TB/s.
//
// Design of the backward. One launch; the carry is elementwise over F,
// so F is split across blocks: block (s, h) owns span s of row h, its
// BWD_THREADS threads BWD_ELEMS elements each (BWD_SPAN elements). A
// thread owns BWD_ELEMS / VEC vectors of VEC elements, vector k at
// offset s * BWD_SPAN + (k * BWD_THREADS + tid) * VEC, so a warp's
// accesses are contiguous. VEC is 16 bytes (4 float32, 8 bfloat16) when
// every row starts 16-byte aligned (F a multiple of VEC, the pointers
// aligned: the host's `bwd_plan`), else 1; a span past the row's end is
// masked per vector (per element for VEC = 1).
// - The float32 carry of a thread's elements lives in registers: no
//   shared memory holds it and no barrier runs in the chunk loop.
// - Chunk c - 1's loads of states, g_states (16 bytes each, read-only
//   path) and decay are issued before chunk c's arithmetic, into a
//   second set of registers, so the next loads are in flight while this
//   chunk computes and stores g_inc.
// - The carry update is a rounded multiply, then a rounded add, as the
//   plain version computes it: g_inc is bit-equal to it.
// - g_decay: each thread sums its elements with fmaf in a fixed order
//   (vector k, then element v), the warp reduces by a shuffle butterfly,
//   and lane 0 writes the warp's partial to partials[c][h][s][w]. After
//   its last chunk, each writing lane fences, the block passes a
//   barrier, and one thread fences and bumps head h's int32 counter
//   (a buffer that holds only counters); the block that arrives last
//   resets it to 0 for the next call on the stream and sums each
//   chunk's S x W partials in (s, w) order. No float atomics: the result
//   does not depend on which block arrives last, and repeated calls are
//   bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba2_scan_kernel(const float* __restrict__ decay, const T* __restrict__ inc,
                   T* __restrict__ states, T* __restrict__ final_state, int C,
                   int H, long long F) {
  const long long hf = static_cast<long long>(H) * F;
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= hf) return;
  const int h = static_cast<int>(idx / F);
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const long long o = static_cast<long long>(c) * hf + idx;
    states[o] = from_f<T>(s);
    s = __fadd_rn(__fmul_rn(decay[c * H + h], s), to_f(inc[o]));
  }
  final_state[idx] = from_f<T>(s);
}

// The backward's shape: threads a block, elements a thread, blocks an SM
// the launch bounds ask for (one wave at the training shape).
constexpr int BWD_THREADS = 128;
constexpr int BWD_ELEMS = 8;
constexpr int BWD_MIN_BLOCKS = 8;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_SPAN = BWD_THREADS * BWD_ELEMS;
static_assert(BWD_ELEMS % 8 == 0, "whole 16-byte vectors for float32 and bfloat16");

// Raw registers of VEC elements of T as loaded: converted to float32
// only when used, so that a load in flight does not stall its issue.
template <typename T, int VEC> struct Raw;
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };

__device__ __forceinline__ float elem(float4 r, int v) {
  return v == 0 ? r.x : v == 1 ? r.y : v == 2 ? r.z : r.w;
}
__device__ __forceinline__ float elem(float r, int) { return r; }
__device__ __forceinline__ float elem(uint4 r, int v) {  // bfloat16 2j in word j's low half
  const unsigned w = v < 2 ? r.x : v < 4 ? r.y : v < 6 ? r.z : r.w;
  return __uint_as_float(v & 1 ? w & 0xffff0000u : w << 16);
}
__device__ __forceinline__ float elem(unsigned short r, int) {
  return __uint_as_float(static_cast<unsigned>(r) << 16);
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void pack(float4& r, const float* x) {
  r = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void pack(float& r, const float* x) { r = x[0]; }
__device__ __forceinline__ void pack(uint4& r, const float* x) {
  r = make_uint4(bf16_bits(x[0]) | bf16_bits(x[1]) << 16, bf16_bits(x[2]) | bf16_bits(x[3]) << 16,
                 bf16_bits(x[4]) | bf16_bits(x[5]) << 16, bf16_bits(x[6]) | bf16_bits(x[7]) << 16);
}
__device__ __forceinline__ void pack(unsigned short& r, const float* x) {
  r = static_cast<unsigned short>(bf16_bits(x[0]));
}

// Chunk c's states and g_states vectors of this thread (zeros where
// masked or null) and its decay, issued on the read-only path.
template <typename R, int K>
__device__ __forceinline__ void load_chunk(const R* __restrict__ s, const R* __restrict__ g,
                                           const float* __restrict__ decay, long long at,
                                           int dat, const bool (&ok)[K], R (&xs)[K],
                                           R (&xg)[K], float& d) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    xs[k] = R{};
    xg[k] = R{};
    if (ok[k]) {
      xs[k] = __ldg(s + at + k * BWD_THREADS);
      if (g) xg[k] = __ldg(g + at + k * BWD_THREADS);
    }
  }
  d = __ldg(decay + dat);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
mamba2_scan_bwd_kernel(const float* __restrict__ decay, const T* __restrict__ states,
                       const T* __restrict__ g_states, const T* __restrict__ g_final,
                       T* __restrict__ g_inc, float* __restrict__ g_decay,
                       int* __restrict__ counters, float* __restrict__ partials, int C,
                       int H, int F, int S) {
  using R = typename Raw<T, VEC>::type;
  constexpr int K = BWD_ELEMS / VEC;
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x / S, s = blockIdx.x - h * S;
  // Offsets in units of R: a row holds F / VEC of them (F % VEC == 0).
  const long long hf = static_cast<long long>(H) * (F / VEC);
  const int off = s * (BWD_SPAN / VEC) + tid;  // vector k at off + k * BWD_THREADS
  const long long row = static_cast<long long>(h) * (F / VEC) + off;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = (off + k * BWD_THREADS) * VEC < F;
  const R* const rs = reinterpret_cast<const R*>(states);
  const R* const rg = reinterpret_cast<const R*>(g_states);
  R* const ri = reinterpret_cast<R*>(g_inc);

  float lam[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    R r{};
    if (g_final && ok[k]) r = __ldg(reinterpret_cast<const R*>(g_final) + row + k * BWD_THREADS);
#pragma unroll
    for (int v = 0; v < VEC; ++v) lam[k][v] = elem(r, v);
  }
  R cs[K], cg[K];
  float d;
  load_chunk<R, K>(rs, rg, decay, (C - 1) * hf + row, (C - 1) * H + h, ok, cs, cg, d);
  for (int c = C - 1; c >= 0; --c) {
    R ns[K], ng[K];
    float nd = 0.f;
    if (c > 0) {
      load_chunk<R, K>(rs, rg, decay, (c - 1) * hf + row, (c - 1) * H + h, ok, ns, ng, nd);
    }
    const long long at = c * hf + row;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!ok[k]) continue;
      float l[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        l[v] = lam[k][v];
        part = fmaf(l[v], elem(cs[k], v), part);
        lam[k][v] = __fadd_rn(__fmul_rn(d, l[v]), elem(cg[k], v));
      }
      pack(ri[at + k * BWD_THREADS], l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) partials[((static_cast<long long>(c) * H + h) * S + s) * BWD_WARPS + warp] = part;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cs[k] = ns[k];
      cg[k] = ng[k];
    }
    d = nd;
  }

  // The merge: the block that arrives last at head h's counter.
  if (lane == 0) __threadfence();  // this warp's partials precede the bump
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(counters + h, 1) + 1 == S;
    if (is_last) counters[h] = 0;  // every split has arrived: ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int c = tid; c < C; c += BWD_THREADS) {
    const float* const p = partials + (static_cast<long long>(c) * H + h) * S * BWD_WARPS;
    float sum = 0.f;
    for (int i = 0; i < S * BWD_WARPS; ++i) sum += __ldcg(p + i);  // (s, w) order
    g_decay[c * H + h] = sum;
  }
}

template <typename T>
int launch_bwd(const void* decay, const void* states, const void* g_states,
               const void* g_final, void* g_inc, void* g_decay, void* counters,
               void* partials, int C, int H, int F, int vec, int splits, void* stream) {
  constexpr int WIDE = 16 / sizeof(T);
  if ((vec != 1 && vec != WIDE) || F % vec || splits != (F + BWD_SPAN - 1) / BWD_SPAN) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(splits) * H);
  auto kernel = vec == 1 ? mamba2_scan_bwd_kernel<T, 1> : mamba2_scan_bwd_kernel<T, WIDE>;
  kernel<<<blocks, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)decay, (const T*)states, (const T*)g_states, (const T*)g_final, (T*)g_inc,
      (float*)g_decay, (int*)counters, (float*)partials, C, H, F, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* decay, const void* inc, void* states, void* final_state,
           int C, int H, long long F, void* stream) {
  const long long hf = static_cast<long long>(H) * F;
  const unsigned blocks = static_cast<unsigned>((hf + THREADS - 1) / THREADS);
  mamba2_scan_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)decay, (const T*)inc, (T*)states, (T*)final_state, C, H, F);
  return (int)cudaGetLastError();
}

}  // namespace

// decay (C, H) float32, inc/states (C, H, F), final (H, F); contiguous.
// Returns the CUDA error of the launch, or 0.
extern "C" int mamba2_scan_f32(const void* decay, const void* inc, void* states,
                               void* final_state, int C, int H, long long F,
                               void* stream) {
  return launch<float>(decay, inc, states, final_state, C, H, F, stream);
}

extern "C" int mamba2_scan_bf16(const void* decay, const void* inc, void* states,
                                void* final_state, int C, int H, long long F,
                                void* stream) {
  return launch<__nv_bfloat16>(decay, inc, states, final_state, C, H, F, stream);
}

// Backward: decay (C, H) float32, states/g_states/g_inc (C, H, F) and
// g_final (H, F) in the forward's inc type (g_states and g_final may be
// null: zeros), g_decay (C, H) float32; contiguous. counters: H int32,
// all 0 (each launch leaves them 0); partials: C * H * splits *
// BWD_WARPS float32. vec: 16 / sizeof(T) (every row 16-byte aligned) or
// 1; splits: ceil(F / BWD_SPAN). Returns the CUDA error, or 0.
extern "C" int mamba2_scan_bwd_f32(const void* decay, const void* states, const void* g_states,
                                   const void* g_final, void* g_inc, void* g_decay,
                                   void* counters, void* partials, int C, int H, int F, int vec,
                                   int splits, void* stream) {
  return launch_bwd<float>(decay, states, g_states, g_final, g_inc, g_decay, counters, partials,
                           C, H, F, vec, splits, stream);
}

extern "C" int mamba2_scan_bwd_bf16(const void* decay, const void* states, const void* g_states,
                                    const void* g_final, void* g_inc, void* g_decay,
                                    void* counters, void* partials, int C, int H, int F, int vec,
                                    int splits, void* stream) {
  return launch_bwd<__nv_bfloat16>(decay, states, g_states, g_final, g_inc, g_decay, counters,
                                   partials, C, H, F, vec, splits, stream);
}
