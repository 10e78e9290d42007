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
// (a null g_states or g_final reads as zeros). One launch, one block per
// head h walking the chunks backwards; the carry lam of the block's F
// elements sits in shared memory as float32 (each thread owns elements
// tid, tid + THREADS, ...), so F is limited by shared memory, not by
// registers. g_decay[c, h] is a block reduction in a fixed order (warp
// shuffles, then the warps' sums in warp order): repeated calls are
// bit-equal. The carry update is a rounded multiply, then a rounded add,
// as the plain version computes it. Bound: bytes. states and g_states
// are read once, g_inc written once: at C=8, H=256, F=4096, float32
// that is 3 x 33.6 MB + 4.2 MB, 31 us at 3.35 TB/s.

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba2_scan_bwd_kernel(const float* __restrict__ decay, const T* __restrict__ states,
                       const T* __restrict__ g_states, const T* __restrict__ g_final,
                       T* __restrict__ g_inc, float* __restrict__ g_decay, int C, int H,
                       int F) {
  extern __shared__ float lam[];  // F floats
  __shared__ float warp_sums[THREADS / 32];
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long hf = static_cast<long long>(H) * F;
  const long long row = static_cast<long long>(h) * F;
  for (int f = tid; f < F; f += THREADS) lam[f] = g_final ? to_f(g_final[row + f]) : 0.f;
  for (int c = C - 1; c >= 0; --c) {
    const float d = decay[c * H + h];
    const long long base = static_cast<long long>(c) * hf + row;
    float part = 0.f;
#pragma unroll 4
    for (int f = tid; f < F; f += THREADS) {
      const float l = lam[f];
      g_inc[base + f] = from_f<T>(l);
      part = fmaf(l, to_f(states[base + f]), part);
      const float g = g_states ? to_f(g_states[base + f]) : 0.f;
      lam[f] = __fadd_rn(__fmul_rn(d, l), g);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) warp_sums[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) sum += warp_sums[w];
      g_decay[c * H + h] = sum;
    }
    __syncthreads();  // warp_sums is read before the next chunk writes it
  }
}

template <typename T>
int launch_bwd(const void* decay, const void* states, const void* g_states,
               const void* g_final, void* g_inc, void* g_decay, int C, int H, int F,
               void* stream) {
  const int bytes = F * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  mamba2_scan_bwd_kernel<T><<<H, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)decay, (const T*)states, (const T*)g_states, (const T*)g_final, (T*)g_inc,
      (float*)g_decay, C, H, F);
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
// null: zeros), g_decay (C, H) float32; contiguous; F * 4 bytes of
// shared memory per block (F <= 57344). Returns the CUDA error, or 0.
extern "C" int mamba2_scan_bwd_f32(const void* decay, const void* states, const void* g_states,
                                   const void* g_final, void* g_inc, void* g_decay, int C,
                                   int H, int F, void* stream) {
  return launch_bwd<float>(decay, states, g_states, g_final, g_inc, g_decay, C, H, F, stream);
}

extern "C" int mamba2_scan_bwd_bf16(const void* decay, const void* states, const void* g_states,
                                    const void* g_final, void* g_inc, void* g_decay, int C,
                                    int H, int F, void* stream) {
  return launch_bwd<__nv_bfloat16>(decay, states, g_states, g_final, g_inc, g_decay, C, H, F,
                                   stream);
}
