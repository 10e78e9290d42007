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
