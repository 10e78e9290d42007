// Color deconvolution (stain separation) for Hopper.
//
// Replaces the TPU kernel `color_deconv_pallas`
// (src/repro/kernels/color_deconv.py, pl.pallas_call at :48).
//
// Per pixel: optical density od = -log10((x + 1) / 256) of the R, G and
// B planes, then the 3x3 DECONV_MATRIX product giving the hematoxylin,
// eosin and residual float32 planes.
//
// Bound on the card: bytes. 3 input bytes (uint8) or 12 (float32) and
// 12 output bytes per pixel against ~30 flops; at 4096x4096 uint8 that
// is 50.3 MB read + 201 MB written, ~75 us at 3.35 TB/s. Design: one
// thread per pixel, a warp on 32 neighbouring pixels of one row, so
// every store is a coalesced 128-byte line. Each input plane comes with
// its own element strides, so the channel views rgb[..., c] of an
// interleaved (H, W, 3) tile are read in place (the three planes of a
// pixel share one cache line) with no de-interleaving copy. The
// arithmetic uses the round-to-nearest intrinsics in the order of the
// plain version (no FMA contraction) and IEEE log10f, so the kernel
// agrees with it to a few ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Mat3 {
  float m[9];
};

__device__ __forceinline__ float od(float x) {
  return -log10f(__fdiv_rn(__fadd_rn(x, 1.0f), 256.0f));
}

__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

template <typename T>
__global__ void color_deconv_kernel(const T* __restrict__ r,
                                    const T* __restrict__ g,
                                    const T* __restrict__ b, long long rs0,
                                    long long rs1, long long gs0,
                                    long long gs1, long long bs0,
                                    long long bs1, int h, int w, Mat3 M,
                                    float* __restrict__ hema,
                                    float* __restrict__ eosin,
                                    float* __restrict__ resid) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    const float odr = od(static_cast<float>(r[y * rs0 + x * rs1]));
    const float odg = od(static_cast<float>(g[y * gs0 + x * gs1]));
    const float odb = od(static_cast<float>(b[y * bs0 + x * bs1]));
    const long long o = static_cast<long long>(y) * w + x;
    hema[o] = dot3(M.m[0], M.m[1], M.m[2], odr, odg, odb);
    eosin[o] = dot3(M.m[3], M.m[4], M.m[5], odr, odg, odb);
    resid[o] = dot3(M.m[6], M.m[7], M.m[8], odr, odg, odb);
  }
}

template <typename T>
int launch(const void* r, const void* g, const void* b, long long rs0,
           long long rs1, long long gs0, long long gs1, long long bs0,
           long long bs1, int h, int w, const float* m, void* hema,
           void* eosin, void* resid, void* stream) {
  Mat3 M;
  for (int i = 0; i < 9; ++i) M.m[i] = m[i];
  const int threads = 256;
  dim3 grid((w + threads - 1) / threads, h < 65535 ? h : 65535);
  color_deconv_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)g, (const T*)b, rs0, rs1, gs0, gs1, bs0, bs1, h,
      w, M, (float*)hema, (float*)eosin, (float*)resid);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements. Returns cudaGetLastError() after the launch.
extern "C" int color_deconv_u8(const void* r, const void* g, const void* b,
                               long long rs0, long long rs1, long long gs0,
                               long long gs1, long long bs0, long long bs1,
                               int h, int w, const float* m, void* hema,
                               void* eosin, void* resid, void* stream) {
  return launch<uint8_t>(r, g, b, rs0, rs1, gs0, gs1, bs0, bs1, h, w, m,
                         hema, eosin, resid, stream);
}

extern "C" int color_deconv_f32(const void* r, const void* g, const void* b,
                                long long rs0, long long rs1, long long gs0,
                                long long gs1, long long bs0, long long bs1,
                                int h, int w, const float* m, void* hema,
                                void* eosin, void* resid, void* stream) {
  return launch<float>(r, g, b, rs0, rs1, gs0, gs1, bs0, bs1, h, w, m, hema,
                       eosin, resid, stream);
}
