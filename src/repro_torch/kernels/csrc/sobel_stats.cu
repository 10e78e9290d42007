// Sobel gradient magnitude + moments of one float32 plane, for Hopper,
// in one launch.
//
// Replaces the TPU kernel `sobel_stats_pallas`
// (src/repro/kernels/sobel_stats.py, pl.pallas_call at :63).
//
// Outputs: mag = sqrt(gx^2 + gy^2) of the 3x3 Sobel stencil with
// edge-replicated borders, and stats = [sum, sumsq, max] of mag.
//
// Bound on the card: bytes. 4 bytes read and 4 written per pixel
// against ~20 flops; at 4096x4096 that is 134 MB, 40 us at 3.35 TB/s.
//
// Design: the strip walk and in-launch merge of feature_fused.cu
// (strip_stencil.cuh) on one plane, with no deconvolution. When the
// plane's rows are contiguous and 16-byte aligned, each row segment is
// copied as 16-byte `cp.async` chunks into a ring of STAGES steps in
// shared memory; otherwise each element is read with its strides. The
// stencil uses the round-to-nearest intrinsics in the plain version's
// order (no FMA contraction) and IEEE sqrtf, so mag agrees with it bit
// for bit.

#include "strip_stencil.cuh"

namespace {

using namespace strip;

constexpr int ROWF = TW + 8;       // floats of one row segment in the ring: x0 - 4 .. x0 + TW + 4
constexpr int CHUNKS = ROWF / 4;   // its 16-byte chunks
constexpr int ROWS_ALIGNED = 0, STRIDED = 1;

template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sobel_stats_kernel(const float* __restrict__ gray, long long s0, long long s1, int h, int w,
                   int rows, float* __restrict__ mag, float* __restrict__ partials,
                   int* __restrict__ counter, float* __restrict__ stats) {
  __shared__ __align__(16) float raw[MODE == ROWS_ALIGNED ? STAGES * RPS * ROWF : 4];
  __shared__ __align__(16) float ring[RING * PITCH];
  const int tid = threadIdx.x, rr = tid / TPR, cx = tid % TPR;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * rows;
  const int rows_here = min(rows, h - y0);
  const int nx = min(PX, w - x0 - PX * cx);  // the thread's pixels inside the image
  const bool vec = (w % PX) == 0;
  float ms = 0.f, mss = 0.f, mmx = -INFINITY;

  auto image_row = [&](int i) { return min(max(y0 - 1 + i, 0), h - 1); };

  auto fetch = [&](int f, int stage) {
    if constexpr (MODE == ROWS_ALIGNED) {
      for (int t = tid; t < RPS * CHUNKS; t += THREADS) {
        const int r = t / CHUNKS, k = t % CHUNKS, i = RPS * f + r;
        const long long off = static_cast<long long>(x0) - 4 + 4 * k;
        const long long n = min(4LL, static_cast<long long>(w) - off);
        if (i <= rows_here + 1 && off >= 0 && n > 0)
          cp_async16(raw + (stage * RPS + r) * ROWF + 4 * k, gray + image_row(i) * s0 + off,
                     static_cast<int>(4 * n));
      }
    }
  };

  // Pixel gx (inside the image) of input row i.
  auto px = [&](int i, int stage, int gx) {
    if constexpr (MODE == ROWS_ALIGNED)
      return raw[(stage * RPS + rr) * ROWF + 4 + gx - x0];
    else
      return gray[image_row(i) * s0 + gx * s1];
  };

  auto convert = [&](int s, int stage) {
    const int i = RPS * s + rr;
    if (i > rows_here + 1) return;
    float* lrow = ring + (i & (RING - 1)) * PITCH;
    float4 v;
    if (MODE == ROWS_ALIGNED && nx == PX) {
      v = *reinterpret_cast<const float4*>(raw + (stage * RPS + rr) * ROWF + 4 + PX * cx);
    } else {
      const int gx = x0 + PX * cx;
      v = make_float4(px(i, stage, min(gx, w - 1)), px(i, stage, min(gx + 1, w - 1)),
                      px(i, stage, min(gx + 2, w - 1)), px(i, stage, min(gx + 3, w - 1)));
    }
    *reinterpret_cast<float4*>(lrow + COL0 + 1 + PX * cx) = v;
    if (cx == 0) lrow[COL0] = px(i, stage, max(x0 - 1, 0));
    if (cx == TPR - 1) lrow[COL0 + TW + 1] = px(i, stage, min(x0 + TW, w - 1));
  };

  auto emit = [&](int s) {
    const int j = RPS * s - 2 + rr;
    if (j < 0 || j >= rows_here || nx <= 0) return;
    float m[PX];
    sobel_row(ring, j, cx, m);
    store_px(mag, static_cast<long long>(y0 + j) * w + x0 + PX * cx, m, nx, vec);
#pragma unroll
    for (int k = 0; k < PX; ++k)
      if (k < nx) {
        ms += m[k];
        mss += m[k] * m[k];
        mmx = fmaxf(mmx, m[k]);
      }
  };

  walk(steps_of(rows_here), fetch, convert, emit);
  float v[3] = {ms, mss, mmx};
  merge_moments<3, 0x4u>(v, partials, counter, stats);
}

template <int MODE>
int launch(const float* gray, long long s0, long long s1, int h, int w, int rows, void* mag,
           void* partials, void* counter, void* stats, cudaStream_t st) {
  sobel_stats_kernel<MODE><<<grid_of(h, w, rows), THREADS, 0, st>>>(
      gray, s0, s1, h, w, rows, static_cast<float*>(mag), static_cast<float*>(partials),
      static_cast<int*>(counter), static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over an (h, w) float32 plane with element strides s0, s1,
// in blocks of `rows` rows; mag (h, w) contiguous. mode 0: rows
// contiguous (s1 == 1) and 16-byte aligned (gray and s0); mode 1: any
// strides. `partials` holds at least 3 floats per block; `counter` is
// one int32, 0 before the launch and left 0 after it. Returns a CUDA
// error (cudaErrorInvalidValue for arguments the kernel does not take),
// or 0.
extern "C" int sobel_stats(int mode, const void* gray, long long s0, long long s1, int h, int w,
                           int rows, void* mag, void* partials, long long partials_len,
                           void* counter, void* stats, void* stream) {
  if (h < 1 || w < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(h, w, rows);
  if (grid.y > 65535 || partials_len < 3LL * grid.x * grid.y)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gray);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == ROWS_ALIGNED) {
    if (s1 != 1 || s0 % 4 || reinterpret_cast<uintptr_t>(gray) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<ROWS_ALIGNED>(g, s0, s1, h, w, rows, mag, partials, counter, stats, st);
  }
  if (mode == STRIDED)
    return launch<STRIDED>(g, s0, s1, h, w, rows, mag, partials, counter, stats, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
