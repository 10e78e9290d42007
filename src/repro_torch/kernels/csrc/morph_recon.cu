// Grayscale morphological reconstruction for Hopper.
//
// Replaces the TPU kernel `morph_recon_step` / `morph_recon_pallas`
// (src/repro/kernels/morph_recon.py, pl.pallas_call at :82).
//
// Computes the 8-connected geodesic dilation of `marker` under `mask`,
// iterated to its fixpoint (Vincent's reconstruction). The fixpoint is
// unique and every sweep order reaches it, so the result equals the
// plain version's whatever the tiling and the number of launches.
//
// One launch = one step. The image is cut into 32x64 tiles, one block
// each. A block loads its tile plus a one-pixel halo of marker and mask
// into shared memory (-inf outside the image, the oracle's reduce_window
// init), clamps marker by mask, then runs up to `max_sweeps` in-place
// sweeps over the tile interior, alternating forward and backward
// raster order so values travel across the tile in few sweeps. A sweep
// that changes nothing ends the block early (__syncthreads_or). The
// halo stays fixed during a launch, so a value crosses one tile
// boundary per launch; the interior is written to a second buffer
// (ping-pong), so no block reads a halo that a neighbour is writing.
// A block that changed anything sets the device-side flag, which the
// host reads once per launch; the step is repeated until it stays 0.
//
// In-place sweeps read neighbours that other threads of the block may be
// updating in the same sweep. Every value read is a valid lower bound of
// the fixpoint (values only rise, and never above the mask), so the
// order only changes how fast the block converges, not where.
//
// Bound on the card: bytes. The function must read marker and mask and
// write the result once: 3 x 4 bytes per pixel, 201 MB at 4096x4096,
// ~60 us at 3.35 TB/s. Each launch moves those bytes again, so the
// time grows with the launch count, which the data decides (roughly
// the longest propagation path in tiles).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BH = 32;
constexpr int BW = 64;
constexpr int SH = BH + 2;
constexpr int SW = BW + 2;
constexpr int THREADS = 256;
constexpr int PER = BH * BW / THREADS;
static_assert(BH * BW % THREADS == 0, "tile must split evenly over threads");

__global__ void __launch_bounds__(THREADS)
morph_recon_kernel(const float* __restrict__ src,
                   const float* __restrict__ mask,
                   float* __restrict__ dst, int h, int w, int max_sweeps,
                   int* __restrict__ changed) {
  __shared__ float v[SH][SW];
  __shared__ float m[SH][SW];
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  const int tid = threadIdx.x;

  for (int i = tid; i < SH * SW; i += THREADS) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float val = -INFINITY, mk = -INFINITY;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const long long o = static_cast<long long>(gy) * w + gx;
      mk = mask[o];
      val = fminf(src[o], mk);
    }
    v[sy][sx] = val;
    m[sy][sx] = mk;
  }
  __syncthreads();

  int any = 0;
  for (int s = 0; s < max_sweeps; ++s) {
    int ch = 0;
    for (int k = 0; k < PER; ++k) {
      int p = tid + k * THREADS;
      if (s & 1) p = BH * BW - 1 - p;
      const int sy = p / BW + 1, sx = p % BW + 1;
      if (y0 + sy - 1 >= h || x0 + sx - 1 >= w) continue;
      float mx = v[sy - 1][sx - 1];
      mx = fmaxf(mx, v[sy - 1][sx]);
      mx = fmaxf(mx, v[sy - 1][sx + 1]);
      mx = fmaxf(mx, v[sy][sx - 1]);
      mx = fmaxf(mx, v[sy][sx]);
      mx = fmaxf(mx, v[sy][sx + 1]);
      mx = fmaxf(mx, v[sy + 1][sx - 1]);
      mx = fmaxf(mx, v[sy + 1][sx]);
      mx = fmaxf(mx, v[sy + 1][sx + 1]);
      const float nv = fminf(mx, m[sy][sx]);
      if (nv > v[sy][sx]) {
        v[sy][sx] = nv;
        ch = 1;
      }
    }
    if (!__syncthreads_or(ch)) break;
    any = 1;
  }

  for (int p = tid; p < BH * BW; p += THREADS) {
    const int sy = p / BW + 1, sx = p % BW + 1;
    const int gy = y0 + sy - 1, gx = x0 + sx - 1;
    if (gy < h && gx < w) dst[static_cast<long long>(gy) * w + gx] = v[sy][sx];
  }
  if (any && tid == 0) *changed = 1;
}

}  // namespace

// One step: dst = up to `max_sweeps` tile-local sweeps of src, and
// *changed = 1 if any block changed a pixel. `changed` is zeroed first.
// All pointers are device pointers to contiguous float32 (H, W) planes
// (changed: one int32). Returns the first CUDA error, or 0.
extern "C" int morph_recon_step(const void* src, const void* mask, void* dst,
                                int h, int w, int max_sweeps, void* changed,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH);
  morph_recon_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)src, (const float*)mask, (float*)dst, h, w, max_sweeps,
      (int*)changed);
  return (int)cudaGetLastError();
}
