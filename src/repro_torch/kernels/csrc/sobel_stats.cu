// Sobel gradient magnitude + moments of one float32 plane, for Hopper.
//
// Replaces the TPU kernel `sobel_stats_pallas`
// (src/repro/kernels/sobel_stats.py, pl.pallas_call at :63).
//
// Outputs: mag = sqrt(gx^2 + gy^2) of the 3x3 Sobel stencil with
// edge-replicated borders, and stats = [sum, sumsq, max] of mag.
//
// Design: the stencil and reduction of feature_fused.cu on one plane.
// One block per 16x64 tile reads its tile plus a one-pixel halo once
// (edge-replicated by clamping the coordinates, which also masks a
// ragged image edge) into shared memory; the stencil runs from there.
// Each block reduces its three moments in a fixed order (warp shuffles,
// then the warps in order) into one row of a partials buffer; a second
// one-block kernel reduces the rows in a fixed order, in double. No
// float atomics: the result is deterministic. The stencil uses the
// round-to-nearest intrinsics in the plain version's order (no FMA
// contraction) and IEEE sqrtf, so mag agrees with it bit for bit.
//
// Bound on the card: bytes. 4 bytes read and 4 written per pixel
// against ~20 flops; at 4096x4096 that is 134 MB, 40 us at 3.35 TB/s
// (the halo re-reads, 16% more input, mostly hit L2).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BH = 16;
constexpr int BW = 64;
constexpr int SH = BH + 2;
constexpr int SW = BW + 2;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RTHREADS = 256;

__global__ void __launch_bounds__(THREADS)
sobel_stats_kernel(const float* __restrict__ gray, long long s0, long long s1,
                   int h, int w, float* __restrict__ mag,
                   float* __restrict__ partials) {
  __shared__ float tile[SH][SW];
  __shared__ float red[WARPS][3];
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  const int tid = threadIdx.x;

  for (int i = tid; i < SH * SW; i += THREADS) {
    const int sy = i / SW, sx = i % SW;
    const int gy = min(max(y0 - 1 + sy, 0), h - 1);
    const int gx = min(max(x0 - 1 + sx, 0), w - 1);
    tile[sy][sx] = gray[gy * s0 + gx * s1];
  }
  __syncthreads();

  float ms = 0.f, mss = 0.f, mmx = -INFINITY;
  for (int p = tid; p < BH * BW; p += THREADS) {
    const int sy = p / BW + 1, sx = p % BW + 1;
    const int gy = y0 + sy - 1, gx = x0 + sx - 1;
    if (gy >= h || gx >= w) continue;
    const float a00 = tile[sy - 1][sx - 1], a01 = tile[sy - 1][sx],
                a02 = tile[sy - 1][sx + 1];
    const float a10 = tile[sy][sx - 1], a12 = tile[sy][sx + 1];
    const float a20 = tile[sy + 1][sx - 1], a21 = tile[sy + 1][sx],
                a22 = tile[sy + 1][sx + 1];
    float tx = __fadd_rn(-a00, a02);
    tx = __fsub_rn(tx, 2.0f * a10);
    tx = __fadd_rn(tx, 2.0f * a12);
    tx = __fsub_rn(tx, a20);
    tx = __fadd_rn(tx, a22);
    float ty = __fsub_rn(-a00, 2.0f * a01);
    ty = __fsub_rn(ty, a02);
    ty = __fadd_rn(ty, a20);
    ty = __fadd_rn(ty, 2.0f * a21);
    ty = __fadd_rn(ty, a22);
    const float m = sqrtf(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)));
    mag[static_cast<long long>(gy) * w + gx] = m;
    ms += m;
    mss += m * m;
    mmx = fmaxf(mmx, m);
  }

  float v[3] = {ms, mss, mmx};
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float o = __shfl_down_sync(0xffffffffu, v[k], off);
      v[k] = k == 2 ? fmaxf(v[k], o) : v[k] + o;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) red[warp][k] = v[k];
  }
  __syncthreads();
  if (tid < 3) {
    float acc = red[0][tid];
    for (int wi = 1; wi < WARPS; ++wi)
      acc = tid == 2 ? fmaxf(acc, red[wi][tid]) : acc + red[wi][tid];
    partials[(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * 3 + tid] = acc;
  }
}

// One block: stats[k] = sum (or max for k = 2) of partials[:, k].
__global__ void __launch_bounds__(RTHREADS)
reduce_partials_kernel(const float* __restrict__ partials, int n,
                       float* __restrict__ stats) {
  __shared__ double acc[RTHREADS][3];
  const int tid = threadIdx.x;
  double v[3] = {0.0, 0.0, -INFINITY};
  for (int i = tid; i < n; i += RTHREADS) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double p = partials[static_cast<long long>(i) * 3 + k];
      v[k] = k == 2 ? fmax(v[k], p) : v[k] + p;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[tid][k] = v[k];
  __syncthreads();
  for (int s = RTHREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        acc[tid][k] = k == 2 ? fmax(acc[tid][k], acc[tid + s][k])
                             : acc[tid][k] + acc[tid + s][k];
    }
    __syncthreads();
  }
  if (tid < 3) stats[tid] = static_cast<float>(acc[0][tid]);
}

dim3 grid_of(int h, int w) { return dim3((w + BW - 1) / BW, (h + BH - 1) / BH); }

}  // namespace

// Rows of the partials buffer (3 floats each) the caller must provide.
extern "C" long long sobel_stats_num_blocks(int h, int w) {
  const dim3 grid = grid_of(h, w);
  return static_cast<long long>(grid.x) * grid.y;
}

// gray (H, W) float32 with element strides s0, s1; mag (H, W)
// contiguous. Returns the first CUDA error of the two launches, or 0.
extern "C" int sobel_stats_f32(const void* gray, long long s0, long long s1,
                               int h, int w, void* mag, void* partials,
                               void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = grid_of(h, w);
  sobel_stats_kernel<<<grid, THREADS, 0, st>>>((const float*)gray, s0, s1, h, w,
                                               (float*)mag, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, RTHREADS, 0, st>>>(
      (const float*)partials, (int)(grid.x * grid.y), (float*)stats);
  return (int)cudaGetLastError();
}
