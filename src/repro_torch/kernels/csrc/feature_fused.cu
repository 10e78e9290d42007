// Fused feature kernel for Hopper: color deconvolution + Sobel of the
// luminance + tile moments, from one read of the RGB planes.
//
// Replaces the TPU kernel `feature_fused_pallas`
// (src/repro/kernels/feature_fused.py, pl.pallas_call at :128).
//
// Outputs: hema and eosin stain planes (od = -log10((x+1)/256), then the
// first two rows of DECONV_MATRIX), the Sobel |grad| of the BT.601
// luminance with edge-replicated borders, and
// stats = [h_sum, h_sumsq, h_max, g_sum, g_sumsq, g_max].
//
// Design. One block per 16x64 tile. The block reads the R, G, B values
// of its tile plus a one-pixel halo (edge-replicated by clamping the
// coordinates, which also masks a ragged image edge) once from device
// memory: each pixel's luminance goes to shared memory, and for pixels
// of the tile the stain planes are computed and stored right there.
// After one barrier the Sobel stencil runs out of shared memory. Each
// block reduces its six moments in a fixed order (warp shuffles, then
// the warps in order) into one row of a partials buffer; a second
// one-block kernel reduces the rows in a fixed order, in double. No
// float atomics: the result is deterministic. The arithmetic uses the
// round-to-nearest intrinsics in the order of the plain version (no FMA
// contraction), IEEE log10f and sqrtf, so the planes agree with it to a
// few ulp.
//
// Bound on the card: bytes. 3 bytes (uint8) read and 12 written per
// pixel against ~60 flops; at 4096x4096 uint8 that is 50.3 MB read +
// 201 MB written, ~75 us at 3.35 TB/s (the halo re-reads, 16% more
// input, mostly hit L2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BH = 16;
constexpr int BW = 64;
constexpr int SH = BH + 2;
constexpr int SW = BW + 2;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RTHREADS = 256;

struct Mat23 {
  float m[6];  // first two rows of DECONV_MATRIX
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
__global__ void __launch_bounds__(THREADS)
feature_fused_kernel(const T* __restrict__ r, const T* __restrict__ g,
                     const T* __restrict__ b, long long rs0, long long rs1,
                     long long gs0, long long gs1, long long bs0,
                     long long bs1, int h, int w, Mat23 M,
                     float* __restrict__ hema, float* __restrict__ eosin,
                     float* __restrict__ mag, float* __restrict__ partials) {
  __shared__ float gray[SH][SW];
  __shared__ float red[WARPS][6];
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  const int tid = threadIdx.x;
  float hs = 0.f, hss = 0.f, hmx = -INFINITY;
  float gs = 0.f, gss = 0.f, gmx = -INFINITY;

  for (int i = tid; i < SH * SW; i += THREADS) {
    const int sy = i / SW, sx = i % SW;
    const int gy = min(max(y0 - 1 + sy, 0), h - 1);
    const int gx = min(max(x0 - 1 + sx, 0), w - 1);
    const float rv = static_cast<float>(r[gy * rs0 + gx * rs1]);
    const float gv = static_cast<float>(g[gy * gs0 + gx * gs1]);
    const float bv = static_cast<float>(b[gy * bs0 + gx * bs1]);
    gray[sy][sx] = dot3(0.299f, 0.587f, 0.114f, rv, gv, bv);
    const bool inner = sy >= 1 && sy <= BH && sx >= 1 && sx <= BW &&
                       y0 + sy - 1 < h && x0 + sx - 1 < w;
    if (inner) {
      const float odr = od(rv), odg = od(gv), odb = od(bv);
      const float he = dot3(M.m[0], M.m[1], M.m[2], odr, odg, odb);
      const long long o = static_cast<long long>(gy) * w + gx;
      hema[o] = he;
      eosin[o] = dot3(M.m[3], M.m[4], M.m[5], odr, odg, odb);
      hs += he;
      hss += he * he;
      hmx = fmaxf(hmx, he);
    }
  }
  __syncthreads();

  for (int p = tid; p < BH * BW; p += THREADS) {
    const int sy = p / BW + 1, sx = p % BW + 1;
    const int gy = y0 + sy - 1, gx = x0 + sx - 1;
    if (gy >= h || gx >= w) continue;
    const float a00 = gray[sy - 1][sx - 1], a01 = gray[sy - 1][sx],
                a02 = gray[sy - 1][sx + 1];
    const float a10 = gray[sy][sx - 1], a12 = gray[sy][sx + 1];
    const float a20 = gray[sy + 1][sx - 1], a21 = gray[sy + 1][sx],
                a22 = gray[sy + 1][sx + 1];
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
    gs += m;
    gss += m * m;
    gmx = fmaxf(gmx, m);
  }

  // Block reduction in a fixed order: warp shuffles, then warp 0.
  float v[6] = {hs, hss, hmx, gs, gss, gmx};
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float o = __shfl_down_sync(0xffffffffu, v[k], off);
      v[k] = (k == 2 || k == 5) ? fmaxf(v[k], o) : v[k] + o;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) red[warp][k] = v[k];
  }
  __syncthreads();
  if (tid < 6) {
    float acc = red[0][tid];
    for (int wi = 1; wi < WARPS; ++wi)
      acc = (tid == 2 || tid == 5) ? fmaxf(acc, red[wi][tid])
                                   : acc + red[wi][tid];
    partials[(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) *
                 6 + tid] = acc;
  }
}

// One block: stats[k] = sum (or max for k = 2, 5) of partials[:, k].
__global__ void __launch_bounds__(RTHREADS)
reduce_partials_kernel(const float* __restrict__ partials, int n,
                       float* __restrict__ stats) {
  __shared__ double acc[RTHREADS][6];
  const int tid = threadIdx.x;
  double v[6] = {0.0, 0.0, -INFINITY, 0.0, 0.0, -INFINITY};
  for (int i = tid; i < n; i += RTHREADS) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const double p = partials[static_cast<long long>(i) * 6 + k];
      v[k] = (k == 2 || k == 5) ? fmax(v[k], p) : v[k] + p;
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[tid][k] = v[k];
  __syncthreads();
  for (int s = RTHREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        acc[tid][k] = (k == 2 || k == 5) ? fmax(acc[tid][k], acc[tid + s][k])
                                         : acc[tid][k] + acc[tid + s][k];
    }
    __syncthreads();
  }
  if (tid < 6) stats[tid] = static_cast<float>(acc[0][tid]);
}

dim3 grid_of(int h, int w) { return dim3((w + BW - 1) / BW, (h + BH - 1) / BH); }

template <typename T>
int launch(const void* r, const void* g, const void* b, long long rs0,
           long long rs1, long long gs0, long long gs1, long long bs0,
           long long bs1, int h, int w, const float* m, void* hema,
           void* eosin, void* mag, void* partials, void* stats,
           void* stream) {
  Mat23 M;
  for (int i = 0; i < 6; ++i) M.m[i] = m[i];
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = grid_of(h, w);
  feature_fused_kernel<T><<<grid, THREADS, 0, s>>>(
      (const T*)r, (const T*)g, (const T*)b, rs0, rs1, gs0, gs1, bs0, bs1, h,
      w, M, (float*)hema, (float*)eosin, (float*)mag, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, RTHREADS, 0, s>>>(
      (const float*)partials, (int)(grid.x * grid.y), (float*)stats);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of the partials buffer (6 floats each) the caller must provide.
extern "C" long long feature_fused_num_blocks(int h, int w) {
  const dim3 grid = grid_of(h, w);
  return static_cast<long long>(grid.x) * grid.y;
}

// Strides are in elements; m holds the first two rows of DECONV_MATRIX.
// Returns the first CUDA error of the two launches, or 0.
extern "C" int feature_fused_u8(const void* r, const void* g, const void* b,
                                long long rs0, long long rs1, long long gs0,
                                long long gs1, long long bs0, long long bs1,
                                int h, int w, const float* m, void* hema,
                                void* eosin, void* mag, void* partials,
                                void* stats, void* stream) {
  return launch<uint8_t>(r, g, b, rs0, rs1, gs0, gs1, bs0, bs1, h, w, m, hema,
                         eosin, mag, partials, stats, stream);
}

extern "C" int feature_fused_f32(const void* r, const void* g, const void* b,
                                 long long rs0, long long rs1, long long gs0,
                                 long long gs1, long long bs0, long long bs1,
                                 int h, int w, const float* m, void* hema,
                                 void* eosin, void* mag, void* partials,
                                 void* stats, void* stream) {
  return launch<float>(r, g, b, rs0, rs1, gs0, gs1, bs0, bs1, h, w, m, hema,
                       eosin, mag, partials, stats, stream);
}
