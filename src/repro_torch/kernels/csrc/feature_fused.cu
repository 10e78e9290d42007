// Fused feature kernel for Hopper: color deconvolution + Sobel of the
// luminance + tile moments, from one read of the RGB planes, in one
// launch.
//
// Replaces the TPU kernel `feature_fused_pallas`
// (src/repro/kernels/feature_fused.py, pl.pallas_call at :128).
//
// Outputs: hema and eosin stain planes (od = -log10((x+1)/256), then the
// first two rows of DECONV_MATRIX), the Sobel |grad| of the BT.601
// luminance with edge-replicated borders, and
// stats = [h_sum, h_sumsq, h_max, g_sum, g_sumsq, g_max].
//
// Bound on the card: bytes. 3 bytes (uint8) read and 12 written per
// pixel against ~60 flops; at 4096x4096 uint8 that is 50.3 MB read +
// 201 MB written, ~75 us at 3.35 TB/s.
//
// Design (strip_stencil.cuh has the walk and the merge). A few hundred
// blocks, each walking a 256-pixel strip of `rows` rows with a ring of
// luminance rows in shared memory, so halo rows are read once per
// strip. Converting an input row computes each pixel's luminance (into
// the ring) and, on the block's own rows, its stain planes, stored
// right there; the Sobel pass then runs out of the ring. Moments merge
// in the same launch (the last block), in block order.
//   * Interleaved input (the main path: r, g, b are the channel views
//     rgb[..., c] of one HWC uint8 buffer, rows 16-byte aligned): each
//     row segment is copied as 16-byte `cp.async` chunks into a ring of
//     STAGES steps in shared memory, and de-interleaved there, four
//     pixels (three 32-bit words) per thread.
//   * Any other layout (separate or strided planes, float32, a crop
//     whose rows are not 16-byte aligned) reads each element with its
//     strides; the arithmetic is shared.
//   * uint8 input looks the optical density up in a 256-entry table in
//     shared memory, filled per block by the same od() on the same card:
//     bit-equal to computing it per pixel. float32 computes it per pixel.
//   * Planes are stored as 16-byte vectors where the row allows.
// The arithmetic uses the round-to-nearest intrinsics in the order of
// the plain version (no FMA contraction), IEEE log10f and sqrtf, so the
// planes agree with it to a few ulp.

#include "strip_stencil.cuh"

namespace {

using namespace strip;

constexpr int ROWB = 3 * TW + 32;  // bytes of one interleaved row segment in the ring
constexpr int CHUNKS = ROWB / 16;  // its 16-byte chunks: bytes 3*x0 - 16 .. 3*(x0+TW) + 16
constexpr int INTERLEAVED = 0, PLANAR_U8 = 1, PLANAR_F32 = 2;

struct Mat23 {
  float m[6];  // first two rows of DECONV_MATRIX
};

struct Planes {
  const void* r;
  const void* g;
  const void* b;
  long long rs0, rs1, gs0, gs1, bs0, bs1;  // element strides
};

__device__ __forceinline__ float od(float x) {
  return -log10f(__fdiv_rn(__fadd_rn(x, 1.0f), 256.0f));
}

__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

__device__ __forceinline__ float lum(float r, float g, float b) {
  return dot3(0.299f, 0.587f, 0.114f, r, g, b);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
feature_fused_kernel(Planes P, int h, int w, int rows, Mat23 M, float* __restrict__ hema,
                     float* __restrict__ eosin, float* __restrict__ mag,
                     float* __restrict__ partials, int* __restrict__ counter,
                     float* __restrict__ stats) {
  __shared__ __align__(16) unsigned char raw[MODE == INTERLEAVED ? STAGES * RPS * ROWB : 16];
  __shared__ __align__(16) float ring[RING * PITCH];
  __shared__ float od_tab[256];
  const int tid = threadIdx.x, rr = tid / TPR, cx = tid % TPR;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * rows;
  const int rows_here = min(rows, h - y0);
  const int nx = min(PX, w - x0 - PX * cx);  // the thread's pixels inside the image
  const bool vec = (w % PX) == 0;
  if (MODE != PLANAR_F32) od_tab[tid] = od(static_cast<float>(tid));  // THREADS == 256
  float hs = 0.f, hss = 0.f, hmx = -INFINITY, gs = 0.f, gss = 0.f, gmx = -INFINITY;

  auto image_row = [&](int i) { return min(max(y0 - 1 + i, 0), h - 1); };

  auto fetch = [&](int f, int stage) {
    if constexpr (MODE == INTERLEAVED) {
      if (tid < RPS * CHUNKS) {
        const int r = tid / CHUNKS, k = tid % CHUNKS, i = RPS * f + r;
        const long long off = 3LL * x0 - 16 + 16 * k;
        const long long n = min(16LL, 3LL * w - off);
        if (i <= rows_here + 1 && off >= 0 && n > 0)
          cp_async16(raw + (stage * RPS + r) * ROWB + 16 * k,
                     static_cast<const unsigned char*>(P.r) + image_row(i) * P.rs0 + off,
                     static_cast<int>(n));
      }
    }
  };

  // Channel values of pixel gx (inside the image) of input row i: bytes
  // for uint8 input, floats for float32.
  auto px_u8 = [&](int i, int stage, int gx, int& cr, int& cg, int& cb) {
    if constexpr (MODE == INTERLEAVED) {
      const unsigned char* p = raw + (stage * RPS + rr) * ROWB + 16 + 3 * (gx - x0);
      cr = p[0];
      cg = p[1];
      cb = p[2];
    } else {
      const long long gy = image_row(i);
      cr = static_cast<const uint8_t*>(P.r)[gy * P.rs0 + gx * P.rs1];
      cg = static_cast<const uint8_t*>(P.g)[gy * P.gs0 + gx * P.gs1];
      cb = static_cast<const uint8_t*>(P.b)[gy * P.bs0 + gx * P.bs1];
    }
  };
  auto px_f32 = [&](int i, int gx, float& r, float& g, float& b) {
    const long long gy = image_row(i);
    r = static_cast<const float*>(P.r)[gy * P.rs0 + gx * P.rs1];
    g = static_cast<const float*>(P.g)[gy * P.gs0 + gx * P.gs1];
    b = static_cast<const float*>(P.b)[gy * P.bs0 + gx * P.bs1];
  };
  auto lum_at = [&](int i, int stage, int gx) {
    if constexpr (MODE == PLANAR_F32) {
      float r, g, b;
      px_f32(i, gx, r, g, b);
      return lum(r, g, b);
    } else {
      int cr, cg, cb;
      px_u8(i, stage, gx, cr, cg, cb);
      return lum(static_cast<float>(cr), static_cast<float>(cg), static_cast<float>(cb));
    }
  };

  auto convert = [&](int s, int stage) {
    const int i = RPS * s + rr;
    if (i > rows_here + 1) return;
    float* lrow = ring + (i & (RING - 1)) * PITCH;
    float l[PX], odr[PX], odg[PX], odb[PX];
    if constexpr (MODE == PLANAR_F32) {
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        float r, g, b;
        px_f32(i, min(x0 + PX * cx + k, w - 1), r, g, b);
        l[k] = lum(r, g, b);
        odr[k] = od(r);
        odg[k] = od(g);
        odb[k] = od(b);
      }
    } else {
      int cr[PX], cg[PX], cb[PX];
      if (MODE == INTERLEAVED && nx == PX) {
        // Pixels 4cx .. 4cx+3 of the strip: 12 bytes at a 4-byte boundary.
        const uint32_t* q = reinterpret_cast<const uint32_t*>(
            raw + (stage * RPS + rr) * ROWB + 16 + 3 * PX * cx);
        const uint32_t w0 = q[0], w1 = q[1], w2 = q[2];
        cr[0] = w0 & 255u, cg[0] = (w0 >> 8) & 255u, cb[0] = (w0 >> 16) & 255u;
        cr[1] = w0 >> 24, cg[1] = w1 & 255u, cb[1] = (w1 >> 8) & 255u;
        cr[2] = (w1 >> 16) & 255u, cg[2] = w1 >> 24, cb[2] = w2 & 255u;
        cr[3] = (w2 >> 8) & 255u, cg[3] = (w2 >> 16) & 255u, cb[3] = w2 >> 24;
      } else {
#pragma unroll
        for (int k = 0; k < PX; ++k)
          px_u8(i, stage, min(x0 + PX * cx + k, w - 1), cr[k], cg[k], cb[k]);
      }
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        l[k] = lum(static_cast<float>(cr[k]), static_cast<float>(cg[k]), static_cast<float>(cb[k]));
        odr[k] = od_tab[cr[k]];
        odg[k] = od_tab[cg[k]];
        odb[k] = od_tab[cb[k]];
      }
    }
    *reinterpret_cast<float4*>(lrow + COL0 + 1 + PX * cx) = make_float4(l[0], l[1], l[2], l[3]);
    if (cx == 0) lrow[COL0] = lum_at(i, stage, max(x0 - 1, 0));
    if (cx == TPR - 1) lrow[COL0 + TW + 1] = lum_at(i, stage, min(x0 + TW, w - 1));
    if (i < 1 || i > rows_here || nx <= 0) return;  // a halo row, or no pixel here
    float he[PX], eo[PX];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      he[k] = dot3(M.m[0], M.m[1], M.m[2], odr[k], odg[k], odb[k]);
      eo[k] = dot3(M.m[3], M.m[4], M.m[5], odr[k], odg[k], odb[k]);
      if (k < nx) {
        hs += he[k];
        hss += he[k] * he[k];
        hmx = fmaxf(hmx, he[k]);
      }
    }
    const long long o = static_cast<long long>(y0 - 1 + i) * w + x0 + PX * cx;
    store_px(hema, o, he, nx, vec);
    store_px(eosin, o, eo, nx, vec);
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
        gs += m[k];
        gss += m[k] * m[k];
        gmx = fmaxf(gmx, m[k]);
      }
  };

  walk(steps_of(rows_here), fetch, convert, emit);
  float v[6] = {hs, hss, hmx, gs, gss, gmx};
  merge_moments<6, 0x24u>(v, partials, counter, stats);
}

template <int MODE>
int launch(const Planes& P, int h, int w, int rows, const float* m, void* hema, void* eosin,
           void* mag, void* partials, long long partials_len, void* counter, void* stats,
           cudaStream_t s) {
  Mat23 M;
  for (int i = 0; i < 6; ++i) M.m[i] = m[i];
  const dim3 grid = grid_of(h, w, rows);
  feature_fused_kernel<MODE><<<grid, THREADS, 0, s>>>(
      P, h, w, rows, M, static_cast<float*>(hema), static_cast<float*>(eosin),
      static_cast<float*>(mag), static_cast<float*>(partials), static_cast<int*>(counter),
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over an h x w image in blocks of `rows` rows. mode 0: r, g,
// b are the channels of one HWC uint8 buffer (g = r + 1, b = r + 2,
// column stride 3, row stride and r 16-byte aligned); mode 1: uint8
// planes, mode 2: float32 planes, any element strides. m holds the first
// two rows of DECONV_MATRIX. `partials` holds at least 6 floats per
// block; `counter` is one int32, 0 before the launch and left 0 after
// it. Returns a CUDA error (cudaErrorInvalidValue for arguments the
// kernel does not take), or 0.
extern "C" int feature_fused(int mode, const void* r, const void* g, const void* b,
                             long long rs0, long long rs1, long long gs0, long long gs1,
                             long long bs0, long long bs1, int h, int w, int rows,
                             const float* m, void* hema, void* eosin, void* mag, void* partials,
                             long long partials_len, void* counter, void* stats, void* stream) {
  if (h < 1 || w < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(h, w, rows);
  if (grid.y > 65535 || partials_len < 6LL * grid.x * grid.y)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t base = reinterpret_cast<uintptr_t>(r);
  if (mode == INTERLEAVED &&
      (reinterpret_cast<uintptr_t>(g) != base + 1 || reinterpret_cast<uintptr_t>(b) != base + 2 ||
       rs1 != 3 || gs1 != 3 || bs1 != 3 || gs0 != rs0 || bs0 != rs0 || rs0 % 16 || base % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes P{r, g, b, rs0, rs1, gs0, gs1, bs0, bs1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case INTERLEAVED:
      return launch<INTERLEAVED>(P, h, w, rows, m, hema, eosin, mag, partials, partials_len,
                                 counter, stats, s);
    case PLANAR_U8:
      return launch<PLANAR_U8>(P, h, w, rows, m, hema, eosin, mag, partials, partials_len,
                               counter, stats, s);
    case PLANAR_F32:
      return launch<PLANAR_F32>(P, h, w, rows, m, hema, eosin, mag, partials, partials_len,
                                counter, stats, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
