// The strip walk shared by feature_fused.cu and sobel_stats.cu: a 3x3
// stencil over a plane built row by row in shared memory, and the
// moments of its output merged across blocks inside the same launch.
//
// Layout. The image is cut into strips TW pixels wide; block (bx, by)
// owns columns [TW*bx, TW*bx + TW) of rows [rows*by, rows*by + rows)
// (`rows` is the host's choice, see the wrappers' `plan`). A block walks
// its rows top to bottom in steps of RPS rows. Its "input rows" are the
// image rows y0 - 1 .. y0 + rows, clamped to the image (input row i is
// image row clamp(y0 - 1 + i)), so the halo rows are read once per
// block and not once per tile. Step s:
//   1. waits for its copies (issued STAGES - 1 steps earlier) and
//      passes a barrier, then issues the copies of step s + STAGES - 1;
//   2. converts input rows RPS*s .. RPS*s + RPS - 1 into a ring of RING
//      rows of the stencil's plane (luminance, or the plane itself),
//      columns x0 - 1 .. x0 + TW clamped to the image;
//   3. passes a barrier and emits output rows RPS*s - 2 .. RPS*s + 1
//      (image rows y0 + j), each from ring rows j, j + 1, j + 2.
// The barrier of step s + 1 separates step s's reads of the ring from
// step s + 1's writes, so a ring of 8 rows is enough. Thread t handles
// ring row t / TPR, pixels PX*(t % TPR) .. + PX - 1 of the strip: one
// 16-byte load or store per row and plane.
//
// The merge. Each block reduces its moments in a fixed order (warp
// shuffles, then the warps in order) into one row of `partials`; one
// thread fences and bumps an int32 counter that lives in a buffer of its
// own; the block that arrives last merges all rows in block order, in
// double, writes `stats` and resets the counter to 0 for the next call
// on the stream. No float atomics: the result does not depend on which
// block arrives last.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace strip {

constexpr int TW = 256;               // strip width, pixels
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PX = 4;                 // pixels of a row per thread
constexpr int TPR = TW / PX;          // threads per row
constexpr int RPS = THREADS / TPR;    // rows per step
constexpr int RING = 8;               // rows of the stencil's plane kept
constexpr int PITCH = TW + 8;         // floats per ring row
constexpr int COL0 = 3;               // ring index of column x0 - 1
constexpr int STAGES = 4;             // steps of input in flight
constexpr int MIN_BLOCKS = 4;         // blocks per SM the launch bounds ask for

static_assert(RPS * TPR == THREADS && RPS == 4, "the emit window assumes 4 rows per step");
static_assert((COL0 + 1) % 4 == 0 && PITCH % 4 == 0, "interior columns 16-byte aligned");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies the first n (1..16) bytes at src (16-byte aligned) into dst
// (16-byte aligned shared memory) and zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Steps of one block (see the header). fetch(f, stage) issues the
// copies of step f into `stage`; convert(s, stage) fills the ring rows
// of step s; emit(s) writes its output rows.
template <class Fetch, class Convert, class Emit>
__device__ __forceinline__ void walk(int nsteps, Fetch fetch, Convert convert, Emit emit) {
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) fetch(s, s % STAGES);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int f = s + STAGES - 1;
    if (f < nsteps) fetch(f, f % STAGES);
    cp_async_commit();
    convert(s, s % STAGES);
    __syncthreads();
    emit(s);
  }
}

// Steps a block of `rows_here` output rows takes: the last emits row
// rows_here - 1.
__device__ __forceinline__ int steps_of(int rows_here) { return (rows_here + 1) / RPS + 1; }

// |grad| of the 3x3 Sobel stencil, in the plain version's order (no
// FMA contraction), IEEE sqrtf.
__device__ __forceinline__ float sobel_mag(float a00, float a01, float a02, float a10,
                                           float a12, float a20, float a21, float a22) {
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
  return sqrtf(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)));
}

// Ring columns PX*cx - 1 .. PX*cx + PX (the thread's pixels and their
// neighbours) of ring row r.
__device__ __forceinline__ void ring6(const float* ring, int r, int cx, float v[PX + 2]) {
  const float* p = ring + (r & (RING - 1)) * PITCH + COL0 + PX * cx;
  const float4 q = *reinterpret_cast<const float4*>(p + 1);
  v[0] = p[0];
  v[1] = q.x;
  v[2] = q.y;
  v[3] = q.z;
  v[4] = q.w;
  v[5] = p[PX + 1];
}

// The thread's PX magnitudes of output row j (ring rows j, j+1, j+2).
__device__ __forceinline__ void sobel_row(const float* ring, int j, int cx, float m[PX]) {
  float a[PX + 2], b[PX + 2], c[PX + 2];
  ring6(ring, j, cx, a);
  ring6(ring, j + 1, cx, b);
  ring6(ring, j + 2, cx, c);
#pragma unroll
  for (int k = 0; k < PX; ++k)
    m[k] = sobel_mag(a[k], a[k + 1], a[k + 2], b[k], b[k + 2], c[k], c[k + 1], c[k + 2]);
}

// Stores the first n (<= PX) of v at plane + off: one 16-byte store when
// all PX are inside the image and the row is 16-byte aligned.
__device__ __forceinline__ void store_px(float* plane, long long off, const float v[PX], int n,
                                         bool vec) {
  if (n == PX && vec) {
    *reinterpret_cast<float4*>(plane + off) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k)
      if (k < n) plane[off + k] = v[k];
  }
}

template <unsigned MAXMASK>
__device__ __forceinline__ float combine(int k, float a, float b) {
  return (MAXMASK >> k) & 1u ? fmaxf(a, b) : a + b;
}
template <unsigned MAXMASK>
__device__ __forceinline__ double combine(int k, double a, double b) {
  return (MAXMASK >> k) & 1u ? fmax(a, b) : a + b;
}

// The block's K moments (sums, or maxima where bit k of MAXMASK is set)
// from each thread's v, into row `block` of partials; the last block to
// arrive merges every row in block order and writes stats (see the
// header). Every thread of the block calls it.
template <int K, unsigned MAXMASK>
__device__ void merge_moments(float v[K], float* __restrict__ partials, int* __restrict__ counter,
                              float* __restrict__ stats) {
  __shared__ float red[WARPS][K];
  __shared__ double dred[WARPS][K];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = combine<MAXMASK>(k, v[k], __shfl_down_sync(0xffffffffu, v[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k] = v[k];
  __syncthreads();
  if (tid < K) {
    float acc = red[0][tid];
    for (int wi = 1; wi < WARPS; ++wi) acc = combine<MAXMASK>(tid, acc, red[wi][tid]);
    partials[static_cast<long long>(block) * K + tid] = acc;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(counter, 1) + 1 == nblocks;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  double d[K];
#pragma unroll
  for (int k = 0; k < K; ++k) d[k] = (MAXMASK >> k) & 1u ? -INFINITY : 0.0;
  for (int i = tid; i < nblocks; i += THREADS)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float p = __ldcg(partials + static_cast<long long>(i) * K + k);
      d[k] = combine<MAXMASK>(k, d[k], static_cast<double>(p));
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      d[k] = combine<MAXMASK>(k, d[k], __shfl_down_sync(0xffffffffu, d[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) dred[warp][k] = d[k];
  __syncthreads();
  if (tid < K) {
    double acc = dred[0][tid];
    for (int wi = 1; wi < WARPS; ++wi) acc = combine<MAXMASK>(tid, acc, dred[wi][tid]);
    stats[tid] = static_cast<float>(acc);
  }
  if (tid == 0) *counter = 0;  // every block has arrived: ready for the next call
}

// Grid of a launch over an h x w image in blocks of `rows` rows.
inline dim3 grid_of(int h, int w, int rows) {
  return dim3(static_cast<unsigned>((w + TW - 1) / TW),
              static_cast<unsigned>((h + rows - 1) / rows));
}

}  // namespace strip
