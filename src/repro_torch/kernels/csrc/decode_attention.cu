// Single-token decode attention over a KV cache, for Hopper.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py, pl.pallas_call at :85).
//
// out[b, h] = softmax(q[b, h] . k[b, h / group, :len_b] * scale)
//             v[b, h / group, :len_b]
// with q (B, HQ, D), k/v (B, HKV, S, D), lengths (B,) int32 (clamped to
// [0, S]; a length of 0 gives zeros, as the TPU kernel does), all
// contiguous, float32 or bfloat16; the output has q's type.
//
// Design (flash-decoding). A batch of 4 x 32 heads is far too small a
// grid for 132 SMs, so the cache length is split across blocks: one
// block of 128 threads per (128-key split, q head, batch). Each thread
// scores one key (its K row read with 16-byte loads), the block reduces
// the split's max and sum in float32, and the P.V product runs with
// each thread on one output column and a slice of the keys. A split at
// or past its sequence's length returns at once: it reads nothing. The
// split's (max, sum, D partial outputs) go to a float32 workspace; a
// second kernel, one block per (head, batch), combines the valid splits
// in a fixed order. q head h reads KV head h / group (the TPU kernel's
// index map), with no repeated K/V.
//
// Bound on the card: bytes. Every valid K and V row is read once:
// at B=4, HQ=HKV=32, D=64, bf16, lengths [2048, 1025, 700, 1] that is
// 31 MB, 9.2 us at 3.35 TB/s; the operations (4 per key element) are
// far below the float32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SPLIT = 128;    // keys per block = threads per block
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Dot product of one contiguous row of D elements with q (float32 in
// shared memory), read with 16-byte loads (rows are 16-byte aligned).
template <int D>
__device__ __forceinline__ float row_dot(const float* row, const float* qs) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = r4[i];
    acc = fmaf(qs[4 * i + 0], x.x, acc);
    acc = fmaf(qs[4 * i + 1], x.y, acc);
    acc = fmaf(qs[4 * i + 2], x.z, acc);
    acc = fmaf(qs[4 * i + 3], x.w, acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* row, const float* qs) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint4 x = r4[i];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
    for (int t = 0; t < 8; ++t) acc = fmaf(qs[8 * i + t], __bfloat162float(e[t]), acc);
  }
  return acc;
}

__device__ __forceinline__ int valid_len(const int* lengths, int b, int S) {
  return min(max(lengths[b], 0), S);
}

template <typename T, int D>
__global__ void __launch_bounds__(SPLIT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    int HQ, int HKV, int S, float scale, int nsplit,
                    float* __restrict__ part_o, float* __restrict__ part_ml) {
  constexpr int PARTS = SPLIT / D;  // threads per output column
  __shared__ float qs[D];
  __shared__ float ps[SPLIT];
  __shared__ float red[SPLIT / 32];
  __shared__ float accs[PARTS][D];
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = valid_len(lengths, b, S);
  const int k0 = sp * SPLIT;
  if (k0 >= len) return;  // past the sequence: no work, never combined
  const int n = min(SPLIT, len - k0);
  const int hk = h / (HQ / HKV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = static_cast<long long>(b) * HQ + h;
  const long long kvoff = (static_cast<long long>(b) * HKV + hk) * S * D;

  if (tid < D) qs[tid] = to_f(q[bh * D + tid]);
  __syncthreads();

  float s = NEG;
  if (tid < n) s = row_dot<D>(k + kvoff + static_cast<long long>(k0 + tid) * D, qs) * scale;

  float mx = s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < SPLIT / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();  // red is reused for the sum

  const float p = tid < n ? expf(s - mx) : 0.f;
  ps[tid] = p;
  float sum = p;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) red[warp] = sum;
  __syncthreads();

  const int d = tid % D, part = tid / D;
  const T* vp = v + kvoff + static_cast<long long>(k0) * D + d;
  float a = 0.f;
  for (int kk = part; kk < n; kk += PARTS)
    a = fmaf(ps[kk], to_f(vp[static_cast<long long>(kk) * D]), a);
  accs[part][d] = a;
  __syncthreads();

  const long long slot = bh * nsplit + sp;
  if (tid < D) {
    float o = accs[0][tid];
#pragma unroll
    for (int t = 1; t < PARTS; ++t) o += accs[t][tid];
    part_o[slot * D + tid] = o;
  }
  if (tid == 0) {
    float l = red[0];
#pragma unroll
    for (int w = 1; w < SPLIT / 32; ++w) l += red[w];
    part_ml[slot * 2 + 0] = mx;
    part_ml[slot * 2 + 1] = l;
  }
}

// One block of D threads per (q head, batch): rescale the valid splits
// to their common max and normalise, in split order.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                      const int* __restrict__ lengths, int HQ, int S, int nsplit,
                      T* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int nvalid = (valid_len(lengths, b, S) + SPLIT - 1) / SPLIT;
  const long long bh = static_cast<long long>(b) * HQ + h;
  const float* ml = part_ml + bh * nsplit * 2;
  const float* po = part_o + bh * nsplit * D;
  float m = NEG;
  for (int i = 0; i < nvalid; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, o = 0.f;
  for (int i = 0; i < nvalid; ++i) {
    const float w = expf(ml[2 * i] - m);
    l = fmaf(ml[2 * i + 1], w, l);
    o = fmaf(po[static_cast<long long>(i) * D + d], w, o);
  }
  out[bh * D + d] = from_f<T>(o / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* part_o, void* part_ml, int B, int HQ, int HKV,
           int S, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nsplit = (S + SPLIT - 1) / SPLIT;
  decode_split_kernel<T, D><<<dim3(nsplit, HQ, B), SPLIT, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, HQ, HKV, S,
      scale, nsplit, (float*)part_o, (float*)part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<dim3(HQ, B), D, 0, st>>>(
      (const float*)part_o, (const float*)part_ml, (const int*)lengths, HQ, S,
      nsplit, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* out, void* part_o, void* part_ml, int B, int HQ, int HKV,
             int S, int D, float scale, void* stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, lengths, out, part_o, part_ml, B, HQ, HKV, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, part_o, part_ml, B, HQ, HKV, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, part_o, part_ml, B, HQ, HKV, S, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Splits of the cache length: the workspace holds B*HQ*splits*D floats
// (part_o) and B*HQ*splits*2 floats (part_ml).
extern "C" int decode_attention_splits(int S) { return (S + SPLIT - 1) / SPLIT; }

// q (B, HQ, D), k/v (B, HKV, S, D), lengths (B,) int32, out (B, HQ, D);
// contiguous, 16-byte aligned; D in {32, 64, 128}; HQ a multiple of
// HKV. Returns the first CUDA error of the two launches, or 0.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, void* part_o,
                                    void* part_ml, int B, int HQ, int HKV, int S,
                                    int D, float scale, void* stream) {
  return dispatch<float>(q, k, v, lengths, out, part_o, part_ml, B, HQ, HKV, S, D, scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, void* part_o,
                                     void* part_ml, int B, int HQ, int HKV, int S,
                                     int D, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, out, part_o, part_ml, B, HQ, HKV, S, D,
                                 scale, stream);
}
