// Flash attention (prefill / training forward) for Hopper.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, pl.pallas_call at :93).
//
// out[b, h] = softmax(q[b, h] k[b, h / group]^T * scale [+ causal mask])
//             v[b, h / group]
// with q (B, H, S, D), k/v (B, HKV, S, D), group = H / HKV, all
// contiguous, float32 or bfloat16; the output has q's type.
//
// Design. One block of 256 threads per (q block of 64 rows, head,
// batch). The Q tile and each 64-key K/V tile are staged through
// shared memory as float32 (K transposed, rows padded, so that neither
// the score loop nor the P.V loop has bank conflicts). Each thread owns
// 4 query rows x 4 keys of a score tile and 4 rows x D/16 columns of
// the output accumulator, in registers. The running max, denominator
// and accumulator are float32 (online softmax, as the TPU kernel's VMEM
// scratch). Causal: a q block visits only the KV blocks at or before
// its diagonal, so fully masked blocks cost nothing; the heaviest q
// blocks are scheduled first. A ragged last block is masked (keys past
// S never count, rows past S are not stored), so any S is accepted. A
// q head reads KV head h / group through the index arithmetic: no
// repeated K/V is materialised.
//
// Bound on the card: at B=4, H=32, S=1024, D=64, bf16, causal, the two
// products over the lower triangle need 2 * B*H*S*(S+1)*D = 17.2 GFLOP
// (17.4 us at the dense bf16 tensor-core rate, 989 TFLOP/s) and q, k,
// v, out move 67.1 MB (20.0 us at 3.35 TB/s): the bytes bound it, just.
// This first version multiplies in float32 on the CUDA cores (no tensor
// cores, no TMA), so it is held to the float32 rate (67 TFLOP/s,
// 257 us) at best; tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
struct Smem {
  static constexpr int QS = D + 4;   // Q tile [row][d]
  static constexpr int KS = BK + 4;  // K^T tile [d][key]
  static constexpr int VS = D;       // V tile [key][d]
  static constexpr int PS = BK + 4;  // P tile [row][key]
  static constexpr int FLOATS = BQ * QS + D * KS + BK * VS + BQ * PS;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int HKV,
                 int S, float scale, int causal) {
  using L = Smem<D>;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + BQ * L::QS;
  float* Vs = Kt + D * L::KS;
  float* Ps = Vs + BK * L::VS;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest (causal) first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int q0 = qb * BQ;
  const long long qoff = (static_cast<long long>(b) * H + h) * S * D;
  const long long koff = (static_cast<long long>(b) * HKV + hk) * S * D;
  const T* qp = q + qoff;
  const T* kp = k + koff;
  const T* vp = v + koff;
  T* op = o + qoff;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * L::QS + c] =
        q0 + r < S ? to_f(qp[static_cast<long long>(q0 + r) * D + c]) : 0.f;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  const int nkb = (kend + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block's K/V/P are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < S;
      const long long g = static_cast<long long>(k0 + r) * D + c;
      Kt[c * L::KS + r] = ok ? to_f(kp[g]) : 0.f;
      Vs[r * L::VS + c] = ok ? to_f(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * L::KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (col >= S || (causal && col > row)) val = NEG;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      // The 16 threads of a row are 16 neighbouring lanes.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * L::PS + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * L::PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * L::VS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      op[static_cast<long long>(row) * D + tx + 16 * j] = from_f<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int HKV, int S, float scale, int causal, void* stream) {
  using L = Smem<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, L::BYTES, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, HKV, S, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
             int HKV, int S, int D, float scale, int causal, void* stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, HKV, S, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, HKV, S, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, HKV, S, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, S, D), k/v (B, HKV, S, D), o (B, H, S, D), contiguous; D in
// {32, 64, 128}; H a multiple of HKV. Returns the CUDA error, or 0.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int HKV, int S, int D,
                                   float scale, int causal, void* stream) {
  return dispatch<float>(q, k, v, o, B, H, HKV, S, D, scale, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int H, int HKV, int S, int D,
                                    float scale, int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, HKV, S, D, scale, causal, stream);
}
