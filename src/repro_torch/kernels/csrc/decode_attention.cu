// Single-token decode attention over a KV cache, for Hopper.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py, pl.pallas_call at :85).
//
// out[b, h] = softmax(q[b, h] . k[b, h / group, :len_b] * scale)
//             v[b, h / group, :len_b]
// with q (B, HQ, D), k/v (B, HKV, S, D), group = HQ / HKV, lengths (B,)
// int32 (clamped to [0, S]; a length of 0 gives zeros, as the TPU kernel
// does), all contiguous and 16-byte aligned, float32 or bfloat16; the
// output has q's type.
//
// Bound on the card: bytes. Each valid K and V row of each KV head must
// be read once, plus q and out: at B=4, HQ=HKV=32, D=64, bf16, lengths
// [2048, 1025, 700, 1] that is 31 MB (9.2 us at 3.35 TB/s); at B=4,
// HQ=32, HKV=8, D=128, bf16, S=16384, lengths [16384, 9000, 4097, 1]
// (the dense models' long-context GQA decode) 120.8 MB (36 us). The
// arithmetic (4 operations per key element and query head) is far below
// the card's rates, but on the CUDA cores its instructions (and the
// shuffles that reduce a dot product spread over lanes) take as long as
// the reads once a block serves 4 or more query heads. So the design
// keeps enough bytes in flight, reads each row once whatever the group,
// multiplies bfloat16 on the tensor cores, and spends one launch.
//
// Design, one launch per call:
// - One block of 4 warps per (split of the cache length, KV head, chunk
//   of its query heads, batch row): up to 16 heads for bfloat16 (the
//   rows of one mma), 1, 2, 4 or 8 for float32. A block serves every
//   query head of its chunk from one read of the K/V rows: no GQA
//   re-reads. The host picks the split length (`plan` in
//   kernels/decode_attention.py) from S, B*HKV and the SM count, never
//   from `lengths`, so no host sync; a split that starts at or past its
//   sequence's length returns at once, reading nothing.
// - Each warp streams its own tiles of the split (warp w takes tiles w,
//   w + 4, ...). A tile is 4 KB of K and 4 KB of V: 32 lanes x 8 chunks
//   of 16 bytes, copied by `cp.async.cg` into a per-warp ring of up to
//   STAGES tiles in shared memory (as many as the warp has per split),
//   so the next tiles are in flight while one is computed. Keys past the
//   split's end are zero-filled by the copy's source size (nothing read).
// - bfloat16 (`decode_tc_kernel`): S = Q K^T and O += P V by
//   `mma.sync.m16n8k16` (float32 accumulate), the block's query heads as
//   the 16 rows (rows past the group are zeros, never written). Q's A
//   fragments stay in registers; K's B fragments come from `ldmatrix`,
//   V's from `ldmatrix.trans`, over rows padded by 16 bytes so that 8
//   rows fall in 8 distinct bank groups. A lane holds two rows of the
//   warp's scores; the online softmax (float32 max, sum and accumulator,
//   ex2.approx with scale * log2(e) applied in float32) reduces a row
//   over the 4 lanes of a quad, and P is rounded to bfloat16 as the A
//   fragment of P V (the C layout of two n8 tiles is the A layout of one
//   k16 step). The warp syncs (`__syncwarp`) around each tile's copies.
// - float32 (`decode_kernel`), on the CUDA cores: a key's D elements are
//   spread over D / 4 lanes of 16 bytes; q for the block's heads sits in
//   registers (scaled by scale * log2(e)), the dot products are reduced
//   by xor shuffles, and each key slot of the warp keeps its own online
//   softmax, updated once per 4-8 keys. The ring's layout is device
//   memory's, so a lane reads only chunks it copied itself: no barrier
//   in the loop. The slots merge by shuffles at the end.
// - The warps merge in order through shared memory. A split that is its
//   sequence's only one writes `out`. Otherwise it writes (max, sum,
//   accumulator) to a float32 workspace and, after a barrier, one thread
//   fences and bumps its (batch, KV head, chunk) counter in an int32
//   workspace of its own (only counters ever live there); the block
//   that arrives last merges the splits in split order (so the result
//   does not depend on which block finished last), writes `out` and
//   resets the counter to 0, ready for the next call on the stream.
// - When B * HKV is too small to fill the card the host takes more,
//   shorter splits (down to one round of 4 tiles); a short cache with
//   few heads leaves SMs idle, but it is little work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNKS = 8;                 // 16-byte chunks a lane copies per K (and V) tile
constexpr int TILE_CHUNKS = 32 * CHUNKS;  // 4 KB of K (and of V) per warp tile
constexpr int STAGES = 3;                 // most tiles in a warp's ring
constexpr int MAX_SPLITS = 256;
constexpr int ROWS = 16;                  // query heads per block on the tensor cores
constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(STAGES >= 1 && STAGES <= 4, "cp_async_wait_upto takes 0..3");

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// At most n (0..3) of this thread's groups still pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16x8, float32) += a (16x16, bf16, row) * b (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x, one MUFU.EX2 (relative error about 2^-22; denormals flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (m, l, acc) <- the merge of (m, l, acc) and (mo, lo, ao).
template <int VEC>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[VEC], float mo, float lo,
                                      const float (&ao)[VEC]) {
  const float mn = fmaxf(m, mo);
  const float a = ex2(m - mn), c = ex2(mo - mn);
  l = l * a + lo * c;
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = acc[e] * a + ao[e] * c;
  m = mn;
}

// Where a block stands: its split [k0, k1) of sequence b, its KV head and
// chunk of query heads (gn of them), and its rows of q and out.
struct Block {
  int b, sp, hk, gn, nact, k0, k1, bg;
  long long row0;  // first element of the block's first query head in q and out
};

// The block's place; false when it has nothing to do (a length of 0 has
// been answered with zeros by split 0).
template <typename T, int D>
__device__ __forceinline__ bool locate(Block& s, const int* lengths, T* out, int HQ, int HKV,
                                       int S, int split_keys, int gb) {
  s.sp = blockIdx.x;
  s.b = blockIdx.z;
  const int group = HQ / HKV, nhc = (group + gb - 1) / gb;
  s.hk = blockIdx.y / nhc;
  const int hc = blockIdx.y % nhc;
  s.gn = min(gb, group - hc * gb);
  s.bg = (s.b * HKV + s.hk) * nhc + hc;
  s.row0 = (static_cast<long long>(s.b) * HQ + s.hk * group + hc * gb) * D;
  const int len = min(max(__ldg(lengths + s.b), 0), S);
  if (len == 0) {
    if (s.sp == 0)
      for (int i = threadIdx.x; i < s.gn * D; i += THREADS) out[s.row0 + i] = from_f<T>(0.f);
    return false;
  }
  s.nact = (len + split_keys - 1) / split_keys;  // splits holding keys
  if (s.sp >= s.nact) return false;
  s.k0 = s.sp * split_keys;
  s.k1 = min(s.k0 + split_keys, len);
  return true;
}

// After the warps have put their (max, sum, accumulator) of R rows in
// `smem` (max [WARPS][R], sum [WARPS][R], accumulator [WARPS][R][D]):
// merge the warps in order; write `out` if this is the sequence's only
// split, else this split's partial result, count it, and if it is the
// last to arrive merge all the splits in split order. `gb` heads per
// chunk lay out the partials: (max, sum) [groups][nsplit][gb][2], then
// the accumulators [groups][nsplit][gb][D].
template <typename T, int D, int R>
__device__ __forceinline__ void finish(const Block& s, unsigned char* smem, int gb, int nsplit,
                                       int groups, T* __restrict__ out, int* __restrict__ cnt,
                                       float* __restrict__ part) {
  __shared__ int is_last;
  const float* const red_m = reinterpret_cast<const float*>(smem);
  const float* const red_l = red_m + WARPS * R;
  const float* const red_o = red_l + WARPS * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* const ob = out + s.row0;
  float* const part_ml = part;
  float* const part_o = part + static_cast<long long>(groups) * nsplit * gb * 2;
  const long long base = static_cast<long long>(s.bg) * nsplit;
  for (int i = tid; i < s.gn * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = red_m[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red_m[w * R + g]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = ex2(red_m[w * R + g] - mx);
      ls = fmaf(red_l[w * R + g], a, ls);
      o = fmaf(red_o[(w * R + g) * D + d], a, o);
    }
    if (s.nact == 1) {
      ob[g * D + d] = from_f<T>(o / ls);
    } else {
      const long long p = (base + s.sp) * gb + g;
      part_o[p * D + d] = o;
      if (d == 0) {
        part_ml[p * 2] = mx;
        part_ml[p * 2 + 1] = ls;
      }
    }
  }
  if (s.nact == 1) return;

  __syncthreads();  // every thread's partial writes precede thread 0's fence
  if (tid == 0) {
    __threadfence();
    const int arrived = atomicAdd(cnt + s.bg, 1) + 1;
    is_last = arrived == s.nact;
    if (is_last) cnt[s.bg] = 0;  // every split has arrived: ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block: every split's (max, sum) into shared memory at once,
  // the max over splits per head, each split's weight, then the sums
  // over the splits in split order (read with __ldcg: other SMs wrote them).
  float* const w_s = reinterpret_cast<float*>(smem);  // [nact][gn] max, then weight
  float* const l_s = w_s + s.nact * s.gn;             // [nact][gn] sums
  for (int i = tid; i < s.nact * s.gn; i += THREADS) {
    const long long p = (base + i / s.gn) * gb + i % s.gn;
    w_s[i] = __ldcg(part_ml + p * 2);
    l_s[i] = __ldcg(part_ml + p * 2 + 1);
  }
  __syncthreads();
  for (int g = warp; g < s.gn; g += WARPS) {
    float mx = NEG;
    for (int j = lane; j < s.nact; j += 32) mx = fmaxf(mx, w_s[j * s.gn + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    __syncwarp();
    for (int j = lane; j < s.nact; j += 32) w_s[j * s.gn + g] = ex2(w_s[j * s.gn + g] - mx);
  }
  __syncthreads();
  for (int i = tid; i < s.gn * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const float* const po = part_o + (base * gb + g) * D + d;  // split j at po + j * gb * D
    float ls = 0.f, o = 0.f;
#pragma unroll 8
    for (int j = 0; j < s.nact; ++j) {
      const float w = w_s[j * s.gn + g];
      ls = fmaf(l_s[j * s.gn + g], w, ls);
      o = fmaf(__ldcg(po + static_cast<long long>(j) * gb * D), w, o);
    }
    ob[g * D + d] = from_f<T>(o / ls);
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int D, int GB>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ out, int* __restrict__ cnt, float* __restrict__ part, int HQ,
              int HKV, int S, int split_keys, int nsplit, int ns, float qscale) {
  constexpr int VEC = 4;                    // floats per 16-byte chunk
  constexpr int TPK = D / VEC;              // lanes per key
  constexpr int KPW = 32 / TPK;             // keys per warp step (key slots)
  constexpr int TILE = CHUNKS * KPW;        // keys per warp tile
  constexpr int SUB = GB * VEC > 32 ? CHUNKS / 2 : CHUNKS;  // steps per softmax update
  extern __shared__ __align__(16) unsigned char smem[];
  Block s;
  if (!locate<float, D>(s, lengths, out, HQ, HKV, S, split_keys, GB)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // q of the block's heads, this lane's VEC columns, in registers.
  const int cc = lane % TPK, slot = lane / TPK;
  float qr[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < s.gn) {
      unpack(__ldg(reinterpret_cast<const uint4*>(q + s.row0 + g * D + cc * VEC)), qr[g]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] *= qscale;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    }
  }

  const long long kvoff = (static_cast<long long>(s.b) * HKV + s.hk) * S * D;
  const float* const kb = k + kvoff;
  const float* const vb = v + kvoff;
  const int k0 = s.k0, k1 = s.k1;
  const int ntile = (k1 - k0 + TILE - 1) / TILE;
  const int nw = ntile > warp ? (ntile - warp + WARPS - 1) / WARPS : 0;  // this warp's tiles
  uint4* const ring = reinterpret_cast<uint4*>(smem) + warp * ns * 2 * TILE_CHUNKS;

  // The warp's i-th tile into ring stage i % ns: lane l copies chunks
  // l, l + 32, ... of K and of V (keys past k1 zero-filled).
  auto issue = [&](int i) {
    const int key0 = k0 + (i * WARPS + warp) * TILE + slot;
    uint4* const ks = ring + (i % ns) * 2 * TILE_CHUNKS;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int key = key0 + c * KPW;
      const bool ok = key < k1;
      const long long off = static_cast<long long>(ok ? key : k0) * D + cc * VEC;
      cp_async16(ks + c * 32 + lane, kb + off, ok ? 16 : 0);
      cp_async16(ks + TILE_CHUNKS + c * 32 + lane, vb + off, ok ? 16 : 0);
    }
  };

  float m[GB], l[GB], acc[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < ns - 1; ++i) {
    if (i < nw) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nw; ++i) {
    if (i + ns - 1 < nw) issue(i + ns - 1);
    cp_async_commit();
    cp_async_wait_upto(ns - 1);  // this lane's chunks of tile i have landed
    const uint4* const ks = ring + (i % ns) * 2 * TILE_CHUNKS;
    const uint4* const vs = ks + TILE_CHUNKS;
    const int key0 = k0 + (i * WARPS + warp) * TILE + slot;
#pragma unroll
    for (int c0 = 0; c0 < CHUNKS; c0 += SUB) {
      float sc[SUB][GB];
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        float kf[VEC];
        unpack(ks[(c0 + c) * 32 + lane], kf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kf[e], d);
          sc[c][g] = d;
        }
      }
#pragma unroll
      for (int off = 1; off < TPK; off <<= 1)
#pragma unroll
        for (int c = 0; c < SUB; ++c)
#pragma unroll
          for (int g = 0; g < GB; ++g) sc[c][g] += __shfl_xor_sync(0xffffffffu, sc[c][g], off);
      float mt[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) mt[g] = m[g];
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        const bool ok = key0 + (c0 + c) * KPW < k1;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          sc[c][g] = ok ? sc[c][g] : NEG;
          mt[g] = fmaxf(mt[g], sc[c][g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float alpha = ex2(m[g] - mt[g]);
        m[g] = mt[g];
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        const bool ok = key0 + (c0 + c) * KPW < k1;
        float vf[VEC];
        unpack(vs[(c0 + c) * 32 + lane], vf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float p = ok ? ex2(sc[c][g] - m[g]) : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Merge the warp's key slots (lanes that differ in the bits >= TPK).
#pragma unroll
  for (int off = TPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      float ao[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      merge<VEC>(m[g], l[g], acc[g], mo, lo, ao);
    }
  }

  // The warps' states through shared memory (the ring is free now).
  float* const red_m = reinterpret_cast<float*>(smem);
  float* const red_l = red_m + WARPS * GB;
  float* const red_o = red_l + WARPS * GB;
  __syncthreads();
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red_o[(warp * GB + g) * D + cc * VEC + e] = acc[g][e];
      if (lane == 0) {
        red_m[warp * GB + g] = m[g];
        red_l[warp * GB + g] = l[g];
      }
    }
  }
  __syncthreads();
  finish<float, D, GB>(s, smem, GB, nsplit, gridDim.z * gridDim.y, out, cnt, part);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

// A warp tile of D-wide bfloat16 rows in shared memory: TK keys of K, then
// TK of V, each row padded by one 16-byte chunk.
template <int D>
struct TcTile {
  static constexpr int CPR = D / 8;             // 16-byte chunks per row
  static constexpr int ROW = CPR + 1;           // padded row, in chunks
  static constexpr int TK = TILE_CHUNKS / CPR;  // keys per warp tile
  static constexpr int STAGE = 2 * TK * ROW;    // chunks per ring stage (K and V)
  static_assert(TK % 16 == 0, "P V takes the tile's keys in k16 steps");
};

template <int D>
__global__ void __launch_bounds__(THREADS)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ lengths,
                 bf16* __restrict__ out, int* __restrict__ cnt, float* __restrict__ part, int HQ,
                 int HKV, int S, int split_keys, int nsplit, int ns, int gb, float qscale) {
  using L = TcTile<D>;
  constexpr int TK = L::TK, NT = TK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  Block s;
  if (!locate<bf16, D>(s, lengths, out, HQ, HKV, S, split_keys, gb)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = lane >> 2, c2 = 2 * (lane & 3);  // fragment row and column pair

  // Q's A fragments (rows past the chunk's heads are zeros).
  unsigned qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const unsigned* src = reinterpret_cast<const unsigned*>(q + s.row0 + r * D + kk * 16 + c2);
      qa[kk][h] = r < s.gn ? __ldg(src) : 0u;
      qa[kk][h + 2] = r < s.gn ? __ldg(src + 4) : 0u;
    }
  }

  const long long kvoff = (static_cast<long long>(s.b) * HKV + s.hk) * S * D;
  const bf16* const kb = k + kvoff;
  const bf16* const vb = v + kvoff;
  const int k0 = s.k0, k1 = s.k1;
  const int ntile = (k1 - k0 + TK - 1) / TK;
  const int nw = ntile > warp ? (ntile - warp + WARPS - 1) / WARPS : 0;  // this warp's tiles
  uint4* const ring = reinterpret_cast<uint4*>(smem) + warp * ns * L::STAGE;

  // The warp's i-th tile into ring stage i % ns: chunk j = 32 c + lane of
  // the tile's contiguous K (and V) rows goes to row j / CPR, chunk j % CPR.
  auto issue = [&](int i) {
    const int key0 = k0 + (i * WARPS + warp) * TK;
    uint4* const ks = ring + (i % ns) * L::STAGE;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int j = c * 32 + lane, row = j / L::CPR, ch = j % L::CPR;
      const int key = key0 + row;
      const bool ok = key < k1;
      const long long off = static_cast<long long>(ok ? key : k0) * D + ch * 8;
      cp_async16(ks + row * L::ROW + ch, kb + off, ok ? 16 : 0);
      cp_async16(ks + (TK + row) * L::ROW + ch, vb + off, ok ? 16 : 0);
    }
  };

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < ns - 1; ++i) {
    if (i < nw) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nw; ++i) {
    __syncwarp();  // every lane is done with the stage refilled next (tile i - 1's)
    if (i + ns - 1 < nw) issue(i + ns - 1);
    cp_async_commit();
    cp_async_wait_upto(ns - 1);
    __syncwarp();  // tile i has landed, for every lane
    const unsigned kbase = smem_addr(ring + (i % ns) * L::STAGE);
    const unsigned vbase = kbase + TK * L::ROW * 16;

    // S = Q K^T: NT n8 tiles of keys; B fragments of two k16 steps per ldmatrix.
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < D / 32; ++k2) {
        unsigned bk[4];
        ldsm_x4(bk, kbase + ((nt * 8 + (lane & 7)) * L::ROW + 4 * k2 + (lane >> 3)) * 16);
        mma_bf16(sc[nt], qa[2 * k2], bk[0], bk[1]);
        mma_bf16(sc[nt], qa[2 * k2 + 1], bk[2], bk[3]);
      }
    }

    // Online softmax over the tile: rows r0 (c0, c1) and r0 + 8 (c2, c3).
    const int kt = k0 + (i * WARPS + warp) * TK + c2;  // this lane's first key column
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kt + nt * 8 + (e & 1) < k1;
        sc[nt][e] = ok ? sc[nt][e] * qscale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = ex2(sc[nt][e] - m[e >> 1]);  // a masked key gives 0
        l[e >> 1] += sc[nt][e];
      }

    // O += P V: P rounded to bfloat16 as A fragments, V's B fragments of
    // two n8 tiles per ldmatrix.trans.
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      const unsigned pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                              pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                              pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        unsigned bv[4];
        ldsm_x4_trans(bv, vbase + ((16 * j + 8 * ((lane >> 3) & 1) + (lane & 7)) * L::ROW +
                                   2 * n2 + (lane >> 4)) * 16);
        mma_bf16(acc[2 * n2], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Row sums over the quad; then the warps' states through shared memory.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* const red_m = reinterpret_cast<float*>(smem);
  float* const red_l = red_m + WARPS * ROWS;
  float* const red_o = red_l + WARPS * ROWS;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if ((lane & 3) == 0) {
      red_m[warp * ROWS + r] = m[h];
      red_l[warp * ROWS + r] = l[h];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      red_o[(warp * ROWS + r) * D + j * 8 + c2] = acc[j][2 * h];
      red_o[(warp * ROWS + r) * D + j * 8 + c2 + 1] = acc[j][2 * h + 1];
    }
  }
  __syncthreads();
  finish<bf16, D, ROWS>(s, smem, gb, nsplit, gridDim.z * gridDim.y, out, cnt, part);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Workspace of a launch: one int32 counter per (batch, KV head, chunk),
// and (max, sum) then D accumulator floats per (split, head) slot.
long long n_counters(int B, int HKV, int nhc) { return static_cast<long long>(B) * HKV * nhc; }
long long n_partials(int B, int HKV, int nhc, int nsplit, int gb, int D) {
  return n_counters(B, HKV, nhc) * nsplit * gb * (2 + D);
}

// Arguments of one call, as the wrapper passes them.
struct Args {
  const void *q, *k, *v, *lengths;
  void *out, *cnt, *part;
  int B, HQ, HKV, S, split_keys, nsplit, gb;
  float scale;
  cudaStream_t stream;
};

// A warp's ring holds as many tiles as it has per split, up to STAGES;
// shared memory is the larger of the rings and the merges' scratch.
int smem_bytes(const Args& a, int tile_keys, int stage_bytes, int rows, int D, int* ns) {
  *ns = std::min(STAGES, (a.split_keys + WARPS * tile_keys - 1) / (WARPS * tile_keys));
  return std::max(WARPS * *ns * stage_bytes,
                  std::max(WARPS * rows * (D + 2), 2 * a.nsplit * a.gb) * 4);
}

template <typename K, typename... P>
int start(K kernel, const Args& a, int bytes, P... params) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nhc = (a.HQ / a.HKV + a.gb - 1) / a.gb;
  kernel<<<dim3(a.nsplit, a.HKV * nhc, a.B), THREADS, bytes, a.stream>>>(params...);
  return (int)cudaGetLastError();
}

template <int D, int GB>
int launch_f32(const Args& a) {
  int ns;
  const int bytes = smem_bytes(a, CHUNKS * 32 * 4 / D, 2 * TILE_CHUNKS * 16, GB, D, &ns);
  return start(decode_kernel<D, GB>, a, bytes, (const float*)a.q, (const float*)a.k,
               (const float*)a.v, (const int*)a.lengths, (float*)a.out, (int*)a.cnt,
               (float*)a.part, a.HQ, a.HKV, a.S, a.split_keys, a.nsplit, ns, a.scale * LOG2E);
}

template <int D>
int launch_bf16(const Args& a) {
  using L = TcTile<D>;
  int ns;
  const int bytes = smem_bytes(a, L::TK, L::STAGE * 16, ROWS, D, &ns);
  return start(decode_tc_kernel<D>, a, bytes, (const bf16*)a.q, (const bf16*)a.k,
               (const bf16*)a.v, (const int*)a.lengths, (bf16*)a.out, (int*)a.cnt,
               (float*)a.part, a.HQ, a.HKV, a.S, a.split_keys, a.nsplit, ns, a.gb,
               a.scale * LOG2E);
}

template <int D>
int f32_heads(const Args& a) {
  switch (a.gb) {
    case 1: return launch_f32<D, 1>(a);
    case 2: return launch_f32<D, 2>(a);
    case 4: return launch_f32<D, 4>(a);
    case 8: return launch_f32<D, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int checked(const Args& a, int D, long long cnt_len, long long part_len) {
  if (a.B <= 0 || a.B > 65535 || a.HKV <= 0 || a.HQ % a.HKV || a.S <= 0 || a.gb <= 0 ||
      a.split_keys <= 0 || a.nsplit <= 0 || a.nsplit > MAX_SPLITS ||
      static_cast<long long>(a.split_keys) * a.nsplit < a.S)
    return (int)cudaErrorInvalidValue;
  const int nhc = (a.HQ / a.HKV + a.gb - 1) / a.gb;
  if (static_cast<long long>(a.HKV) * nhc > 65535 || cnt_len < n_counters(a.B, a.HKV, nhc) ||
      part_len < n_partials(a.B, a.HKV, nhc, a.nsplit, a.gb, D))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// q (B, HQ, D), k/v (B, HKV, S, D), lengths (B,) int32, out (B, HQ, D);
// contiguous, 16-byte aligned; D in {32, 64, 128}; HQ a multiple of HKV.
// `heads` query heads per block (float32: 1, 2, 4 or 8; bfloat16: 1 to
// 16), `nsplit` (<= 256) splits of `split_keys` keys covering S. `cnt`:
// `cnt_len` int32 counters, all 0 (one per batch row, KV head and chunk
// of `heads` query heads; the kernel leaves them 0); `part`: `part_len`
// floats ((2 + D) per split, counter and head). A launch given less is
// refused. One launch; returns its CUDA error, or 0.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, void* cnt, long long cnt_len,
                                    void* part, long long part_len, int B, int HQ, int HKV, int S,
                                    int D, int heads, int split_keys, int nsplit, float scale,
                                    void* stream) {
  const Args a{q, k, v, lengths, out, cnt, part, B, HQ, HKV, S, split_keys, nsplit, heads, scale,
               (cudaStream_t)stream};
  if (int err = checked(a, D, cnt_len, part_len)) return err;
  switch (D) {
    case 32: return f32_heads<32>(a);
    case 64: return f32_heads<64>(a);
    case 128: return f32_heads<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, void* cnt, long long cnt_len,
                                     void* part, long long part_len, int B, int HQ, int HKV,
                                     int S, int D, int heads, int split_keys, int nsplit,
                                     float scale, void* stream) {
  const Args a{q, k, v, lengths, out, cnt, part, B, HQ, HKV, S, split_keys, nsplit, heads, scale,
               (cudaStream_t)stream};
  if (int err = checked(a, D, cnt_len, part_len)) return err;
  if (heads > ROWS) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_bf16<32>(a);
    case 64: return launch_bf16<64>(a);
    case 128: return launch_bf16<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
