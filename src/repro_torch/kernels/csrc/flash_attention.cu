// Flash attention (prefill / training forward) for Hopper.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, pl.pallas_call at :93).
//
// out[b, h] = softmax(q[b, h] k[b, h / group]^T * scale [+ causal mask])
//             v[b, h / group]
// with q (B, H, S, D), k/v (B, HKV, S, D), group = H / HKV, all
// contiguous, float32 or bfloat16; the output has q's type. As in the
// TPU kernel: float32 running max, denominator and accumulator, fully
// masked KV blocks skipped, acc / max(l, 1e-30) stored in q's type.
//
// Bound on the card: at B=4, H=32, S=1024, D=64, bf16, causal, q, k, v
// and out move 67.1 MB (0.0200 ms at 3.35 TB/s) and the two products
// over the lower triangle need 2 * B*H*S*(S+1)*D = 17.2 GFLOP
// (0.0174 ms at the dense bf16 tensor-core rate, 989 TFLOP/s): the
// bytes bound it, just, so the products must run on the tensor cores
// and the copies must overlap them.
//
// bfloat16 (`flash_bf16_kernel`, the serving path): FlashAttention-2's
// structure on the `mma.sync` tensor-core instructions.
// - One block of 4 warps per (q block of 64 rows, head, batch); each
//   warp owns 16 query rows. K/V come in tiles of 64 keys.
// - Q, K and V tiles go from device memory to shared memory by
//   `cp.async` in 16-byte chunks; K/V sit in a two-stage ring, so tile
//   j + 1 is in flight while tile j is multiplied (one barrier per
//   tile). Rows past S are zero-filled by the copy's source size:
//   nothing is read out of bounds. Shared memory: 5 tiles of 64 x D bf16
//   (40 KB at D = 64, 80 KB at D = 128).
// - Each row of D bf16 is stored with its 16-byte chunk index XORed by
//   the row (mod 8), so every `ldmatrix` reads 8 rows from 8 distinct
//   bank groups with no padding. A lane's ldmatrix address is one XOR
//   of a precomputed offset plus immediates (`ldsm_offset`).
// - S = Q K^T by `mma.sync.m16n8k16` (bf16 in, float32 accumulate): Q's
//   A fragments are loaded once by `ldmatrix` and stay in registers for
//   the whole KV loop; K's B fragments come from `ldmatrix` of the
//   row-major [key][d] tile.
// - Online softmax in registers: a thread holds two rows of its warp's
//   16 x 64 score tile; the row max reduces over the 4 lanes of a quad
//   by shuffles. Scale and log2(e) are folded into one multiply-add,
//   and the exponentials are `ex2.approx` (one MUFU.EX2 each). Masks are
//   applied only to the diagonal KV block (causal) and the ragged last
//   block.
// - P V with no round trip through shared memory: the float32 score
//   accumulators of two neighbouring n8 tiles are rounded to bf16 and
//   are the A fragment of an m16k16 product (the C layout of m16n8 is
//   the A layout of m16k16); V's B fragments come from
//   `ldmatrix.trans`. P is rounded to bf16 before this product (the TPU
//   kernel keeps it in float32; scaled_dot_product_attention rounds it
//   the same way). The row sums l are the same rounded P times a column
//   of ones, one more product per 16 keys on the tensor cores in place
//   of 32 float adds and the quad reduction.
// - Occupancy: D <= 64 is held to 128 registers (4 blocks, 16 warps per
//   SM, no spills); D = 128 takes ~200 (2 blocks).
// - Causal: a q block visits only the KV blocks at or before its
//   diagonal, and the grid runs the heaviest q blocks of every head
//   first. GQA by index arithmetic (h / group): no repeated K/V.
//
// float32 (`flash_f32_kernel`, for float32 callers): three-pass TF32 on
// the tensor cores, at float32 accuracy.
// - Each float32 operand a is split into hi = tf32(a) and lo = tf32(a -
//   hi), tf32() rounding to nearest with ties away from zero as
//   `cvt.rna.tf32.f32` does (add 0x1000 to the bits, clear the low 13).
//   Each product is lo*hi + hi*lo + hi*hi on `mma.sync.m16n8k8` (tf32 in,
//   float32 accumulate; the small terms first): three products for each
//   tile pair. The dropped lo*lo is under 2^-22 of a*b, so the products
//   are off by about what float32 rounding gives; one pass of TF32 (2^-11
//   of each operand) misses the float32 bar of 2e-5 by far
//   (tests/test_torch_flash_f32_numerics.py models both).
// - Short accumulation chains: the tensor cores truncate each sum into an
//   accumulator instead of rounding it to nearest. In Q K^T the small
//   terms go to an accumulator of their own, added to hi*hi's at the end
//   (one truncated sum a k8 step for the large one, not three); P V of a
//   tile is summed from zero and added to the output as acc * alpha +
//   tile, one float32 FMA, so the chains do not grow with S. With all
//   three passes and every tile in one accumulator, the error against
//   exact attention at 5,120 keys was 7x the plain version's on an H100.
// - The bf16 kernel's structure: 4 warps of 16 query rows, K/V tiles in
//   a two-stage cp.async ring (rows past S zero-filled by the source
//   size), the online softmax in registers with ex2.approx and scale *
//   log2(e) folded, masks only on the diagonal and ragged tiles (a warp
//   skips a tile wholly above its rows), the heaviest causal q blocks
//   first, GQA by h / group.
// - Q and K tiles are rows of D floats, 16-byte chunk ch of row r stored
//   at ch ^ (r mod 8). `ldmatrix` (.b16, not transposed) of rows of 16
//   bytes hands lane 4g + t the 32-bit element (row g, col t): the tf32 A
//   fragment of Q and the B fragment of K^T, d along the row.
// - P stays float32 in registers and is split like the inputs. The C
//   layout of m16n8 (cols 2t, 2t + 1) is not the A layout of m16n8k8
//   (cols t, t + 4); the sum over keys takes any key order, so k index t
//   of each 8-key step stands for key 2t and t + 4 for key 2t + 1: P's
//   c0, c1, c2, c3 are a0, a2, a1, a3 with no shuffle, and V's B fragment
//   reads keys 2t and 2t + 1. `ldmatrix.trans` is 16-bit only, so V is
//   read by 32-bit shared loads from rows padded to D + 4 floats: the 32
//   lanes (key 2t or 2t + 1, column g) hit 32 banks.
// - Where the splits happen: K and V fragments are split by each warp as
//   it reads them; Q is split once into registers (hi and lo) at D <= 64,
//   and at D = 128 read from its shared tile by ldmatrix and split at each
//   use (`q_in_registers`: hi and lo would take 128 registers a thread;
//   raw fragments held in registers measured 10% slower). P V runs k8
//   steps outer, into D / 8 independent tile accumulators.
// - Tiles and occupancy: 64 keys a tile (D = 128: 32, so that the ring
//   fits two blocks an SM); shared memory 42, 82, 97 KB at D = 32, 64,
//   128: 3, 2, 2 blocks (12, 8, 8 warps) an SM. The row sums add the
//   unsplit float32 P, per thread, reduced across the quad at the end.
// - Bound: the three passes at dense TF32's 494.7 TFLOP/s (H100 SXM data
//   sheet): 0.814 ms at 1x20x5120x128 causal, where 67 TFLOP/s of float32
//   FMAs gave 2.004. The dynamic shared memory attribute is set once per
//   instantiation and device, not at every call.
//
// Training: both forward kernels can also write the float32 log-sum-exp
// of each row, lse[b, h, row] = log(sum_j exp(s_j * scale)), for the
// backward pass; serving passes no lse buffer and runs the bf16 kernel
// instantiated without that store (the `LSE = false` template).
//
// Backward (no TPU counterpart: the JAX package differentiates plain jnp).
// With P = exp(S * scale - lse) recomputed from q, k and the forward's
// lse, Dvec = rowsum(dO * O):
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - Dvec),
//   dQ = dS K * scale, dK = dS^T Q * scale,
// causal mask and ragged tiles as in the forward (masked P is 0). Each
// output element is summed in a fixed order by one thread, with no
// atomics: repeated calls are bit-equal.
//
// bfloat16 (`flash_bwd_dq_tc_kernel`, `flash_bwd_dkdv_tc_kernel`, the
// training path): seven products on `mma.sync.m16n8k16` (bf16 in,
// float32 accumulate), with the forward's swizzled tiles, `cp.async`
// ring and fragment layouts. Two kernels, each with one block of 4 warps
// per 64-row block, recompute S and dP:
// - dQ, per (q block, head, batch): each warp owns 16 query rows. Its
//   prologue sums Dvec of its rows from O and dO (a quad of lanes per
//   row) and stores it for the dK/dV kernel, which runs after it on the
//   same stream. Q and dO are A fragments; 64-key K/V tiles stream
//   through a two-stage ring. Per 32 keys: S = Q K^T and dP = dO V^T,
//   P = exp2(S * scale * log2(e) - lse * log2(e)) in registers (masks
//   only on the diagonal and ragged tiles, and 32-key steps wholly above
//   a warp's diagonal skipped), dS = P (dP - Dvec) in the C fragments,
//   rounded to bf16 and used as the A fragment of dQ += dS K (the C
//   layout of m16n8 is the A layout of m16k16, as for the forward's
//   P V), K's B fragments by `ldmatrix.trans` of the same tile.
// - dK/dV, per (key block, query head, batch): each warp owns 16 keys;
//   K and V are A fragments, and 64-row Q/dO tiles with their lse and
//   Dvec stream through the ring, from the key block's diagonal down.
//   Per 32 queries: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T in
//   registers (lse and Dvec read by column from shared memory), both
//   rounded to bf16 as A fragments of dV += P^T dO and dK += dS^T Q.
// - GQA: the dK/dV grid runs over query heads, so a group is split
//   across blocks. With a group of 1 the block stores bf16 dK and dV;
//   otherwise each stores its head's float32 partials (B, H, S, D) and
//   `flash_bwd_dkdv_sum_kernel` sums each group in head order. Launches
//   per call: 2 with a group of 1, else 3.
// - Registers: D <= 64 holds Q/dO (dQ) and K/V (dK/dV) as fragments;
//   D = 128 reads them from shared memory at each use (the dK and dV
//   accumulators alone take 128 registers a thread).
// float32 (`flash_bwd_dq_f32_kernel`, `flash_bwd_dkdv_f32_kernel`, for
// float32 callers): the bf16 backward's two kernels, grids, Dvec
// prologue, ring, masks, skips and GQA partials, with every one of the
// seven products in the forward's three-pass TF32 on `mma.sync.m16n8k8`
// (lo*hi + hi*lo + hi*hi, operands split as `cvt.rna.tf32.f32` rounds).
// - Short chains: S and dP sum hi*hi apart from the small terms (the
//   forward's Q K^T); each step's dQ, dK and dV product is summed from
//   zero, one column tile at a time, and added to its float32
//   accumulator with one add, so no truncated chain grows with S.
// - P and dS stay float32 in the C fragments and become split A
//   fragments with the forward's key renumbering (k index t of an 8-column
//   step stands for column 2t, t + 4 for 2t + 1: c0, c1, c2, c3 are a0, a2,
//   a1, a3), so the second operand's B fragment is rows 2t and 2t + 1,
//   column g. Every tile is stored in one layout, swizzled as the
//   forward's K: `ldmatrix` reads it as a B operand with k = d (K in
//   Q K^T, Q in K Q^T), and 32-bit loads read it with k = row (K in dS K,
//   Q in dS^T Q, dO in P^T dO): lane (g, t) reads physical chunk
//   (2n + g / 4) ^ 2t of row 2t, so the 32 lanes hit 32 banks with no
//   second layout and no padding.
// - Splits: at D <= 64 each streamed tile is split once into hi and lo
//   tiles as it lands, by the threads that copied it (`split_rows`, no
//   extra barrier), so the B operands cost two loads and no arithmetic;
//   at D = 128 the two halves would leave one block an SM, and every warp
//   splits the raw tile at each use (at 4x32x1024x64 on an H100, split
//   at use took 1.27 ms, split once 1.02). A operands split once into
//   registers at D = 32, read by ldmatrix and split at each use above.
// - Tiles: 64-row blocks (16 rows a warp); streamed tiles of 64, 32, 16
//   rows and steps of 32, 32, 16 columns at D = 32, 64, 128; shared
//   memory 81, 97, 96 KB with one warp group (two blocks an SM), 146, 161,
//   129 KB with two (see below). At D = 128 the dK and dV
//   accumulators alone would take 128 registers a thread (255 and a
//   spill), so the dK/dV grid holds a dV block and a dK block for each
//   key block (`split_dkdv`): S^T is computed in both, 5 products for 4,
//   in twice the blocks. The dQ kernel's grid is the bf16 one. Launches
//   per call: 2 with a group of 1, else 3 (the group sum writes float32).
// - Warp groups: where a kernel's grid has at most two blocks an SM (the
//   training path's shapes: 128 and 80 dQ blocks), a block runs two
//   groups of 4 warps over alternate tiles of the stream (the ring holds
//   two tiles a stage), each with its own accumulators, and group 1's are
//   added to group 0's through shared memory at the end, in one order:
//   repeats stay bit-equal. Else one group, two blocks an SM.
// - Address offsets: `chunk_pair` and `BCols` keep 4 XORed lane offsets
//   in registers and the rest as immediates, not one register per chunk
//   pair or column tile (D / 8 of each, hoisted out of the tile loop).
// - Bound: as below, with the five products at three TF32 passes (494.7
//   TFLOP/s): at B=4, H=32, S=1024, D=64 float32 causal, 269.0 MB (0.0803
//   ms) against 129.0 GFLOP (0.2608 ms): operations bound it.
// Bound: at B=4, H=32, S=1024, D=64, bf16, causal, q, k, v, o, dO, lse
// in and dQ, dK, dV out move 134.7 MB (0.0402 ms at 3.35 TB/s); the
// five products over the lower triangle (S and dP once, dV, dK, dQ)
// need 5 * 2 * B*H*S*(S+1)/2 * D = 43.0 GFLOP (0.0435 ms at 989 TFLOP/s
// on the tensor cores): operations bound it. The kernels do 7 (S and
// dP in both), 60.2 GFLOP.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1.0e30f;

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Rows of D bf16 in shared memory are swizzled: 16-byte chunk `ch` of
// row `row` is stored at chunk ch ^ key(row), so the 8 rows that one
// ldmatrix phase reads fall in 8 distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz_key(int row) {
  return D >= 64 ? (row & 7) : ((row >> 1) & 3);  // D = 32: two rows per 128 bytes
}
template <int D>
__device__ __forceinline__ int swz(int row, int ch) {  // element offset
  return row * D + ((ch ^ swz_key<D>(row)) << 3);
}
// Byte offset of the row that this lane addresses in an ldmatrix.x4 of
// rows [0, 16) (lane row r < 16, chunk c of chunk pair 0). Since
// (2j + c) ^ key = 2j ^ (c ^ key), chunk pair j of rows [R, R + 16) is at
// (offset ^ (j << 5)) + R * 2D: one XOR per chunk pair, then immediates.
template <int D>
__device__ __forceinline__ unsigned ldsm_offset(int r, int c) {
  return r * D * 2 + ((c ^ swz_key<D>(r)) << 4);
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

// ROWS rows of D bf16 from row `row` of `src` into a swizzled tile,
// by cp.async in 16-byte chunks; rows past S are zero-filled (source
// size 0, nothing read). A thread copies one chunk column every STEP
// rows; STEP is a multiple of 8, so all its rows share one swizzle.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row, int S, int tid) {
  constexpr int CH = D / 8, STEP = THREADS / CH;
  static_assert(STEP % 8 == 0 && ROWS % STEP == 0, "whole passes of a fixed swizzle");
  const int r = tid / CH, ch = tid % CH;
  bf16* d = dst + swz<D>(r, ch);
  const bf16* g = src + static_cast<long long>(row + r) * D + ch * 8;
  if (row + ROWS <= S) {
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) cp_async16(d + i * STEP * D, g + i * STEP * D, 16);
  } else {
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) {
      const bool ok = row + r + i * STEP < S;
      cp_async16(d + i * STEP * D, ok ? g + i * STEP * D : src, ok ? 16 : 0);
    }
  }
}

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int BK = 64;  // keys per K/V tile
constexpr int THREADS = 128;

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// A (16x16): a0 (row g, k 2t..2t+1), a1 (row g+8, same k), a2 (row g,
// k 2t+8..), a3 (row g+8, k 2t+8..). B (16x8): b0 (k 2t..2t+1, col g),
// b1 (k 2t+8.., col g). C (16x8): c0, c1 (row g, cols 2t, 2t+1), c2, c3
// (row g+8, same cols).

// s (16 x BK, float32) = the warp's 16 rows of Q times K^T. kt: the K
// tile's shared address; klane: this lane's ldsm_offset in it.
template <int D>
__device__ __forceinline__ void qk(float (&s)[BK / 8][4], const unsigned (&qf)[D / 16][4],
                                   unsigned kt, unsigned klane) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const unsigned a = kt + (klane ^ (kk << 5));  // d chunks 2kk, 2kk + 1
#pragma unroll
    for (int p = 0; p < BK / 16; ++p) {
      unsigned kf[4];  // b0, b1 of key tile 2p, then of 2p + 1
      ldsm_x4(kf, a + p * 16 * D * 2);
      mma_bf16(s[2 * p], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * p + 1], qf[kk], kf[2], kf[3]);
    }
  }
}

// Online softmax of the scores s of keys k0.. (masked where needed);
// rescale acc and add P V, P rounded to bf16. vt: the V tile's shared
// address; vlane: this lane's ldsm_offset in it. The row sums of P are
// one more product on the tensor cores, P times a column of ones, into
// l (the C fragment of an m16n8 product: l[0], l[1] row g, l[2], l[3]
// row g + 8), so l sums the same rounded P that multiplies V.
template <int D>
__device__ __forceinline__ void softmax_pv(float (&s)[BK / 8][4], float (&acc)[D / 8][4],
                                           float (&m)[2], float (&l)[4], unsigned vt,
                                           unsigned vlane, int k0, int row0, int S, int causal,
                                           float scale_log2, int lane) {
  constexpr int NT = BK / 8, DT = D / 8;
  const int g = lane >> 2, t = lane & 3;
  if (k0 + BK > S || (causal && k0 + BK - 1 > row0)) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = row0 + g + (e >> 1) * 8;
        if (col >= S || (causal && col > row)) s[j][e] = NEG;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // rows g and g + 8
    float mx = fmaxf(s[0][2 * i], s[0][2 * i + 1]);
#pragma unroll
    for (int j = 1; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    const float alpha = ex2(m[i] - m_new);
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * i] = ex2(fmaf(s[j][2 * i], scale_log2, -m_new));
      s[j][2 * i + 1] = ex2(fmaf(s[j][2 * i + 1], scale_log2, -m_new));
    }
    l[2 * i] *= alpha;
    l[2 * i + 1] *= alpha;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][2 * i] *= alpha;
      acc[j][2 * i + 1] *= alpha;
    }
  }
  unsigned pa[BK / 16][4];  // P as the A fragments of BK / 16 k16 steps
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    mma_bf16(l, pa[kk], 0x3f803f80u, 0x3f803f80u);  // bf16 ones
  }
#pragma unroll
  for (int p = 0; p < DT / 2; ++p) {
    const unsigned a = vt + (vlane ^ (p << 5));  // d chunks 2p, 2p + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned vf[4];  // b0, b1 of d tile 2p, then of 2p + 1
      ldsm_x4_trans(vf, a + kk * 16 * D * 2);
      mma_bf16(acc[2 * p], pa[kk], vf[0], vf[1]);
      mma_bf16(acc[2 * p + 1], pa[kk], vf[2], vf[3]);
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  return (BQ + 4 * BK) * D * 2;  // Q, and two stages of K and V
}

template <int D, int MINB, bool LSE>
__global__ void __launch_bounds__(THREADS, MINB)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                  int H, int HKV, int S, float scale_log2, int causal) {
  constexpr int KD = D / 16, NT = BK / 8, DT = D / 8, TILE = BK * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * D;    // two stages
  bf16* Vs = Ks + 2 * TILE;  // two stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // heaviest (causal) first
  const int hk = h / (H / HKV);
  const int q0 = qb * BQ;
  const long long qoff = (static_cast<long long>(b) * H + h) * S * D;
  const long long koff = (static_cast<long long>(b) * HKV + hk) * S * D;
  const bf16* qp = q + qoff;
  const bf16* kp = k + koff;
  const bf16* vp = v + koff;
  bf16* op = o + qoff;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // the warp's first query row
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int nkb = (kend + BK - 1) / BK;

  const unsigned ks = smem_addr(Ks), vs = smem_addr(Vs);
  // This lane's ldmatrix offsets in a K tile and (transposed) in a V tile.
  const unsigned klane = ldsm_offset<D>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const unsigned vlane = ldsm_offset<D>((lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4);

  unsigned qf[KD][4];
  float acc[DT][4];
  float m[2] = {NEG, NEG};            // rows g and g + 8, in log2 units
  float l[4] = {0.f, 0.f, 0.f, 0.f};  // their sums (see softmax_pv)
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  auto load_q = [&]() {
    const unsigned qlane = warp * 16 * D * 2 + ldsm_offset<D>(lane & 15, lane >> 4);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], smem_addr(Qs) + (qlane ^ (kk << 5)));
  };

  load_rows<BQ, D, THREADS>(Qs, qp, q0, S, tid);
  load_rows<BK, D, THREADS>(Ks, kp, 0, S, tid);
  load_rows<BK, D, THREADS>(Vs, vp, 0, S, tid);
  cp_async_commit();
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1;
    cp_async_wait<0>();  // block kb has landed
    __syncthreads();     // ... for every thread, and block kb - 1 is consumed
    if (kb == 0) load_q();
    if (kb + 1 < nkb) {  // block kb + 1 into the stage of block kb - 1
      load_rows<BK, D, THREADS>(Ks + (st ^ 1) * TILE, kp, (kb + 1) * BK, S, tid);
      load_rows<BK, D, THREADS>(Vs + (st ^ 1) * TILE, vp, (kb + 1) * BK, S, tid);
      cp_async_commit();
    }
    float s[NT][4];
    qk<D>(s, qf, ks + st * TILE * 2, klane);
    softmax_pv<D>(s, acc, m, l, vs + st * TILE * 2, vlane, kb * BK, row0, S, causal,
                  scale_log2, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(l[2 * i], 1e-30f);
    const int row = row0 + g + i * 8;
    if (row >= S) continue;
    bf16* orow = op + static_cast<long long>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<unsigned*>(orow + j * 8) =
          pack_bf16(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    if constexpr (LSE) {  // m is in log2 units: lse = (m + log2 l) ln 2
      if (t == 0)
        lse[(static_cast<long long>(b) * H + h) * S + row] =
            (m[i] + log2f(fmaxf(l[2 * i], 1e-30f))) * LN2;
    }
  }
}

template <int D, int MINB, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int HKV, int S, float scale, int causal, void* stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<D, MINB, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_bf16_kernel<D, MINB, LSE><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, H, HKV, S,
      scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

template <int D, int MINB>
int launch_lse(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int HKV, int S, float scale, int causal, void* stream) {
  return lse == nullptr
             ? launch<D, MINB, false>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream)
             : launch<D, MINB, true>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream);
}

// Blocks per SM: D <= 64 is held to 128 registers, so 4 blocks (16
// warps) share an SM; D = 128 needs ~200 registers (2 blocks).
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int HKV, int S, int D, float scale, int causal, void* stream) {
  switch (D) {
    case 32: return launch_lse<32, 4>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream);
    case 64: return launch_lse<64, 4>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream);
    case 128: return launch_lse<128, 1>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 forward on the tensor cores: three-pass TF32

namespace f32 {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ex2;
using tc::ldsm_x4;
using tc::LN2;
using tc::smem_addr;

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int THREADS = 128;

template <int D>
__host__ __device__ constexpr int bk() {  // keys per K/V tile
  return D == 128 ? 32 : 64;
}
template <int D>
__host__ __device__ constexpr int vstride() {  // floats per row of a V tile
  return D + 4;
}
// Whether a warp's Q fragments are split once into hi and lo held in
// registers, or read from the shared Q tile by ldmatrix and split at each
// use (D = 128: hi and lo would take 128 registers a thread).
template <int D>
__host__ __device__ constexpr bool q_in_registers() {
  return D <= 64;
}
template <int D>
__host__ __device__ constexpr int smem_bytes() {  // Q, and two stages of K and V
  return (BQ * D + 2 * bk<D>() * D + 2 * bk<D>() * vstride<D>()) * 4;
}

// The bits of x rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest,
// ties away from zero (half a TF32 ulp added to the magnitude, the low 13
// bits cleared).
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x (float32 bits) = hi + lo to about 2^-22 of x, both TF32.
__device__ __forceinline__ void split(unsigned x, unsigned& hi, unsigned& lo) {
  hi = tf32(__uint_as_float(x));
  lo = tf32(__uint_as_float(x) - __uint_as_float(hi));
}

// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 g + t.
// A (16x8): a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4), a3
// (row g+8, k t+4). B (8x8): b0 (k t, col g), b1 (k t+4, col g). C
// (16x8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in three passes, the small terms first: lo*hi, hi*lo, hi*hi.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                     unsigned bl0, unsigned bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}
// big += ah bh and small += al bh + ah bl: the three passes into two
// accumulators, so that the large one takes one truncated sum a k8 step,
// not three.
__device__ __forceinline__ void mma3_split(float (&big)[4], float (&small)[4],
                                           const unsigned (&ah)[4], const unsigned (&al)[4],
                                           unsigned bh0, unsigned bh1, unsigned bl0,
                                           unsigned bl1) {
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// Byte offset of the row that this lane addresses in an ldmatrix.x4 of a
// tile of rows of D floats, chunk ch of row r stored at ch ^ (r mod 8)
// (row r, chunk c of chunk pair 0). Chunk pair kk is (offset ^ (kk << 5)).
template <int D>
__device__ __forceinline__ unsigned ldsm_offset(int r, int c) {
  return r * D * 4 + ((c ^ (r & 7)) << 4);
}
// Chunk pair kk of an ldsm_offset (of rows under 16, or plus whole rows of
// 16): offset ^ (kk << 5), written as an XOR of kk mod 4 and an immediate
// for the rest (the bits above the swizzle are clear), so that a loop over
// the tiles holds 4 such offsets in registers, not D / 8.
__device__ __forceinline__ unsigned chunk_pair(unsigned offset, int kk) {
  return (offset ^ ((kk & 3) << 5)) + ((kk >> 2) << 7);
}

// ROWS rows of D floats from row `row` of `src` into a tile of row
// stride STRIDE floats, by cp.async in 16-byte chunks (SWZ: chunk ch of
// row r at ch ^ (r mod 8)) by NT threads; rows past S are zero-filled
// (source size 0, nothing read).
template <int ROWS, int D, int STRIDE, bool SWZ, int NT = THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row, int S, int tid) {
  constexpr int CH = D / 4, STEP = NT / CH;
  static_assert(NT % CH == 0 && ROWS % STEP == 0, "whole passes over the tile");
  const int r = tid / CH, ch = tid % CH;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const int rr = r + i * STEP;
    float* d = dst + rr * STRIDE + ((SWZ ? ch ^ (rr & 7) : ch) << 2);
    const bool ok = row + rr < S;
    cp_async16(d, ok ? src + static_cast<long long>(row + rr) * D + ch * 4 : src, ok ? 16 : 0);
  }
}

// The hi and lo fragments of an ldmatrix.x4 at shared address `addr`:
// split from the raw tile (LO 0), or read from a tile split once, its lo
// half LO floats past its hi half.
template <int LO>
__device__ __forceinline__ void b_frags(unsigned addr, unsigned (&h)[4], unsigned (&l)[4]) {
  if constexpr (LO != 0) {
    ldsm_x4(h, addr);
    ldsm_x4(l, addr + LO * 4);
  } else {
    unsigned raw[4];
    ldsm_x4(raw, addr);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(raw[e], h[e], l[e]);
  }
}

// A warp's 16 rows of a swizzled tile (the forward's Q; the backward's Q
// and dO, or K and V) as the hi and lo A fragments of D / 8 k8 steps: split
// once into registers (REGS), or read by ldmatrix and split at each use
// (see q_in_registers).
template <int D, bool REGS>
struct ARows {
  unsigned hi[REGS ? D / 8 : 1][4], lo[REGS ? D / 8 : 1][4];
  unsigned tile, off;  // the tile's shared address; this lane's ldsm_offset in it
  __device__ __forceinline__ void load(unsigned q_tile, int warp, int lane) {
    tile = q_tile;
    off = warp * 16 * D * 4 + ldsm_offset<D>(lane & 15, lane >> 4);
    if constexpr (REGS) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        ldsm_x4(hi[kk], tile + chunk_pair(off, kk));
#pragma unroll
        for (int e = 0; e < 4; ++e) split(hi[kk][e], hi[kk][e], lo[kk][e]);
      }
    }
  }
  __device__ __forceinline__ void get(int kk, unsigned (&h)[4], unsigned (&l)[4]) const {
    if constexpr (REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = hi[kk][e];
        l[e] = lo[kk][e];
      }
    } else {
      b_frags<0>(tile + chunk_pair(off, kk), h, l);
    }
  }
};

// s (16 x BK) = the warp's 16 rows of A times rows [0, BK) of a swizzled
// tile, transposed (the forward's Q K^T): hi*hi summed apart from the two
// small terms, which are added at the end. kt: the shared address of the
// tile's first row; klane: this lane's ldsm_offset in it; LO: the tile's,
// see b_frags.
template <int D, int BK, bool REGS, int LO = 0>
__device__ __forceinline__ void mm_nt(float (&s)[BK / 8][4], const ARows<D, REGS>& qf,
                                      unsigned kt, unsigned klane) {
  float sl[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    unsigned ah[4], al[4];
    qf.get(kk, ah, al);
    const unsigned a = kt + chunk_pair(klane, kk);  // d chunks 2kk, 2kk + 1
#pragma unroll
    for (int p = 0; p < BK / 16; ++p) {
      unsigned bh[4], bl[4];  // b0, b1 of key tile 2p, then of 2p + 1
      b_frags<LO>(a + p * 16 * D * 4, bh, bl);
      mma3_split(s[2 * p], sl[2 * p], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3_split(s[2 * p + 1], sl[2 * p + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];
}

// Online softmax of the scores s of keys k0.. (masked where needed), then
// acc = acc * alpha + P V, P V of the tile summed from zero and added with
// one float32 FMA. vt: this lane's element (key 2t, column g) of the V
// tile. l: this thread's partial row sums of rows g and g + 8 (its own
// columns).
template <int D, int BK>
__device__ __forceinline__ void softmax_pv(float (&s)[BK / 8][4], float (&acc)[D / 8][4],
                                           float (&m)[2], float (&l)[2], const float* vt,
                                           int k0, int row0, int S, int causal,
                                           float scale_log2, int lane) {
  constexpr int NT = BK / 8, DT = D / 8, VS = vstride<D>();
  const int g = lane >> 2, t = lane & 3;
  if (k0 + BK > S || (causal && k0 + BK - 1 > row0)) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = row0 + g + (e >> 1) * 8;
        if (col >= S || (causal && col > row)) s[j][e] = NEG;
      }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // rows g and g + 8
    float mx = fmaxf(s[0][2 * i], s[0][2 * i + 1]);
#pragma unroll
    for (int j = 1; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * i] = ex2(fmaf(s[j][2 * i], scale_log2, -m_new));
      s[j][2 * i + 1] = ex2(fmaf(s[j][2 * i + 1], scale_log2, -m_new));
      sum += s[j][2 * i] + s[j][2 * i + 1];
    }
    l[i] = fmaf(l[i], alpha[i], sum);
  }
  // P's A fragments, split: k8 step j is keys 8j + 2t (k t) and 8j + 2t + 1
  // (k t + 4), so c0, c1, c2, c3 of s[j] are a0, a2, a1, a3.
  auto p_frags = [&](int j, unsigned (&ph)[4], unsigned (&pl)[4]) {
    split(__float_as_uint(s[j][0]), ph[0], pl[0]);  // a0: row g, key 2t
    split(__float_as_uint(s[j][2]), ph[1], pl[1]);  // a1: row g + 8, key 2t
    split(__float_as_uint(s[j][1]), ph[2], pl[2]);  // a2: row g, key 2t + 1
    split(__float_as_uint(s[j][3]), ph[3], pl[3]);  // a3: row g + 8, key 2t + 1
  };
  // c += P V of k8 step j and column tile n (this lane: columns 8n + g).
  auto pv = [&](float (&c)[4], const unsigned (&ph)[4], const unsigned (&pl)[4], int j, int n) {
    const float* vr = vt + 8 * j * VS + 8 * n;
    unsigned bh0, bl0, bh1, bl1;
    split(__float_as_uint(vr[0]), bh0, bl0);   // b0: key 2t
    split(__float_as_uint(vr[VS]), bh1, bl1);  // b1: key 2t + 1
    mma3(c, ph, pl, bh0, bh1, bl0, bl1);
  };
  auto add = [&](float (&a)[4], const float (&c)[4]) {  // a = a * alpha + c
    a[0] = fmaf(a[0], alpha[0], c[0]);
    a[1] = fmaf(a[1], alpha[0], c[1]);
    a[2] = fmaf(a[2], alpha[1], c[2]);
    a[3] = fmaf(a[3], alpha[1], c[3]);
  };
  float c[DT][4];  // the tile's P V, one chain per column tile
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    unsigned ph[4], pl[4];
    p_frags(j, ph, pl);
#pragma unroll
    for (int n = 0; n < DT; ++n) pv(c[n], ph, pl, j, n);
  }
#pragma unroll
  for (int n = 0; n < DT; ++n) add(acc[n], c[n]);
}

template <int D, int MINB, bool LSE>
__global__ void __launch_bounds__(THREADS, MINB)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int H, int HKV, int S, float scale_log2, int causal) {
  constexpr int BK = bk<D>(), VS = vstride<D>(), DT = D / 8;
  constexpr int KTILE = BK * D, VTILE = BK * VS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * D;     // two stages
  float* Vs = Ks + 2 * KTILE;  // two stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // heaviest (causal) first
  const int hk = h / (H / HKV);
  const int q0 = qb * BQ;
  const long long qoff = (static_cast<long long>(b) * H + h) * S * D;
  const long long koff = (static_cast<long long>(b) * HKV + hk) * S * D;
  const float* kp = k + koff;
  const float* vp = v + koff;
  float* op = o + qoff;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // the warp's first query row
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int nkb = (kend + BK - 1) / BK;

  const unsigned ks = smem_addr(Ks);
  // This lane's ldmatrix offset in a K tile, and its V element (key 2t, column g).
  const unsigned klane = ldsm_offset<D>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const float* vlane = Vs + 2 * t * VS + g;

  ARows<D, q_in_registers<D>()> qf;
  float acc[DT][4];
  float m[2] = {NEG, NEG};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};  // this thread's part of their sums
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  load_rows<BQ, D, D, true>(Qs, q + qoff, q0, S, tid);
  load_rows<BK, D, D, true>(Ks, kp, 0, S, tid);
  load_rows<BK, D, VS, false>(Vs, vp, 0, S, tid);
  cp_async_commit();
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1, k0 = kb * BK;
    cp_async_wait<0>();  // block kb has landed
    __syncthreads();     // ... for every thread, and block kb - 1 is consumed
    if (kb == 0) qf.load(smem_addr(Qs), warp, lane);
    if (kb + 1 < nkb) {  // block kb + 1 into the stage of block kb - 1
      load_rows<BK, D, D, true>(Ks + (st ^ 1) * KTILE, kp, k0 + BK, S, tid);
      load_rows<BK, D, VS, false>(Vs + (st ^ 1) * VTILE, vp, k0 + BK, S, tid);
      cp_async_commit();
    }
    if (causal && k0 > row0 + 15) continue;  // every key of the tile is above the warp's rows
    float s[BK / 8][4];
    mm_nt<D, BK>(s, qf, ks + st * KTILE * 4, klane);
    softmax_pv<D, BK>(s, acc, m, l, vlane + st * VTILE, k0, row0, S, causal, scale_log2, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int row = row0 + g + i * 8;
    if (row >= S) continue;
    float* orow = op + static_cast<long long>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) =
          make_float2(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    if constexpr (LSE) {  // m is in log2 units: lse = (m + log2 l) ln 2
      if (t == 0) lse[(static_cast<long long>(b) * H + h) * S + row] = (m[i] + log2f(den)) * LN2;
    }
  }
}

template <int D, int MINB, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int HKV, int S, float scale, int causal, void* stream) {
  constexpr int bytes = smem_bytes<D>();
  // The dynamic shared memory attribute, once per device (bit `dev`).
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(flash_f32_kernel<D, MINB, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_f32_kernel<D, MINB, LSE><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, H, HKV, S,
      scale * tc::LOG2E, causal);
  return (int)cudaGetLastError();
}

template <int D, int MINB>
int launch_lse(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int HKV, int S, float scale, int causal, void* stream) {
  return lse == nullptr
             ? launch<D, MINB, false>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream)
             : launch<D, MINB, true>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream);
}

// Blocks per SM: 3 at D = 32 (4 would cap the registers at 128: spills), 2
// at D = 64 and 128 (shared memory bounds them).
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int HKV, int S, int D, float scale, int causal, void* stream) {
  switch (D) {
    case 32: return launch_lse<32, 3>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream);
    case 64: return launch_lse<64, 2>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream);
    case 128: return launch_lse<128, 2>(q, k, v, o, lse, B, H, HKV, S, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 backward on the tensor cores

namespace tc {

constexpr int NC = 32;  // columns of S (keys for dQ, queries for dK/dV) per step

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// A warp's 16 rows of a swizzled 64 x D tile as the A fragments of D / 16
// k16 steps: loaded once into registers (REGS), or read from shared
// memory at each use.
template <int D, bool REGS>
struct ARows {
  unsigned r[REGS ? D / 16 : 1][4];
  unsigned base, lane_off;  // the warp's rows in the tile; this lane's ldsm_offset
  __device__ __forceinline__ void init(unsigned tile, int warp, int lane) {
    base = tile + warp * 16 * D * 2;
    lane_off = ldsm_offset<D>(lane & 15, lane >> 4);
    if constexpr (REGS) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(r[kk], base + (lane_off ^ (kk << 5)));
    }
  }
  __device__ __forceinline__ void get(int kk, unsigned (&a)[4]) const {
    if constexpr (REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = r[kk][e];
    } else {
      ldsm_x4(a, base + (lane_off ^ (kk << 5)));
    }
  }
};

// c (16 x NC, float32) = A (16 x D) times rows [col0, col0 + NC) of a
// swizzled tile, transposed. blane: this lane's ldsm_offset for B
// fragments read as they lie (the forward's K in Q K^T).
template <int D, bool REGS>
__device__ __forceinline__ void mm_nt(float (&c)[NC / 8][4], const ARows<D, REGS>& a,
                                      unsigned tile, unsigned blane, int col0) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  const unsigned base = tile + col0 * D * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned af[4];
    a.get(kk, af);
    const unsigned at = base + (blane ^ (kk << 5));  // d chunks 2kk, 2kk + 1
#pragma unroll
    for (int p = 0; p < NC / 16; ++p) {
      unsigned bf[4];  // b0, b1 of column tile 2p, then of 2p + 1
      ldsm_x4(bf, at + p * 16 * D * 2);
      mma_bf16(c[2 * p], af, bf[0], bf[1]);
      mma_bf16(c[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += A (16 x NC, bf16 fragments of NC / 16 k16 steps) times
// rows [row0, row0 + NC) of a swizzled tile. tlane: this lane's
// ldsm_offset for B fragments read by ldmatrix.trans (the forward's V).
template <int D>
__device__ __forceinline__ void mm_nn(float (&acc)[D / 8][4], const unsigned (&a)[NC / 16][4],
                                      unsigned tile, unsigned tlane, int row0) {
  const unsigned base = tile + row0 * D * 2;
#pragma unroll
  for (int p = 0; p < D / 16; ++p) {
    const unsigned at = base + (tlane ^ (p << 5));  // d chunks 2p, 2p + 1
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk) {
      unsigned bf[4];  // b0, b1 of d tile 2p, then of 2p + 1
      ldsm_x4_trans(bf, at + kk * 16 * D * 2);
      mma_bf16(acc[2 * p], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * p + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// The C fragments of 16 x NC as bf16 A fragments of NC / 16 k16 steps.
__device__ __forceinline__ void to_afrags(unsigned (&a)[NC / 16][4], const float (&c)[NC / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// This lane's ldmatrix offsets in a swizzled tile: B fragments read as
// they lie, and read transposed (the forward's klane and vlane).
template <int D>
__device__ __forceinline__ unsigned blane_of(int lane) {
  return ldsm_offset<D>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
}
template <int D>
__device__ __forceinline__ unsigned tlane_of(int lane) {
  return ldsm_offset<D>((lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4);
}

template <int D>
constexpr int bwd_smem_bytes() {  // two 64-row tiles held, two two-stage rings
  return 6 * BQ * D * 2 + 2 * 2 * BQ * 4;  // + the dK/dV kernel's lse and Dvec ring
}

// One block per (head, batch, q block): dQ of 64 rows, and Dvec of them.
template <int D, int MINB, bool REGS>
__global__ void __launch_bounds__(THREADS, MINB)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ dvec, bf16* __restrict__ dq, int H, int HKV, int S,
                       float scale, int causal) {
  constexpr int DT = D / 8, TILE = BK * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * D;
  bf16* Ks = dOs + BQ * D;   // two stages
  bf16* Vs = Ks + 2 * TILE;  // two stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // heaviest (causal) first
  const int hk = h / (H / HKV);
  const int q0 = qb * BQ;
  const long long rows = (static_cast<long long>(b) * H + h) * S;
  const long long qoff = rows * D;
  const long long koff = (static_cast<long long>(b) * HKV + hk) * S * D;
  const bf16* kp = k + koff;
  const bf16* vp = v + koff;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int nkb = (kend + BK - 1) / BK;
  const float scale_log2 = scale * LOG2E;

  load_rows<BQ, D, THREADS>(Qs, q + qoff, q0, S, tid);
  load_rows<BQ, D, THREADS>(dOs, dout + qoff, q0, S, tid);
  load_rows<BK, D, THREADS>(Ks, kp, 0, S, tid);
  load_rows<BK, D, THREADS>(Vs, vp, 0, S, tid);
  cp_async_commit();

  // Dvec and lse (log2 units) of rows g and g + 8: lane t of the quad
  // sums a quarter of the row, then two shuffles (0 past S).
  float dv[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    float sum = 0.f;
    if (row < S) {
      const long long at = qoff + static_cast<long long>(row) * D + t * (D / 4);
      const uint4* op = reinterpret_cast<const uint4*>(o + at);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const uint4 x = op[c], y = dp[c];
        const unsigned xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
          sum = fmaf(xf.x, yf.x, sum);
          sum = fmaf(xf.y, yf.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dv[i] = sum;
    lse2[i] = row < S ? lse[rows + row] * LOG2E : 0.f;
    if (t == 0 && row < S) dvec[rows + row] = sum;
  }

  const unsigned ks = smem_addr(Ks), vs = smem_addr(Vs);
  const unsigned blane = blane_of<D>(lane), tlane = tlane_of<D>(lane);
  ARows<D, REGS> qa, da;
  float acc[DT][4];
  zero<D>(acc);

  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1, k0 = kb * BK;
    cp_async_wait<0>();  // block kb has landed
    __syncthreads();     // ... for every thread, and block kb - 1 is consumed
    if (kb == 0) {
      qa.init(smem_addr(Qs), warp, lane);
      da.init(smem_addr(dOs), warp, lane);
    }
    if (kb + 1 < nkb) {  // block kb + 1 into the stage of block kb - 1
      load_rows<BK, D, THREADS>(Ks + (st ^ 1) * TILE, kp, k0 + BK, S, tid);
      load_rows<BK, D, THREADS>(Vs + (st ^ 1) * TILE, vp, k0 + BK, S, tid);
      cp_async_commit();
    }
    const unsigned kt = ks + st * TILE * 2, vt = vs + st * TILE * 2;
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > row0);
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += NC) {
      if (causal && k0 + c0 > row0 + 15) break;  // every key above the warp's diagonal
      float s[NC / 8][4], dp[NC / 8][4];
      mm_nt<D, REGS>(s, qa, kt, blane, c0);
      mm_nt<D, REGS>(dp, da, vt, blane, c0);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = ex2(fmaf(s[j][e], scale_log2, -lse2[i]));
          if (edge) {
            const int col = k0 + c0 + j * 8 + 2 * t + (e & 1), row = row0 + g + 8 * i;
            if (col >= S || (causal && col > row)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dv[i]);  // dS
        }
      unsigned dsa[NC / 16][4];
      to_afrags(dsa, s);
      mm_nn<D>(acc, dsa, kt, tlane, c0);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= S) continue;
    bf16* qrow = dq + qoff + static_cast<long long>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<unsigned*>(qrow + j * 8) =
          pack_bf16(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// One block per (query head, batch, key block): dK and dV of 64 keys from
// one query head. PARTIAL: float32 partials of the head (B, H, S, D),
// unscaled, for flash_bwd_dkdv_sum_kernel; else bf16 dK and dV (a group
// of 1).
template <int D, int MINB, bool REGS, bool PARTIAL>
__global__ void __launch_bounds__(THREADS, MINB)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         void* __restrict__ dk, void* __restrict__ dv, int H, int HKV, int S,
                         float scale, int causal) {
  constexpr int DT = D / 8, TILE = BQ * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * D;
  bf16* Qs = Vs + BK * D;     // two stages
  bf16* dOs = Qs + 2 * TILE;  // two stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE);  // two stages of BQ
  float* Dv = Ls + 2 * BQ;                              // two stages of BQ

  const int h = blockIdx.x, b = blockIdx.y;
  const int kb = blockIdx.z;  // the first key blocks see the most q tiles (causal)
  const int hk = h / (H / HKV);
  const int k0 = kb * BK;
  const long long rows = (static_cast<long long>(b) * H + h) * S;
  const long long koff = (static_cast<long long>(b) * HKV + hk) * S * D;
  const bf16* qp = q + rows * D;
  const bf16* dp_ = dout + rows * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16;  // the warp's first key
  const int nqb = (S + BQ - 1) / BQ;
  const int qstart = causal ? kb : 0;
  const float scale_log2 = scale * LOG2E;

  // q tile qb and its lse and Dvec into stage st (0 past S).
  auto load_q = [&](int qb, int st) {
    load_rows<BQ, D, THREADS>(Qs + st * TILE, qp, qb * BQ, S, tid);
    load_rows<BQ, D, THREADS>(dOs + st * TILE, dp_, qb * BQ, S, tid);
    const int r = tid & (BQ - 1), row = qb * BQ + r;
    const float* src = (tid < BQ ? lse : dvec) + rows;
    float* dst = (tid < BQ ? Ls : Dv) + st * BQ + r;
    cp_async4(dst, row < S ? src + row : src, row < S ? 4 : 0);
    cp_async_commit();
  };
  load_rows<BK, D, THREADS>(Ks, k + koff, k0, S, tid);
  load_rows<BK, D, THREADS>(Vs, v + koff, k0, S, tid);
  load_q(qstart, 0);

  const unsigned qs = smem_addr(Qs), ds = smem_addr(dOs);
  const unsigned blane = blane_of<D>(lane), tlane = tlane_of<D>(lane);
  ARows<D, REGS> ka, va;
  float adk[DT][4], adv[DT][4];
  zero<D>(adk);
  zero<D>(adv);

  for (int qb = qstart; qb < nqb; ++qb) {
    const int st = (qb - qstart) & 1, q0 = qb * BQ;
    cp_async_wait<0>();  // tile qb (and K, V) has landed
    __syncthreads();     // ... for every thread, and tile qb - 1 is consumed
    if (qb == qstart) {
      ka.init(smem_addr(Ks), warp, lane);
      va.init(smem_addr(Vs), warp, lane);
    }
    if (qb + 1 < nqb) load_q(qb + 1, st ^ 1);
    const unsigned qt = qs + st * TILE * 2, dt = ds + st * TILE * 2;
    const float* ls = Ls + st * BQ;
    const float* dvs = Dv + st * BQ;
    const bool edge = q0 + BQ > S || (causal && q0 < key0 + 15);
#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += NC) {
      if (causal && q0 + c0 + NC - 1 < key0) continue;  // every query before the warp's keys
      float s[NC / 8][4], dpt[NC / 8][4];
      mm_nt<D, REGS>(s, ka, qt, blane, c0);   // S^T
      mm_nt<D, REGS>(dpt, va, dt, blane, c0);  // dP^T
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int c = c0 + j * 8 + 2 * t;  // this lane's two query columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dvs + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x, dq_ = (e & 1) ? d2.y : d2.x;
          float p = ex2(fmaf(s[j][e], scale_log2, -lq * LOG2E));
          if (edge) {
            const int col = q0 + c + (e & 1), key = key0 + g + 8 * (e >> 1);
            if (col >= S || (causal && col < key)) p = 0.f;
          }
          s[j][e] = p;                       // P^T
          dpt[j][e] = p * (dpt[j][e] - dq_);  // dS^T
        }
      }
      unsigned pa[NC / 16][4], dsa[NC / 16][4];
      to_afrags(pa, s);
      to_afrags(dsa, dpt);
      mm_nn<D>(adv, pa, dt, tlane, c0);
      mm_nn<D>(adk, dsa, qt, tlane, c0);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + 8 * i;
    if (key >= S) continue;
    const long long e = static_cast<long long>(key) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      if constexpr (PARTIAL) {
        const long long at = rows * D + e + j * 8;
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + at) =
            make_float2(adk[j][2 * i], adk[j][2 * i + 1]);
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + at) =
            make_float2(adv[j][2 * i], adv[j][2 * i + 1]);
      } else {
        const long long at = koff + e + j * 8;
        *reinterpret_cast<unsigned*>(static_cast<bf16*>(dk) + at) =
            pack_bf16(adk[j][2 * i] * scale, adk[j][2 * i + 1] * scale);
        *reinterpret_cast<unsigned*>(static_cast<bf16*>(dv) + at) =
            pack_bf16(adv[j][2 * i], adv[j][2 * i + 1]);
      }
    }
  }
}

// 4 floats times s, stored as bf16 or float32.
__device__ __forceinline__ void store4(bf16* p, float4 x, float s) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(x.x * s, x.y * s), pack_bf16(x.z * s, x.w * s));
}
__device__ __forceinline__ void store4(float* p, float4 x, float s) {
  *reinterpret_cast<float4*>(p) = make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// dk[b, hk] = scale * sum over g of dkp[b, hk * group + g], dv likewise
// (no scale), in head order, stored as T (bf16 or float32): 4 elements a
// thread.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ dkp, const float* __restrict__ dvp,
                          T* __restrict__ dk, T* __restrict__ dv, long long head_elems,
                          long long total, int group, float scale) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e >= total) return;
  const long long src = (e / head_elems) * group * head_elems + e % head_elems;
  float4 sk = *reinterpret_cast<const float4*>(dkp + src);
  float4 sv = *reinterpret_cast<const float4*>(dvp + src);
  for (int i = 1; i < group; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(dkp + src + i * head_elems);
    const float4 c = *reinterpret_cast<const float4*>(dvp + src + i * head_elems);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  store4(dk + e, sk, scale);
  store4(dv + e, sv, 1.f);
}

template <int D, int MINB, bool REGS>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
               const void* dout, void* dvec, void* dq, void* dk, void* dv, void* dkp, void* dvp,
               int B, int H, int HKV, int S, float scale, int causal, void* stream) {
  constexpr int bytes = bwd_smem_bytes<D>();
  cudaStream_t st = (cudaStream_t)stream;
  const bool partial = H != HKV;
  auto dkdv = partial ? flash_bwd_dkdv_tc_kernel<D, MINB, REGS, true>
                      : flash_bwd_dkdv_tc_kernel<D, MINB, REGS, false>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D, MINB, REGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_bwd_dq_tc_kernel<D, MINB, REGS><<<grid, THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (float*)dvec, (bf16*)dq, H, HKV, S, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<grid, THREADS, bytes, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                     (const bf16*)dout, (const float*)lse, (const float*)dvec,
                                     partial ? dkp : dk, partial ? dvp : dv, H, HKV, S, scale,
                                     causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return (int)err;
  const long long head = static_cast<long long>(S) * D, total = head * B * HKV;
  flash_bwd_dkdv_sum_kernel<bf16><<<(unsigned)((total / 4 + 255) / 256), 256, 0, st>>>(
      (const float*)dkp, (const float*)dvp, (bf16*)dk, (bf16*)dv, head, total, H / HKV, scale);
  return (int)cudaGetLastError();
}

// Blocks per SM and whether the A operands stay in registers, by head dim.
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                 const void* dout, void* dvec, void* dq, void* dk, void* dv, void* dkp,
                 void* dvp, int B, int H, int HKV, int S, int D, float scale, int causal,
                 void* stream) {
  switch (D) {
    case 32:
      return launch_bwd<32, 2, true>(q, k, v, o, lse, dout, dvec, dq, dk, dv, dkp, dvp, B, H,
                                     HKV, S, scale, causal, stream);
    case 64:
      return launch_bwd<64, 2, true>(q, k, v, o, lse, dout, dvec, dq, dk, dv, dkp, dvp, B, H,
                                     HKV, S, scale, causal, stream);
    case 128:
      return launch_bwd<128, 1, false>(q, k, v, o, lse, dout, dvec, dq, dk, dv, dkp, dvp, B,
                                       H, HKV, S, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 backward on the tensor cores: three-pass TF32

namespace f32bwd {

using f32::ARows;
using f32::mm_nt;
using f32::mma3;
using f32::split;
using f32::THREADS;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ex2;
using tc::LOG2E;
using tc::smem_addr;

constexpr int BR = 64;  // rows a block owns: queries (dQ) or keys (dK/dV), 16 a warp

// Whether each streamed tile is split once into hi and lo tiles as it
// lands (by the threads that copied it), or split by every warp at each
// use (D = 128: the two halves would leave one block an SM).
template <int D>
__host__ __device__ constexpr bool presplit() {
  return D <= 64;
}
// Whether a dK/dV block computes both (D <= 64), or the grid holds a dV
// block and a dK block for each key block (D = 128: the dK and dV
// accumulators alone would take 128 registers a thread; each block
// computes S^T again, 5 products for 4, in twice the blocks).
template <int D>
__host__ __device__ constexpr bool split_dkdv() {
  return D == 128;
}
template <int D>
__host__ __device__ constexpr int tile() {  // rows of a streamed tile: keys (dQ), queries (dK/dV)
  return D == 128 ? 16 : D == 64 ? 32 : 64;
}
template <int D>
__host__ __device__ constexpr int nc() {  // columns of S (and dP) a step
  return D == 128 ? 16 : 32;
}
// Floats from a streamed hi tile to its lo tile, with G warp groups (a
// streamed tile of G tile<D>() rows).
template <int D, int G>
__host__ __device__ constexpr int lo_offset() {
  return presplit<D>() ? 4 * G * tile<D>() * D : 0;
}
template <int D, int G>
__host__ __device__ constexpr int smem_bytes() {
  // two 64-row tiles held, two two-stage rings (and their lo halves), the
  // dK/dV kernel's lse and Dvec ring
  return (2 * BR * D + 4 * G * tile<D>() * D + lo_offset<D, G>() + 4 * G * tile<D>()) * 4;
}

// Splits this thread's chunks of a tile that it copied with
// f32::load_rows<ROWS, D, D, true, NT> (once they have landed): hi in
// place, lo LO floats further.
template <int ROWS, int D, int LO, int NT>
__device__ __forceinline__ void split_rows(float* tile, int tid) {
  constexpr int CH = D / 4, STEP = NT / CH;
  const int r = tid / CH, ch = tid % CH;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const int rr = r + i * STEP;
    float* p = tile + rr * D + ((ch ^ (rr & 7)) << 2);
    const float4 x = *reinterpret_cast<const float4*>(p);
    unsigned h[4], l[4];
    split(__float_as_uint(x.x), h[0], l[0]);
    split(__float_as_uint(x.y), h[1], l[1]);
    split(__float_as_uint(x.z), h[2], l[2]);
    split(__float_as_uint(x.w), h[3], l[3]);
    *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(p + LO) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// This lane's float offsets, in a swizzled tile of rows of D floats, of its
// elements (row 2t, column 8m + g) and (row 2t + 1, column 8m + g), m < 4:
// the B fragment of A times the tile's rows, k index t standing for row
// 2t and t + 4 for row 2t + 1 (see mm_nn). Chunk 2m + g / 4 of row 2t is
// stored at (2m + g / 4) ^ 2t, so the 32 lanes hit 32 banks; column tile
// n is at x[n % 4] + 32 (n / 4), the XOR with 8n touching only the bits
// below 32 (an immediate offset from 4 registers, not D / 8).
template <int D>
struct BCols {
  int x0[4], x1[4];
  __device__ __forceinline__ explicit BCols(int lane) {
    const int g = lane >> 2, t = lane & 3;
    const int x = 2 * t * D + ((((g >> 2) ^ (2 * t)) << 2) | (g & 3));
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x0[m] = x ^ (8 * m);
      x1[m] = D + (x ^ 4 ^ (8 * m));
    }
  }
};

// The hi and lo parts of the float at p: split (LO 0), or read from a tile
// split once (see f32::b_frags).
template <int LO>
__device__ __forceinline__ void b_elem(const float* p, unsigned& h, unsigned& l) {
  if constexpr (LO != 0) {
    h = __float_as_uint(p[0]);
    l = __float_as_uint(p[LO]);
  } else {
    split(__float_as_uint(p[0]), h, l);
  }
}

// acc (16 x D) += A (16 x NC: the hi and lo A fragments of NC / 8 k8 steps,
// k index t of step j standing for row 8j + 2t and t + 4 for 8j + 2t + 1)
// times rows [0, NC) of a swizzled tile, each column tile's product summed
// from zero and added with one add. rows: the tile's first row; LO: see
// b_elem.
template <int D, int NC, int LO>
__device__ __forceinline__ void mm_nn(float (&acc)[D / 8][4], const unsigned (&ah)[NC / 8][4],
                                      const unsigned (&al)[NC / 8][4], const float* rows,
                                      const BCols<D>& x) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const float* r = rows + 8 * j * D + 32 * (n / 4);
      unsigned bh0, bl0, bh1, bl1;
      b_elem<LO>(r + x.x0[n % 4], bh0, bl0);  // b0: row 2t
      b_elem<LO>(r + x.x1[n % 4], bh1, bl1);  // b1: row 2t + 1
      mma3(c, ah[j], al[j], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

// The C fragments of 16 x NC as split A fragments of NC / 8 k8 steps, with
// no shuffle: k8 step j is columns 8j + 2t (k t) and 8j + 2t + 1 (k t + 4),
// so c0, c1, c2, c3 of c[j] are a0, a2, a1, a3.
template <int NC>
__device__ __forceinline__ void to_afrags(unsigned (&h)[NC / 8][4], unsigned (&l)[NC / 8][4],
                                          const float (&c)[NC / 8][4]) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    split(__float_as_uint(c[j][0]), h[j][0], l[j][0]);  // a0: row g, column 2t
    split(__float_as_uint(c[j][2]), h[j][1], l[j][1]);  // a1: row g + 8, column 2t
    split(__float_as_uint(c[j][1]), h[j][2], l[j][2]);  // a2: row g, column 2t + 1
    split(__float_as_uint(c[j][3]), h[j][3], l[j][3]);  // a3: row g + 8, column 2t + 1
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// This lane's ldsm_offset for B fragments read as they lie (the forward's klane).
template <int D>
__device__ __forceinline__ unsigned blane_of(int lane) {
  return f32::ldsm_offset<D>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
}

// Merges the G warp groups' accumulators of a block into group 0's, in
// group order, through shared memory `red` (free: no copy in flight, the
// last tile consumed). Thread-major, so the 32 lanes hit 32 banks.
template <int G, int N>
__device__ __forceinline__ void merge_groups(float (&acc)[N][4], float* red, int tid) {
  if constexpr (G > 1) {
    const int grp = tid / THREADS, tg = tid % THREADS;
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int gi = 1; gi < G; ++gi) {
      if (grp == gi) {
#pragma unroll
        for (int j = 0; j < N; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(j * 4 + e) * THREADS + tg] = acc[j][e];
      }
      __syncthreads();
      if (grp == 0) {
#pragma unroll
        for (int j = 0; j < N; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += red[(j * 4 + e) * THREADS + tg];
      }
      __syncthreads();
    }
  }
}

// One block per (head, batch, q block): dQ of 64 rows, and Dvec of them.
// G warp groups of 4 warps (16 rows each) take alternate tiles of T keys:
// tiles of G T keys stream through the ring, group g the g-th T rows.
template <int D, int MINB, bool REGS, int G>
__global__ void __launch_bounds__(THREADS * G, MINB)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dvec, float* __restrict__ dq, int H, int HKV, int S,
                        float scale, int causal) {
  constexpr int T = tile<D>(), NC = nc<D>(), DT = D / 8, NT = THREADS * G;
  constexpr int TK = G * T, TILE = TK * D, LO = lo_offset<D, G>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BR * D;
  float* Ks = dOs + BR * D;   // two stages (their lo halves LO floats on)
  float* Vs = Ks + 2 * TILE;  // two stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // heaviest (causal) first
  const int hk = h / (H / HKV);
  const int q0 = qb * BR;
  const long long rows = (static_cast<long long>(b) * H + h) * S;
  const long long qoff = rows * D;
  const long long koff = (static_cast<long long>(b) * HKV + hk) * S * D;
  const float* kp = k + koff;
  const float* vp = v + koff;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2, wr = warp & 3;  // warp group; the warp's rows in the block
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wr * 16;
  const int kend = causal ? min(S, q0 + BR) : S;
  const int nkb = (kend + TK - 1) / TK;
  const float scale_log2 = scale * LOG2E;

  f32::load_rows<BR, D, D, true, NT>(Qs, q + qoff, q0, S, tid);
  f32::load_rows<BR, D, D, true, NT>(dOs, dout + qoff, q0, S, tid);
  f32::load_rows<TK, D, D, true, NT>(Ks, kp, 0, S, tid);
  f32::load_rows<TK, D, D, true, NT>(Vs, vp, 0, S, tid);
  cp_async_commit();

  // Dvec and lse (log2 units) of rows g and g + 8: lane t of the quad
  // sums a quarter of the row, then two shuffles (0 past S).
  float dv[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    float sum = 0.f;
    if (row < S) {
      const long long at = qoff + static_cast<long long>(row) * D + t * (D / 4);
      const float4* op = reinterpret_cast<const float4*>(o + at);
      const float4* dp = reinterpret_cast<const float4*>(dout + at);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const float4 x = op[c], y = dp[c];
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dv[i] = sum;
    lse2[i] = row < S ? lse[rows + row] * LOG2E : 0.f;
    if (grp == 0 && t == 0 && row < S) dvec[rows + row] = sum;
  }

  const unsigned ks = smem_addr(Ks), vs = smem_addr(Vs);
  const unsigned blane = blane_of<D>(lane);
  const BCols<D> x(lane);
  ARows<D, REGS> qa, da;
  float acc[DT][4];
  zero<D>(acc);

  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1, k0 = kb * TK + grp * T;  // this group's first key
    cp_async_wait<0>();  // tile kb has landed
    if constexpr (LO != 0) {
      split_rows<TK, D, LO, NT>(Ks + st * TILE, tid);
      split_rows<TK, D, LO, NT>(Vs + st * TILE, tid);
    }
    __syncthreads();  // ... for every thread, and tile kb - 1 is consumed
    if (kb == 0) {
      qa.load(smem_addr(Qs), wr, lane);
      da.load(smem_addr(dOs), wr, lane);
    }
    if (kb + 1 < nkb) {  // tile kb + 1 into the stage of tile kb - 1
      f32::load_rows<TK, D, D, true, NT>(Ks + (st ^ 1) * TILE, kp, (kb + 1) * TK, S, tid);
      f32::load_rows<TK, D, D, true, NT>(Vs + (st ^ 1) * TILE, vp, (kb + 1) * TK, S, tid);
      cp_async_commit();
    }
    if (k0 >= kend) continue;  // the group's keys are all past the block's
    const int r0 = st * TK + grp * T;  // the group's first row in the ring
#pragma unroll
    for (int c0 = 0; c0 < T; c0 += NC) {
      if (causal && k0 + c0 > row0 + 15) break;  // every key above the warp's diagonal
      const unsigned at = (r0 + c0) * D * 4;
      float s[NC / 8][4], dp[NC / 8][4];
      mm_nt<D, NC, REGS, LO>(s, qa, ks + at, blane);   // S
      mm_nt<D, NC, REGS, LO>(dp, da, vs + at, blane);  // dP
      const bool edge = k0 + c0 + NC > S || (causal && k0 + c0 + NC - 1 > row0);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = ex2(fmaf(s[j][e], scale_log2, -lse2[i]));
          if (edge) {
            const int col = k0 + c0 + j * 8 + 2 * t + (e & 1), row = row0 + g + 8 * i;
            if (col >= S || (causal && col > row)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dv[i]);  // dS
        }
      unsigned ah[NC / 8][4], al[NC / 8][4];
      to_afrags<NC>(ah, al, s);
      mm_nn<D, NC, LO>(acc, ah, al, Ks + (r0 + c0) * D, x);  // dQ += dS K
    }
  }
  merge_groups<G>(acc, Ks, tid);
  if (grp != 0) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= S) continue;
    float* qrow = dq + qoff + static_cast<long long>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(qrow + j * 8) =
          make_float2(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// One block per (query head, batch, key block): dK and dV of 64 keys from
// one query head, or (split_dkdv) one of the two, by the parity of
// blockIdx.z. G warp groups of 4 warps (16 keys each) take alternate
// tiles of T queries, as in the dQ kernel. PARTIAL: float32 partials of
// the head (B, H, S, D), unscaled, for flash_bwd_dkdv_sum_kernel; else
// dK and dV (a group of 1).
template <int D, int MINB, bool REGS, bool PARTIAL, int G>
__global__ void __launch_bounds__(THREADS * G, MINB)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int HKV, int S,
                          float scale, int causal) {
  constexpr int T = tile<D>(), NC = nc<D>(), DT = D / 8, NT = THREADS * G;
  constexpr int TQ = G * T, TILE = TQ * D, LO = lo_offset<D, G>();
  constexpr bool SPLIT = split_dkdv<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BR * D;
  float* Qs = Vs + BR * D;          // two stages (their lo halves LO floats on)
  float* dOs = Qs + 2 * TILE;       // two stages
  float* Ls = dOs + 2 * TILE + LO;  // two stages of TQ
  float* Dv = Ls + 2 * TQ;          // two stages of TQ

  const int h = blockIdx.x, b = blockIdx.y;
  // The first key blocks see the most q tiles (causal).
  const int kb = SPLIT ? blockIdx.z >> 1 : blockIdx.z;
  const bool want_dk = !SPLIT || (blockIdx.z & 1), want_dv = !SPLIT || !(blockIdx.z & 1);
  const int hk = h / (H / HKV);
  const int k0 = kb * BR;
  const long long rows = (static_cast<long long>(b) * H + h) * S;
  const long long koff = (static_cast<long long>(b) * HKV + hk) * S * D;
  const float* qp = q + rows * D;
  const float* dp_ = dout + rows * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2, wr = warp & 3;  // warp group; the warp's keys in the block
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + wr * 16;  // the warp's first key
  const int nqb = (S + TQ - 1) / TQ;
  const int qstart = causal ? k0 / TQ : 0;
  const float scale_log2 = scale * LOG2E;

  // q tile qb and its lse and Dvec into stage st (0 past S).
  auto load_q = [&](int qb, int st) {
    f32::load_rows<TQ, D, D, true, NT>(Qs + st * TILE, qp, qb * TQ, S, tid);
    f32::load_rows<TQ, D, D, true, NT>(dOs + st * TILE, dp_, qb * TQ, S, tid);
    if (tid < 2 * TQ) {
      const int r = tid % TQ, row = qb * TQ + r;
      const float* src = (tid < TQ ? lse : dvec) + rows;
      float* dst = (tid < TQ ? Ls : Dv) + st * TQ + r;
      cp_async4(dst, row < S ? src + row : src, row < S ? 4 : 0);
    }
    cp_async_commit();
  };
  f32::load_rows<BR, D, D, true, NT>(Ks, k + koff, k0, S, tid);
  f32::load_rows<BR, D, D, true, NT>(Vs, v + koff, k0, S, tid);
  load_q(qstart, 0);

  const unsigned qs = smem_addr(Qs), ds = smem_addr(dOs);
  const unsigned blane = blane_of<D>(lane);
  const BCols<D> x(lane);
  ARows<D, REGS> ka, va;
  // dV then dK; split: the one of this block.
  constexpr int NACC = SPLIT ? 1 : 2;
  float acc[NACC][DT][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a) zero<D>(acc[a]);

  for (int qb = qstart; qb < nqb; ++qb) {
    const int st = (qb - qstart) & 1, q0 = qb * TQ + grp * T;  // this group's first query
    cp_async_wait<0>();  // tile qb (and K, V) has landed
    if constexpr (LO != 0) {
      split_rows<TQ, D, LO, NT>(Qs + st * TILE, tid);
      split_rows<TQ, D, LO, NT>(dOs + st * TILE, tid);
    }
    __syncthreads();  // ... for every thread, and tile qb - 1 is consumed
    if (qb == qstart) {
      ka.load(smem_addr(Ks), wr, lane);
      va.load(smem_addr(Vs), wr, lane);
    }
    if (qb + 1 < nqb) load_q(qb + 1, st ^ 1);
    if (q0 >= S) continue;  // the group's queries are all past S
    const int r0 = st * TQ + grp * T;  // the group's first row in the ring
    const float* ls = Ls + r0;
    const float* dvs = Dv + r0;
#pragma unroll
    for (int c0 = 0; c0 < T; c0 += NC) {
      if (causal && q0 + c0 + NC - 1 < key0) continue;  // every query before the warp's keys
      const unsigned at = (r0 + c0) * D * 4;
      float s[NC / 8][4], dpt[NC / 8][4];
      mm_nt<D, NC, REGS, LO>(s, ka, qs + at, blane);                   // S^T
      if (want_dk) mm_nt<D, NC, REGS, LO>(dpt, va, ds + at, blane);  // dP^T
      const bool edge = q0 + c0 + NC > S || (causal && q0 + c0 < key0 + 15);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int c = c0 + j * 8 + 2 * t;  // this lane's two query columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dvs + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x, dq_ = (e & 1) ? d2.y : d2.x;
          float p = ex2(fmaf(s[j][e], scale_log2, -lq * LOG2E));
          if (edge) {
            const int col = q0 + c + (e & 1), key = key0 + g + 8 * (e >> 1);
            if (col >= S || (causal && col < key)) p = 0.f;
          }
          s[j][e] = p;                                      // P^T
          if (want_dk) dpt[j][e] = p * (dpt[j][e] - dq_);  // dS^T
        }
      }
      unsigned ah[NC / 8][4], al[NC / 8][4];
      if (want_dv) {
        to_afrags<NC>(ah, al, s);
        mm_nn<D, NC, LO>(acc[0], ah, al, dOs + (r0 + c0) * D, x);  // dV += P^T dO
      }
      if (want_dk) {
        to_afrags<NC>(ah, al, dpt);
        mm_nn<D, NC, LO>(acc[NACC - 1], ah, al, Qs + (r0 + c0) * D, x);  // dK += dS^T Q
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NACC; ++a) merge_groups<G>(acc[a], Qs, tid);
  if (grp != 0) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + 8 * i;
    if (key >= S) continue;
    const long long e = (PARTIAL ? rows * D : koff) + static_cast<long long>(key) * D + 2 * t;
    const float sk = PARTIAL ? 1.f : scale;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      if (want_dv)
        *reinterpret_cast<float2*>(dv + e + j * 8) =
            make_float2(acc[0][j][2 * i], acc[0][j][2 * i + 1]);
      if (want_dk)
        *reinterpret_cast<float2*>(dk + e + j * 8) =
            make_float2(acc[NACC - 1][j][2 * i] * sk, acc[NACC - 1][j][2 * i + 1] * sk);
    }
  }
}

// Per device (bit `dev`): whether the kernels' dynamic shared memory
// attribute is set, and the device's SM count.
struct DeviceState {
  std::atomic<unsigned long long> ready{0};
  int sms[64] = {};
};

// Sets the dynamic shared memory attribute of the kernels for G warp groups.
template <int D, int MINB, bool REGS, int G>
int prepare() {
  const void* fns[] = {(const void*)flash_bwd_dq_f32_kernel<D, MINB, REGS, G>,
                       (const void*)flash_bwd_dkdv_f32_kernel<D, MINB, REGS, true, G>,
                       (const void*)flash_bwd_dkdv_f32_kernel<D, MINB, REGS, false, G>};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D, G>());
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int D, int MINB, bool REGS, int G>
int launch_dq(dim3 grid, cudaStream_t st, const void* q, const void* k, const void* v,
              const void* o, const void* lse, const void* dout, void* dvec, void* dq, int H,
              int HKV, int S, float scale, int causal) {
  flash_bwd_dq_f32_kernel<D, MINB, REGS, G><<<grid, THREADS * G, smem_bytes<D, G>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout,
      (const float*)lse, (float*)dvec, (float*)dq, H, HKV, S, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, int MINB, bool REGS, int G>
int launch_dkdv(dim3 grid, cudaStream_t st, bool partial, const void* q, const void* k,
                const void* v, const void* dout, const void* lse, const void* dvec, void* dk,
                void* dv, int H, int HKV, int S, float scale, int causal) {
  auto kernel = partial ? flash_bwd_dkdv_f32_kernel<D, MINB, REGS, true, G>
                        : flash_bwd_dkdv_f32_kernel<D, MINB, REGS, false, G>;
  kernel<<<grid, THREADS * G, smem_bytes<D, G>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)dvec, (float*)dk, (float*)dv, H, HKV, S, scale, causal);
  return (int)cudaGetLastError();
}

// Two warp groups a block where the grid has at most two blocks an SM
// (the training path's shapes: each block's chain of tiles halves; on an
// H100 7b's kernels took 0.0395 ms for 0.0416, 10 (b)'s 0.0785 for 0.0950),
// else one (4x32x1024x64 took 1.1262 ms with two for 1.0203).
template <int D, int MINB, bool REGS>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* dvec, void* dq, void* dk, void* dv, void* dkp, void* dvp,
           int B, int H, int HKV, int S, float scale, int causal, void* stream) {
  static DeviceState state;
  cudaStream_t st = (cudaStream_t)stream;
  const bool partial = H != HKV;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(state.ready.load(std::memory_order_acquire) & bit)) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    int e = prepare<D, MINB, REGS, 1>();
    if (e == 0) e = prepare<D, 1, REGS, 2>();
    if (e != 0) return e;
    if (dev < 64) state.sms[dev] = sms;
    state.ready.fetch_or(bit, std::memory_order_release);
  }
  const long long sms = dev < 64 ? state.sms[dev] : 0;
  const dim3 grid(H, B, (S + BR - 1) / BR);
  const dim3 kv_grid(H, B, grid.z * (split_dkdv<D>() ? 2 : 1));
  const bool two_q = 1ll * grid.x * grid.y * grid.z <= 2 * sms;
  const bool two_kv = 1ll * kv_grid.x * kv_grid.y * kv_grid.z <= 2 * sms;
  int e = two_q ? launch_dq<D, 1, REGS, 2>(grid, st, q, k, v, o, lse, dout, dvec, dq, H, HKV,
                                           S, scale, causal)
                : launch_dq<D, MINB, REGS, 1>(grid, st, q, k, v, o, lse, dout, dvec, dq, H, HKV,
                                              S, scale, causal);
  if (e != 0) return e;
  void* dkt = partial ? dkp : dk;
  void* dvt = partial ? dvp : dv;
  e = two_kv ? launch_dkdv<D, 1, REGS, 2>(kv_grid, st, partial, q, k, v, dout, lse, dvec, dkt,
                                          dvt, H, HKV, S, scale, causal)
             : launch_dkdv<D, MINB, REGS, 1>(kv_grid, st, partial, q, k, v, dout, lse, dvec,
                                             dkt, dvt, H, HKV, S, scale, causal);
  if (e != 0 || !partial) return e;
  const long long head = static_cast<long long>(S) * D, total = head * B * HKV;
  tc::flash_bwd_dkdv_sum_kernel<float><<<(unsigned)((total / 4 + 255) / 256), 256, 0, st>>>(
      (const float*)dkp, (const float*)dvp, (float*)dk, (float*)dv, head, total, H / HKV, scale);
  return (int)cudaGetLastError();
}

// Blocks per SM (one warp group a block) and whether the A operands stay
// in registers, by head dim (D >= 64: read from shared memory and split at
// each use).
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* lse,
             const void* dout, void* dvec, void* dq, void* dk, void* dv, void* dkp, void* dvp,
             int B, int H, int HKV, int S, int D, float scale, int causal, void* stream) {
  switch (D) {
    case 32:
      return launch<32, 2, true>(q, k, v, o, lse, dout, dvec, dq, dk, dv, dkp, dvp, B, H, HKV,
                                 S, scale, causal, stream);
    case 64:
      return launch<64, 2, false>(q, k, v, o, lse, dout, dvec, dq, dk, dv, dkp, dvp, B, H, HKV,
                                  S, scale, causal, stream);
    case 128:
      return launch<128, 2, false>(q, k, v, o, lse, dout, dvec, dq, dk, dv, dkp, dvp, B, H,
                                   HKV, S, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32bwd

}  // namespace

// q (B, H, S, D), k/v (B, HKV, S, D), o (B, H, S, D), contiguous; D in
// {32, 64, 128}; H a multiple of HKV; pointers 16-byte aligned.
// lse (B, H, S) float32, or null for none. Returns the CUDA error, or 0.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int HKV, int S, int D,
                                   float scale, int causal, void* stream) {
  return f32::dispatch(q, k, v, o, (float*)lse, B, H, HKV, S, D, scale, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int B, int H, int HKV, int S, int D,
                                    float scale, int causal, void* stream) {
  return tc::dispatch(q, k, v, o, (float*)lse, B, H, HKV, S, D, scale, causal, stream);
}

// Backward: q, o, dout, dq (B, H, S, D); k, v, dk, dv (B, HKV, S, D); lse
// (B, H, S) float32 from the forward; dvec (B, H, S) float32 scratch; dkp,
// dvp float32 (B, H, S, D) scratch when H > HKV, else null. All
// contiguous, of one type but lse, dvec, dkp and dvp; the pointers
// 16-byte aligned. Returns the CUDA error, or 0.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* lse, const void* dout,
                                       void* dvec, void* dq, void* dk, void* dv, void* dkp,
                                       void* dvp, int B, int H, int HKV, int S, int D,
                                       float scale, int causal, void* stream) {
  return f32bwd::dispatch(q, k, v, o, lse, dout, dvec, dq, dk, dv, dkp, dvp, B, H, HKV, S, D,
                          scale, causal, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* lse, const void* dout,
                                        void* dvec, void* dq, void* dk, void* dv, void* dkp,
                                        void* dvp, int B, int H, int HKV, int S, int D,
                                        float scale, int causal, void* stream) {
  return tc::dispatch_bwd(q, k, v, o, lse, dout, dvec, dq, dk, dv, dkp, dvp, B, H, HKV, S, D,
                          scale, causal, stream);
}
