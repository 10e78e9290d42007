// Grayscale morphological reconstruction for Hopper: one persistent,
// cooperative launch per reconstruction.
//
// Replaces the TPU kernel `morph_recon_step` / `morph_recon_pallas`
// (src/repro/kernels/morph_recon.py:82, its pl.pallas_call).
//
// Computes Vincent's 8-connected grayscale reconstruction: the
// fixpoint of v <- min(dilate3x3(v), mask) from v = min(marker, mask),
// with -inf beyond the edges (the oracle's reduce_window init). The
// fixpoint is unique and is reached by any order of such updates, so
// the result is bit-identical to the plain version's
// (repro_torch.kernels.ref.morph_recon_ref) whatever the tile order.
//
// Bound on the card: bytes. The function must read marker and mask and
// write the result once: 12 bytes per pixel, 201 MB at 4096x4096,
// 0.0601 ms at 3.35 TB/s. The operations (9 max + 1 min per pixel and
// sweep) depend on the data; one sweep is 0.0025 ms of float32 work.
//
// Design.
// - The image is cut into 32x64 tiles. A block loads a tile plus a
//   one-pixel halo of the working plane and the mask into shared memory
//   and runs up to `max_sweeps` in-place sweeps over the tile, forward
//   and backward raster order in turn, until a sweep changes nothing
//   (__syncthreads_or).
// - The grid is persistent: cudaLaunchCooperativeKernel with as many
//   blocks as can be resident at once (occupancy query x SMs, at first
//   use). Rounds end at a grid barrier
//   (cooperative_groups::this_grid().sync()). Within a round a block
//   claims its next tile from an atomic counter, so a block that drew
//   tiles needing many sweeps does not hold the round back while the
//   others wait at the barrier. The kernel holds every SM of the card
//   while it runs; that is what the WSI path wants (one `gpu` lane per
//   card, one op at a time on it).
// - Round 0 visits every tile, in raster order of the claims, reading
//   marker and mask (so the halo is min(marker, mask) even where the
//   neighbour has not run yet), and writes every pixel of the tile into
//   `out`, the one working plane. Later rounds read the tile and its
//   halo from `out` itself.
// - Dirty tiles. A later round visits only the tiles marked in the round
//   before. A visit that raises a pixel on the tile's border marks the
//   neighbour whose halo holds that pixel: the top row marks the tile
//   above, the left column the tile to the left, and so on; a corner
//   pixel also marks the diagonal neighbour, because an 8-connected
//   path can cross at a corner. A visit that stops at the sweep cap with
//   its last sweep still changing marks its own tile. The first mark of
//   a tile (atomicExch on its flag) appends it to the next round's work
//   list (atomicAdd on the list's count).
// - Buffers by round. Flags and lists come in two, by the round's
//   parity: round r reads those of parity r and writes those of parity
//   r + 1; the block that claims a tile clears its flag in round r,
//   before the barrier that precedes round r + 1, which writes that
//   array next. The list counts and claim counters come in three, by
//   round % 3: the count that round r appends to is read after its
//   barrier and during round r + 1, so it can only be zeroed in round
//   r + 2 (by block 0), before round r + 3 appends to it again. With two
//   of them a block still reading the count after a barrier could see
//   it zeroed by a faster block, and stop early.
// - Exit. After the barrier of round r every block reads the count of
//   the list that round r built and stops if it is 0.
// - No host synchronisation: the wrapper issues the launch and returns.
//   The kernel writes its rounds, tile visits, in-tile sweeps and a
//   changed flag into a small int32 workspace that a caller may read
//   after the fact.
//
// Why the result is exact. Every value that is ever written is
// min(max of values read, mask) of values that were themselves lower
// bounds of the fixpoint, so every value in `out` is a lower bound at
// all times, whatever a block reads while a neighbour writes (a 32-bit
// float is read or written whole). When a round marks nothing, every
// tile was last visited after the last rise of any pixel in its halo
// (a rise marks the tile for the next round), and that visit ended with
// a sweep that changed nothing, so each pixel equals
// min(max of its 3x3 neighbourhood, mask) on the final plane. A fixpoint
// that lies between min(marker, mask) and the reconstruction is the
// reconstruction.
//
// Memory. `out`, the flags, lists and counters are written and read by
// different blocks inside one launch, so they are read with ld.global.cg
// (__ldcg, the L2, which is coherent) and never through the read-only
// or L1 path, which could return a value from before the barrier. The
// marker and the mask never change during the launch and stay on __ldg.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BH = 32;
constexpr int BW = 64;
constexpr int SH = BH + 2;
constexpr int SW = BW + 2;
constexpr int THREADS = 256;
constexpr int PER = BH * BW / THREADS;
static_assert(BH * BW % THREADS == 0, "tile must split evenly over threads");
// Resident blocks per SM the register budget must allow (<= 51 registers
// a thread; ptxas spills a few bytes for it): more blocks hide the
// latency of the sweeps' shared-memory loads and barriers. Unbounded,
// ptxas takes 126 registers and 2 blocks fit; on the four pairs of a
// 4096x4096 tile 5 blocks beat 6 and 2 in sum on an H100 (PERF.md).
constexpr int MIN_BLOCKS = 5;

// Workspace layout (int32): rounds, tile visits, in-tile sweeps,
// changed, three list counts and three claim counters (round % 3), then
// two dirty-flag arrays and two work lists of n_tiles each (round % 2).
constexpr int WS_ROUNDS = 0;
constexpr int WS_VISITS = 1;
constexpr int WS_SWEEPS = 2;
constexpr int WS_CHANGED = 3;
constexpr int WS_COUNT = 4;
constexpr int WS_CLAIM = 7;
constexpr int WS_HEAD = 10;

// Border rises of a visit, one bit per neighbour whose halo holds the
// pixel, and one for the tile itself (stopped at the sweep cap).
constexpr int kN = 1, kS = 2, kW = 4, kE = 8;
constexpr int kNW = 16, kNE = 32, kSW = 64, kSE = 128, kSelf = 256;

struct Params {
  const float* marker;  // read in round 0 only
  const float* mask;    // read-only for the whole launch
  float* out;           // the working plane, shared by all blocks
  int* ws;
  int h, w, tiles_x, tiles_y, max_sweeps, max_rounds;
};

__device__ __forceinline__ int edge_bits(int sy, int sx) {
  const bool top = sy == 1, bottom = sy == BH, left = sx == 1, right = sx == BW;
  return (top ? kN : 0) | (bottom ? kS : 0) | (left ? kW : 0) | (right ? kE : 0) |
         (top && left ? kNW : 0) | (top && right ? kNE : 0) |
         (bottom && left ? kSW : 0) | (bottom && right ? kSE : 0);
}

// One visit of tile `t`. Returns the marks it must make, sets *rose
// when any pixel of the tile rose and adds the sweeps it ran to *sweeps.
__device__ int visit(const Params& p, int t, bool first, float (*v)[SW],
                     float (*m)[SW], int* s_bits, int* rose, int* sweeps) {
  const int tid = threadIdx.x;
  const int x0 = (t % p.tiles_x) * BW;
  const int y0 = (t / p.tiles_x) * BH;
  if (tid == 0) *s_bits = 0;
  for (int i = tid; i < SH * SW; i += THREADS) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float val = -INFINITY, mk = -INFINITY;
    if (gy >= 0 && gy < p.h && gx >= 0 && gx < p.w) {
      const long long o = static_cast<long long>(gy) * p.w + gx;
      mk = __ldg(p.mask + o);
      val = first ? fminf(__ldg(p.marker + o), mk) : __ldcg(p.out + o);
    }
    v[sy][sx] = val;
    m[sy][sx] = mk;
  }
  __syncthreads();
  float v0[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int q = tid + k * THREADS;
    v0[k] = v[q / BW + 1][q % BW + 1];
  }

  int s = 0;
  for (; s < p.max_sweeps; ++s) {
    int ch = 0;
    for (int k = 0; k < PER; ++k) {
      int q = tid + k * THREADS;
      if (s & 1) q = BH * BW - 1 - q;
      const int sy = q / BW + 1, sx = q % BW + 1;
      if (y0 + sy - 1 >= p.h || x0 + sx - 1 >= p.w) continue;
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
  }

  int bits = 0, up = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int q = tid + k * THREADS;
    const int sy = q / BW + 1, sx = q % BW + 1;
    const int gy = y0 + sy - 1, gx = x0 + sx - 1;
    if (gy >= p.h || gx >= p.w) continue;
    const float nv = v[sy][sx];
    const bool risen = nv > v0[k];
    if (first || risen) __stcg(p.out + static_cast<long long>(gy) * p.w + gx, nv);
    if (risen) {
      up = 1;
      bits |= edge_bits(sy, sx);
    }
  }
  if (bits) atomicOr(s_bits, bits);
  *rose = __syncthreads_or(up);
  *sweeps += s < p.max_sweeps ? s + 1 : s;
  // The last sweep still changed something: the tile may not be done.
  return *s_bits | (s == p.max_sweeps ? kSelf : 0);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
morph_recon_kernel(Params p) {
  __shared__ float v[SH][SW];
  __shared__ float m[SH][SW];
  __shared__ int s_bits, s_tile;
  cg::grid_group grid = cg::this_grid();
  const int n_tiles = p.tiles_x * p.tiles_y;
  int visits = 0, sweeps = 0, changed = 0, round = 0;

  for (;;) {
    const int par = round & 1;
    int* flags = p.ws + WS_HEAD;              // [2][n_tiles]
    int* lists = p.ws + WS_HEAD + 2 * n_tiles;  // [2][n_tiles]
    int* count_nxt = p.ws + WS_COUNT + (round + 1) % 3;
    int* claim = p.ws + WS_CLAIM + round % 3;
    if (round > 0 && blockIdx.x == 0 && threadIdx.x == 0) {
      // Last read in round - 1, next written in round + 1.
      p.ws[WS_COUNT + (round + 2) % 3] = 0;
      p.ws[WS_CLAIM + (round + 2) % 3] = 0;
    }
    const int n_work = round == 0 ? n_tiles : __ldcg(p.ws + WS_COUNT + round % 3);
    for (;;) {
      if (threadIdx.x == 0) {
        const int i = atomicAdd(claim, 1);
        s_tile = i >= n_work ? -1 : round == 0 ? i : __ldcg(lists + par * n_tiles + i);
      }
      __syncthreads();
      const int t = s_tile;
      if (t < 0) break;
      if (round > 0 && threadIdx.x == 0) atomicExch(flags + par * n_tiles + t, 0);
      int rose = 0;
      const int bits = visit(p, t, round == 0, v, m, &s_bits, &rose, &sweeps);
      ++visits;
      changed |= rose;
      if (threadIdx.x == 0 && bits) {
        const int ty = t / p.tiles_x, tx = t % p.tiles_x;
        const bool n = ty > 0, s = ty + 1 < p.tiles_y;
        const bool w = tx > 0, e = tx + 1 < p.tiles_x;
        auto mark = [&](bool ok, int bit, int dy, int dx) {
          const int nt = t + dy * p.tiles_x + dx;
          // The first mark of a tile in a round puts it on the next list.
          if (ok && (bits & bit) && !atomicExch(flags + (1 - par) * n_tiles + nt, 1))
            lists[(1 - par) * n_tiles + atomicAdd(count_nxt, 1)] = nt;
        };
        mark(n, kN, -1, 0);
        mark(s, kS, 1, 0);
        mark(w, kW, 0, -1);
        mark(e, kE, 0, 1);
        mark(n && w, kNW, -1, -1);
        mark(n && e, kNE, -1, 1);
        mark(s && w, kSW, 1, -1);
        mark(s && e, kSE, 1, 1);
        mark(true, kSelf, 0, 0);
      }
      // The next claim overwrites s_tile, the next visit v, m and s_bits.
      __syncthreads();
    }
    if (round + 1 >= p.max_rounds) break;
    grid.sync();
    if (__ldcg(count_nxt) == 0) break;  // the round marked nothing
    ++round;
  }
  if (threadIdx.x == 0) {
    atomicAdd(p.ws + WS_VISITS, visits);
    atomicAdd(p.ws + WS_SWEEPS, sweeps);
    if (changed) atomicExch(p.ws + WS_CHANGED, 1);
    if (blockIdx.x == 0) p.ws[WS_ROUNDS] = round + 1;
  }
}

int g_grid[64];  // per device: resident blocks per SM x SMs, 0 = not asked yet

}  // namespace

extern "C" {

// Length in int32 of the workspace `morph_recon_run` needs for an
// (h, w) plane: the head plus two flag arrays and two work lists.
int morph_recon_ws_ints(int h, int w) {
  const int n_tiles = ((w + BW - 1) / BW) * ((h + BH - 1) / BH);
  return WS_HEAD + 4 * n_tiles;
}

// Reconstruction of `marker` under `mask` into `out` in one cooperative
// launch, at most `max_rounds` rounds (1: round 0 alone, the one-step
// form; a large number: to the fixpoint). `ws` is a zeroed int32
// workspace of `ws_ints` = morph_recon_ws_ints(h, w) entries (any other
// length is refused with cudaErrorInvalidValue); afterwards ws[0] = rounds, ws[1] = tile visits, ws[2] = in-tile
// sweeps summed over the visits, ws[3] = 1 if any pixel rose above
// min(marker, mask). `out` must not alias marker or mask.
// All pointers are device pointers to contiguous float32 (H, W) planes.
// Returns the launch's CUDA error (a refused cooperative launch
// included), or 0; the host never waits.
int morph_recon_run(const void* marker, const void* mask, void* out, void* ws,
                    int ws_ints, int h, int w, int max_sweeps, int max_rounds,
                    void* stream) {
  if (ws_ints != morph_recon_ws_ints(h, w)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_grid[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, morph_recon_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_grid[dev] = per_sm * sms;
  }
  Params p{(const float*)marker, (const float*)mask, (float*)out, (int*)ws,
           h, w, (w + BW - 1) / BW, (h + BH - 1) / BH, max_sweeps, max_rounds};
  const int n_tiles = p.tiles_x * p.tiles_y;
  const int grid = n_tiles < g_grid[dev] ? n_tiles : g_grid[dev];
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)morph_recon_kernel, dim3(grid),
                                    dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
