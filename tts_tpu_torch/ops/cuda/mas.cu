// Monotonic alignment search (MAS) for Glow-TTS training, for Hopper
// (sm_90a), fp32.
//
// Replaces tts_tpu/ops/pallas/mas_kernel.py (`_mas_kernel`, run by the
// pallas_call in `maximum_path_pallas`). Per item b, with t_x the count of
// mask[b, :, 0] > 0 and t_y the count of mask[b, 0, :] > 0 and value zeroed
// where mask <= 0, it runs the max-plus dynamic program over mel columns
// y < t_y,
//
//   stay      = (x == y) ? NEG : prev[x]
//   diag      = x == 0 ? (y == 0 ? 0 : NEG) : prev[x - 1]
//   dec[y][x] = diag >= stay
//   cur[x]    = max(stay, diag) + value[x][y]
//
// then backtracks from x = t_x - 1 over y = t_y - 1 .. 0, stepping x -= 1
// where dec[y][x] is set and y > 0, never below x = 0 (the guard of
// tts_tpu's numpy oracle; the Pallas kernel would roll x = 0 over to
// T_x - 1 instead), and returns path[x][y] = (x on the path at y) * mask.
// The order of operations is kept (one max, then one add, __fadd_rn: no FMA
// can form) and so is the tie rule >=, so the path equals the plain PyTorch
// version bit for bit.
//
// Bound on the card. Bytes: value inside the lengths and the whole mask
// read once, the whole path written once, at 3.35 TB/s (0.0167 ms at 32 x
// 192 x 864). No MAS reaches it: an item's DP is a chain of t_y dependent
// columns on one SM, and its backtrack a chain of dependent steps. Taking
// ~40 cycles a column for each, the latency floor is ~35 us at 864
// columns (1.98 GHz). Most of the kernel's time is the DP: one warp runs
// it alone, half of it on the half-rate compare/select pipe, beside the
// staging warps' shared-memory traffic (scripts/mas_phase_clocks.py prints
// the cycles of each phase).
//
// Design (one launch per call, one block per item, value and mask read in
// their own (B, T_x, T_y) layout; the wrapper runs nothing else):
// - The DP row lives in registers: W = ceil(T_x / 256) DP warps, each lane
//   R <= 8 consecutive rows x = (32 w + lane) R + r, updated from the last
//   down so each reads its neighbour's value of the column before; the
//   lane's first row gets x - 1 by one shuffle a column. One warp covers
//   T_x <= 256 (192 on the training path) with no barrier at all; several
//   warps exchange one boundary value a column through a named barrier of
//   the DP warps only. The x == y test, the last columns and column 0 are
//   handled in groups of 4 columns apart, so most groups run without a
//   branch.
// - Staging warps (7, or 8 beside several DP warps) copy tiles of C
//   columns of mask (every column) and value (columns y < t_y) for all
//   rows by cp.async of 16 (or 8, or 4) bytes, a ring of up to 6 stages.
//   C is 32 where 3 stages fit (128-byte rows read whole: with 32-byte
//   pieces DRAM, not the DP, set the pace), else 16 or 8. The
//   16-byte chunks of a row are permuted by the row, which keeps the DP's
//   16-byte reads (4 columns of a row, loaded a group ahead) to 2-way bank
//   conflicts. A staging thread then writes path = 0 * mask for the chunks
//   it copied, and zeroes value where mask <= 0 only in chunks that have
//   such a cell (their shared-memory traffic delays the DP's shuffles and
//   loads). So the mask is read once and the path's zeros leave while the
//   DP runs, also past t_y. Staging and DP warps meet on named barriers
//   (full / empty per slot).
// - Decisions: a lane sets bit y % 32 of a register word per row (a
//   compare and a predicated OR) and stores its R words every 32 columns,
//   into a plane [x][y / 32] in shared memory where it, the tiles and the
//   backtrack's output fit, else in a global scratch the wrapper allocates
//   (mas_scratch_words). No warp vote and no store per column.
// - One thread backtracks move by move: the next move in a 32-column block
//   is the highest set bit of x's word at or below the current column
//   (__clz), so the chain has ~t_x links, not t_y; the word of x - 1 is
//   held and the next loaded off the chain. It leaves the move columns as
//   bits and x at the top of each block.
// - Every thread then writes path[x_y][y] = 1 * mask[x_y][y] for y < t_y,
//   x_y = x at its block's top less a popcount of the moves above y.
// T_x beyond what the tiles allow (> 1,792 on an H100) runs the general
// kernel: the DP row in shared memory with one block barrier per column,
// value and mask read from global memory, the same decision plane (in the
// scratch), backtrack and path writes.
//
// Layouts: value, mask, path (B, T_x, T_y) float32 contiguous; scratch
// int32.

#include <cuda_runtime.h>
#include <stdint.h>

// Built with -DMAS_PHASE_CLOCKS, the fast kernel records clock64() at its
// phase boundaries for the first 64 items (scripts/mas_phase_clocks.py):
// 0 start, 1 lengths read, 2 DP done (its first warp), 3 staging done (its
// first warp), 4 backtrack starts, 5 backtrack done, 6 path written.
#ifdef MAS_PHASE_CLOCKS
__device__ unsigned long long mas_clocks[64][8];
#define MAS_CLOCK(i, who)                                              \
  if (threadIdx.x == (who) && blockIdx.x < 64)                         \
    mas_clocks[blockIdx.x][i] = clock64()
#else
#define MAS_CLOCK(i, who)
#endif

namespace {

constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int MAX_C = 32;             // mel columns a stage, at most
constexpr int MAX_R = 8;              // DP rows per lane
constexpr int MAX_W = 7;              // DP warps (8 boundary slots)
constexpr int MAX_STAGES = 6;
constexpr int FAST_THREADS = (MAX_W + 8) * 32;
constexpr int GENERAL_THREADS = 1024;
constexpr int DP_BAR = 1 + 2 * MAX_STAGES;   // named barriers: 1..12 ring

struct Plan {
  int general;      // the row-in-shared-memory kernel
  int R, W, P;      // rows per lane, DP warps, staging warps
  int rows;         // rows of a tile, 32 R W (general: T_x rounded to 32)
  int C, lc;        // mel columns a stage; log2 of its 16-byte chunks
  int S;            // stages of the ring
  int bits_smem;    // decisions and backtrack in shared memory
  int pitch;        // decision words a row: ceil(T_y / 32)
  int item_words;   // rows x pitch decision words, then the path's moves
                    // and x at each block's top (pitch words each)
  size_t smem;      // dynamic shared memory, bytes
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// V floats (V = 1, 2, 4) by cp.async; zero-filled when !ok
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(4 * V), "r"(ok ? 4 * V : 0));
}

__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

// V floats (aligned to 4 V bytes) to and from registers
template <int V>
__device__ __forceinline__ void load_v(float (&d)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&d)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  else
    *p = d[0];
}

// element (x, c) of a tile: rows of 4 << lc floats, whose 16-byte chunks
// are permuted by the row (XOR with its low bits)
__device__ __forceinline__ int tile_at(int x, int c, int lc) {
  return (x << (lc + 2)) + ((((c >> 2) ^ x) & ((1 << lc) - 1)) << 2)
         + (c & 3);
}

// t_x and t_y of one item into len[0], len[1]
__device__ void item_lengths(const float* __restrict__ m, int T_x, int T_y,
                             int* len) {
  if (threadIdx.x < 2) len[threadIdx.x] = 0;
  __syncthreads();
  int cx = 0, cy = 0;
  for (int i = threadIdx.x; i < T_x; i += blockDim.x)
    cx += m[(size_t)i * T_y] > 0.f;
  for (int i = threadIdx.x; i < T_y; i += blockDim.x) cy += m[i] > 0.f;
  cx = __reduce_add_sync(kFull, cx);
  cy = __reduce_add_sync(kFull, cy);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(len, cx);
    atomicAdd(len + 1, cy);
  }
  __syncthreads();
}

// One thread: the path from the decision plane (bit y % 32 of word
// [x][y / 32]), 32 columns a block, move by move: the next move is the
// highest set bit at or below the current column of the word of x (found
// by __clz), so the chain has t_x links, not t_y. The word of x - 1 is
// held, the one of x - 2 loaded when x moves. Out: the move columns as
// bits (moves[y / 32]) and x at the top of each block (xtop[y / 32]);
// x_y = xtop - the moves above y in its block.
__device__ __forceinline__ void backtrack(const unsigned* plane, int pw,
                                          int tx, int ty, unsigned* moves,
                                          int* xtop) {
  int x = tx - 1;
  for (int yb = (ty - 1) >> 5; yb >= 0; --yb) {
    const unsigned* col = plane + yb;
    const int top = min(31, ty - 1 - 32 * yb);
    unsigned w = col[x * pw];
    unsigned wl = x > 0 ? col[(x - 1) * pw] : 0u;
    unsigned avail = top == 31 ? ~0u : (2u << top) - 1u;   // columns <= top
    unsigned mv = 0u;
    xtop[yb] = x;
    while (x > 0) {
      const unsigned cand = w & avail;
      if (!cand) break;
      const int k = 31 - __clz(cand);
      mv |= 1u << k;                     // at column 32 yb + k: to x - 1
      avail = (1u << k) - 1u;
      --x;
      w = wl;
      wl = x > 0 ? col[(x - 1) * pw] : 0u;
    }
    moves[yb] = mv;
  }
}

// path[x_y][y] = 1 * mask[x_y][y] over the block (the rest of the path
// holds 0 * mask already); a move at column 0 moves no column's x
__device__ void write_ones(const float* __restrict__ m, float* __restrict__ p,
                           const unsigned* moves, const int* xtop, int T_y,
                           int ty) {
#pragma unroll 4
  for (int y = threadIdx.x; y < ty; y += blockDim.x) {
    const int x = xtop[y >> 5] - __popc((moves[y >> 5] >> (y & 31)) >> 1);
    const size_t o = (size_t)x * T_y + y;
    p[o] = 1.f * m[o];
  }
}

// One DP column for a lane's R consecutive rows x0 .. x0 + R - 1, values in
// component j of v4; left0 is prev[x0 - 1] (from the lane before, or the
// warp before / the start for lane 0). The rows are updated from the last
// down, each reading its neighbour's value of the column before; a
// decision sets bit y % 32 of the lane's word of its row. CHECK: the row
// x == y may be this lane's.
template <int R, bool CHECK>
__device__ __forceinline__ void dp_column(float (&prev)[R],
                                          unsigned (&dbits)[R],
                                          const float4 (&v4)[R], int j,
                                          float left0, int y, int x0) {
  const unsigned bm = 1u << (y & 31);
  const int d = y - x0;                 // the row x == y, if it is ours
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const float left = r == 0 ? left0 : prev[r - 1];
    const float stay = CHECK && d == r ? kNeg : prev[r];
    // a predicated OR: the decision costs a compare and one op
    asm("{\n .reg .pred p;\n setp.ge.f32 p, %1, %2;\n @p or.b32 %0, %0, %3;\n}"
        : "+r"(dbits[r]) : "f"(left), "f"(stay), "r"(bm));
    const float v = j == 0 ? v4[r].x : j == 1 ? v4[r].y
                   : j == 2 ? v4[r].z : v4[r].w;
    prev[r] = __fadd_rn(fmaxf(stay, left), v);
  }
}

// Four columns yh .. yh + 3 (those below ty). FULL: all four are below ty,
// none is column 0 and no row x == y is in this block's rows: no test in
// the columns. MULTI: several DP warps, one boundary value a column
// through xbuf and a named barrier.
template <int R, bool MULTI, bool FULL>
__device__ __forceinline__ void dp_group(float (&prev)[R],
                                         unsigned (&dbits)[R],
                                         const float4 (&v4)[R], int yh,
                                         int ty, int x0, int warp, int lane,
                                         float (*xbuf)[MAX_W + 1], int W) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int y = yh + j;
    if (!FULL && y >= ty) break;
    const float from = __shfl_sync(kFull, prev[R - 1], (lane + 31) & 31);
    // left of lane 0's first row: the warp before's last row, or the start
    // (0 into x = 0 at y = 0, NEG after)
    float bnd = kNeg;
    if (MULTI && warp > 0) {
      if (FULL || y > 0) bnd = xbuf[(y - 1) & 1][warp - 1];
    } else if (!FULL && y == 0) {
      bnd = 0.f;
    }
    const float left0 = lane > 0 ? from : bnd;
    dp_column<R, !FULL>(prev, dbits, v4, j, left0, y, x0);
    if (MULTI) {
      if (lane == 31) xbuf[y & 1][warp] = prev[R - 1];
      bar_sync(DP_BAR, 32 * W);
    }
  }
}

// Columns 4 h .. 4 h + 3 of the stage in tv, for a lane's R rows
template <int R>
__device__ __forceinline__ void load_group(float4 (&v4)[R], const float* tv,
                                           int x0, int h, int lc) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    v4[r] = *reinterpret_cast<const float4*>(tv + tile_at(x0 + r, 4 * h, lc));
}

// A group of 4 columns from yh, then the decision words of 32 columns once
// they are complete
template <int R, bool MULTI>
__device__ __forceinline__ void run_group(float (&prev)[R],
                                          unsigned (&dbits)[R],
                                          const float4 (&v4)[R], int yh,
                                          int ty, int x0, int warp, int lane,
                                          float (*xbuf)[MAX_W + 1],
                                          const Plan& p, unsigned* prow) {
  if (yh + 4 <= ty && yh > 0 && yh >= p.rows)
    dp_group<R, MULTI, true>(prev, dbits, v4, yh, ty, x0, warp, lane, xbuf,
                             p.W);
  else
    dp_group<R, MULTI, false>(prev, dbits, v4, yh, ty, x0, warp, lane, xbuf,
                              p.W);
  if (((yh + 4) & 31) == 0 && yh + 4 <= ty) {   // 32 columns done
#pragma unroll
    for (int r = 0; r < R; ++r) {
      prow[r * p.pitch + (yh >> 5)] = dbits[r];
      dbits[r] = 0u;
    }
  }
}

// The DP warps: columns y < t_y from the ring, the decision words into
// plane (rows x, pitch words a row).
template <int R, bool MULTI>
__device__ __forceinline__ void dp_warps(const float* sm, unsigned* plane,
                                         float (*xbuf)[MAX_W + 1],
                                         const Plan& p, int ty, int n_all) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbar = (p.W + p.P) * 32;
  const int tile = p.rows * p.C;
  const int n_st = (ty + p.C - 1) / p.C;
  float prev[R];
  unsigned dbits[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    prev[r] = kNeg;
    dbits[r] = 0u;
  }
  const int x0 = (warp * 32 + lane) * R;
  unsigned* prow = plane + x0 * p.pitch;
  for (int i = 0, slot = 0; i < n_st;
       ++i, slot = slot + 1 == p.S ? 0 : slot + 1) {
    bar_sync(1 + slot, nbar);
    const float* tv = sm + slot * 2 * tile;
    // 4-column groups, the next group's values loaded while this one runs
    float4 va[R], vb[R];
    load_group<R>(va, tv, x0, 0, p.lc);
#pragma unroll 1
    for (int h = 0; h < p.C / 4; h += 2) {
      const int ya = i * p.C + 4 * h;
      if (ya >= ty) break;
      load_group<R>(vb, tv, x0, h + 1, p.lc);
      run_group<R, MULTI>(prev, dbits, va, ya, ty, x0, warp, lane, xbuf, p,
                          prow);
      const int yb = ya + 4;
      if (yb >= ty) break;
      if (h + 2 < p.C / 4) load_group<R>(va, tv, x0, h + 2, p.lc);
      run_group<R, MULTI>(prev, dbits, vb, yb, ty, x0, warp, lane, xbuf, p,
                          prow);
    }
    if (i + p.S < n_all) bar_arrive(1 + MAX_STAGES + slot, nbar);
  }
  if (ty & 31) {                                    // the last, partial word
#pragma unroll
    for (int r = 0; r < R; ++r) prow[r * p.pitch + (ty >> 5)] = dbits[r];
  }
}

// The staging warps: every column's mask (path = 0 * mask), and value for
// the DP's columns y < t_y, through the ring.
template <int V>
__device__ __forceinline__ void staging_warps(float* sm,
                                              const float* __restrict__ vb,
                                              const float* __restrict__ mb,
                                              float* __restrict__ pb,
                                              const Plan& p, int T_x,
                                              int T_y, int tx, int ty) {
  // log2 of a stage's units (V floats) a row
  const int lu = p.lc + 2 - (V == 4 ? 2 : V == 2 ? 1 : 0);
  const int pt = threadIdx.x - 32 * p.W, np = 32 * p.P;
  const int nbar = (p.W + p.P) * 32;
  const int C = p.C;
  const int tile = p.rows * C;
  const int units = T_x << lu;
  const int n_st = (ty + C - 1) / C;
  const int n_all = (T_y + C - 1) / C;
  const int S = p.S;
  auto copy_stage = [&](int i, int slot) {
    float* tv = sm + slot * 2 * tile;
    float* tm = tv + tile;
    const int y0 = i * C;
    for (int q = pt; q < units; q += np) {
      const int x = q >> lu, c = (q & ((1 << lu) - 1)) * V;
      const int y = y0 + c;
      const bool in = y < T_y;
      const size_t o = (size_t)x * T_y + y;
      const int at = tile_at(x, c, p.lc);
      cp_async<V>(tm + at, in ? mb + o : mb, in);
      if (i < n_st)
        cp_async<V>(tv + at, in && x < tx ? vb + o : vb, in && x < tx);
    }
  };
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_all) copy_stage(i, i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = 0, slot = 0; i < n_all;
       ++i, slot = slot + 1 == S ? 0 : slot + 1) {
    cp_async_wait(S - 2);
    // path = 0 * mask for these columns; value zeroed where mask <= 0. A
    // thread touches only the chunks it copied.
    float* tv = sm + slot * 2 * tile;
    const float* tm = tv + tile;
    const int y0 = i * C;
#pragma unroll 2
    for (int q = pt; q < units; q += np) {
      const int x = q >> lu, c = (q & ((1 << lu) - 1)) * V;
      const int y = y0 + c;
      if (y >= T_y) continue;
      const int at = tile_at(x, c, p.lc);
      float m[V], z[V];
      load_v<V>(m, tm + at);
#pragma unroll
      for (int e = 0; e < V; ++e) z[e] = 0.f * m[e];
      store_v<V>(pb + (size_t)x * T_y + y, z);
      bool zero = false;                 // rare inside the lengths
#pragma unroll
      for (int e = 0; e < V; ++e) zero |= !(m[e] > 0.f);
      if (i < n_st && zero && x < tx && y < ty) {
        float v[V];
        load_v<V>(v, tv + at);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = m[e] > 0.f ? v[e] : 0.f;
        store_v<V>(tv + at, v);
      }
    }
    if (i < n_st) bar_arrive(1 + slot, nbar);
    // the next stage goes to the slot of stage i - 1: wait for the DP to
    // be done with it, if it was the DP's
    const int nx = i + S - 1;
    if (nx < n_all) {
      const int back = slot == 0 ? S - 1 : slot - 1;
      if (i >= 1 && i - 1 < n_st) bar_sync(1 + MAX_STAGES + back, nbar);
      copy_stage(nx, back);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int R, int V>
__global__ void __launch_bounds__(FAST_THREADS)
mas_fast_kernel(const float* __restrict__ value, const float* __restrict__ mask,
                float* __restrict__ path, unsigned* __restrict__ scratch,
                int T_x, int T_y, Plan p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int len[2];
  __shared__ float xbuf[2][MAX_W + 1];
  const size_t item = (size_t)blockIdx.x * T_x * T_y;
  const float* mb = mask + item;
  float* pb = path + item;
  MAS_CLOCK(0, 0);
  item_lengths(mb, T_x, T_y, len);
  MAS_CLOCK(1, 0);
  const int tx = len[0], ty = len[1];
  const int n_all = (T_y + p.C - 1) / p.C;
  unsigned* splane = reinterpret_cast<unsigned*>(sm + 2 * p.S * p.rows * p.C);
  unsigned* gplane = scratch + (size_t)blockIdx.x * p.item_words;
  unsigned* plane = p.bits_smem ? splane : gplane;
  if ((int)(threadIdx.x >> 5) >= p.W)
    staging_warps<V>(sm, value + item, mb, pb, p, T_x, T_y, tx, ty);
  else if (p.W > 1)
    dp_warps<R, true>(sm, plane, xbuf, p, ty, n_all);
  else
    dp_warps<R, false>(sm, plane, xbuf, p, ty, n_all);
  MAS_CLOCK(2, 0);
  MAS_CLOCK(3, 32 * p.W);
  __syncthreads();
  MAS_CLOCK(4, 0);
  unsigned* moves = plane + p.rows * p.pitch;
  int* xtop = reinterpret_cast<int*>(moves + p.pitch);
  if (threadIdx.x == 0 && tx > 0) {
    if (p.bits_smem)     // spelled out so that shared addressing is seen
      backtrack(splane, p.pitch, tx, ty, splane + p.rows * p.pitch,
                reinterpret_cast<int*>(splane + p.rows * p.pitch + p.pitch));
    else
      backtrack(gplane, p.pitch, tx, ty, moves, xtop);
  }
  MAS_CLOCK(5, 0);
  __syncthreads();
  if (tx > 0) write_ones(mb, pb, moves, xtop, T_y, ty);
#ifdef MAS_PHASE_CLOCKS
  __syncthreads();
  MAS_CLOCK(6, 0);
#endif
}

__global__ void __launch_bounds__(GENERAL_THREADS)
mas_general_kernel(const float* __restrict__ value,
                   const float* __restrict__ mask, float* __restrict__ path,
                   unsigned* __restrict__ scratch, int T_x, int T_y, Plan p) {
  extern __shared__ float rows[];
  __shared__ int len[2];
  const size_t item = (size_t)blockIdx.x * T_x * T_y;
  const float* vb = value + item;
  const float* mb = mask + item;
  float* pb = path + item;
  item_lengths(mb, T_x, T_y, len);
  const int tx = len[0], ty = len[1];
  for (size_t i = threadIdx.x; i < (size_t)T_x * T_y; i += blockDim.x)
    pb[i] = 0.f * mb[i];
  unsigned* bits = scratch + (size_t)blockIdx.x * p.item_words;
  unsigned* moves = bits + (size_t)p.rows * p.pitch;
  int* xtop = reinterpret_cast<int*>(moves + p.pitch);
  float* prev = rows;
  float* cur = rows + p.rows;
  for (int x = threadIdx.x; x < p.rows; x += blockDim.x) prev[x] = kNeg;
  __syncthreads();
  unsigned dbits[32];            // a word for each of this thread's rows
  for (int k = 0; k < 32; ++k) dbits[k] = 0u;
  for (int y = 0; y < ty; ++y) {
    const unsigned bm = 1u << (y & 31);
    const bool flush = (y & 31) == 31 || y == ty - 1;
    for (int x = threadIdx.x, k = 0; x < tx; x += blockDim.x, ++k) {
      const size_t o = (size_t)x * T_y + y;
      const float val = mb[o] > 0.f ? vb[o] : 0.f;
      const float stay = x == y ? kNeg : prev[x];
      const float diag = x == 0 ? (y == 0 ? 0.f : kNeg) : prev[x - 1];
      if (diag >= stay) dbits[k] |= bm;
      if (flush) {
        bits[(size_t)x * p.pitch + (y >> 5)] = dbits[k];
        dbits[k] = 0u;
      }
      cur[x] = __fadd_rn(fmaxf(stay, diag), val);
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
  if (threadIdx.x == 0 && tx > 0)
    backtrack(bits, p.pitch, tx, ty, moves, xtop);
  __syncthreads();
  if (tx > 0) write_ones(mb, pb, moves, xtop, T_y, ty);
}

int max_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

// The split of one launch, from the shapes and the card alone.
Plan mas_plan(int T_x, int T_y) {
  Plan p{};
  // the card's opt-in shared memory, less the kernels' static arrays
  const size_t avail = (size_t)max_smem_optin() - 256;
  p.W = (T_x + 32 * MAX_R - 1) / (32 * MAX_R);
  p.R = (T_x + 32 * p.W - 1) / (32 * p.W);
  p.rows = 32 * p.R * p.W;
  p.P = p.W == 1 ? 7 : 8;
  p.pitch = (T_y + 31) / 32;
  p.item_words = (p.rows + 2) * p.pitch;
  const size_t bits = sizeof(unsigned) * (size_t)p.item_words;
  // the widest stage (128-byte rows read whole) that leaves 3 stages beside
  // the decision plane; else beside nothing (the plane in the scratch);
  // else 2 of 8 columns
  const auto stage = [&](int c) {
    return 2 * sizeof(float) * (size_t)p.rows * c;
  };
  for (int c = MAX_C; c >= 8 && !p.C; c /= 2)
    if (bits < avail && (avail - bits) / stage(c) >= 3) {
      p.C = c;
      p.bits_smem = 1;
    }
  for (int c = MAX_C; c >= 8 && !p.C; c /= 2)
    if (avail / stage(c) >= 3) p.C = c;
  if (!p.C && avail / stage(8) >= 2) p.C = 8;
  if (p.W > MAX_W || !p.C) {
    p.general = 1;           // T_x <= 32 x the general kernel's threads
    p.bits_smem = 0;
    p.rows = (T_x + 31) & ~31;
    p.item_words = (p.rows + 2) * p.pitch;
    p.smem = 2 * sizeof(float) * (size_t)p.rows;
    return p;
  }
  p.lc = p.C == 32 ? 3 : p.C == 16 ? 2 : 1;
  p.S = (int)((avail - (p.bits_smem ? bits : 0)) / stage(p.C));
  if (p.S > MAX_STAGES) p.S = MAX_STAGES;
  p.smem = p.S * stage(p.C) + (p.bits_smem ? bits : 0);
  return p;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();   // not left for a later check
  return err;
}

template <int R, int V>
cudaError_t launch_fast(const float* value, const float* mask, float* path,
                        unsigned* scratch, int B, int T_x, int T_y,
                        const Plan& p, cudaStream_t st) {
  cudaError_t err = set_smem(mas_fast_kernel<R, V>, p.smem);
  if (err != cudaSuccess) return err;
  mas_fast_kernel<R, V><<<B, (p.W + p.P) * 32, p.smem, st>>>(
      value, mask, path, scratch, T_x, T_y, p);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_fast_v(const float* value, const float* mask, float* path,
                          unsigned* scratch, int B, int T_x, int T_y,
                          const Plan& p, cudaStream_t st) {
  switch (p.R) {
    case 1: return launch_fast<1, V>(value, mask, path, scratch, B, T_x, T_y, p, st);
    case 2: return launch_fast<2, V>(value, mask, path, scratch, B, T_x, T_y, p, st);
    case 3: return launch_fast<3, V>(value, mask, path, scratch, B, T_x, T_y, p, st);
    case 4: return launch_fast<4, V>(value, mask, path, scratch, B, T_x, T_y, p, st);
    case 5: return launch_fast<5, V>(value, mask, path, scratch, B, T_x, T_y, p, st);
    case 6: return launch_fast<6, V>(value, mask, path, scratch, B, T_x, T_y, p, st);
    case 7: return launch_fast<7, V>(value, mask, path, scratch, B, T_x, T_y, p, st);
    default: return launch_fast<8, V>(value, mask, path, scratch, B, T_x, T_y, p, st);
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// int32 words of the scratch that mas_forward needs at these shapes: the
// decision plane and the backtrack's output, where they do not fit in
// shared memory; 0 where they do.
long long mas_scratch_words(int B, int T_x, int T_y) {
  if (B < 1 || T_x < 1 || T_y < 1) return 0;
  const Plan p = mas_plan(T_x, T_y);
  if (p.bits_smem) return 0;
  return (long long)B * p.item_words;
}

// path (B, T_x, T_y) from value and mask of the same shape; scratch holds
// mas_scratch_words words.
int mas_forward(const float* value, const float* mask, float* path,
                unsigned* scratch, int B, int T_x, int T_y, void* stream) {
  if (B == 0 || T_x == 0 || T_y == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = mas_plan(T_x, T_y);
  if (p.general) {
    cudaError_t err = set_smem(mas_general_kernel, p.smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = p.rows < GENERAL_THREADS ? p.rows : GENERAL_THREADS;
    mas_general_kernel<<<B, threads, p.smem, st>>>(value, mask, path,
                                                   scratch, T_x, T_y, p);
    return (int)cudaGetLastError();
  }
  // copies of 16, 8 or 4 bytes, as T_y and the operands' alignment allow
  auto fits = [&](int v) {
    return T_y % v == 0 && aligned(value, 4 * v) && aligned(mask, 4 * v) &&
           aligned(path, 4 * v);
  };
  if (fits(4))
    return (int)launch_fast_v<4>(value, mask, path, scratch, B, T_x, T_y, p, st);
  if (fits(2))
    return (int)launch_fast_v<2>(value, mask, path, scratch, B, T_x, T_y, p, st);
  return (int)launch_fast_v<1>(value, mask, path, scratch, B, T_x, T_y, p, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef MAS_PHASE_CLOCKS
int mas_read_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, mas_clocks, sizeof(mas_clocks));
}
#endif

}  // extern "C"
