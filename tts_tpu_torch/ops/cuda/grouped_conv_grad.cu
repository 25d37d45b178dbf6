// Weight and input gradients of the MelGAN discriminator's grouped strided
// convs, for Hopper (sm_90a), fp32.
//
// Replaces tts_tpu/ops/pallas/grouped_conv_grad.py: `_wgrad_kernel` (the
// pallas_call in `grouped_conv_wgrad`) and `_dgrad_kernel` (the pallas_call
// in `grouped_conv_dgrad`), the backward of `grouped_conv_pallas_wgrad`.
// The forward y = conv1d(x, W, stride s, padding pad = (k - 1) / 2,
// groups G) stays the library conv. With one input channel per group
// (m = 1, the layers the selection rule sends here) and n output channels
// per group, o = g n + j, in NCW layout:
//
//   dW[o, 0, t] = sum_{b, l} x[b, g, s l + t - pad] dy[b, o, l]
//   dx[b, g, p] = sum_{j, t, l : s l + t - pad = p} W[g n + j, 0, t] dy[b, g n + j, l]
//
// with x zero outside [0, L). At the path's shapes (k = 41, s = 4, n = 4)
// dW sums 262,144 products per weight at down_0 and dx about 44 per sample.
//
// Bound on the card: bytes. Each layer reads x and dy once and writes dW
// (wgrad) or reads dy and writes dx (dgrad): at scale 0, B = 64, about
// 134 MB, 0.040 ms at 3.35 TB/s, against 1.4 GFLOP (0.022 ms at 67 TFLOP/s).
// dgrad's FMAs are half its bytes' time, so both have to overlap.
//
// wgrad design. The TPU kernel accumulates dW over a sequential grid; CUDA
// blocks run in parallel, so the sum is split in two deterministic passes.
// For a phase ph = t mod s, xs_ph[v] = x[s v + ph - pad] turns the sum into
// a correlation, dW[g n + j, s u + ph] = sum_l xs_ph[l + u] dy[g n + j, l].
// Pass 1 (wgrad_kernel): a thread owns TU = 11 consecutive taps of one
// phase (a "tap group"; s x ceil(ceil(k / s) / 11) of them, 4 at the
// path's k = 41, s = 4) for all n <= 4 outputs, and R = 8 consecutive
// output positions l at a time: it reads the R + TU - 1 samples of xs_ph
// and the R dy float4s once and does R x TU x 4 = 352 FMAs with them, in
// registers (the TPU kernel's taps-by-positions product, tiled for the
// register file). A warp is one tap group over 32 runs of R; the block's 8
// warps cover the tap groups and as many run sets as fit. A block owns one
// group and a run of "segments" (an item's chunk of up to 8 x 32 x (8 /
// tap groups) positions; several short items to a pass), walked in passes:
// x phase-split and dy as (l, j) float4s in one shared-memory buffer while
// the next pass fills the other; one pad word per 8 keeps every lane's
// loads on its own bank. The path's layers (s = 4, k = 41, 16-byte aligned
// rows) stage by float4 loads into registers a pass ahead (a float4 of x
// is one v of all four phases), stored after the current pass is
// multiplied: a quarter of the instructions of element-wise staging, which
// otherwise (cp.async of 4 bytes an element, any geometry) took as long as
// the products. At the end the lanes' sums meet by a fixed butterfly of
// shuffles, the warps of a tap group in warp order, and the block writes
// one (n x k) partial. At most 528 blocks in all (two waves of two blocks
// per SM of an H100), from the shapes alone. Pass 2 (wgrad_reduce_kernel)
// sums each weight's partials in block order. No atomics: dW is bitwise the
// same from run to run.
//
// dgrad design (gather form, no atomics). With s = 4 and pad a multiple of
// 4 (k = 8 c + 1, pad = 4 c; the path's k = 41 has c = 5) the 4 samples
// p = 4 m .. 4 m + 3 of one float4 of dx are the 4 phases of one padded
// position v = m + c, so
//
//   dx4[b, g, m] = sum_{j < n, u < 2 c + 1} W4[g, j, u] dy[b, g n + j, m + c - u]
//
// with W4[g, j, u] = W[g n + j, 0, 4 u .. 4 u + 3] (zero past k): 4 n (2 c + 1)
// products a sample, 44 at the path's layers, and dx has exactly L / 4 = L_out
// float4s a row, so nothing of the padding is computed or cropped. The
// fast kernel (dgrad_fast_kernel; s = 4, pad, L and L_out multiples of 4,
// 16-byte aligned dy and dx) tiles this in registers: a lane owns DR = 8
// consecutive float4s of one row and holds, per output j, the 24 dy values
// around them (6 aligned float4 loads through L1, which serves the halo its
// neighbours share; the next j's loaded while this one is multiplied), so
// one broadcast float4 of W4 from shared memory feeds
// 4 DR = 32 FMAs (the general kernel's: 4). A warp walks a run of segments
// of 32 DR float4s, (g, b, segment) in that order, staging a group's W4
// into its own shared memory only when g changes; the grid is whole waves
// of at most two 256-thread blocks per SM, from the shapes alone. The
// lanes' float4s pass through the warp's shared memory (a pad float4 every
// 8 keeps both sides free of bank conflicts) and leave as 16-byte stores of
// 32 consecutive float4s. Other geometries (s < 4, pad % 4 != 0, unaligned
// operands: a dy that is a view at a 4-byte offset) take the general
// kernel (dgrad_kernel): a thread owns one v, so its s samples (one per
// phase) read the same n dy values for each u; the group's weights sit in
// shared memory as (u, j, phase) float4s, so one broadcast 16-byte load
// serves a (u, j) for all phases; samples of the padding are not written.
// Each dx sample is summed by one thread in a fixed order: two calls give
// the same bits.
//
// Takes: m = 1, 1 <= n <= 4, 1 <= s <= 4, odd k <= 63.
// Layouts: x, dx (B, G, L); dy (B, G n, L_out); W, dW (G n, 1, k); float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 63;
constexpr int MAX_N = 4;
constexpr int MAX_S = 4;
constexpr int TU = 11;                       // wgrad: taps per thread
constexpr int WR = 8;                        // wgrad: positions per run
constexpr int TARGET_BLOCKS = 528;           // wgrad: two waves of two
                                             // blocks per SM of an H100
constexpr int VC = THREADS;                  // dgrad: v positions per block
constexpr int U_MAX = MAX_K;                 // dgrad: taps per phase (s = 1)
constexpr int DR = 8;                        // dgrad fast: float4s per lane
constexpr int DSEG = 32 * DR;                // dgrad fast: float4s per warp
                                             // segment
constexpr int DU_MAX = 15;                   // dgrad fast: 2 c + 1, c <= 7
constexpr int DG_TARGET_BLOCKS = 264;        // dgrad fast: one wave of two
                                             // blocks per SM of an H100

// wgrad: the split of one launch, from the shapes alone
struct WgradPlan {
  int n_tg, tap_runs, lw, nlr;   // tap groups, runs of TU per phase, run
                                 // sets per tap group, runs per pass
  int seg_runs, chunks, spp;     // runs per segment, segments per item and
                                 // per pass
  int xlen, xseg, xph, dseg;     // shared layout, in floats / float4s
  int passes, nb;                // passes per block, blocks per group
  int smem_bytes;
  int chunks_log2;               // chunks = 2^chunks_log2 (fast path)
};

// The fast path's float4s a thread stages per pass: x and dy
constexpr int XCH = 3;
constexpr int DCH = 2;

// Fast path (s = 4, one tap run, 16-byte aligned rows and segments): a
// pass's x and dy as float4s in registers, loaded a pass ahead and stored
// after the current pass is multiplied. A float4 of x is one v of all four
// phases; a float4 of dy four positions of one output.
struct FastStage {
  float4 x[XCH];
  float4 d[DCH];
  int xm[XCH];      // q << 16 | v, -1 past the pass's chunks
  int dm[DCH];      // q << 16 | l << 2 | j, -1 past them
};

// Each thread's chunks, the same in every pass: x chunk (segment q, v); dy
// chunk (q, position l, output j), j fastest so that the four outputs of a
// position land on four banks.
__device__ __forceinline__ void fast_chunks(FastStage& f, const WgradPlan& p) {
  const int quads = p.seg_runs * WR / 4;
#pragma unroll
  for (int c = 0; c < XCH; ++c) {
    const int idx = threadIdx.x + c * THREADS;
    const int q = idx / p.xlen;
    f.xm[c] = q < p.spp ? q << 16 | idx % p.xlen : -1;
  }
#pragma unroll
  for (int c = 0; c < DCH; ++c) {
    const int idx = threadIdx.x + c * THREADS;
    const int q = idx / (MAX_N * quads);
    f.dm[c] = q < p.spp ? q << 16 | (idx / MAX_N) % quads << 4 | idx % MAX_N
                        : -1;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ int padded(int v) { return v + v / WR; }

// One pass's segments of group gi into `buf`: x phase-split with the halo,
// dy as (l, j) float4s; zero outside x, beyond L_out and for j >= n.
template <int S>
__device__ void wgrad_stage(float* buf, const WgradPlan& p,
                            const float* __restrict__ x,
                            const float* __restrict__ dy, int G, int n,
                            int L, int Lout, int pad, int gi, int sid0,
                            int sid_end) {
  float* xs = buf;
  float* dys = buf + S * p.xph;
  const int seg_len = p.seg_runs * WR;
  for (int q = 0; q < p.spp; ++q) {
    const int sid = sid0 + q;
    if (sid >= sid_end) break;
    const int b = sid / p.chunks;
    const int l0 = (sid % p.chunks) * seg_len;
    const float* xg = x + ((size_t)b * G + gi) * L;
    const int p0 = S * l0 - pad;
    for (int i = threadIdx.x; i < S * p.xlen; i += THREADS) {
      const int pos = p0 + i;
      const bool ok = pos >= 0 && pos < L;
      cp_async4(xs + (i % S) * p.xph + q * p.xseg + padded(i / S),
                ok ? xg + pos : xg, ok);
    }
    const float* dyg = dy + ((size_t)b * G * n + (size_t)gi * n) * Lout + l0;
#pragma unroll
    for (int j = 0; j < MAX_N; ++j)
      for (int l = threadIdx.x; l < seg_len; l += THREADS) {
        const bool ok = j < n && l0 + l < Lout;
        cp_async4(dys + (q * p.dseg + padded(l)) * 4 + j,
                  ok ? dyg + (size_t)j * Lout + l : dy, ok);
      }
  }
}

// A pass's float4s into registers: zero outside x, beyond L_out, for
// j >= n and past the block's segments.
__device__ __forceinline__ void fast_load(FastStage& f, const WgradPlan& p,
                                          const float* __restrict__ x,
                                          const float* __restrict__ dy,
                                          int G, int n, int L, int Lout,
                                          int pad, int gi, int sid0,
                                          int sid_end) {
  const int seg_len = p.seg_runs * WR;
  const int mask = (1 << p.chunks_log2) - 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < XCH; ++c) {
    const int sid = sid0 + (f.xm[c] >> 16);
    f.x[c] = zero;
    if (f.xm[c] >= 0 && sid < sid_end) {
      const int b = sid >> p.chunks_log2;
      const int v = (sid & mask) * seg_len + (f.xm[c] & 0xffff);
      const int pos = 4 * v - pad;
      if (pos >= 0 && pos < L)
        f.x[c] = *reinterpret_cast<const float4*>(
            x + ((size_t)b * G + gi) * L + pos);
    }
  }
#pragma unroll
  for (int c = 0; c < DCH; ++c) {
    const int sid = sid0 + (f.dm[c] >> 16);
    const int j = f.dm[c] & 3;
    f.d[c] = zero;
    if (f.dm[c] >= 0 && sid < sid_end && j < n) {
      const int b = sid >> p.chunks_log2;
      const int l = (sid & mask) * seg_len + 4 * ((f.dm[c] >> 4) & 0xfff);
      if (l < Lout)
        f.d[c] = *reinterpret_cast<const float4*>(
            dy + ((size_t)b * G * n + (size_t)gi * n + j) * Lout + l);
    }
  }
}

// The registers into the stage: x by phase (a float4 is one v of the four
// phases), dy as (l, j) float4s.
__device__ __forceinline__ void fast_store(float* buf, const FastStage& f,
                                           const WgradPlan& p) {
  float* dys = buf + 4 * p.xph;
#pragma unroll
  for (int c = 0; c < XCH; ++c) {
    if (f.xm[c] < 0) continue;
    float* at = buf + (f.xm[c] >> 16) * p.xseg + padded(f.xm[c] & 0xffff);
    at[0] = f.x[c].x;
    at[p.xph] = f.x[c].y;
    at[2 * p.xph] = f.x[c].z;
    at[3 * p.xph] = f.x[c].w;
  }
#pragma unroll
  for (int c = 0; c < DCH; ++c) {
    if (f.dm[c] < 0) continue;
    const int l = 4 * ((f.dm[c] >> 4) & 0xfff);
    float* at = dys + ((f.dm[c] >> 16) * p.dseg + padded(l)) * 4
                + (f.dm[c] & 3);
    at[0] = f.d[c].x;
    at[4] = f.d[c].y;
    at[8] = f.d[c].z;
    at[12] = f.d[c].w;
  }
}

template <int S, bool FAST>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
             float* __restrict__ partial, WgradPlan p, int B, int G, int n,
             int L, int Lout, int k, int pad) {
  extern __shared__ __align__(16) float sm[];
  const int gi = blockIdx.y;
  const int total = B * p.chunks;
  const int sid_begin = blockIdx.x * p.passes * p.spp;
  const int sid_end = min(total, sid_begin + p.passes * p.spp);
  const int stage = S * p.xph + 4 * p.spp * p.dseg;
  const int n_pass = (sid_end - sid_begin + p.spp - 1) / p.spp;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tg = warp % p.n_tg, lset = warp / p.n_tg;
  const int ph = tg % S, ru = tg / S;
  const int lr = lset * 32 + lane;
  const int q = lr / p.seg_runs, r = lr % p.seg_runs;
  const bool computes = warp < p.n_tg * p.lw && q < p.spp;

  float acc[TU][MAX_N];
#pragma unroll
  for (int u = 0; u < TU; ++u)
#pragma unroll
    for (int j = 0; j < MAX_N; ++j) acc[u][j] = 0.f;

  FastStage fs;
  if (FAST) {
    fast_chunks(fs, p);
    fast_load(fs, p, x, dy, G, n, L, Lout, pad, gi, sid_begin, sid_end);
    fast_store(sm, fs, p);
  } else {
    wgrad_stage<S>(sm, p, x, dy, G, n, L, Lout, pad, gi, sid_begin,
                   sid_end);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int ps = 0; ps < n_pass; ++ps) {
    const float* buf = sm + (ps & 1) * stage;
    float* nxt = sm + ((ps + 1) & 1) * stage;
    const bool more = ps + 1 < n_pass;
    if (FAST) {
      if (more)
        fast_load(fs, p, x, dy, G, n, L, Lout, pad, gi,
                  sid_begin + (ps + 1) * p.spp, sid_end);
    } else if (more) {
      wgrad_stage<S>(nxt, p, x, dy, G, n, L, Lout, pad, gi,
                     sid_begin + (ps + 1) * p.spp, sid_end);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (computes && sid_begin + ps * p.spp + q < sid_end) {
      const float* xrow = buf + ph * p.xph + q * p.xseg;
      float xv[WR + TU - 1];
      if (FAST) {              // one tap run: the run starts a padded row
#pragma unroll
        for (int m = 0; m < WR + TU - 1; ++m)
          xv[m] = xrow[(WR + 1) * r + m + m / WR];
      } else {
        const int vb = r * WR + ru * TU;
#pragma unroll
        for (int m = 0; m < WR + TU - 1; ++m) xv[m] = xrow[padded(vb + m)];
      }
      const float4* drow = reinterpret_cast<const float4*>(buf + S * p.xph)
                           + q * p.dseg + r * (WR + 1);
#pragma unroll
      for (int i = 0; i < WR; ++i) {
        const float4 d = drow[i];
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          acc[u][0] = fmaf(xv[i + u], d.x, acc[u][0]);
          acc[u][1] = fmaf(xv[i + u], d.y, acc[u][1]);
          acc[u][2] = fmaf(xv[i + u], d.z, acc[u][2]);
          acc[u][3] = fmaf(xv[i + u], d.w, acc[u][3]);
        }
      }
    }
    if (FAST && more) fast_store(nxt, fs, p);
    __syncthreads();
  }

  // the lanes' sums by a fixed butterfly; then the run sets of each tap
  // group in warp order
#pragma unroll
  for (int u = 0; u < TU; ++u)
#pragma unroll
    for (int j = 0; j < MAX_N; ++j)
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[u][j] += __shfl_xor_sync(0xffffffffu, acc[u][j], off);
  float* red = sm;                             // (warp, TU x MAX_N)
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < TU; ++u)
#pragma unroll
      for (int j = 0; j < MAX_N; ++j) red[(warp * TU + u) * MAX_N + j] =
          acc[u][j];
  }
  __syncthreads();
  float* out = partial + ((size_t)gi * p.nb + blockIdx.x) * n * k;
  for (int i = threadIdx.x; i < p.n_tg * TU * MAX_N; i += THREADS) {
    const int j = i % MAX_N, u = (i / MAX_N) % TU, g = i / (MAX_N * TU);
    const int t = S * ((g / S) * TU + u) + g % S;
    if (j >= n || t >= k) continue;
    float sum = 0.f;
    for (int w = 0; w < p.lw; ++w)
      sum += red[((w * p.n_tg + g) * TU + u) * MAX_N + j];
    out[j * k + t] = sum;
  }
}

// dw[g n k + j k + t] = sum over the group's nb block partials, in order
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dw, int nk, int nb,
                                    int n_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const float* src = partial + (size_t)(o / nk) * nb * nk + o % nk;
  float sum = 0.f;
  for (int c = 0; c < nb; ++c) sum += src[(size_t)c * nk];
  dw[o] = sum;
}

__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ w,
             float* __restrict__ dx, int G, int n, int L, int Lout, int k,
             int s, int pad, int v_first, int n_vchunks) {
  // weights as (u, j, phase): t = s u + phase, zero where t >= k or
  // phase >= s
  __shared__ __align__(16) float ws[U_MAX * MAX_N * 4];
  __shared__ float dys[MAX_N * (VC + U_MAX)];

  const int gi = blockIdx.x % G;
  const int rest = blockIdx.x / G;
  const int b = rest / n_vchunks;
  const int v0 = v_first + (rest % n_vchunks) * VC;
  const int U = (k + s - 1) / s;
  const int cout = G * n;

  for (int i = threadIdx.x; i < U * MAX_N * 4; i += THREADS) {
    const int ph = i % 4, j = (i / 4) % MAX_N, u = i / (4 * MAX_N);
    const int t = s * u + ph;
    ws[i] = (ph < s && j < n && t < k) ? w[(size_t)(gi * n + j) * k + t] : 0.f;
  }
  // dy at l = v - u for v in [v0, v0 + VC), u in [0, U): l - (v0 - U + 1)
  const int l_base = v0 - (U - 1);
  const int span = VC + U - 1;
  const float* dyg = dy + ((size_t)b * cout + gi * n) * Lout;
  for (int i = threadIdx.x; i < n * span; i += THREADS) {
    const int j = i / span, li = i % span;
    const int l = l_base + li;
    dys[j * (VC + U_MAX) + li] =
        (l >= 0 && l < Lout) ? dyg[(size_t)j * Lout + l] : 0.f;
  }
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < MAX_N; ++j) {
      if (j < n) {
        const float d = dys[j * (VC + U_MAX) + threadIdx.x + (U - 1) - u];
        const float4 wv =
            *reinterpret_cast<const float4*>(&ws[(u * MAX_N + j) * 4]);
        acc[0] = fmaf(wv.x, d, acc[0]);
        acc[1] = fmaf(wv.y, d, acc[1]);
        acc[2] = fmaf(wv.z, d, acc[2]);
        acc[3] = fmaf(wv.w, d, acc[3]);
      }
    }
  }
  float* dxg = dx + ((size_t)b * G + gi) * L;
  const int v = v0 + threadIdx.x;
#pragma unroll
  for (int ph = 0; ph < MAX_S; ++ph) {
    const int p = s * v + ph - pad;
    if (ph < s && p >= 0 && p < L) dxg[p] = acc[ph];
  }
}

// dy[m0 - 8 .. m0 + 16) of one row as 6 aligned float4s, zero outside
// [0, M)
__device__ __forceinline__ void load_window(float (&win)[24],
                                            const float* __restrict__ row,
                                            int m0, int M) {
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int f = m0 - 8 + 4 * e;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f >= 0 && f < M) v = __ldg(reinterpret_cast<const float4*>(row + f));
    win[4 * e] = v.x;
    win[4 * e + 1] = v.y;
    win[4 * e + 2] = v.z;
    win[4 * e + 3] = v.w;
  }
}

// dx4[m] for the lanes' DR consecutive float4s of segments of (g, b) rows;
// see the header. C = pad / 4.
template <int C>
__global__ void __launch_bounds__(THREADS, 2)
dgrad_fast_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                  float* __restrict__ dx, int B, int G, int n, int M,
                  int per_warp) {
  constexpr int U = 2 * C + 1;
  constexpr int K = 8 * C + 1;
  __shared__ __align__(16) float4 wsm[WARPS][MAX_N * DU_MAX];
  __shared__ __align__(16) float4 osm[WARPS][DSEG + DSEG / 8];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nseg = (M + DSEG - 1) / DSEG;
  const long long total = (long long)G * B * nseg;
  const long long first = ((long long)blockIdx.x * WARPS + warp) * per_warp;
  const long long last = min(total, first + per_warp);
  float* wf = reinterpret_cast<float*>(wsm[warp]);
  int g_staged = -1;
  for (long long sid = first; sid < last; ++sid) {
    const int seg = (int)(sid % nseg);
    const long long row = sid / nseg;
    const int b = (int)(row % B), g = (int)(row / B);
    if (g != g_staged) {          // W4 of group g as (j, u) float4s
      __syncwarp();
      for (int i = lane; i < MAX_N * U * 4; i += 32) {
        const int ph = i % 4, u = (i / 4) % U, j = i / (4 * U);
        const int t = 4 * u + ph;
        wf[i] = j < n && t < K ? w[(size_t)(g * n + j) * K + t] : 0.f;
      }
      __syncwarp();
      g_staged = g;
    }
    const int m0 = seg * DSEG + lane * DR;
    float4 acc[DR];
#pragma unroll
    for (int i = 0; i < DR; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* dyr = dy + ((size_t)b * G + g) * n * M;
    // dy[m0 - 8 .. m0 + 16) of output j: every m0 + i + c - u, i < DR,
    // u < U, c <= 7; the window of j + 1 loads while j is multiplied
    float win[2][24];
    load_window(win[0], dyr, m0, M);
#pragma unroll
    for (int j = 0; j < MAX_N; ++j) {
      if (j >= n) break;
      if (j + 1 < n) load_window(win[(j + 1) & 1], dyr + (size_t)(j + 1) * M,
                                 m0, M);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 wv = wsm[warp][j * U + u];
#pragma unroll
        for (int i = 0; i < DR; ++i) {
          const float d = win[j & 1][i + C - u + 8];
          acc[i].x = fmaf(wv.x, d, acc[i].x);
          acc[i].y = fmaf(wv.y, d, acc[i].y);
          acc[i].z = fmaf(wv.z, d, acc[i].z);
          acc[i].w = fmaf(wv.w, d, acc[i].w);
        }
      }
    }
    // lane-major into shared memory, out as 32 consecutive float4s a store
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DR; ++i) osm[warp][9 * lane + i] = acc[i];
    __syncwarp();
    float4* out = reinterpret_cast<float4*>(dx) + ((size_t)b * G + g) * M;
#pragma unroll
    for (int i = 0; i < DR; ++i) {
      const int q = 32 * i + lane;
      if (seg * DSEG + q < M) out[seg * DSEG + q] = osm[warp][q + q / 8];
    }
  }
}

cudaError_t check_geometry(int n, int k, int s, int pad, int L, int Lout) {
  if (n < 1 || n > MAX_N || s < 1 || s > MAX_S || k < 1 || k > MAX_K ||
      k % 2 == 0 || pad != (k - 1) / 2 || L < 1 ||
      Lout != (L + 2 * pad - k) / s + 1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

WgradPlan wgrad_plan(int B, int G, int Lout, int k, int s) {
  WgradPlan p;
  p.tap_runs = ((k + s - 1) / s + TU - 1) / TU;
  p.n_tg = s * p.tap_runs;                          // <= 8 for k <= 63
  p.lw = WARPS / p.n_tg;
  p.nlr = 32 * p.lw;
  const int runs = (Lout + WR - 1) / WR;
  p.seg_runs = runs < p.nlr ? runs : p.nlr;
  p.chunks = (runs + p.seg_runs - 1) / p.seg_runs;
  p.spp = p.nlr / p.seg_runs;
  const int seg_len = p.seg_runs * WR;
  p.xlen = seg_len + p.tap_runs * TU - 1;
  p.xseg = (p.xlen + WR - 1) / WR * (WR + 1);
  p.xph = (p.spp * p.xseg + 3) / 4 * 4;             // float4-aligned dy
  p.dseg = seg_len / WR * (WR + 1);
  const int stage = s * p.xph + 4 * p.spp * p.dseg;
  const int red = WARPS * TU * MAX_N;
  p.smem_bytes = (2 * stage > red ? 2 * stage : red) * (int)sizeof(float);
  p.chunks_log2 = -1;
  for (int e = 0; e < 31; ++e)
    if (p.chunks == 1 << e) p.chunks_log2 = e;
  const int passes_all = (B * p.chunks + p.spp - 1) / p.spp;
  int nb = TARGET_BLOCKS / G;
  if (nb < 1) nb = 1;
  if (nb > passes_all) nb = passes_all;
  p.passes = (passes_all + nb - 1) / nb;
  p.nb = (passes_all + p.passes - 1) / p.passes;
  return p;
}

template <int S, bool FAST>
cudaError_t launch_wgrad(const float* x, const float* dy, float* partial,
                         const WgradPlan& p, int B, int G, int n, int L,
                         int Lout, int k, int pad, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<S, FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here: not to a later launch's check
    return err;
  }
  wgrad_kernel<S, FAST><<<dim3(p.nb, G), THREADS, p.smem_bytes, st>>>(
      x, dy, partial, p, B, G, n, L, Lout, k, pad);
  return cudaGetLastError();
}

// The fast path's conditions: float4s of x hold one v of the four phases
// (s = 4, pad and L multiples of 4), float4s of dy stay in one row (L_out a
// multiple of 4), one tap run, chunks a power of two, aligned operands and
// the pass's float4s within XCH and DCH a thread.
bool wgrad_fast(const WgradPlan& p, const float* x, const float* dy, int L,
                int Lout, int s, int pad) {
  return s == 4 && pad % 4 == 0 && L % 4 == 0 && Lout % 4 == 0 &&
         p.tap_runs == 1 && p.chunks_log2 >= 0 &&
         p.spp * p.xlen <= XCH * THREADS &&
         p.spp * p.seg_runs * WR <= DCH * THREADS &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dy) % 16 == 0;
}

template <int C>
cudaError_t launch_dgrad_fast(const float* dy, const float* w, float* dx,
                              int B, int G, int n, int M, cudaStream_t st) {
  const long long total = (long long)G * B * ((M + DSEG - 1) / DSEG);
  long long warps = (long long)DG_TARGET_BLOCKS * WARPS;
  if (warps > total) warps = total;
  const long long per_warp = (total + warps - 1) / warps;
  const long long blocks = ((total + per_warp - 1) / per_warp + WARPS - 1)
                           / WARPS;
  dgrad_fast_kernel<C><<<(int)blocks, THREADS, 0, st>>>(
      dy, w, dx, B, G, n, M, (int)per_warp);
  return cudaGetLastError();
}

// The fast path's conditions: float4s of dx are the four phases of one v
// (s = 4, pad and L multiples of 4), float4s of dy stay in one row (L_out a
// multiple of 4), aligned operands.
bool dgrad_fast(const float* dy, const float* dx, int L, int Lout, int s,
                int pad) {
  return s == 4 && pad % 4 == 0 && L % 4 == 0 && Lout % 4 == 0 &&
         reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dx) % 16 == 0;
}

}  // namespace

extern "C" {

// Floats of the wgrad scratch (the blocks' partials) for these shapes.
long long grouped_conv_wgrad_scratch_floats(int B, int G, int n, int Lout,
                                            int k, int s) {
  if (B < 1 || G < 1 || n < 1 || Lout < 1 || k < 1 || s < 1 || s > MAX_S)
    return 0;
  return (long long)G * wgrad_plan(B, G, Lout, k, s).nb * n * k;
}

// dW (G n, 1, k) from x (B, G, L) and dy (B, G n, Lout); partial is
// scratch of grouped_conv_wgrad_scratch_floats floats.
int grouped_conv_wgrad_forward(const float* x, const float* dy, float* dw,
                               float* partial, int B, int G, int n, int L,
                               int Lout, int k, int s, int pad,
                               void* stream) {
  cudaError_t err = check_geometry(n, k, s, pad, L, Lout);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || G < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WgradPlan p = wgrad_plan(B, G, Lout, k, s);
  if (wgrad_fast(p, x, dy, L, Lout, s, pad)) {
    err = launch_wgrad<4, true>(x, dy, partial, p, B, G, n, L, Lout, k, pad,
                                st);
  } else {
    switch (s) {
      case 1: err = launch_wgrad<1, false>(x, dy, partial, p, B, G, n, L,
                                           Lout, k, pad, st); break;
      case 2: err = launch_wgrad<2, false>(x, dy, partial, p, B, G, n, L,
                                           Lout, k, pad, st); break;
      case 3: err = launch_wgrad<3, false>(x, dy, partial, p, B, G, n, L,
                                           Lout, k, pad, st); break;
      default: err = launch_wgrad<4, false>(x, dy, partial, p, B, G, n, L,
                                            Lout, k, pad, st); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int n_out = G * n * k;
  wgrad_reduce_kernel<<<(n_out + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      partial, dw, n * k, p.nb, n_out);
  return (int)cudaGetLastError();
}

// dx (B, G, L) from dy (B, G n, Lout) and W (G n, 1, k).
int grouped_conv_dgrad_forward(const float* dy, const float* w, float* dx,
                               int B, int G, int n, int L, int Lout, int k,
                               int s, int pad, void* stream) {
  cudaError_t err = check_geometry(n, k, s, pad, L, Lout);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dgrad_fast(dy, dx, L, Lout, s, pad)) {
    switch (pad / 4) {
      case 0: return (int)launch_dgrad_fast<0>(dy, w, dx, B, G, n, Lout, st);
      case 1: return (int)launch_dgrad_fast<1>(dy, w, dx, B, G, n, Lout, st);
      case 2: return (int)launch_dgrad_fast<2>(dy, w, dx, B, G, n, Lout, st);
      case 3: return (int)launch_dgrad_fast<3>(dy, w, dx, B, G, n, Lout, st);
      case 4: return (int)launch_dgrad_fast<4>(dy, w, dx, B, G, n, Lout, st);
      case 5: return (int)launch_dgrad_fast<5>(dy, w, dx, B, G, n, Lout, st);
      case 6: return (int)launch_dgrad_fast<6>(dy, w, dx, B, G, n, Lout, st);
      default: return (int)launch_dgrad_fast<7>(dy, w, dx, B, G, n, Lout, st);
    }
  }
  // v = q / s over the padded samples q = p + pad of p in [0, L)
  const int v_first = pad / s;
  const int v_last = (pad + L - 1) / s;
  const int n_vchunks = (v_last - v_first + VC) / VC;
  dgrad_kernel<<<B * n_vchunks * G, THREADS, 0, st>>>(
      dy, w, dx, G, n, L, Lout, k, s, pad, v_first, n_vchunks);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
