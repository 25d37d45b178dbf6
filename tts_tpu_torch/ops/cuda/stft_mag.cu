// STFT magnitude of framed audio for the GAN spectral losses, for Hopper
// (sm_90a), fp32 in and out, products on the tensor cores (3xTF32).
//
// Replaces tts_tpu/ops/pallas/stft_kernel.py (`_mag_kernel`, run by the
// pallas_call in `_mag_fwd`, entry `stft_magnitude`). For frames x (N, K)
// (K = n_fft samples each) and the window w (K), the real DFT's H = K / 2 + 1
// bins:
//
//   mag[r, f] = sqrt(re^2 + im^2 + 1e-12),
//   re = sum_k x[r,k] w[k] cos(2 pi k f / K), im = -sum_k x[r,k] w[k] sin(..)
//
// The TPU kernel multiplies the frames by dense window-folded banks (K x H).
// Here the DFT's own structure cuts the operations, in two paths.
//
// Fold (any K; the losses' 683 and 171). With xw = x w (the window applied
// while staging: for 683/300 and 171/60 the centred window is not
// symmetric), cos is even and sin odd under k <-> K - k, for every K, odd
// ones too. With G = K / 2 for even K and G = H for odd K, for j in [0, G):
//
//   e[j] = xw[j] + xw[K - j], o[j] = xw[j] - xw[K - j]   (j > 0)
//   e[0] = xw[0],             o[0] = 0
//   re[f] = e . C[:, f] (+ (-1)^f xw[K/2], even K),  im[f] = o . S[:, f]
//   C[j, f] = cos(2 pi j f / K), S[j, f] = -sin(2 pi j f / K)
//
// for f in [0, G): two (N x G) x (G x G) products instead of two (N x K) x
// (K x H), half the operations. For even K the sample K/2 (its own pair)
// enters as the rank-1 term above, and the Nyquist bin f = K/2 is
// re = sum_j (-1)^j e[j] + (-1)^(K/2) xw[K/2], im = 0, summed in fp32 by the
// staging threads of the first bins tile, so the products fill whole tiles.
//
// Radix-2 (K a multiple of 64; the losses' 2048, 1024, 512 and 384): one
// decimation-in-time step, then the fold of each half (below): four
// (N x K/4) x (K/4 x K/4) products, half the operations again.
//
// The banks (C and S at the size folded) are built once per resolution in
// Python (ops/stft.py::half_banks), zero-padded to P x P, P a multiple of
// 128 (checked here).
//
// 3xTF32. Each operand v is split into hi = v truncated to TF32 and lo =
// v - hi truncated to TF32; a product is hi.hi + hi.lo + lo.hi, each term an
// mma.sync.m16n8k8 TF32 product with fp32 accumulation. What is dropped
// (lo.lo, lo's truncation) is ~2^-20 of a product, so the result keeps
// fp32's accuracy (the losses' tolerance: 1e-4 of the largest magnitude;
// one TF32 term alone misses it, at 2-3e-4) at the tensor cores' rate. The
// split is two integer masks and a subtraction: with cvt.rna.tf32 (the
// conversion pipe, a quarter of the FMA rate) the splits, not the products,
// paced the kernel.
//
// Bound on the card: bytes. The function's least work is the frames in and
// the magnitudes out (4 (N K + N H) bytes, plus window and banks once)
// against a real FFT's ~2.5 K log2 K operations a frame; at the six loss
// resolutions that is ~0.45 GB, ~0.14 ms at 3.35 TB/s. This kernel does far
// more operations than an FFT (3 x 2 x (2 or 4) N G^2, ~92 TF32 GFLOP at
// the six resolutions) and is bound by the tensor cores' mma.sync rate and
// by staging the frames.
//
// Fold design. A block computes 128 frames x 128 bins of both products (8
// warps, 2 x 4, each 64 x 32: 4 x 4 m16n8 tiles of re and of im, 128
// accumulators a thread). The folded K loop steps 16 at a time through two
// shared-memory stages: the bank tiles (C and S, fp32) arrive by cp.async;
// the frame tile is read into registers a stage ahead, then windowed,
// folded, split (hi and lo of e and o) and stored while the tensor cores
// work on the current stage. Wide tiles keep the refolding of a frame (once
// per bins tile) and the re-reading of a bank tile (once per frames tile)
// low. Row strides of 20 (frames) and 136 (banks) floats make every
// fragment load conflict-free. The complex spectrum never leaves registers:
// the magnitude is taken in the epilogue. Ragged edges (frame counts no
// multiple of 128; 171 and 683's 86 and 342 bins) are zero-filled on load
// (the banks by their padding) and masked on store. Blocks walk the bins
// fastest, so the blocks of one frame tile run together and read the frames
// from L2.
//
// Layouts: frames (N, K), window (K), banks (2, P, P) = C, S; mag (N, H);
// row-major float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int WM = 64;               // frames per warp
constexpr int BM = WM * WARPS_M;     // frames per block
constexpr int BN = 128;              // bins per block
constexpr int BK = 16;               // folded samples per stage
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WN = BN / WARPS_N;     // bins per warp
constexpr int MT = WM / 16;          // m16 tiles per warp
constexpr int NT8 = WN / 8;          // n8 tiles per warp
constexpr int AS = BK + 4;           // frame tile row stride (floats)
constexpr int BS = BN + 8;           // bank tile row stride (floats)
constexpr int A_FLOATS = 4 * BM * AS;    // e hi, e lo, o hi, o lo
constexpr int B_FLOATS = 2 * BK * BS;    // C, S
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int SMEM_BYTES = 2 * STAGE_FLOATS * (int)sizeof(float);
constexpr int ROWS_PER_PASS = THREADS / BK;      // 16
constexpr int A_PAIRS = BM / ROWS_PER_PASS;      // (row, j) pairs a thread
constexpr float kEps = 1e-12f;

constexpr uint32_t TF32_MASK = 0xffffe000u;   // sign, exponent, 10 bits

// v = hi + lo, both TF32 (low 13 bits zero), by truncation: two integer
// masks and a subtraction, where cvt.rna.tf32 would use the conversion
// pipe, a quarter of the FMA rate, and pace the products.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & TF32_MASK;
  lo = __float_as_uint(v - __uint_as_float(hi)) & TF32_MASK;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage of the frame tile in registers: rows r0 + 16 i of folded column
// j, both ends of the pair, and the window at both.
struct FrameRegs {
  float a[A_PAIRS];
  float b[A_PAIRS];
  float wa, wb;
  bool paired;
};

__device__ __forceinline__ void load_frames(FrameRegs& f,
                                            const float* __restrict__ frames,
                                            const float* __restrict__ window,
                                            int N, int K, int G, int row0,
                                            int j) {
  const bool in = j < G;
  f.paired = in && j != 0;
  f.wa = in ? window[j] : 0.f;
  f.wb = f.paired ? window[K - j] : 0.f;
  const int r0 = row0 + threadIdx.x / BK;
#pragma unroll
  for (int i = 0; i < A_PAIRS; ++i) {
    const int r = r0 + i * ROWS_PER_PASS;
    const float* row = frames + (size_t)r * K;
    f.a[i] = (in && r < N) ? row[j] : 0.f;
    f.b[i] = (f.paired && r < N) ? row[K - j] : 0.f;
  }
}

// Fold, split and store one stage of the frame tile; add (-1)^j e[j] to
// the rows' Nyquist sums.
__device__ __forceinline__ void store_frames(float* as, const FrameRegs& f,
                                             int j, float (&nyq)[A_PAIRS]) {
  const int jl = threadIdx.x % BK;
  const int rl = threadIdx.x / BK;
#pragma unroll
  for (int i = 0; i < A_PAIRS; ++i) {
    const float xa = f.a[i] * f.wa;
    const float xb = f.b[i] * f.wb;
    const float e = xa + xb;
    const float o = f.paired ? xa - xb : 0.f;
    nyq[i] += (j & 1) ? -e : e;
    uint32_t eh, el, oh, ol;
    split_tf32(e, eh, el);
    split_tf32(o, oh, ol);
    const int at = (rl + i * ROWS_PER_PASS) * AS + jl;
    as[at] = __uint_as_float(eh);
    as[BM * AS + at] = __uint_as_float(el);
    as[2 * BM * AS + at] = __uint_as_float(oh);
    as[3 * BM * AS + at] = __uint_as_float(ol);
  }
}

// The stage's 16 rows x TN columns of C and S, by cp.async, into rows of
// TN + 8 floats.
template <int TN>
__device__ __forceinline__ void load_banks(float* bs,
                                           const float* __restrict__ banks,
                                           int P, int k0, int col0) {
  constexpr int CHUNKS = BK * TN / 4;               // float4s of one plane
#pragma unroll
  for (int s = 0; s < 2 * CHUNKS / THREADS; ++s) {
    const int i = threadIdx.x + s * THREADS;
    const int plane = i / CHUNKS, rem = i % CHUNKS;
    const int k = rem / (TN / 4), c = (rem % (TN / 4)) * 4;
    cp_async16(bs + (plane * BK + k) * (TN + 8) + c,
               banks + (size_t)plane * P * P + (size_t)(k0 + k) * P + col0
                   + c);
  }
}

// xw[r, K/2] (even K), the sample that pairs with itself
__device__ __forceinline__ float middle_sample(const float* __restrict__ frames,
                                               const float* __restrict__ window,
                                               int K, int r) {
  return frames[(size_t)r * K + K / 2] * window[K / 2];
}

__global__ void __launch_bounds__(THREADS, 1)
stft_mag_kernel(const float* __restrict__ frames,
                const float* __restrict__ window,
                const float* __restrict__ banks, float* __restrict__ mag,
                int N, int K, int G, int P) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane / 4, tig = lane % 4;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int jl = threadIdx.x % BK;
  const int nk = (G + BK - 1) / BK;
  const int H = K / 2 + 1;
  const bool even = K % 2 == 0;

  float acc[2][MT][NT8][4];     // re, im
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][m][n][c] = 0.f;
  float nyq[A_PAIRS];
#pragma unroll
  for (int i = 0; i < A_PAIRS; ++i) nyq[i] = 0.f;

  FrameRegs fr;
  load_frames(fr, frames, window, N, K, G, row0, jl);
  load_banks<BN>(sm + A_FLOATS, banks, P, 0, col0);
  cp_async_commit();
  store_frames(sm, fr, jl, nyq);

  for (int kt = 0; kt < nk; ++kt) {
    const float* as = sm + (kt & 1) * STAGE_FLOATS;
    const float* bs = as + A_FLOATS;
    float* nxt = sm + ((kt + 1) & 1) * STAGE_FLOATS;
    const bool more = kt + 1 < nk;
    if (more) {
      load_banks<BN>(nxt + A_FLOATS, banks, P, (kt + 1) * BK, col0);
      cp_async_commit();
      load_frames(fr, frames, window, N, K, G, row0, (kt + 1) * BK + jl);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {             // re: e . C, im: o . S
        uint32_t bh[NT8][2], bl[NT8][2];
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          const float* col = bs + p * BK * BS + wn * WN + n * 8 + gid;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            split_tf32(col[(kk + tig + 4 * h) * BS], bh[n][h], bl[n][h]);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t ah[4], al[4];
          const float* t = as + 2 * p * BM * AS
                           + (wm * WM + m * 16 + gid) * AS + kk + tig;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int at = (c & 1) * 8 * AS + (c >> 1) * 4;
            ah[c] = __float_as_uint(t[at]);
            al[c] = __float_as_uint(t[BM * AS + at]);
          }
#pragma unroll
          for (int n = 0; n < NT8; ++n) mma_tf32(acc[p][m][n], al, bh[n]);
#pragma unroll
          for (int n = 0; n < NT8; ++n) mma_tf32(acc[p][m][n], ah, bl[n]);
#pragma unroll
          for (int n = 0; n < NT8; ++n) mma_tf32(acc[p][m][n], ah, bh[n]);
        }
      }
    }
    if (more) store_frames(nxt, fr, (kt + 1) * BK + jl, nyq);
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * WM + m * 16 + gid + 8 * h;
      if (r >= N) continue;
      const float mid = even ? middle_sample(frames, window, K, r) : 0.f;
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int f = col0 + wn * WN + n * 8 + 2 * tig + c;
          const float x = acc[0][m][n][2 * h + c] + ((f & 1) ? -mid : mid);
          const float y = acc[1][m][n][2 * h + c];
          if (f < G) mag[(size_t)r * H + f] = sqrtf(x * x + y * y + kEps);
        }
    }

  // the Nyquist bin of even K, once per frame: the 16 staging threads of a
  // row meet by shuffles
  if (even && blockIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < A_PAIRS; ++i) {
      float v = nyq[i];
#pragma unroll
      for (int off = BK / 2; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int r = row0 + threadIdx.x / BK + i * ROWS_PER_PASS;
      if (jl == 0 && r < N) {
        const float mid = middle_sample(frames, window, K, r);
        v += ((K / 2) & 1) ? -mid : mid;
        mag[(size_t)r * H + K / 2] = sqrtf(v * v + kEps);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Radix-2 path (K a multiple of 64: 2048, 1024, 512, 384). One
// decimation-in-time step first: with M = K / 2, Q = K / 4, the even
// samples u[m] = xw[2 m] and the odd ones v[m] = xw[2 m + 1] each have an
// M-point real DFT, computed by the fold above at size M (e_u, o_u, e_v, o_v
// for j < Q; C2[j, f] = cos(2 pi j f / M), S2 = -sin; the middle samples
// u[Q] = xw[K/2], v[Q] = xw[K/2 + 1] as rank-1 terms). Then for f < Q, with
// T = exp(-2 pi i f / K) V[f]:
//
//   X[f] = U[f] + T,   X[K/2 - f] = conj(U[f] - T),
//   X[K/4] = U[Q] - i V[Q]   (U[Q], V[Q]: the sub-DFTs' Nyquist sums)
//
// so four (N x Q) x (Q x Q) products give every bin: half the operations
// of the fold alone. A block computes 128 frames x 64 f of all four (8
// warps, 4 x 2, each 32 x 32), i.e. 128 output bins. The frame tile
// arrives raw by 16-byte cp.async (both ends of the K loop's sample range
// and the window's) two stages ahead; it is windowed and folded into four
// fp32 planes between the products of the stage before (one barrier a
// stage; the fold's instructions interleave with the products), and the
// products split their fragments into TF32 parts as they read them.
// ---------------------------------------------------------------------------

constexpr int R2_BN = 64;            // sub-DFT bins f per block
constexpr int R2_WM = 32;            // frames per warp (4 warps down)
constexpr int R2_WN = 32;            // f per warp (2 warps across)
constexpr int R2_MT = R2_WM / 16;
constexpr int R2_NT8 = R2_WN / 8;
constexpr int R2_BS = R2_BN + 8;     // bank tile row stride (floats)
constexpr int R2_FRONT = 2 * BK;     // raw samples 2 j0 ... 2 j0 + 31
constexpr int R2_BACK = 2 * BK + 4;  // raw samples K - 2 j0 - 32 ... + 3
constexpr int R2_RS = R2_FRONT + R2_BACK;   // raw row stride (floats)
constexpr int R2_PLANES = 4;         // e_u, o_u, e_v, o_v (fp32)
constexpr int R2_A_FLOATS = R2_PLANES * BM * AS;
constexpr int R2_B_FLOATS = 2 * BK * R2_BS;
constexpr int R2_STAGE_FLOATS = R2_A_FLOATS + R2_B_FLOATS;
constexpr int R2_RAW_FLOATS = (BM + 1) * R2_RS;   // + the window's row
constexpr int R2_SMEM_BYTES =
    2 * (R2_STAGE_FLOATS + R2_RAW_FLOATS) * (int)sizeof(float);

// The raw samples of folded columns [j0, j0 + 16) of the block's frames and
// of the window, by 16-byte cp.async; zero past N and past a row's end.
__device__ __forceinline__ void r2_load_raw(float* raw,
                                            const float* __restrict__ frames,
                                            const float* __restrict__ window,
                                            int N, int K, int row0, int j0) {
  constexpr int CHUNKS = R2_RS / 4;                 // float4s of a row
  for (int i = threadIdx.x; i < (BM + 1) * CHUNKS; i += THREADS) {
    const int rr = i / CHUNKS, c = i % CHUNKS;
    const int first = c < R2_FRONT / 4 ? 2 * j0 + 4 * c
                                        : K - 2 * j0 - 2 * BK
                                              + 4 * (c - R2_FRONT / 4);
    const int r = row0 + rr;
    const float* src = rr == BM ? window + first
                                : frames + (size_t)r * K + first;
    const bool ok = first + 4 <= K && (rr == BM || r < N);
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(raw + rr * R2_RS + 4 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(ok ? src : window), "r"(ok ? 16 : 0));
  }
}

// Window and fold rows I0 + 16 i, I0 <= i < I1, of one stage: a thread
// takes one column (16 lanes on one row's 16 columns: the float2 reads of
// the raw sample pairs and the plane writes stay on distinct banks); adds
// (-1)^j e[j] to its rows' two Nyquist sums. The planes stay fp32: the
// products split them as they read their fragments.
template <int I0, int I1>
__device__ __forceinline__ void r2_fold(float* as, const float* raw, int j0,
                                        float (&nyq_u)[A_PAIRS],
                                        float (&nyq_v)[A_PAIRS]) {
  const int jl = threadIdx.x % BK, rl = threadIdx.x / BK;
  const int j = j0 + jl;
  const int f = 2 * jl, b = R2_FRONT + 2 * BK - 2 * jl;   // 2j and K - 2j
  const float* w = raw + BM * R2_RS;
  const float2 wf = *reinterpret_cast<const float2*>(w + f);
  const float2 wb = *reinterpret_cast<const float2*>(w + b);
  const float sign = (j & 1) ? -1.f : 1.f;
#pragma unroll
  for (int i = I0; i < I1; ++i) {
    const int rr = rl + i * ROWS_PER_PASS;
    const float* x = raw + rr * R2_RS;
    const float2 xf = *reinterpret_cast<const float2*>(x + f);
    const float u = xf.x * wf.x, v = xf.y * wf.y;
    float eu = u, ou = 0.f, ev = v, ov = 0.f;
    if (j != 0) {
      const float2 xb = *reinterpret_cast<const float2*>(x + b);
      const float um = xb.x * wb.x, vm = xb.y * wb.y;
      eu = u + um;
      ou = u - um;
      ev = v + vm;
      ov = v - vm;
    }
    nyq_u[i] += sign * eu;
    nyq_v[i] += sign * ev;
    float* at = as + rr * AS + jl;
    at[0] = eu;
    at[BM * AS] = ou;
    at[2 * BM * AS] = ev;
    at[3 * BM * AS] = ov;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stft_mag_radix2_kernel(const float* __restrict__ frames,
                       const float* __restrict__ window,
                       const float* __restrict__ banks,
                       float* __restrict__ mag, int N, int K, int P) {
  extern __shared__ __align__(16) float sm[];
  float* const raw0 = sm + 2 * R2_STAGE_FLOATS;
  float* const raw1 = raw0 + R2_RAW_FLOATS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int gid = lane / 4, tig = lane % 4;
  const int col0 = blockIdx.x * R2_BN;
  const int row0 = blockIdx.y * BM;
  const int Q = K / 4, H = K / 2 + 1;
  const int nk = Q / BK;

  float acc[4][R2_MT][R2_NT8][4];   // U re, U im, V re, V im
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int m = 0; m < R2_MT; ++m)
#pragma unroll
      for (int n = 0; n < R2_NT8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][m][n][c] = 0.f;
  float nyq_u[A_PAIRS], nyq_v[A_PAIRS];
#pragma unroll
  for (int i = 0; i < A_PAIRS; ++i) nyq_u[i] = nyq_v[i] = 0.f;

  // stage k's raw samples land a whole stage before they are folded (two
  // raw buffers); the fold of stage k + 1 runs between the products of
  // stage k, one barrier a stage
  r2_load_raw(raw0, frames, window, N, K, row0, 0);
  load_banks<R2_BN>(sm + R2_A_FLOATS, banks, P, 0, col0);
  cp_async_commit();
  if (nk > 1) r2_load_raw(raw1, frames, window, N, K, row0, BK);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  r2_fold<0, A_PAIRS>(sm, raw0, 0, nyq_u, nyq_v);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    const float* as = sm + (kt & 1) * R2_STAGE_FLOATS;
    const float* bs = as + R2_A_FLOATS;
    float* nxt = sm + ((kt + 1) & 1) * R2_STAGE_FLOATS;
    const float* raw = (kt & 1) ? raw0 : raw1;     // stage kt + 1's
    const bool fold = kt + 1 < nk;
    if (kt + 2 < nk)
      r2_load_raw((kt & 1) ? raw1 : raw0, frames, window, N, K, row0,
                  (kt + 2) * BK);
    if (fold)
      load_banks<R2_BN>(nxt + R2_A_FLOATS, banks, P, (kt + 1) * BK, col0);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {        // C2 for U re, V re; S2 for im
        uint32_t bh[R2_NT8][2], bl[R2_NT8][2];
#pragma unroll
        for (int n = 0; n < R2_NT8; ++n) {
          const float* col = bs + t * BK * R2_BS + wn * R2_WN + n * 8 + gid;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            split_tf32(col[(kk + tig + 4 * h) * R2_BS], bh[n][h], bl[n][h]);
          }
        }
#pragma unroll
        for (int uv = 0; uv < 2; ++uv) {
          const int p = 2 * uv + t;           // plane and accumulator
#pragma unroll
          for (int m = 0; m < R2_MT; ++m) {
            uint32_t ah[4], al[4];
            const float* a = as + p * BM * AS
                             + (wm * R2_WM + m * 16 + gid) * AS + kk + tig;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              split_tf32(a[(c & 1) * 8 * AS + (c >> 1) * 4], ah[c], al[c]);
            }
#pragma unroll
            for (int n = 0; n < R2_NT8; ++n)
              mma_tf32(acc[p][m][n], al, bh[n]);
#pragma unroll
            for (int n = 0; n < R2_NT8; ++n)
              mma_tf32(acc[p][m][n], ah, bl[n]);
#pragma unroll
            for (int n = 0; n < R2_NT8; ++n)
              mma_tf32(acc[p][m][n], ah, bh[n]);
          }
        }
      }
      if (fold) {
        if (kk == 0)
          r2_fold<0, A_PAIRS / 2>(nxt, raw, (kt + 1) * BK, nyq_u, nyq_v);
        else
          r2_fold<A_PAIRS / 2, A_PAIRS>(nxt, raw, (kt + 1) * BK, nyq_u,
                                        nyq_v);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < R2_MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * R2_WM + m * 16 + gid + 8 * h;
      if (r >= N) continue;
      const float* row = frames + (size_t)r * K;
      const float mu = row[K / 2] * window[K / 2];
      const float mv = row[K / 2 + 1] * window[K / 2 + 1];
#pragma unroll
      for (int n = 0; n < R2_NT8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int f = col0 + wn * R2_WN + n * 8 + 2 * tig + c;
          if (f >= Q) continue;
          const int e = 2 * h + c;
          const float sign = (f & 1) ? -1.f : 1.f;
          const float ur = acc[0][m][n][e] + sign * mu;
          const float ui = acc[1][m][n][e];
          const float vr = acc[2][m][n][e] + sign * mv;
          const float vi = acc[3][m][n][e];
          float sn, cs;
          sincospif(2.f * f / K, &sn, &cs);
          const float tr = cs * vr + sn * vi, ti = cs * vi - sn * vr;
          float* out = mag + (size_t)r * H;
          out[f] = sqrtf((ur + tr) * (ur + tr) + (ui + ti) * (ui + ti) + kEps);
          out[K / 2 - f] =
              sqrtf((ur - tr) * (ur - tr) + (ui - ti) * (ui - ti) + kEps);
        }
    }

  // X[K/4] = U[Q] - i V[Q], once per frame: the 16 fold threads of a row
  // meet by shuffles
  if (blockIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < A_PAIRS; ++i) {
      float uq = nyq_u[i], vq = nyq_v[i];
#pragma unroll
      for (int off = BK / 2; off > 0; off /= 2) {
        uq += __shfl_xor_sync(0xffffffffu, uq, off);
        vq += __shfl_xor_sync(0xffffffffu, vq, off);
      }
      const int r = row0 + threadIdx.x / BK + i * ROWS_PER_PASS;
      if (threadIdx.x % BK == 0 && r < N) {
        const float* row = frames + (size_t)r * K;
        const float sign = (Q & 1) ? -1.f : 1.f;
        uq += sign * row[K / 2] * window[K / 2];
        vq += sign * row[K / 2 + 1] * window[K / 2 + 1];
        mag[(size_t)r * H + Q] = sqrtf(uq * uq + vq * vq + kEps);
      }
    }
  }
}

}  // namespace

extern "C" {

// mag (N, K / 2 + 1) from frames (N, K), window (K) and the half-banks
// (2, P, P), a multiple of 128: for K a multiple of 64 the radix-2 path's
// C2, S2 of size K / 4, else the fold's C, S of size G (K / 2 for even K,
// K / 2 + 1 for odd).
int stft_mag_forward(const float* frames, const float* window,
                     const float* banks, float* mag, int N, int K, int P,
                     void* stream) {
  if (K % 64 == 0 && K >= 64) {
    if (N < 0 || P < K / 4 || P % R2_BN != 0 || (N + BM - 1) / BM > 65535)
      return (int)cudaErrorInvalidValue;
    if (N == 0) return (int)cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        stft_mag_radix2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        R2_SMEM_BYTES);
    if (err != cudaSuccess) {
      cudaGetLastError();   // reported here: not to a later launch's check
      return (int)err;
    }
    const dim3 grid((K / 4 + R2_BN - 1) / R2_BN, (N + BM - 1) / BM);
    stft_mag_radix2_kernel<<<grid, THREADS, R2_SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(
        frames, window, banks, mag, N, K, P);
    return (int)cudaGetLastError();
  }
  const int G = K % 2 == 0 ? K / 2 : K / 2 + 1;
  if (N < 0 || K < 2 || P < G || P % BN != 0 ||
      (N + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      stft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here: not to a later launch's check
    return (int)err;
  }
  const dim3 grid((G + BN - 1) / BN, (N + BM - 1) / BM);
  stft_mag_kernel<<<grid, THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      frames, window, banks, mag, N, K, G, P);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
