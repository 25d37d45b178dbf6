// The whole greedy Tacotron2 decode, for Hopper (sm_90a), fp32.
//
// Replaces tts_tpu/ops/pallas/fused_taco2_decode.py (`_make_kernel`, run by
// the pallas_call in `fused_decode`), which keeps every weight in VMEM and
// runs the step loop inside one kernel. Here the host loop over steps is in
// C (one call from Python), and each step is a chain of 8 launches on one
// stream:
//
//   1-2. rows_kernel<dense>: prenet, relu(last_frame pw1), relu(. pw2),
//        no bias; last_frame is the previous step's frames_full at
//        (r - 1) * n_mels (zeros at step 0)
//   3.   rows_kernel<lstm>: attention LSTM on [prenet, context, h1]
//   4.   rows_kernel<dense>: the query projection pq = h1 qk
//   5.   attention_kernel: location conv (k=31, SAME) and dense layer,
//        v . tanh(pq + processed_inputs + loc), mask (-1e9), softmax,
//        cum += align, context = sum_t align enc; one block per item
//   6.   rows_kernel<lstm>: decoder LSTM on [h1, context, h2]
//   7.   rows_kernel<dense>: frames_full = [h2, context] projw + projb
//   8.   stop_kernel: stop = [h2, frames_full] . stopw + stopb, and the
//        first r * n_mels of frames_full to the output; one block per item
//
// rows_kernel is one kernel for every product of a row of activations with
// a weight matrix. The input row is up to three segments, so [x, h] is
// never concatenated in memory. A block owns 32 weight columns for 16
// items: 32 output columns (dense), or 8 hidden units with all four of
// their gate columns (LSTM), so the cell update is its epilogue. The items'
// input values are staged in shared memory 256 at a time, double-buffered;
// the 8 warps split the sum, each thread keeping 32 independent weight
// loads in flight per chunk, and meet in shared memory. (A first version,
// with 8 items and a plain loop over the input in global memory, was
// latency-bound: on an H100 at 700 W about 190 us per LSTM launch, and
// 185 us per attention launch, which also projected the query and looped
// over global memory, at B=64.) h1 and
// h2 are double-buffered across steps (every block reads all of h); c is
// updated in place (one thread per (item, unit)). The location conv is
// computed as a conv (31 x 2 taps into 32 filters), not as tts_tpu's
// banded matrix, a TPU layout that does about 5x the operations at T=128.
//
// Bound on the card. At bench.py's batched geometry (B=64, T=128, r=2,
// 124 steps) about 2.45 GFLOP a step, 304 GFLOP in all: 4.5 ms at 67
// TFLOP/s fp32. The weights (about 73 MB fp32 at full width) exceed the
// 50 MB L2, so re-reading them from HBM every step costs 2.7 ms at 3.35
// TB/s: operations bound it. At B=1 each step still reads all the weights:
// bytes bound it, about 22 us a step. What holds this design back: 8
// dependent launches a step, fp32 FMAs off the tensor cores, and each
// weight column is re-read once per 16 items.
//
// Layouts (row-major, float32). enc (B, T, D); pi (B, T, A); mask (B, T)
// 1/0; weights as ops/taco2_decode.py::pack_decoder_params; state (zeros on
// entry, see `state_floats`); frames (steps, B, r M); stop (steps, B);
// align_out (steps, B, T).

#include <cuda_runtime.h>

namespace {

constexpr int NW = 8;    // warps per block
constexpr int BI = 16;   // items per rows_kernel block
constexpr int KC = 256;  // input values staged per chunk (a multiple of 4)
constexpr int TT = 32;   // positions per tile in attention_kernel
constexpr int LF = 32;   // location filters (fixed by the model)

struct Seg {
  const float* p;  // row b at p + b * ld
  int ld;
  int len;
};
struct Segs {
  Seg s[3];  // unused ones have len 0
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reductions over a block of NW warps; `red` holds NW floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NW; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// A block computes 32 output columns for 16 items: each lane owns one
// column. Dense (LSTM = false): columns c0 + lane of N, out = act(x W +
// bias). LSTM: 8 hidden units j0 + u with their 4 gates, lane = q * 8 + u
// owning column q H + j0 + u; after the sum the gates meet by warp
// shuffles and lanes u < 8 apply the cell (c in place). The input is taken
// KC values at a time, double-buffered: a thread loads its 32 weights of a
// chunk, starts loading the next chunk's input values into registers, then
// multiplies the chunk from shared memory (the 16 items' values as float4
// broadcasts, each warp taking every 8th group of 4); one barrier per
// chunk. (Prefetching the next chunk's weights as well took 128 registers
// and was slower at B=64.)
template <bool LSTM>
__global__ void __launch_bounds__(NW * 32, 2) rows_kernel(
    Segs in, const float* __restrict__ W, int ldw,
    const float* __restrict__ bias, int N, int relu, float* __restrict__ out,
    int ld_out, float* __restrict__ c, int B) {
  static_assert(KC == NW * 32, "a thread stages one input position");
  constexpr int QPW = KC / (4 * NW);         // groups of 4 per warp
  __shared__ __align__(16) float xs[2][BI][KC];
  __shared__ float red[NW][BI][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = in.s[0].len + in.s[1].len + in.s[2].len;
  const int b0 = blockIdx.y * BI;
  const int nb = min(BI, B - b0);
  int col;
  bool live;
  if (LSTM) {
    const int j = blockIdx.x * 8 + (lane & 7);
    col = (lane >> 3) * N + j;
    live = j < N;
  } else {
    col = blockIdx.x * 32 + lane;
    live = col < N;
  }

  float xr[BI];
  auto load = [&](int k0) {
    // this thread's position k of the input: its segment, then the items
    int k = k0 + tid;
    const float* p = in.s[0].p;
    int ld = in.s[0].ld;
    if (k >= in.s[0].len) {
      k -= in.s[0].len;
      p = in.s[1].p;
      ld = in.s[1].ld;
      if (k >= in.s[1].len) {
        k -= in.s[1].len;
        p = in.s[2].p;
        ld = in.s[2].ld;
      }
    }
    const bool ok = k0 + tid < K;
#pragma unroll
    for (int b = 0; b < BI; ++b)
      xr[b] = (ok && b < nb) ? p[(size_t)(b0 + b) * ld + k] : 0.f;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int b = 0; b < BI; ++b) xs[buf][b][tid] = xr[b];
  };

  float acc[BI];
#pragma unroll
  for (int b = 0; b < BI; ++b) acc[b] = 0.f;
  load(0);
  store(0);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < K; k0 += KC, buf ^= 1) {
    float wc[QPW][4];
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const int k = k0 + 4 * (warp + i * NW);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wc[i][q] = (live && k + q < K) ? W[(size_t)(k + q) * ldw + col] : 0.f;
    }
    const bool more = k0 + KC < K;
    if (more) load(k0 + KC);
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const int g = warp + i * NW;
#pragma unroll
      for (int b = 0; b < BI; ++b) {
        const float4 x = *reinterpret_cast<const float4*>(&xs[buf][b][4 * g]);
        acc[b] += x.x * wc[i][0] + x.y * wc[i][1] + x.z * wc[i][2]
                  + x.w * wc[i][3];
      }
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < BI; ++b) red[warp][b][lane] = acc[b];
  __syncthreads();

  for (int b = warp; b < BI; b += NW) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) v += red[w][b][lane];
    if (live && bias != nullptr) v += bias[col];
    const size_t row = (size_t)(b0 + b);
    if (LSTM) {
      const int u = lane & 7;
      const float gi = __shfl_sync(0xffffffffu, v, u);
      const float gf = __shfl_sync(0xffffffffu, v, u + 8);
      const float gg = __shfl_sync(0xffffffffu, v, u + 16);
      const float go = __shfl_sync(0xffffffffu, v, u + 24);
      if (lane < 8 && live && b < nb) {
        const int j = col;                  // q = 0 for lanes 0..7
        const float cn = sigmoidf(gf) * c[row * N + j]
                         + sigmoidf(gi) * tanhf(gg);
        c[row * N + j] = cn;
        out[row * ld_out + j] = sigmoidf(go) * tanhf(cn);
      }
    } else if (live && b < nb) {
      out[row * ld_out + col] = relu ? fmaxf(v, 0.f) : v;
    }
  }
}

// Floats at the start of attention_kernel's shared memory: the tile
// buffers, or the context's per-warp sums, whichever is larger (a multiple
// of 4, so the arrays after it stay 16-byte aligned).
__host__ __device__ inline int tile_region(int A, int KL, int D) {
  const int tiles = TT * LF + TT * A + 2 * A + KL * 2 * LF + TT * (A / 32);
  const int sums = NW * D;
  return ((tiles > sums ? tiles : sums) + 3) / 4 * 4;
}

// One block of NW warps per item b; pq = h1 qk comes from a rows_kernel
// launch before it. The energies of a tile of TT positions: the location
// conv into shared memory (one output per thread and filter), the tile's
// processed inputs staged, then thread (a, group) keeps location_dense's
// column a in registers and takes every (256 / A)-th position of the tile:
// 32 FMAs on float4 broadcasts of the conv row, tanh, times v[a], and a
// sum over a by warp shuffles and shared memory.
__global__ void __launch_bounds__(NW * 32) attention_kernel(
    const float* __restrict__ pqg, const float* __restrict__ pi,
    const float* __restrict__ kloc, const float* __restrict__ ld,
    const float* __restrict__ v, const float* __restrict__ enc,
    const float* __restrict__ mask, float* __restrict__ align,
    float* __restrict__ cum, float* __restrict__ ctx,
    float* __restrict__ align_out, int T, int A, int KL, int D) {
  extern __shared__ __align__(16) float sm[];
  const int W = T + KL - 1;                 // padded alignment row
  float* conv = sm;                         // TT LF (16-byte aligned rows)
  float* pis = conv + TT * LF;              // TT A: the tile's inputs
  float* pq = pis + TT * A;                 // A
  float* vs = pq + A;                       // A
  float* kl = vs + A;                       // KL 2 LF
  float* parts = kl + KL * 2 * LF;          // TT (A / 32)
  // the context's per-warp sums (NW D) reuse the region of the above
  float* e = sm + tile_region(A, KL, D);    // T
  float* win = e + T;                       // 2 W: [align; cum], padded
  float* red = win + 2 * W;                 // NW
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = NW * 32;
  const int pad = (KL - 1) / 2;
  const float* pib = pi + (size_t)b * T * A;

  for (int i = tid; i < A; i += nt) {
    pq[i] = pqg[(size_t)b * A + i];
    vs[i] = v[i];
  }
  for (int i = tid; i < KL * 2 * LF; i += nt) kl[i] = kloc[i];
  for (int i = tid; i < W; i += nt) {
    const int t = i - pad;
    const bool in = t >= 0 && t < T;
    win[i] = in ? align[(size_t)b * T + t] : 0.f;
    win[W + i] = in ? cum[(size_t)b * T + t] : 0.f;
  }
  const int a = tid % A, grp = tid / A, ngrp = nt / A;
  float wcol[LF];
#pragma unroll
  for (int f = 0; f < LF; ++f) wcol[f] = ld[f * A + a];
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += TT) {
    for (int i = tid; i < TT * LF; i += nt) {
      const int t = t0 + i / LF, f = i % LF;
      float s = 0.f;
      if (t < T)
        for (int tap = 0; tap < KL; ++tap) {
          s += win[t + tap] * kl[(tap * 2) * LF + f];
          s += win[W + t + tap] * kl[(tap * 2 + 1) * LF + f];
        }
      conv[i] = s;
    }
    for (int i = tid; i < TT * A; i += nt) {
      const int t = t0 + i / A;
      pis[i] = t < T ? pib[(size_t)t * A + i % A] : 0.f;
    }
    __syncthreads();
    for (int tl = grp; tl < TT; tl += ngrp) {
      const float4* ct = reinterpret_cast<const float4*>(conv + tl * LF);
      float l = 0.f;
#pragma unroll
      for (int f4 = 0; f4 < LF / 4; ++f4) {
        const float4 x = ct[f4];
        l += x.x * wcol[4 * f4] + x.y * wcol[4 * f4 + 1]
             + x.z * wcol[4 * f4 + 2] + x.w * wcol[4 * f4 + 3];
      }
      const float part = warp_sum(vs[a] * tanhf(pq[a] + pis[tl * A + a] + l));
      if (lane == 0) parts[tl * (A / 32) + a / 32] = part;
    }
    __syncthreads();
    for (int tl = tid; tl < TT && t0 + tl < T; tl += nt) {
      float s = 0.f;
      for (int w = 0; w < A / 32; ++w) s += parts[tl * (A / 32) + w];
      e[t0 + tl] = mask[(size_t)b * T + t0 + tl] > 0.f ? s : -1e9f;
    }
    __syncthreads();
  }

  // softmax over the positions
  float m = -3.0e38f;
  for (int t = tid; t < T; t += nt) m = fmaxf(m, e[t]);
  m = block_max(m, red);
  float s = 0.f;
  for (int t = tid; t < T; t += nt) {
    const float p = expf(e[t] - m);
    e[t] = p;
    s += p;
  }
  s = block_sum(s, red);
  const float inv = 1.f / s;
  for (int t = tid; t < T; t += nt) {
    const float p = e[t] * inv;
    e[t] = p;
    align[(size_t)b * T + t] = p;
    align_out[(size_t)b * T + t] = p;
    cum[(size_t)b * T + t] += p;
  }
  __syncthreads();

  // context = sum_t align enc: warp w sums positions w, w + 8, ... into
  // float4s of D (lane, lane + 32, ...), then the warps' sums meet in
  // shared memory (reusing the tile buffers: D floats per warp)
  const float4* encb = reinterpret_cast<const float4*>(enc + (size_t)b * T * D);
  float* csum = sm;
  for (int d4 = lane; d4 < D / 4; d4 += 32) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = warp; t < T; t += NW) {
      const float p = e[t];
      const float4 x = encb[(size_t)t * (D / 4) + d4];
      acc.x += p * x.x;
      acc.y += p * x.y;
      acc.z += p * x.z;
      acc.w += p * x.w;
    }
    reinterpret_cast<float4*>(csum + warp * D)[d4] = acc;
  }
  __syncthreads();
  for (int d = tid; d < D; d += nt) {
    float acc = 0.f;
    for (int w = 0; w < NW; ++w) acc += csum[w * D + d];
    ctx[(size_t)b * D + d] = acc;
  }
}

// One block of NW warps per item b.
__global__ void __launch_bounds__(NW * 32) stop_kernel(
    const float* __restrict__ h2, const float* __restrict__ ff,
    const float* __restrict__ stopw, const float* __restrict__ stopb,
    float* __restrict__ stop_out, float* __restrict__ frames_out, int H2,
    int NP, int RM) {
  __shared__ float red[NW];
  const int b = blockIdx.x, tid = threadIdx.x, nt = NW * 32;
  const float* ffb = ff + (size_t)b * NP;
  float s = 0.f;
  for (int k = tid; k < H2; k += nt) s += h2[(size_t)b * H2 + k] * stopw[k];
  for (int k = tid; k < NP; k += nt) s += ffb[k] * stopw[H2 + k];
  s = block_sum(s, red);
  if (tid == 0) stop_out[b] = s + stopb[0];
  for (int k = tid; k < RM; k += nt) frames_out[(size_t)b * RM + k] = ffb[k];
}

Segs segs(Seg a, Seg b = {nullptr, 0, 0}, Seg c = {nullptr, 0, 0}) {
  Segs s;
  s.s[0] = a;
  s.s[1] = b;
  s.s[2] = c;
  return s;
}

template <bool LSTM>
cudaError_t rows(const Segs& in, const float* W, int ldw, const float* bias,
                 int N, int relu, float* out, int ld_out, float* c, int B,
                 cudaStream_t st) {
  dim3 grid(LSTM ? (N + 7) / 8 : (N + 31) / 32, (B + BI - 1) / BI);
  rows_kernel<LSTM><<<grid, NW * 32, 0, st>>>(in, W, ldw, bias, N, relu, out,
                                              ld_out, c, B);
  return cudaGetLastError();
}

size_t attention_smem(int T, int A, int KL, int D) {
  return sizeof(float) * (tile_region(A, KL, D) + T + 2 * (T + KL - 1) + NW);
}

}  // namespace

extern "C" {

// Floats of the zero-initialised state the caller allocates.
long long state_floats(int B, int T, int D, int A, int M, int P1, int P2,
                       int H, int H2, int NP) {
  return (long long)B
         * (M + P1 + P2 + 3LL * H + 3LL * H2 + D + 2LL * T + NP + A);
}

// Runs `steps` decode steps, 8 launches each, on `stream`; returns the
// first CUDA error, else 0.
int taco2_decode(const float* enc, const float* pi, const float* mask,
                 const float* pw1, const float* pw2, const float* aw,
                 const float* ab, const float* qk, const float* kloc,
                 const float* ld, const float* v, const float* dw,
                 const float* db, const float* projw, const float* projb,
                 const float* stopw, const float* stopb, float* state,
                 float* frames, float* stop, float* align_out, int steps,
                 int B, int T, int D, int A, int F, int KL, int M, int P1,
                 int P2, int H, int H2, int NP, int r, void* stream) {
  if (steps == 0 || B == 0) return (int)cudaSuccess;
  // attention_kernel keeps 32 location filters' weights in registers,
  // splits A over whole warps of one block and reads enc as float4s
  if (F != LF || A % 32 != 0 || (NW * 32) % A != 0 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* zeros_in = state;                       // (B, M)
  float* p1 = zeros_in + (size_t)B * M;          // (B, P1)
  float* p2 = p1 + (size_t)B * P1;               // (B, P2)
  float* h1 = p2 + (size_t)B * P2;               // (2, B, H)
  float* c1 = h1 + 2 * (size_t)B * H;            // (B, H)
  float* h2 = c1 + (size_t)B * H;                // (2, B, H2)
  float* c2 = h2 + 2 * (size_t)B * H2;           // (B, H2)
  float* ctx = c2 + (size_t)B * H2;              // (B, D)
  float* al = ctx + (size_t)B * D;               // (B, T)
  float* cum = al + (size_t)B * T;               // (B, T)
  float* ff = cum + (size_t)B * T;               // (B, NP)
  float* pq = ff + (size_t)B * NP;               // (B, A)
  const int RM = r * M;

  const size_t smem = attention_smem(T, A, KL, D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    const float* h1p = h1 + cur * (size_t)B * H;
    float* h1n = h1 + nxt * (size_t)B * H;
    const float* h2p = h2 + cur * (size_t)B * H2;
    float* h2n = h2 + nxt * (size_t)B * H2;
    const Seg last = s == 0 ? Seg{zeros_in, M, M}
                            : Seg{ff + (size_t)(r - 1) * M, NP, M};
    if ((err = rows<false>(segs(last), pw1, P1, nullptr, P1, 1, p1, P1,
                           nullptr, B, st)) != cudaSuccess)
      return (int)err;
    if ((err = rows<false>(segs({p1, P1, P1}), pw2, P2, nullptr, P2, 1, p2,
                           P2, nullptr, B, st)) != cudaSuccess)
      return (int)err;
    if ((err = rows<true>(segs({p2, P2, P2}, {ctx, D, D}, {h1p, H, H}), aw,
                          4 * H, ab, H, 0, h1n, H, c1, B, st)) != cudaSuccess)
      return (int)err;
    if ((err = rows<false>(segs({h1n, H, H}), qk, A, nullptr, A, 0, pq, A,
                           nullptr, B, st)) != cudaSuccess)
      return (int)err;
    attention_kernel<<<B, NW * 32, smem, st>>>(
        pq, pi, kloc, ld, v, enc, mask, al, cum, ctx,
        align_out + (size_t)s * B * T, T, A, KL, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = rows<true>(segs({h1n, H, H}, {ctx, D, D}, {h2p, H2, H2}), dw,
                          4 * H2, db, H2, 0, h2n, H2, c2, B, st))
        != cudaSuccess)
      return (int)err;
    if ((err = rows<false>(segs({h2n, H2, H2}, {ctx, D, D}), projw, NP,
                           projb, NP, 0, ff, NP, nullptr, B, st))
        != cudaSuccess)
      return (int)err;
    stop_kernel<<<B, NW * 32, 0, st>>>(h2n, ff, stopw, stopb,
                                       stop + (size_t)s * B,
                                       frames + (size_t)s * B * RM, H2, NP,
                                       RM);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
