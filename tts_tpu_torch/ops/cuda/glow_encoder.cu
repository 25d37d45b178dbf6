// The whole eval-mode Glow-TTS encoder, for Hopper (sm_90a), fp32.
//
// Replaces tts_tpu/ops/pallas/fused_glow_encoder.py (`_make_kernel`, run by
// the pallas_call in `_fused_encoder`), which keeps every weight and a
// stack of items in VMEM and runs the encoder as one kernel. Here one C
// entry point runs it as a chain of launches on the caller's stream,
// activations in (B*T, C) row-major scratch that the caller allocates:
//
//   prenet   n_pre x conv_gemm (conv k_pre, LayerNorm, ReLU)
//            1 x conv_gemm (1x1 projection + residual, masked)
//   layer    conv_gemm: q | k | v as one 3C-wide product of the masked input
//            attention_kernel: rel-pos multi-head attention, window 4
//            conv_gemm: output projection + residual + LayerNorm
//            conv_gemm: FFN conv k_ffn + ReLU
//            conv_gemm: FFN conv k_ffn, masked, + residual + LayerNorm
//   heads    conv_gemm: proj_mean, masked
//            2 x conv_gemm (conv k_dp, ReLU, LayerNorm), the duration
//            predictor; conv_gemm: its 1-wide projection, masked
//
// n_pre + 1 + 5 L + 4 launches: 38 at the shipped width (3 prenet convs,
// 6 layers).
//
// conv_gemm computes out = epilogue(sum_j shift_j(in [* m]) W_j + b): tap j
// reads row t + j - taps/2 of the same item (zero outside it, so items never
// see each other), W is tap-major (taps * C_in, N). A block owns 64 rows (32
// where 64-row tiles would not fill the card) and 64 * NC columns; 16 K
// values of the input rows and the weights are staged in shared memory per
// step, double-buffered (the next step's values wait in registers while
// this step's are multiplied); each thread keeps 4 (or 2) rows x 4 * NC
// columns of sums. Where the tiles are fewer than the SMs (a small
// batch: at B=1 x 96 a LayerNorm product has 3), K is split over a thread
// block cluster of up to 8 blocks and the partial sums meet in the first
// block through distributed shared memory, in a fixed order. (A first
// version without the split took 2.9 ms for the encoder at B=1 x 96 on an
// H100 at 700 W: a few blocks each walked up to 144 dependent K steps.)
// The epilogue applies, in this order and as each call asks: bias, ReLU,
// mask, residual, LayerNorm over the row (eps 1e-4, two-pass; the block
// then holds all N <= 256 columns of its rows, and the 16 threads of a row
// meet by warp shuffles), ReLU, mask.
//
// attention_kernel: one block per (item, head, 16 query rows; down to 4
// where the blocks would be fewer than the SMs). Scores
// q . k / sqrt(kc) against all T keys of the item are kept in shared memory
// (T floats a row, any T the card's shared memory holds: T <= 3,043 at
// kc 96 on an H100, glow_encoder_max_text_length; GlowTTS.encode runs the
// module above it), keys staged 64 at a time; the key-side band q . emb_rel_k[r] /
// sqrt(kc) is added at |j - i| <= 4; key columns beyond the length are set
// to -1e4, as tts_tpu sets them; softmax in float32; then P V (values staged
// 64 at a time) plus the value-side band sum_r p[i, i + r - 4] emb_rel_v[r].
// Padded query rows see a softmax over the valid keys, as in tts_tpu; every
// output that leaves the encoder is masked.
//
// Bound on the card. At bench.py's batched geometry (B=128, T=128, shipped
// width) about 244 GFLOP, 3.6 ms at 67 TFLOP/s fp32, against 28.7 MB of
// weights and ~30 MB of input and output: operations. At B=1 the launches
// re-read the 28.7 MB of weights (they fit the 50 MB L2 across calls), so
// 38 dependent launches bound it in practice. What holds this design back:
// fp32 FMAs off the tensor cores (2 rows x 4 NC columns a thread, the
// operands staged 16 K values at a time), activations that go through L2
// between launches, and 38 launches that each wait for the one before.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TK = 16;   // K values staged per step
constexpr int RW = 4;    // relative window (tts_tpu's REL_W)
constexpr int NR = 2 * RW + 1;
constexpr int TQ = 16;   // query rows per attention block (fewer at a
                         // small batch, so that the blocks fill the card)
constexpr int KT = 64;   // keys or values staged per attention step

enum : int {
  MASK_IN = 1,     // multiply the input rows by the mask
  RELU_PRE = 2,
  MASK_PRE = 4,
  RESIDUAL = 8,
  LAYERNORM = 16,
  RELU_POST = 32,
  MASK_POST = 64,
};

struct Gemm {
  const float* in;  // (M, ldi); columns [0, cin) are read
  int ldi, cin, taps;
  const float* w;     // (taps * cin, N)
  const float* bias;  // (N)
  const float* res;   // (M, ldr) or null; may alias out
  int ldr;
  const float* gamma;  // LayerNorm scale and shift (N)
  const float* beta;
  float* out;  // (M, ldo)
  int ldo, N, flags;
};

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// RM rows x 4 NC columns of sums a thread: blocks of 16 RM rows x 64 NC
// columns.
template <int NC, int RM>
__global__ void __launch_bounds__(NT) conv_gemm_kernel(
    const Gemm g, const float* __restrict__ mask, int M, int T) {
  constexpr int BN = 64 * NC, BM = 16 * RM;
  constexpr int WL = TK * BN / NT;  // weight values each thread stages
  __shared__ __align__(16) float As[2][TK][BM + 4];
  __shared__ __align__(16) float Ws[2][TK][BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = g.taps * g.cin, half = g.taps / 2;
  const bool mask_in = g.flags & MASK_IN;

  // staging: this thread loads input rows m0 + am + 16 e at K offset ak of
  // each step
  const int ak = tid & 15, am = tid >> 4;
  int arow[RM], at[RM];
#pragma unroll
  for (int e = 0; e < RM; ++e) {
    arow[e] = m0 + am + 16 * e;
    at[e] = arow[e] % T;
  }
  float areg[RM], wreg[WL];
  auto load = [&](int k0) {
    const int kk = k0 + ak;
    const int j = kk / g.cin, c = kk - j * g.cin;
#pragma unroll
    for (int e = 0; e < RM; ++e) {
      float v = 0.f;
      const int s = at[e] + j - half;
      if (arow[e] < M && kk < K && s >= 0 && s < T) {
        const int src = arow[e] + j - half;
        v = g.in[(size_t)src * g.ldi + c];
        if (mask_in) v *= mask[src];
      }
      areg[e] = v;
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int idx = tid + i * NT, k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      wreg[i] = (gk < K && gn < g.N) ? g.w[(size_t)gk * g.N + gn] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < RM; ++e) As[buf][ak][am + 16 * e] = areg[e];
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int idx = tid + i * NT;
      Ws[buf][idx / BN][idx % BN] = wreg[i];
    }
  };

  float acc[RM][NC][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][c][q] = 0.f;

  // split K: block z of the cluster (gridDim.z blocks) takes its share of
  // the K steps
  const int S = gridDim.z, z = blockIdx.z;
  const int nk = (K + TK - 1) / TK;
  const int kb = nk * z / S, ke = nk * (z + 1) / S;
  load(kb * TK);
  store(0);
  __syncthreads();
  for (int kt = kb; kt < ke; ++kt) {
    const int cur = (kt - kb) & 1;
    if (kt + 1 < ke) load((kt + 1) * TK);
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[RM];
      if constexpr (RM == 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
        a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[cur][k][ty * RM + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 w =
            *reinterpret_cast<const float4*>(&Ws[cur][k][c * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][c][0] += a[i] * w.x;
          acc[i][c][1] += a[i] * w.y;
          acc[i][c][2] += a[i] * w.z;
          acc[i][c][3] += a[i] * w.w;
        }
      }
    }
    if (kt + 1 < ke) store(cur ^ 1);
    __syncthreads();
  }

  if constexpr (BM == 2 * TK) {  // the 32-row tiles split K
    if (S > 1) {
      // the partial sums meet in the cluster's first block, read from the
      // others' shared memory (distributed shared memory), in rank order
      float* red = &Ws[0][0][0];  // (BM, BN): the weight tiles' room
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          *reinterpret_cast<float4*>(
              &red[(ty * RM + i) * BN + c * 64 + tx * 4]) =
              make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2],
                          acc[i][c][3]);
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (z == 0) {
        for (int r = 1; r < S; ++r) {
          const float* other = cluster.map_shared_rank(red, r);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const float4 v = *reinterpret_cast<const float4*>(
                  &other[(ty * RM + i) * BN + c * 64 + tx * 4]);
              acc[i][c][0] += v.x;
              acc[i][c][1] += v.y;
              acc[i][c][2] += v.z;
              acc[i][c][3] += v.w;
            }
        }
      }
      cluster.sync();  // the others' shared memory stays until it is read
      if (z != 0) return;
    }
  }

  // epilogue, row by row (uniform across the warp: the shuffles of the
  // LayerNorm need every lane)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = m0 + ty * RM + i;
    const bool live = r < M;
    const float mr = live ? mask[r] : 0.f;
    float v[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + c * 64 + tx * 4 + q;
        const bool ok = n < g.N;
        float x = acc[i][c][q] + (ok ? g.bias[n] : 0.f);
        if (g.flags & RELU_PRE) x = fmaxf(x, 0.f);
        if (g.flags & MASK_PRE) x *= mr;
        if ((g.flags & RESIDUAL) && ok && live)
          x += g.res[(size_t)r * g.ldr + n];
        v[c][q] = ok ? x : 0.f;
      }
    if (g.flags & LAYERNORM) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) s += v[c][q];
      const float mean = group16_sum(s) / g.N;
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + c * 64 + tx * 4 + q;
          const float dv = v[c][q] - mean;
          if (n < g.N) d += dv * dv;
        }
      const float inv = 1.f / sqrtf(group16_sum(d) / g.N + 1e-4f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + c * 64 + tx * 4 + q;
          if (n < g.N)
            v[c][q] = (v[c][q] - mean) * inv * g.gamma[n] + g.beta[n];
        }
    }
    if (!live) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + c * 64 + tx * 4 + q;
        if (n >= g.N) continue;
        float x = v[c][q];
        if (g.flags & RELU_POST) x = fmaxf(x, 0.f);
        if (g.flags & MASK_POST) x *= mr;
        g.out[(size_t)r * g.ldo + n] = x;
      }
  }
}

// Shared floats of one attention block.
size_t attention_floats(int T, int kc, int tq) {
  return (size_t)2 * tq * kc + tq * NR + (size_t)KT * (kc + 1)
         + (size_t)tq * T;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// qkv (B*T, 3C): q | k | v, head h at columns h*kc of each; out (B*T, C).
__global__ void __launch_bounds__(NT) attention_kernel(
    const float* __restrict__ qkv, const float* __restrict__ erk,
    const float* __restrict__ erv, const float* __restrict__ mask,
    float* __restrict__ out, int T, int C, int kc, int tq, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                  // (tq, kc) queries
  float* os = qs + tq * kc;        // (tq, kc) P V sums
  float* qe = os + tq * kc;        // (tq, NR) key-side band logits
  float* kv = qe + tq * NR;        // (KT, kc + 1) staged keys or values
  float* ps = kv + KT * (kc + 1);  // (tq, T) scores, then probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * tq;
  const int ld = 3 * C, kp = kc + 1;
  const float* base = qkv + (size_t)b * T * ld + h * kc;
  const float* mrow = mask + (size_t)b * T;

  for (int i = tid; i < tq * kc; i += NT) {
    const int qi = i / kc, d = i - qi * kc, row = q0 + qi;
    qs[i] = row < T ? base[(size_t)row * ld + d] : 0.f;
    os[i] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < tq * NR; i += NT) {
    const int qi = i / NR, r = i - qi * NR;
    float s = 0.f;
    for (int d = 0; d < kc; ++d) s += qs[qi * kc + d] * erk[r * kc + d];
    qe[i] = s * scale;
  }

  for (int j0 = 0; j0 < T; j0 += KT) {
    const int nj = min(KT, T - j0);
    __syncthreads();
    for (int i = tid; i < nj * kc; i += NT) {
      const int jj = i / kc, d = i - jj * kc;
      kv[jj * kp + d] = base[(size_t)(j0 + jj) * ld + C + d];
    }
    __syncthreads();
    for (int i = tid; i < tq * nj; i += NT) {
      const int qi = i / nj, jj = i - qi * nj, j = j0 + jj;
      const float* qr = qs + qi * kc;
      const float* kr = kv + jj * kp;
      float s = 0.f;
      for (int d = 0; d < kc; ++d) s += qr[d] * kr[d];
      s *= scale;
      const int rel = j - (q0 + qi);
      if (rel >= -RW && rel <= RW) s += qe[qi * NR + rel + RW];
      if (!(mrow[j] > 0.f)) s = -1e4f;
      ps[qi * T + j] = s;
    }
  }
  __syncthreads();

  for (int qi = warp; qi < tq; qi += NT / 32) {
    if (q0 + qi >= T) continue;
    float* p = ps + qi * T;
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, p[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) p[j] = p[j] / sum;
  }

  for (int j0 = 0; j0 < T; j0 += KT) {
    const int nj = min(KT, T - j0);
    __syncthreads();
    for (int i = tid; i < nj * kc; i += NT) {
      const int jj = i / kc, d = i - jj * kc;
      kv[jj * kp + d] = base[(size_t)(j0 + jj) * ld + 2 * C + d];
    }
    __syncthreads();
    for (int i = tid; i < tq * kc; i += NT) {
      const int qi = i / kc, d = i - qi * kc;
      if (q0 + qi >= T) continue;
      const float* p = ps + qi * T + j0;
      float s = 0.f;
      for (int jj = 0; jj < nj; ++jj) s += p[jj] * kv[jj * kp + d];
      os[i] += s;
    }
  }

  for (int i = tid; i < tq * kc; i += NT) {
    const int qi = i / kc, d = i - qi * kc, row = q0 + qi;
    if (row >= T) continue;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int j = row + r - RW;
      if (j >= 0 && j < T) s += ps[qi * T + j] * erv[r * kc + d];
    }
    out[((size_t)b * T + row) * C + h * kc + d] = os[i] + s;
  }
}

template <int NC, int RM>
cudaError_t launch_gemm(const Gemm& g, const float* mask, int M, int T,
                        dim3 grid, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv_gemm_kernel<NC, RM>, g, mask, M, T);
}

// Tiles of 64 rows x 64 nc columns where they fill the card (nc <= 3); else
// of 32 rows, and where those are still fewer than the SMs (a small batch),
// K is split over a cluster of up to 8 blocks, each with at least 4 steps.
cudaError_t gemm(const Gemm& g, const float* mask, int M, int T, int sms,
                 cudaStream_t s) {
  int nc;
  if (g.flags & LAYERNORM) {
    nc = (g.N + 63) / 64;  // one block holds every column of its rows
    if (nc > 4) return cudaErrorInvalidValue;
  } else {
    nc = g.N > 64 ? 2 : 1;
  }
  const int cols = (g.N + 64 * nc - 1) / (64 * nc);
  if (nc <= 3 && cols * ((M + 63) / 64) >= sms) {
    const dim3 grid(cols, (M + 63) / 64, 1);
    switch (nc) {
      case 1: return launch_gemm<1, 4>(g, mask, M, T, grid, s);
      case 2: return launch_gemm<2, 4>(g, mask, M, T, grid, s);
      default: return launch_gemm<3, 4>(g, mask, M, T, grid, s);
    }
  }
  dim3 grid(cols, (M + 31) / 32, 1);
  const int tiles = grid.x * grid.y;
  const int steps = (g.taps * g.cin + TK - 1) / TK;
  if (tiles < sms)
    grid.z = max(1, min(8, min((sms + tiles - 1) / tiles, steps / 4)));
  switch (nc) {
    case 1: return launch_gemm<1, 2>(g, mask, M, T, grid, s);
    case 2: return launch_gemm<2, 2>(g, mask, M, T, grid, s);
    case 3: return launch_gemm<3, 2>(g, mask, M, T, grid, s);
    default: return launch_gemm<4, 2>(g, mask, M, T, grid, s);
  }
}

Gemm make(const float* in, int ldi, int cin, int taps, const float* w,
          const float* bias, float* out, int N, int flags) {
  Gemm g{};
  g.in = in;
  g.ldi = ldi;
  g.cin = cin;
  g.taps = taps;
  g.w = w;
  g.bias = bias;
  g.out = out;
  g.ldo = N;
  g.N = N;
  g.flags = flags;
  return g;
}

// Walks the packed weights in ops/glow_encoder.py's order.
struct Walk {
  const float* p;
  const float* take(size_t n) {
    const float* q = p;
    p += n;
    return q;
  }
};

}  // namespace

extern "C" {

// Floats of the packed weights (ops/glow_encoder.py::pack_glow_encoder_params).
long long glow_encoder_weight_floats(int C, int F, int Fdp, int H, int L,
                                     int n_out, int k_pre, int n_pre,
                                     int k_ffn, int k_dp) {
  const long long kc = C / H;
  long long n = n_pre * ((long long)k_pre * C * C + 3LL * C) + C * C + C;
  n += L * (3LL * C * C + 3LL * C + 2LL * NR * kc + C * C + C + 2LL * C
            + (long long)k_ffn * C * F + F + (long long)k_ffn * F * C + C
            + 2LL * C);
  n += (long long)C * n_out + n_out;
  n += (long long)k_dp * C * Fdp + 3LL * Fdp + (long long)k_dp * Fdp * Fdp
       + 3LL * Fdp + Fdp + 1;
  return n;
}

// The longest text T whose attention block fits the opt-in shared memory of
// `device` at k_ch = kc, by attention_floats at the largest query tile TQ
// (a text that long always runs TQ query rows per block); a negative CUDA
// error if the card cannot be asked. Callers run the module above it.
int glow_encoder_max_text_length(int kc, int device) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  const size_t floats = (size_t)optin / sizeof(float);
  const size_t fixed = attention_floats(0, kc, TQ);
  return floats < fixed ? 0 : (int)((floats - fixed) / TQ);
}

// The whole encoder on `stream`: x (B*T, C) holds the embedded text on entry
// (it is the residual stream, overwritten); mask (B*T) 1/0; h0, h1 (B*T,
// max(C, F, Fdp)), qkv (B*T, 3C), att (B*T, C) scratch; out (B*T, 2 n_out +
// 1) zero on entry: means | log-scales (left zero: mean_only) | log-
// durations. Returns the first CUDA error, else 0.
int glow_encoder_forward(float* x, const float* mask, const float* weights,
                         float* h0, float* h1, float* qkv, float* att,
                         float* out, int B, int T, int C, int F, int Fdp,
                         int H, int L, int n_out, int k_pre, int n_pre,
                         int k_ffn, int k_dp, float scale, void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  if (C % H != 0 || C > 256 || Fdp > 256 || n_pre < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T, kc = C / H, ldo = 2 * n_out + 1;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  int tq = TQ;
  while (tq > 4 && B * H * ((T + tq - 1) / tq) < sms) tq /= 2;
  const size_t smem = attention_floats(T, kc, tq) * sizeof(float);
  if ((err = cudaFuncSetAttribute(
           attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess) {
    cudaGetLastError();   // reported here: not to a later launch's check
    return (int)err;
  }
  Walk w{weights};
  float* bufs[2] = {h0, h1};

  // prenet (each take() in its own statement: the walk's order is the
  // packing order)
  for (int i = 0; i < n_pre; ++i) {
    const float* cw = w.take((size_t)k_pre * C * C);
    const float* cb = w.take(C);
    Gemm g = make(i == 0 ? x : bufs[(i - 1) & 1], C, C, k_pre, cw, cb,
                  bufs[i & 1], C, MASK_IN | LAYERNORM | RELU_POST);
    g.gamma = w.take(C);
    g.beta = w.take(C);
    if ((err = gemm(g, mask, M, T, sms, s)) != cudaSuccess) return (int)err;
  }
  {
    const float* pw = w.take((size_t)C * C);
    const float* pb = w.take(C);
    Gemm g = make(bufs[(n_pre - 1) & 1], C, C, 1, pw, pb, x, C,
                  RESIDUAL | MASK_POST);
    g.res = x;
    g.ldr = C;
    if ((err = gemm(g, mask, M, T, sms, s)) != cudaSuccess) return (int)err;
  }

  for (int l = 0; l < L; ++l) {
    const float* wqkv = w.take((size_t)3 * C * C);
    const float* bqkv = w.take(3 * C);
    const float* erk = w.take(NR * kc);
    const float* erv = w.take(NR * kc);
    if ((err = gemm(make(x, C, C, 1, wqkv, bqkv, qkv, 3 * C, MASK_IN), mask,
                     M, T, sms, s)) != cudaSuccess)
      return (int)err;
    attention_kernel<<<dim3((T + tq - 1) / tq, H, B), NT, smem, s>>>(
        qkv, erk, erv, mask, att, T, C, kc, tq, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const float* wo = w.take((size_t)C * C);
    const float* bo = w.take(C);
    Gemm o = make(att, C, C, 1, wo, bo, x, C, RESIDUAL | LAYERNORM);
    o.res = x;
    o.ldr = C;
    o.gamma = w.take(C);
    o.beta = w.take(C);
    if ((err = gemm(o, mask, M, T, sms, s)) != cudaSuccess) return (int)err;
    const float* f1w = w.take((size_t)k_ffn * C * F);
    const float* f1b = w.take(F);
    if ((err = gemm(make(x, C, C, k_ffn, f1w, f1b, h0, F,
                         MASK_IN | RELU_PRE),
                    mask, M, T, sms, s)) != cudaSuccess)
      return (int)err;
    const float* f2w = w.take((size_t)k_ffn * F * C);
    const float* f2b = w.take(C);
    Gemm f2 = make(h0, F, F, k_ffn, f2w, f2b, x, C,
                   MASK_IN | MASK_PRE | RESIDUAL | LAYERNORM);
    f2.res = x;
    f2.ldr = C;
    f2.gamma = w.take(C);
    f2.beta = w.take(C);
    if ((err = gemm(f2, mask, M, T, sms, s)) != cudaSuccess) return (int)err;
  }

  // the masked encoder output feeds both heads (MASK_IN)
  const float* pmw = w.take((size_t)C * n_out);
  const float* pmb = w.take(n_out);
  Gemm pm = make(x, C, C, 1, pmw, pmb, out, n_out, MASK_IN | MASK_POST);
  pm.ldo = ldo;
  if ((err = gemm(pm, mask, M, T, sms, s)) != cudaSuccess) return (int)err;
  const float* src = x;
  int cin = C;
  for (int i = 0; i < 2; ++i) {
    const float* dw = w.take((size_t)k_dp * cin * Fdp);
    const float* db = w.take(Fdp);
    Gemm d = make(src, cin, cin, k_dp, dw, db, bufs[i], Fdp,
                  MASK_IN | RELU_PRE | LAYERNORM);
    d.gamma = w.take(Fdp);
    d.beta = w.take(Fdp);
    if ((err = gemm(d, mask, M, T, sms, s)) != cudaSuccess) return (int)err;
    src = bufs[i];
    cin = Fdp;
  }
  const float* dpw = w.take(Fdp);
  const float* dpb = w.take(1);
  Gemm dp = make(src, Fdp, Fdp, 1, dpw, dpb, out + 2 * n_out, 1,
                 MASK_IN | MASK_POST);
  dp.ldo = ldo;
  if ((err = gemm(dp, mask, M, T, sms, s)) != cudaSuccess) return (int)err;
  return (int)cudaSuccess;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
