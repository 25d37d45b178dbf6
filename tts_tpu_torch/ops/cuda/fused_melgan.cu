// MelGAN-family generator kernels for Hopper (sm_90a), fp32.
//
// Replace the whole-generator Pallas kernel of
// tts_tpu/ops/pallas/fused_melgan.py (`_make_generator_kernel`, run by the
// pallas_call in `_fused_generator`, entry `megakernel_inference`). The TPU
// kernel kept one item's weights and activations in VMEM; a Hopper block has
// 227 KB of shared memory, so the generator runs as a chain of time-tiled
// kernels on PyTorch's stream:
//
//   proj_in   edge pad (inference padding) + reflect pad + conv k=7, mel in
//             (B, T, n_mels) -> (B, C0, T')
//   upsample  leaky + transposed conv (stride f, kernel 2f) as two taps per
//             output phase (polyphase), zero edges -> (B, C/2, T*f)
//   [the residual stack of each stage: fused_resstack.cu]
//   tail      leaky + reflect pad + conv k=7 + tanh + PQMF polyphase
//             synthesis (J taps, zero edges) -> waveform (B, T*N)
//
// Every kernel writes true time order; none of the TPU's phase-block lane
// layout is carried over. Bound on the card: operations (fp32 FMA on the
// CUDA cores); each block stages its input tile (plus halo) in shared memory
// once and computes a (channels x time) tile from it, lanes along time so
// shared reads are conflict-free and weight reads are warp-wide float4
// broadcasts (weights are stored output channel innermost).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kChannelsPerBlock = 64;

__device__ __forceinline__ int reflect_index(int g, int T) {
  if (g < 0) g = -g;
  if (g >= T) g = 2 * (T - 1) - g;
  return g < 0 ? 0 : (g >= T ? T - 1 : g);
}

__device__ __forceinline__ int clamp_index(int g, int T) {
  return g < 0 ? 0 : (g >= T ? T - 1 : g);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

// ---------------------------------------------------------------------------
// proj_in: out[b, co, t] = bias[co] + sum_{ci,k} W[co, ci, k] * xp[ci, t+k-K/2]
// where xp is the mel edge-padded by `pad` frames then reflect-padded.
// w: (C_out/4, C_in, K, 4), grouped by 4 output channels.
// Grid (time tiles, channel blocks, B); tile = 32 * TB.
template <int TB>
__global__ void __launch_bounds__(kThreads)
proj_in_kernel(const float* __restrict__ mel, float* __restrict__ out,
               const float* __restrict__ w, const float* __restrict__ bias,
               int T, int Cm, int Co, int K, int pad) {
  extern __shared__ float smem[];
  constexpr int tile = 32 * TB;
  const int W = tile + K - 1;
  const int Tp = T + 2 * pad;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * tile;
  const float* mb = mel + (long)b * T * Cm;
  for (int i = threadIdx.x; i < Cm * W; i += blockDim.x) {
    const int j = i / Cm;
    const int c = i - j * Cm;
    const int m = reflect_index(t0 - K / 2 + j, Tp);
    smem[c * W + j] = mb[(long)clamp_index(m - pad, T) * Cm + c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int c_begin = blockIdx.y * kChannelsPerBlock;
  const int n_cg = (min(Co - c_begin, kChannelsPerBlock) + 3) >> 2;
  for (int g = warp; g < n_cg; g += nwarps) {
    const int co = c_begin + g * 4;
    const float4 bb = *reinterpret_cast<const float4*>(bias + co);
    float acc[4][TB];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      acc[0][i] = bb.x; acc[1][i] = bb.y; acc[2][i] = bb.z; acc[3][i] = bb.w;
    }
    const float4* wg = reinterpret_cast<const float4*>(w) + (long)(co / 4) * Cm * K;
#pragma unroll 2
    for (int ci = 0; ci < Cm; ++ci) {
      const float* xr = smem + ci * W + lane;
      for (int k = 0; k < K; ++k) {
        const float4 wv = __ldg(wg + ci * K + k);
#pragma unroll
        for (int i = 0; i < TB; ++i) {
          const float v = xr[32 * i + k];
          acc[0][i] = fmaf(wv.x, v, acc[0][i]);
          acc[1][i] = fmaf(wv.y, v, acc[1][i]);
          acc[2][i] = fmaf(wv.z, v, acc[2][i]);
          acc[3][i] = fmaf(wv.w, v, acc[3][i]);
        }
      }
    }
    float* ob = out + (long)b * Co * Tp;
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const int t = t0 + lane + 32 * i;
      if (t < Tp) {
#pragma unroll
        for (int c = 0; c < 4; ++c) ob[(long)(co + c) * Tp + t] = acc[c][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// upsample: out[b, co, u*f + p] = bias[co]
//     + sum_ci A_p[ci, co] * lx[ci, u + q_p] + B_p[ci, co] * lx[ci, u + q_p - 1]
// with lx = leaky(x), zero outside [0, T), q_p = (p + P) / f in {0, 1}.
// w: (f, C_out/4, C_in, 2, 4) = [A_p; B_p] grouped by 4 output channels.
// Grid (time tiles, channel blocks, B); tile = 32 * TB input frames.
template <int TB>
__global__ void __launch_bounds__(kThreads)
upsample_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ w, const float* __restrict__ bias,
                int Ci, int Co, int T, int f, int P, float slope) {
  extern __shared__ float smem[];
  constexpr int tile = 32 * TB;
  constexpr int W = tile + 2;          // frames [u0 - 1, u0 + tile]
  const int b = blockIdx.z;
  const int u0 = blockIdx.x * tile;
  const float* xb = x + (long)b * Ci * T;
  for (int i = threadIdx.x; i < Ci * W; i += blockDim.x) {
    const int c = i / W;
    const int j = i - c * W;
    const int u = u0 - 1 + j;
    smem[i] = (u >= 0 && u < T) ? leaky(xb[(long)c * T + u], slope) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int c_begin = blockIdx.y * kChannelsPerBlock;
  const int n_cg = (min(Co - c_begin, kChannelsPerBlock) + 3) >> 2;
  const int Tf = T * f;
  float* ob = out + (long)b * Co * Tf;
  for (int item = warp; item < n_cg * f; item += nwarps) {
    const int co = c_begin + (item % n_cg) * 4;
    const int p = item / n_cg;
    const int q = (p + P) / f;
    const float4 bb = *reinterpret_cast<const float4*>(bias + co);
    float acc[4][TB];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      acc[0][i] = bb.x; acc[1][i] = bb.y; acc[2][i] = bb.z; acc[3][i] = bb.w;
    }
    // this (phase, channel group)'s weights: (C_in, 2) float4s, contiguous
    const float4* wg = reinterpret_cast<const float4*>(w)
        + ((long)p * (Co / 4) + co / 4) * Ci * 2;
#pragma unroll 4
    for (int ci = 0; ci < Ci; ++ci) {
      const float4 wa = __ldg(wg + 2 * ci);
      const float4 wb = __ldg(wg + 2 * ci + 1);
      // local index of frame u + q is (u - u0) + q + 1
      const float* xr = smem + ci * W + lane + q;
#pragma unroll
      for (int i = 0; i < TB; ++i) {
        const float va = xr[32 * i + 1];
        const float vb = xr[32 * i];
        acc[0][i] = fmaf(wb.x, vb, fmaf(wa.x, va, acc[0][i]));
        acc[1][i] = fmaf(wb.y, vb, fmaf(wa.y, va, acc[1][i]));
        acc[2][i] = fmaf(wb.z, vb, fmaf(wa.z, va, acc[2][i]));
        acc[3][i] = fmaf(wb.w, vb, fmaf(wa.w, va, acc[3][i]));
      }
    }
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const int u = u0 + lane + 32 * i;
      if (u < T) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ob[(long)(co + c) * Tf + (long)u * f + p] = acc[c][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tail: sub[c, s] = tanh(bias[c] + sum_{ci,k} w[ci, k, c] * leaky(x)[ci, reflect(s+k-K/2)])
// for s in [0, T) (zero outside), then with J > 0 (PQMF, N subbands):
//   wav[b, t*N + p] = sum_{j,c} syn[j, c, p] * sub[c, t + j - q]
// or with J == 0: wav[b, t*N + c] = sub[c, t] (channels-last subbands).
// Grid (time tiles, B).
constexpr int kTailTile = 256;

__global__ void __launch_bounds__(kThreads)
tail_kernel(const float* __restrict__ x, float* __restrict__ wav,
            const float* __restrict__ w, const float* __restrict__ bias,
            const float* __restrict__ syn, int C, int T, int N, int K, int J,
            int q, float slope) {
  extern __shared__ float smem[];
  const int taps = J > 0 ? J : 1;
  const int S = kTailTile + taps - 1;        // subband frames the tile needs
  const int W = S + K - 1;                   // input frames they need
  const int s_off = J > 0 ? q : 0;
  float* xs = smem;                          // [C][W]
  float* sub = xs + C * W;                   // [N][S]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTailTile;
  const float* xb = x + (long)b * C * T;
  for (int i = threadIdx.x; i < C * W; i += blockDim.x) {
    const int c = i / W;
    const int j = i - c * W;
    const int m = reflect_index(t0 - s_off - K / 2 + j, T);
    xs[i] = leaky(xb[(long)c * T + m], slope);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * S; i += blockDim.x) {
    const int c = i / S;
    const int s = i - c * S;
    const int sg = t0 - s_off + s;
    float v = 0.f;
    if (sg >= 0 && sg < T) {
      float acc = bias[c];
      for (int ci = 0; ci < C; ++ci) {
        const float* xr = xs + ci * W + s;
        const float* wr = w + (long)ci * K * N + c;
        for (int k = 0; k < K; ++k) acc = fmaf(__ldg(wr + k * N), xr[k], acc);
      }
      v = tanhf(acc);
    }
    sub[i] = v;
  }
  __syncthreads();

  float* wb = wav + (long)b * T * N;
  for (int i = threadIdx.x; i < kTailTile * N; i += blockDim.x) {
    const int t = i / N;
    const int p = i - t * N;
    if (t0 + t >= T) continue;
    float acc;
    if (J > 0) {
      acc = 0.f;
      for (int j = 0; j < J; ++j)
        for (int c = 0; c < N; ++c)
          acc = fmaf(__ldg(syn + (j * N + c) * N + p), sub[c * S + t + j], acc);
    } else {
      acc = sub[p * S + t];
    }
    wb[(long)(t0 + t) * N + p] = acc;
  }
}

// Opt a kernel in to the full 227 KB of dynamic shared memory, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* opted_in) {
  if (*opted_in) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) *opted_in = true;
  return err;
}

}  // namespace

extern "C" {

// Frames per time tile: 64 (TB=2), or 32 (TB=1) for wide inputs so the
// staged tile stays small enough for two blocks per SM.
static int frames_tb(int C_in) { return C_in >= 256 ? 1 : 2; }

static long proj_in_smem_bytes(int Cm, int K) {
  return 4L * Cm * (32 * frames_tb(Cm) + K - 1);
}

int melgan_proj_in(const float* mel, float* out, const float* w,
                   const float* bias, int B, int T, int Cm, int Co, int K,
                   int pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tb = frames_tb(Cm);
  const int tile = 32 * tb;
  const int Tp = T + 2 * pad;
  const size_t smem = proj_in_smem_bytes(Cm, K);
  dim3 grid((Tp + tile - 1) / tile,
            (Co + kChannelsPerBlock - 1) / kChannelsPerBlock, B);
  static bool opted_in[2] = {false, false};
  cudaError_t err;
  if (tb == 2) {
    if ((err = allow_smem(proj_in_kernel<2>, &opted_in[1])) != cudaSuccess)
      return err;
    proj_in_kernel<2><<<grid, kThreads, smem, s>>>(mel, out, w, bias, T, Cm,
                                                   Co, K, pad);
  } else {
    if ((err = allow_smem(proj_in_kernel<1>, &opted_in[0])) != cudaSuccess)
      return err;
    proj_in_kernel<1><<<grid, kThreads, smem, s>>>(mel, out, w, bias, T, Cm,
                                                   Co, K, pad);
  }
  return (int)cudaGetLastError();
}

static long upsample_smem_bytes(int Ci) { return 4L * Ci * (32 * frames_tb(Ci) + 2); }

int melgan_upsample(const float* x, float* out, const float* w,
                    const float* bias, int B, int Ci, int Co, int T, int f,
                    int P, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tb = frames_tb(Ci);
  const int tile = 32 * tb;
  const size_t smem = upsample_smem_bytes(Ci);
  dim3 grid((T + tile - 1) / tile,
            (Co + kChannelsPerBlock - 1) / kChannelsPerBlock, B);
  static bool opted_in[2] = {false, false};
  cudaError_t err;
  if (tb == 2) {
    if ((err = allow_smem(upsample_kernel<2>, &opted_in[1])) != cudaSuccess)
      return err;
    upsample_kernel<2><<<grid, kThreads, smem, s>>>(x, out, w, bias, Ci, Co,
                                                    T, f, P, slope);
  } else {
    if ((err = allow_smem(upsample_kernel<1>, &opted_in[0])) != cudaSuccess)
      return err;
    upsample_kernel<1><<<grid, kThreads, smem, s>>>(x, out, w, bias, Ci, Co,
                                                    T, f, P, slope);
  }
  return (int)cudaGetLastError();
}

static long tail_smem_bytes(int C, int N, int K, int J) {
  const int S = kTailTile + (J > 0 ? J : 1) - 1;
  return 4L * (C * (S + K - 1) + N * S);
}

int melgan_tail(const float* x, float* wav, const float* w, const float* bias,
                const float* syn, int B, int C, int T, int N, int K, int J,
                int q, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = tail_smem_bytes(C, N, K, J);
  static bool opted_in = false;
  cudaError_t err = allow_smem(tail_kernel, &opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kTailTile - 1) / kTailTile, B);
  tail_kernel<<<grid, kThreads, smem, s>>>(x, wav, w, bias, syn, C, T, N, K,
                                           J, q, slope);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
