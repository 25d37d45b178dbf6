// Bidirectional LSTM of the Tacotron2 encoder, for Hopper (sm_90a), fp32.
//
// Replaces tts_tpu/ops/pallas/fused_bilstm.py (`_make_kernel`, run by the
// pallas_call in `fused_bilstm`). As there, the caller flips the backward
// direction's input over each item's length beforehand and flips its output
// back afterwards, so both directions scan forward over all T steps. One
// step of direction z is the fused cell
//
//   gates = [x_t, h] W_z + b_z      W_z (C + H, 4H), gate blocks i, f, g, o
//   c' = f c + i g,  h' = o tanh(c')
//
// Design. The input half of the product does not depend on h, so it runs
// first for all T steps and both directions as one tiled SGEMM
// (input_gemm_kernel: 64x64 tiles, K steps of 16, 4x4 register tiles read
// as float4 from shared memory, bias b_z folded in). Then one launch per
// step (lstm_step_kernel) adds h_{t-1} W_hh for both directions and applies
// the cell: a block owns 8 hidden units with all four of their gate
// columns, for 16 items, so the cell update stays inside the block. (A
// first version, 32 units for 8 items reading h from global memory in the
// sum, took about 20 us a step at B=64 on an H100 at 700 W, latency-bound.)
// h_t is written straight into the output, which the next step reads as
// h_{t-1}; c is updated in place (each (item, unit) is read and written by
// one thread). The host loop over steps is in C, so
// a call costs 1 + T launches and one call from Python.
//
// Bound on the card (B=64, T=128, C=512, H=256): operations. 2 directions x
// 2 B T (C + H) 4H = 25.8 GFLOP, 0.39 ms at 67 TFLOP/s fp32, against about
// 40 MB of operands and output (0.012 ms at 3.35 TB/s). The 128 dependent
// steps hold it back: each step is 67 MFLOP spread over 256 blocks, so the
// per-step time is launch and latency bound; W_hh (1 MB per direction)
// stays in L2 across steps.
//
// Layouts. xt (2, T*B, C) time-major rows; wf, wb (C + H, 4H); bf, bb (4H);
// g (2, T*B, 4H) scratch; c (2, B, H) zero on entry; out (2, T, B, H).

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64, TN = 64, TK = 16;   // input GEMM tile
constexpr int RU = 8;                      // hidden units per step block
constexpr int RB = 16;                     // items per step block
constexpr int RW = 8;                      // warps per step block
constexpr int KC = 256;                    // h values staged per chunk

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(256) input_gemm_kernel(
    const float* __restrict__ xt, const float* __restrict__ wf,
    const float* __restrict__ wb, const float* __restrict__ bf,
    const float* __restrict__ bb, float* __restrict__ g, int M, int K,
    int N) {
  const int z = blockIdx.z;
  const float* A = xt + (size_t)z * M * K;
  const float* W = z ? wb : wf;
  const float* bias = z ? bb : bf;
  float* G = g + (size_t)z * M * N;
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Ws[TK][TN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < TM * TK; i += 256) {
      const int m = i / TK, k = i % TK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < TK * TN; i += 256) {
      const int k = i / TN, n = i % TN;
      const int gk = k0 + k, gn = n0 + n;
      Ws[k][n] = (gk < K && gn < N) ? W[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) G[(size_t)m * N + n] = acc[i][j] + bias[n];
    }
  }
}

// Step t of both directions: gates = gin[t] + h_{t-1} W_hh, then the cell.
// A block owns 8 hidden units with their 4 gate columns (lane = q * 8 + u
// owns column q H + j0 + u) for 16 items. h_{t-1} of the items is staged
// in shared memory KC values at a time; the 8 warps split the sum, each
// thread keeping 32 independent weight loads per chunk in flight, and meet
// in shared memory; the gates meet by warp shuffles.
__global__ void __launch_bounds__(RW * 32) lstm_step_kernel(
    const float* __restrict__ g, const float* __restrict__ wf,
    const float* __restrict__ wb, float* __restrict__ out,
    float* __restrict__ c, int t, int B, int T, int C, int H) {
  __shared__ __align__(16) float hs[RB][KC];
  __shared__ float red[RW][RB][32];
  const int z = blockIdx.z;
  const size_t N = 4 * (size_t)H;
  const float* Whh = (z ? wb : wf) + (size_t)C * N;
  const float* gin = g + ((size_t)z * T + t) * B * N;
  float* outz = out + (size_t)z * T * B * H;
  const float* hprev = t > 0 ? outz + (size_t)(t - 1) * B * H : outz;
  float* hout = outz + (size_t)t * B * H;
  float* cz = c + (size_t)z * B * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x * 8 + (lane & 7);
  const size_t col = (size_t)(lane >> 3) * H + j;
  const bool live = j < H;
  const int b0 = blockIdx.y * RB;
  const int nb = min(RB, B - b0);

  float acc[RB];
#pragma unroll
  for (int b = 0; b < RB; ++b) acc[b] = 0.f;
  for (int k0 = 0; t > 0 && k0 < H; k0 += KC) {
    for (int i = tid; i < RB * KC; i += RW * 32) {
      const int b = i / KC, k = k0 + i % KC;
      hs[b][i % KC] = (b < nb && k < H) ? hprev[(size_t)(b0 + b) * H + k]
                                        : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int i = 0; i < KC / (4 * RW); ++i) {
        const int q4 = warp + i * RW;
        const int k = k0 + 4 * q4;
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = k + q < H ? Whh[(size_t)(k + q) * N + col] : 0.f;
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          const float4 x = *reinterpret_cast<const float4*>(&hs[b][4 * q4]);
          acc[b] += x.x * w[0] + x.y * w[1] + x.z * w[2] + x.w * w[3];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < RB; ++b) red[warp][b][lane] = acc[b];
  __syncthreads();

  for (int b = warp; b < RB; b += RW) {
    const size_t row = (size_t)(b0 + b);
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < RW; ++w) v += red[w][b][lane];
    if (live && b < nb) v += gin[row * N + col];
    const int u = lane & 7;
    const float gi = __shfl_sync(0xffffffffu, v, u);
    const float gf = __shfl_sync(0xffffffffu, v, u + 8);
    const float gg = __shfl_sync(0xffffffffu, v, u + 16);
    const float go = __shfl_sync(0xffffffffu, v, u + 24);
    if (lane < 8 && live && b < nb) {
      const float cn = sigmoidf(gf) * cz[row * H + j]
                       + sigmoidf(gi) * tanhf(gg);
      cz[row * H + j] = cn;
      hout[row * H + j] = sigmoidf(go) * tanhf(cn);
    }
  }
}

}  // namespace

extern "C" {

// Launches 1 + T kernels on `stream`; returns the first CUDA error, else 0.
int bilstm_forward(const float* xt, const float* wf, const float* bf,
                   const float* wb, const float* bb, float* g, float* c,
                   float* out, int B, int T, int C, int H, void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = T * B, N = 4 * H;
  dim3 ggrid((N + TN - 1) / TN, (M + TM - 1) / TM, 2);
  input_gemm_kernel<<<ggrid, 256, 0, s>>>(xt, wf, wb, bf, bb, g, M, C, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 sgrid((H + RU - 1) / RU, (B + RB - 1) / RB, 2);
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<<<sgrid, RW * 32, 0, s>>>(g, wf, wb, out, c, t, B, T,
                                               C, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
