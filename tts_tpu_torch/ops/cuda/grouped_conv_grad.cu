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
// 134 MB, 0.040 ms at 3.35 TB/s, against 1.4 GFLOP (0.020 ms at 67 TFLOP/s).
//
// wgrad design. The TPU kernel accumulates dW over a sequential grid; CUDA
// blocks run in parallel, so the sum is split in two deterministic passes.
// Pass 1: a block takes one group and one chunk of up to 1024 output
// positions of one item. It stages the chunk's x with its (k - 1)-sample
// halo in shared memory split by phase (xs[t mod s][l + t / s] holds sample
// s l + t - pad, so lanes on consecutive l read consecutive words) and the
// group's n dy rows. Warp w owns taps w, w + 8, ...; each lane walks l in
// steps of 32, reads the n dy values once and multiplies them into every tap
// it owns; the lanes' sums meet by warp shuffles, and lane 0 writes the
// block's (n x k) partial. Pass 2 sums the partials of all chunks of every
// weight in chunk order. No atomics: dW is the same from run to run.
//
// dgrad design (gather form, no atomics). Padded sample q = p + pad of
// input g receives tap t = s u + (q mod s) from dy[., ., q / s - u]. A
// thread owns one q / s = v, so its s samples (one per phase) read the same
// n dy values for each u; the group's weights sit in shared memory as
// (u, j, phase) float4s, so one broadcast 16-byte load serves a (u, j) for
// all phases. Samples of the padding are not written: the kernel crops them.
//
// Takes: m = 1, 1 <= n <= 4, 1 <= s <= 4, odd k <= 63.
// Layouts: x, dx (B, G, L); dy (B, G n, L_out); W, dW (G n, 1, k); float32.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 63;
constexpr int MAX_N = 4;
constexpr int MAX_S = 4;
constexpr int TAPS_PER_WARP = (MAX_K + WARPS - 1) / WARPS;   // 8
constexpr int LC = 1024;                     // wgrad: outputs per chunk
// wgrad: one phase row holds LC + (k - 1) / s samples, rounded up to a
// multiple of 32 plus 8 so the s rows start in different banks
constexpr int XS_ROW_MAX = ((LC + MAX_K + 31) / 32) * 32 + 8;
constexpr int VC = THREADS;                  // dgrad: v positions per block
constexpr int U_MAX = MAX_K;                 // dgrad: taps per phase (s = 1)

__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const float* __restrict__ x,
                     const float* __restrict__ dy,
                     float* __restrict__ partial, int G, int n, int L,
                     int Lout, int k, int s, int pad, int n_lchunks) {
  __shared__ float xs[MAX_S * XS_ROW_MAX];
  __shared__ float dys[MAX_N * LC];

  const int gi = blockIdx.x % G;
  const int chunk = blockIdx.x / G;
  const int b = chunk / n_lchunks;
  const int l0 = (chunk % n_lchunks) * LC;
  const int nl = min(LC, Lout - l0);
  const int row_len = nl + (k - 1) / s;
  const int row = ((row_len + 31) / 32) * 32 + 8;
  const int cout = G * n;

  const float* xg = x + ((size_t)b * G + gi) * L;
  const int p_base = s * l0 - pad;
  for (int i = threadIdx.x; i < s * row_len; i += THREADS) {
    const int p = p_base + i;
    xs[(i % s) * row + i / s] = (p >= 0 && p < L) ? xg[p] : 0.f;
  }
  const float* dyg = dy + ((size_t)b * cout + gi * n) * Lout + l0;
  for (int i = threadIdx.x; i < n * nl; i += THREADS) {
    const int j = i / nl, l = i % nl;
    dys[j * LC + l] = dyg[(size_t)j * Lout + l];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int offs[TAPS_PER_WARP];
#pragma unroll
  for (int u = 0; u < TAPS_PER_WARP; ++u) {
    const int t = warp + WARPS * u;
    offs[u] = t < k ? (t % s) * row + t / s : 0;
  }
  float acc[TAPS_PER_WARP][MAX_N];
#pragma unroll
  for (int u = 0; u < TAPS_PER_WARP; ++u)
#pragma unroll
    for (int j = 0; j < MAX_N; ++j) acc[u][j] = 0.f;

  for (int l = lane; l < nl; l += 32) {
    float d[MAX_N];
#pragma unroll
    for (int j = 0; j < MAX_N; ++j) d[j] = j < n ? dys[j * LC + l] : 0.f;
#pragma unroll
    for (int u = 0; u < TAPS_PER_WARP; ++u) {
      if (warp + WARPS * u < k) {
        const float xv = xs[offs[u] + l];
#pragma unroll
        for (int j = 0; j < MAX_N; ++j) acc[u][j] = fmaf(xv, d[j], acc[u][j]);
      }
    }
  }

  float* out = partial + (size_t)chunk * cout * k;
#pragma unroll
  for (int u = 0; u < TAPS_PER_WARP; ++u) {
    const int t = warp + WARPS * u;
#pragma unroll
    for (int j = 0; j < MAX_N; ++j) {
      float v = acc[u][j];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0 && t < k && j < n) out[(size_t)(gi * n + j) * k + t] = v;
    }
  }
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dw, int n_chunks,
                                    int n_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float sum = 0.f;
  for (int c = 0; c < n_chunks; ++c) sum += partial[(size_t)c * n_out + o];
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

cudaError_t check_geometry(int n, int k, int s, int pad, int L, int Lout) {
  if (n < 1 || n > MAX_N || s < 1 || s > MAX_S || k < 1 || k > MAX_K ||
      k % 2 == 0 || pad != (k - 1) / 2 || L < 1 ||
      Lout != (L + 2 * pad - k) / s + 1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dW (G n, 1, k) from x (B, G, L) and dy (B, G n, Lout); partial is
// scratch of B * ceil(Lout / 1024) * G n * k floats.
int grouped_conv_wgrad_forward(const float* x, const float* dy, float* dw,
                               float* partial, int B, int G, int n, int L,
                               int Lout, int k, int s, int pad,
                               void* stream) {
  cudaError_t err = check_geometry(n, k, s, pad, L, Lout);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_lchunks = (Lout + LC - 1) / LC;
  const int n_chunks = B * n_lchunks;
  wgrad_partial_kernel<<<n_chunks * G, THREADS, 0, st>>>(
      x, dy, partial, G, n, L, Lout, k, s, pad, n_lchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = G * n * k;
  wgrad_reduce_kernel<<<(n_out + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      partial, dw, n_chunks, n_out);
  return (int)cudaGetLastError();
}

// dx (B, G, L) from dy (B, G n, Lout) and W (G n, 1, k).
int grouped_conv_dgrad_forward(const float* dy, const float* w, float* dx,
                               int B, int G, int n, int L, int Lout, int k,
                               int s, int pad, void* stream) {
  cudaError_t err = check_geometry(n, k, s, pad, L, Lout);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || G < 1) return (int)cudaErrorInvalidValue;
  // v = q / s over the padded samples q = p + pad of p in [0, L)
  const int v_first = pad / s;
  const int v_last = (pad + L - 1) / s;
  const int n_vchunks = (v_last - v_first + VC) / VC;
  dgrad_kernel<<<B * n_vchunks * G, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      dy, w, dx, G, n, L, Lout, k, s, pad, v_first, n_vchunks);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
