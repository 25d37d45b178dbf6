// STFT magnitude of framed audio for the GAN spectral losses, for Hopper
// (sm_90a), fp32.
//
// Replaces tts_tpu/ops/pallas/stft_kernel.py (`_mag_kernel`, run by the
// pallas_call in `_mag_fwd`, entry `stft_magnitude`). For frames (N, K)
// (K = n_fft samples each, window folded into the banks) and the
// window-folded real-DFT banks wr, wi (K, F), F = n_fft / 2 + 1:
//
//   mag[r, f] = sqrt((sum_k fr[r,k] wr[k,f])^2 + (sum_k fr[r,k] wi[k,f])^2
//                    + 1e-12)
//
// The complex spectrum never reaches device memory: both products share the
// frames tile and the magnitude is taken in the epilogue, as the TPU kernel
// does on its matrix unit.
//
// Bound on the card: operations. 4 N K F fp32 FLOPs (two products) against
// 4 (N K + 2 K F + N F) bytes; at n_fft 2048 on 64 x 16384 samples that is
// 37.1 GFLOP (0.55 ms at 67 TFLOP/s) against ~71 MB (0.02 ms). The work
// is fp32 on the CUDA cores (no TF32: the losses' tolerance is fp32's).
//
// Design: a plain shared-memory SGEMM with two accumulators. A block
// computes a 64-frame x 64-bin tile; the K loop stages 16 columns of the
// frames (stored transposed, rows padded to 68 floats so that the
// transposing stores hit few bank conflicts and each thread's 4 frames read
// as one float4) and 16 rows of each bank. Each of the 256 threads keeps a
// 4 x 4 tile of re and of im in registers: per k, three 16-byte shared loads
// feed 32 FMAs. Ragged edges (odd n_fft 171 and 683; bins 86 ... 1025, no
// multiple of 64) are zero-filled on load and masked on store. The TPU
// kernel's bins tiling for VMEM (btile 256) is not carried over.
//
// Layouts: frames (N, K), wr / wi (K, F), mag (N, F); row-major float32.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // frames per block tile
constexpr int BN = 64;        // bins per block tile
constexpr int BK = 16;        // samples per K step
constexpr int TM = 4;         // frames per thread
constexpr int TN = 4;         // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr float kEps = 1e-12f;

__global__ void __launch_bounds__(THREADS)
stft_mag_kernel(const float* __restrict__ frames,
                const float* __restrict__ wr,
                const float* __restrict__ wi,
                float* __restrict__ mag, int N, int K, int F) {
  __shared__ __align__(16) float fr_s[BK][BM + 4];
  __shared__ __align__(16) float wr_s[BK][BN];
  __shared__ __align__(16) float wi_s[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float re[TM][TN];
  float im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / THREADS; ++s) {
      const int i = tid + s * THREADS;
      const int r = i / BK, k = i % BK;
      const int gr = row0 + r, gk = k0 + k;
      fr_s[k][r] = (gr < N && gk < K) ? frames[(size_t)gr * K + gk] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < BK * BN / THREADS; ++s) {
      const int i = tid + s * THREADS;
      const int k = i / BN, c = i % BN;
      const int gk = k0 + k, gc = col0 + c;
      const bool ok = gk < K && gc < F;
      const size_t at = (size_t)gk * F + gc;
      wr_s[k][c] = ok ? wr[at] : 0.f;
      wi_s[k][c] = ok ? wi[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&fr_s[k][ty * TM]);
      const float4 r = *reinterpret_cast<const float4*>(&wr_s[k][tx * TN]);
      const float4 m = *reinterpret_cast<const float4*>(&wi_s[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float rv[TN] = {r.x, r.y, r.z, r.w};
      const float mv[TN] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          re[i][j] = fmaf(av[i], rv[j], re[i][j]);
          im[i][j] = fmaf(av[i], mv[j], im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < F)
        mag[(size_t)r * F + c] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j] + kEps);
    }
  }
}

}  // namespace

extern "C" {

int stft_mag_forward(const float* frames, const float* wr, const float* wi,
                     float* mag, int N, int K, int F, void* stream) {
  if (N == 0 || F == 0) return (int)cudaSuccess;
  if (N < 0 || K <= 0 || F < 0 || (F + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BM - 1) / BM, (F + BN - 1) / BN);
  stft_mag_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, wr, wi, mag, N, K, F);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
