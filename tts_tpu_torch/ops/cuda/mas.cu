// Monotonic alignment search (MAS) for Glow-TTS training, for Hopper
// (sm_90a), fp32.
//
// Replaces tts_tpu/ops/pallas/mas_kernel.py (`_mas_kernel`, run by the
// pallas_call in `maximum_path_pallas`). Per item b with lengths (t_x, t_y)
// it runs the max-plus dynamic program over mel columns y < t_y,
//
//   stay      = (x == y) ? NEG : prev[x]
//   diag      = x == 0 ? (y == 0 ? 0 : NEG) : prev[x - 1]
//   dec[y][x] = diag >= stay
//   cur[x]    = max(stay, diag) + value[x][y]
//
// then backtracks from x = t_x - 1 over y = t_y - 1 .. 0, writing
// path[x][y] = 1 and stepping x -= 1 where dec[y][x] is set and y > 0. The
// backtrack never steps below x = 0 (the guard of tts_tpu's numpy oracle;
// the Pallas kernel would roll x = 0 over to T_x - 1 instead). The order of
// operations is kept (one max, then one add; no FMA can form) and so is the
// tie rule >=, so the path equals the plain PyTorch version bit for bit.
//
// Design. One CUDA block per item, threads over text positions (each thread
// loops over x in steps of blockDim when T_x is larger). The DP row is
// double-buffered in shared memory, with one __syncthreads per column.
// Decisions go to a global (B, T_y, T_x) byte scratch that the wrapper
// allocates. The block zero-fills its item's path, then one thread walks the
// backtrack. `value` arrives transposed to (B, T_y, T_x) (the wrapper does
// it once, as the JAX wrapper does), so each column is one coalesced row.
// Columns y >= t_y and rows x >= t_x come out 0.
//
// Bound on the card: bytes. The function reads value inside the lengths and
// the mask once and writes the path once: at most 12 bytes per (x, y), at
// 3.35 TB/s (the decision scratch is this kernel's own choice and is not
// counted; it adds 1 byte per cell of traffic). Its real limit is
// latency: a serial chain of t_y dependent columns (one barrier and one
// global load each), then a t_y-step backtrack of dependent byte loads by
// one thread. A batch uses B blocks of the 132 SMs.
//
// Layouts. value_t, dec: (B, T_y, T_x); path: (B, T_x, T_y), float32;
// t_xs, t_ys: (B) int32.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;

__global__ void mas_kernel(const float* __restrict__ value_t,
                           const int* __restrict__ t_xs,
                           const int* __restrict__ t_ys,
                           float* __restrict__ path,
                           unsigned char* __restrict__ dec, int T_x, int T_y) {
  extern __shared__ float rows[];
  const int b = blockIdx.x;
  const int tx = t_xs[b];
  const int ty = t_ys[b];
  const float* v = value_t + (size_t)b * T_y * T_x;
  unsigned char* d = dec + (size_t)b * T_y * T_x;
  float* p = path + (size_t)b * T_x * T_y;

  for (size_t i = threadIdx.x; i < (size_t)T_x * T_y; i += blockDim.x)
    p[i] = 0.f;
  float* prev = rows;
  float* cur = rows + T_x;
  for (int x = threadIdx.x; x < T_x; x += blockDim.x) prev[x] = kNeg;
  __syncthreads();

  for (int y = 0; y < ty; ++y) {
    const float* vy = v + (size_t)y * T_x;
    unsigned char* dy = d + (size_t)y * T_x;
    for (int x = threadIdx.x; x < tx; x += blockDim.x) {
      const float val = vy[x];
      const float stay = (x == y) ? kNeg : prev[x];
      const float diag = x == 0 ? (y == 0 ? 0.f : kNeg) : prev[x - 1];
      dy[x] = diag >= stay ? 1 : 0;
      cur[x] = fmaxf(stay, diag) + val;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  // the decisions and the zero-filled path are visible to the whole block
  // after this barrier
  __syncthreads();
  if (threadIdx.x == 0 && tx > 0) {
    int x = tx - 1;
    for (int y = ty - 1; y >= 0; --y) {
      p[(size_t)x * T_y + y] = 1.f;
      if (y > 0 && x > 0 && d[(size_t)y * T_x + x]) --x;
    }
  }
}

}  // namespace

extern "C" {

int mas_forward(const float* value_t, const int* t_xs, const int* t_ys,
                float* path, unsigned char* dec, int B, int T_x, int T_y,
                void* stream) {
  if (B == 0 || T_x == 0 || T_y == 0) return (int)cudaSuccess;
  int threads = ((T_x + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = 2 * sizeof(float) * (size_t)T_x;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mas_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      value_t, t_xs, t_ys, path, dec, T_x, T_y);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
