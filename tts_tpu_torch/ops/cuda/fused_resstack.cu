// One MelGAN residual block, fused, for Hopper (sm_90a), fp32.
//
// Replaces the per-block body of tts_tpu/ops/pallas/fused_resstack.py
// (`stack_body`, run by the pallas_call in `_fused_stack_packed`). For one
// block with dilation d:
//
//   h   = leaky(b1 + conv_k3_dilated_d(reflect_pad_d(leaky(x))))
//   out = bout + W2 . h + Wsc . x            (1x1 conv2 + 1x1 shortcut)
//
// Design. The TPU kernel held a whole item's time axis in VMEM and ran all
// blocks of a stack in one call. A Hopper block has at most 227 KB of shared
// memory, so time is tiled. Each CUDA block owns a (tile of time) x (one
// item) and stages x[:, t0 - d, t0 + tile + d) in shared memory, reflected at
// the sequence edges as it is loaded. One launch per residual block means the
// reflection is always applied to that block's own input (an intermediate of
// the stack), which is what torch's ReflectionPad1d in every block does, and
// no halo is recomputed. The cost is one extra read and write of the
// activation per block, which at these channel counts (24..192) is small
// next to the arithmetic: the block does 10*C MACs per element it moves.
//
// Bound on the card: operations. Everything is fp32 FMA on the CUDA cores
// (67 TFLOP/s peak on an H100 SXM); tensor cores (TF32) would break the 1e-4
// parity tolerance and are left for a later change. Each warp computes a
// 4-channel x (32*TB)-sample tile; lanes run along time, so shared-memory
// reads are conflict-free and each weight load is one float4 broadcast to
// the whole warp. Weights are grouped by those 4 output channels, so a warp
// streams one contiguous run of float4s through L1. leaky(x) is applied once,
// as the tile is staged.
//
// Layouts. x and out are addressed through (batch, channel, time) strides,
// so (B, C, T) and (B, T, C) tensors both work without a transpose.
// w1: (C/4, C_in, 3, 4); b1: (C); w2: (C/4, 2C, 4) over [h; x] (conv2 then
// shortcut); bout: (C) = conv2 bias + shortcut bias.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ int reflect_index(int g, int T) {
  if (g < 0) g = -g;
  if (g >= T) g = 2 * (T - 1) - g;
  return g < 0 ? 0 : (g >= T ? T - 1 : g);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

template <int TB>
__global__ void __launch_bounds__(kThreads)
resblock_kernel(const float* __restrict__ x, long sxb, long sxc, long sxt,
                float* __restrict__ out, long sob, long soc, long sot,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ bout,
                int C, int T, int d, int tile, float slope) {
  extern __shared__ float smem[];
  const int W = tile + 2 * d;
  float* ys = smem;           // [C][W]    leaky(block input), reflected halo
  float* hs = smem + C * W;   // [C][tile] leaky(conv1 output)
  const float inv_slope = 1.f / slope;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const float* xb = x + (long)b * sxb;
  for (int i = threadIdx.x; i < C * W; i += blockDim.x) {
    const int c = i / W;
    const int j = i - c * W;
    ys[i] = leaky(xb[(long)c * sxc + (long)reflect_index(t0 - d + j, T) * sxt],
                  slope);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int chunk = 32 * TB;
  const int n_cg = C >> 2;
  const int n_items = n_cg * (tile / chunk);

  // phase 1: dilated conv over leaky(x), then leaky
  for (int item = warp; item < n_items; item += nwarps) {
    const int cg = item % n_cg;
    const int col0 = (item / n_cg) * chunk + lane;
    const float4 bb = *reinterpret_cast<const float4*>(b1 + 4 * cg);
    // this group's weights, contiguous: (C_in, 3) float4s
    const float4* wg = reinterpret_cast<const float4*>(w1) + (long)cg * C * 3;
    float acc[4][TB];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      acc[0][i] = bb.x; acc[1][i] = bb.y; acc[2][i] = bb.z; acc[3][i] = bb.w;
    }
#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
      const float* yr = ys + ci * W + col0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 w = __ldg(wg + ci * 3 + k);
#pragma unroll
        for (int i = 0; i < TB; ++i) {
          const float v = yr[32 * i + k * d];
          acc[0][i] = fmaf(w.x, v, acc[0][i]);
          acc[1][i] = fmaf(w.y, v, acc[1][i]);
          acc[2][i] = fmaf(w.z, v, acc[2][i]);
          acc[3][i] = fmaf(w.w, v, acc[3][i]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < TB; ++i)
        hs[(4 * cg + c) * tile + col0 + 32 * i] = leaky(acc[c][i], slope);
  }
  __syncthreads();

  // phase 2: 1x1 conv2 over h plus 1x1 shortcut over x, with x recovered
  // from leaky(x) (exact for x > 0, within an ulp below)
  for (int item = warp; item < n_items; item += nwarps) {
    const int cg = item % n_cg;
    const int col0 = (item / n_cg) * chunk + lane;
    const float4 bb = *reinterpret_cast<const float4*>(bout + 4 * cg);
    const float4* wg = reinterpret_cast<const float4*>(w2) + (long)cg * 2 * C;
    float acc[4][TB];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      acc[0][i] = bb.x; acc[1][i] = bb.y; acc[2][i] = bb.z; acc[3][i] = bb.w;
    }
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      const float4 wh = __ldg(wg + ci);
      const float4 wx = __ldg(wg + C + ci);
      const float* hr = hs + ci * tile + col0;
      const float* yr = ys + ci * W + d + col0;
#pragma unroll
      for (int i = 0; i < TB; ++i) {
        const float h = hr[32 * i];
        const float y = yr[32 * i];
        const float v = y > 0.f ? y : y * inv_slope;
        acc[0][i] = fmaf(wx.x, v, fmaf(wh.x, h, acc[0][i]));
        acc[1][i] = fmaf(wx.y, v, fmaf(wh.y, h, acc[1][i]));
        acc[2][i] = fmaf(wx.z, v, fmaf(wh.z, h, acc[2][i]));
        acc[3][i] = fmaf(wx.w, v, fmaf(wh.w, h, acc[3][i]));
      }
    }
    float* ob = out + (long)b * sob;
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const int t = t0 + col0 + 32 * i;
      if (t < T) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ob[(long)(4 * cg + c) * soc + (long)t * sot] = acc[c][i];
      }
    }
  }
}

template <int TB>
cudaError_t launch(const float* x, long sxb, long sxc, long sxt, float* out,
                   long sob, long soc, long sot, const float* w1,
                   const float* b1, const float* w2, const float* bout, int B,
                   int C, int T, int d, int tile, float slope,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)C * (2 * tile + 2 * d);
  static bool opted_in = false;  // the opt-in is per kernel, not per launch
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        resblock_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  dim3 grid((T + tile - 1) / tile, B);
  resblock_kernel<TB><<<grid, kThreads, smem, stream>>>(
      x, sxb, sxc, sxt, out, sob, soc, sot, w1, b1, w2, bout, C, T, d, tile,
      slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The time tile a block of C channels and dilation d uses: a power of two
// in [32, 512] with C * tile <= 12288 (about the same arithmetic per CUDA
// block at every stage) and at most ~110 KB of shared memory, so two blocks
// fit on one SM. A width that needs more than 227 KB even at 32 makes the
// launch fail, and the wrapper raises.
static int resblock_tile(int C, int d) {
  int tile = 512;
  while (tile > 32 && ((long)C * tile > 12288 ||
                       4L * C * (2 * tile + 2 * d) > 110 * 1024))
    tile /= 2;
  return tile;
}

int resblock_forward(const float* x, long sxb, long sxc, long sxt, float* out,
                     long sob, long soc, long sot, const float* w1,
                     const float* b1, const float* w2, const float* bout,
                     int B, int C, int T, int d, float slope, void* stream) {
  const int tile = resblock_tile(C, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile >= 128)
    return (int)launch<4>(x, sxb, sxc, sxt, out, sob, soc, sot, w1, b1, w2,
                          bout, B, C, T, d, tile, slope, s);
  if (tile == 64)
    return (int)launch<2>(x, sxb, sxc, sxt, out, sob, soc, sot, w1, b1, w2,
                          bout, B, C, T, d, tile, slope, s);
  return (int)launch<1>(x, sxb, sxc, sxt, out, sob, soc, sot, w1, b1, w2,
                        bout, B, C, T, d, tile, slope, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
