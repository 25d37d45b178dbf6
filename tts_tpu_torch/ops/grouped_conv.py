"""Grouped strided 1-d conv whose gradients run on hand-written kernels
(≙ tts_tpu/ops/pallas/grouped_conv_grad.py: ``grouped_conv_wgrad``,
``grouped_conv_dgrad``, ``grouped_conv_pallas_wgrad``), in NCW layout.

y = conv1d(x, W, stride s, zero padding (k - 1) // 2, groups G), x (B, G m,
L), W (G n, m, k), dy (B, G n, L_out):

    dW[g n + j, i, t] = sum_{b, l} x[b, g m + i, s l + t - pad] dy[b, g n + j, l]

and dx is its transpose. ``grouped_conv`` runs the forward as the library
conv (tts_tpu leaves it to XLA) and its backward through
``grouped_conv_wgrad`` / ``grouped_conv_dgrad``: the CUDA kernels
(``ops/cuda/grouped_conv_grad.cu``) for CUDA tensors, the plain tap loops
``*_torch`` for CPU tensors. As in tts_tpu, the gradients are computed in
float32 whatever the operands' dtype and returned in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tts_tpu_torch.ops.cuda import grouped_conv_grad as gc_cuda


def grouped_conv_wgrad_torch(x: torch.Tensor, dy: torch.Tensor,
                             kernel_size: int, stride: int, groups: int
                             ) -> torch.Tensor:
    """dW (cout, cin // groups, k), the plain version: one product per
    tap."""
    B, cin, _ = x.shape
    cout, Lout = dy.shape[1], dy.shape[2]
    g, m, n = groups, cin // groups, cout // groups
    pad = (kernel_size - 1) // 2
    xp = F.pad(x, (pad, pad))
    dyg = dy.reshape(B, g, n, Lout)
    taps = []
    for t in range(kernel_size):
        sl = xp[:, :, t:t + stride * (Lout - 1) + 1:stride]
        taps.append(torch.einsum("bgml,bgnl->gnm",
                                 sl.reshape(B, g, m, Lout), dyg))
    return torch.stack(taps, dim=-1).reshape(cout, m, kernel_size)


def grouped_conv_dgrad_torch(dy: torch.Tensor, weight: torch.Tensor,
                             x_len: int, stride: int, groups: int
                             ) -> torch.Tensor:
    """dx (B, cin, x_len), the plain version: each tap's contribution
    scattered into the padded input, then the padding cropped."""
    B, cout, Lout = dy.shape
    _, m, k = weight.shape
    g, n = groups, cout // groups
    pad = (k - 1) // 2
    dxp = dy.new_zeros((B, g * m, x_len + 2 * pad))
    w = weight.reshape(g, n, m, k)
    dyg = dy.reshape(B, g, n, Lout)
    for t in range(k):
        part = torch.einsum("bgnl,gnm->bgml", dyg, w[..., t])
        dxp[:, :, t:t + stride * (Lout - 1) + 1:stride] += part.reshape(
            B, g * m, Lout)
    return dxp[:, :, pad:pad + x_len]


def grouped_conv_wgrad(x: torch.Tensor, dy: torch.Tensor, kernel_size: int,
                       stride: int, groups: int) -> torch.Tensor:
    """dW in x's dtype: the kernel for CUDA tensors, the plain version for
    CPU tensors, in float32."""
    x32, dy32 = x.float().contiguous(), dy.float().contiguous()
    if x.device.type == "cpu":
        dw = grouped_conv_wgrad_torch(x32, dy32, kernel_size, stride, groups)
    else:
        dw = gc_cuda.grouped_conv_wgrad_cuda(x32, dy32, kernel_size, stride,
                                             groups)
    return dw.to(x.dtype)


def grouped_conv_dgrad(dy: torch.Tensor, weight: torch.Tensor, x_len: int,
                       stride: int, groups: int) -> torch.Tensor:
    """dx in dy's dtype: the kernel for CUDA tensors, the plain version for
    CPU tensors, in float32."""
    dy32, w32 = dy.float().contiguous(), weight.float().contiguous()
    if dy.device.type == "cpu":
        dx = grouped_conv_dgrad_torch(dy32, w32, x_len, stride, groups)
    else:
        dx = gc_cuda.grouped_conv_dgrad_cuda(dy32, w32, x_len, stride, groups)
    return dx.to(dy.dtype)


class GroupedConv(torch.autograd.Function):
    """conv1d(x, weight, stride, padding (k - 1) // 2, groups) without bias;
    the backward computes only the gradients autograd asks for."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, stride: int,
                groups: int):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (stride, groups)
        return F.conv1d(x, weight, None, stride, (weight.shape[-1] - 1) // 2,
                        1, groups)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, weight = ctx.saved_tensors
        stride, groups = ctx.geometry
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_conv_dgrad(dy, weight, x.shape[-1], stride, groups)
        if ctx.needs_input_grad[1]:
            dw = grouped_conv_wgrad(x, dy, weight.shape[-1], stride, groups)
        return dx, dw, None, None


def grouped_conv(x: torch.Tensor, weight: torch.Tensor, stride: int,
                 groups: int) -> torch.Tensor:
    return GroupedConv.apply(x, weight, stride, groups)
