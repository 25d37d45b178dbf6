"""The whole eval-mode Glow-TTS encoder as one call (≙ tts_tpu/ops/pallas/
fused_glow_encoder.py: ``REL_W``, ``pack_glow_encoder_params``, the kernel
body ``_make_kernel`` and ``fused_glow_encoder_apply``).

From the embedded text (B, T, C) and the mask to (means | log-scales |
log-durations) (B, T, 2 n_out + 1), as the kernel body computes it:

- prenet: n_pre x (conv k_pre of the masked input -> LayerNorm -> ReLU),
  then x = (x + proj(y)) * m;
- each layer: q | k | v of x * m; rel-pos attention (window 4, relative
  embeddings zero outside it; key columns beyond the length set to -1e4, so
  padded query rows see a softmax over the valid keys); x = LN(x + out);
  y = relu(conv(x * m)); y = conv(y * m) * m; x = LN(x + y);
- x = x * m; means = proj_mean(x) * m; log-scales zero (mean_only);
  duration predictor 2 x (conv k_dp of the masked input -> ReLU -> LN),
  log-durations = proj(y * m) * m.

Convs are products of tap-concatenated shifted rows, zero across item
edges (tts_tpu's ``_shift_rows`` / ``_conv_op``); LayerNorm eps 1e-4.

``fused_glow_encoder`` is the entry: the embedding lookup times sqrt(C)
runs outside the kernel, as in tts_tpu; a CUDA tensor then runs the
hand-written kernels (``ops/cuda/glow_encoder.cu``), a CPU tensor the plain
version ``glow_encoder_torch``. Both are float32 and eval-mode only (no
dropout, no gradient).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from tts_tpu_torch.ops.cuda import glow_encoder as glow_encoder_cuda
from tts_tpu_torch.ops.masking import sequence_mask

REL_W = 4  # the relative window the kernel computes (tts_tpu's REL_W)


class EncoderDims(NamedTuple):
    hidden: int
    filt: int
    filt_dp: int
    heads: int
    layers: int
    n_out: int
    k_pre: int
    n_pre: int
    k_ffn: int
    k_dp: int


class PackedGlowEncoder(NamedTuple):
    """The kernel's operands: every weight in one float32 buffer, in
    tts_tpu's packing order (q, k and v as one (C, 3C) product)."""
    flat: torch.Tensor
    dims: EncoderDims


def supports_fused_encoder(enc) -> bool:
    """The configuration B3 computes: the port's ``GlowTTSEncoder``
    (transformer, prenet, mean_only; the gated-conv and time-depth-separable
    encoders are refused) of one speaker (no speaker channels
    into the duration predictor: B3 takes no conditioning, as tts_tpu's
    Pallas encoder) with window 4 in every layer, and LayerNorm widths
    (hidden, duration filter) of at most 256, which one block of the kernel
    holds. Depends on the configuration only."""
    from tts_tpu_torch.models.glow.encoder import GlowTTSEncoder
    if (not isinstance(enc, GlowTTSEncoder) or enc.c_in_channels
            or enc.encoder_type != "transformer"):
        return False
    tr = enc.encoder
    return (all(a.window == REL_W for a in tr.attn_layers)
            and enc.hidden_channels <= 256
            and enc.duration_predictor.conv_1.out_channels <= 256)


def fused_encoder_max_length(enc, device: torch.device):
    """The longest text ``fused_glow_encoder`` runs for ``enc`` on
    ``device``: on a CUDA device what the attention kernel's shared memory
    holds (``ops/cuda/glow_encoder.py::max_text_length``); None on the CPU,
    whose plain version has no limit."""
    if device.type == "cpu":
        return None
    kc = enc.hidden_channels // enc.encoder.attn_layers[0].num_heads
    return glow_encoder_cuda.max_text_length(kc, device)


def _layout(d: EncoderDims) -> List[Tuple[str, tuple]]:
    """(name, shape) of every packed weight, in the kernel's order."""
    C, F_, Fd, kc = d.hidden, d.filt, d.filt_dp, d.hidden // d.heads
    nr = 2 * REL_W + 1
    out = []
    for i in range(d.n_pre):
        out += [(f"pre{i}.w", (d.k_pre * C, C)), (f"pre{i}.b", (C,)),
                (f"pre{i}.g", (C,)), (f"pre{i}.beta", (C,))]
    out += [("pre.proj.w", (C, C)), ("pre.proj.b", (C,))]
    for i in range(d.layers):
        out += [(f"l{i}.qkv.w", (C, 3 * C)), (f"l{i}.qkv.b", (3 * C,)),
                (f"l{i}.erk", (nr, kc)), (f"l{i}.erv", (nr, kc)),
                (f"l{i}.o.w", (C, C)), (f"l{i}.o.b", (C,)),
                (f"l{i}.ln1.g", (C,)), (f"l{i}.ln1.b", (C,)),
                (f"l{i}.f1.w", (d.k_ffn * C, F_)), (f"l{i}.f1.b", (F_,)),
                (f"l{i}.f2.w", (d.k_ffn * F_, C)), (f"l{i}.f2.b", (C,)),
                (f"l{i}.ln2.g", (C,)), (f"l{i}.ln2.b", (C,))]
    out += [("mean.w", (C, d.n_out)), ("mean.b", (d.n_out,))]
    out += [("dp1.w", (d.k_dp * C, Fd)), ("dp1.b", (Fd,)), ("dp1.g", (Fd,)),
            ("dp1.beta", (Fd,)), ("dp2.w", (d.k_dp * Fd, Fd)),
            ("dp2.b", (Fd,)), ("dp2.g", (Fd,)), ("dp2.beta", (Fd,)),
            ("dp.proj.w", (Fd, 1)), ("dp.proj.b", (1,))]
    return out


def unpack(packed: PackedGlowEncoder) -> Dict[str, torch.Tensor]:
    """Views of the packed buffer by name (``_layout``)."""
    views, at = {}, 0
    for name, shape in _layout(packed.dims):
        n = math.prod(shape)
        views[name] = packed.flat[at:at + n].view(shape)
        at += n
    if at != packed.flat.numel():
        raise ValueError(f"glow encoder: {packed.flat.numel()} packed "
                         f"weights for a layout of {at}")
    return views


def _tap_major(conv: torch.nn.Conv1d) -> torch.Tensor:
    """torch Conv1d weight (out, in, k) -> (k * in, out): row j * in + c is
    tap j (input row t + j - k // 2) of input channel c."""
    w = conv.weight
    return w.permute(2, 1, 0).reshape(-1, w.shape[0])


@torch.no_grad()
def pack_glow_encoder_params(enc, device=None) -> PackedGlowEncoder:
    """A port ``GlowTTSEncoder`` that ``supports_fused_encoder`` accepts ->
    the kernel's operands, float32 on ``device`` (the module's when None)."""
    if not supports_fused_encoder(enc):
        raise ValueError("this Glow-TTS encoder is not supported by the "
                         "fused encoder (window 4, widths <= 256)")
    pre, tr, dp = enc.pre, enc.encoder, enc.duration_predictor
    att0 = tr.attn_layers[0]
    dims = EncoderDims(
        hidden=enc.hidden_channels, filt=tr.ffn_layers[0].conv_1.out_channels,
        filt_dp=dp.conv_1.out_channels, heads=att0.num_heads,
        layers=len(tr.attn_layers), n_out=enc.proj_m.out_channels,
        k_pre=pre.conv_layers[0].kernel_size[0], n_pre=len(pre.conv_layers),
        k_ffn=tr.ffn_layers[0].conv_1.kernel_size[0],
        k_dp=dp.conv_1.kernel_size[0])
    parts: List[torch.Tensor] = []
    for conv, norm in zip(pre.conv_layers, pre.norm_layers):
        parts += [_tap_major(conv), conv.bias, norm.gamma, norm.beta]
    parts += [_tap_major(pre.proj), pre.proj.bias]
    for att, ln1, ffn, ln2 in zip(tr.attn_layers, tr.norm_layers_1,
                                  tr.ffn_layers, tr.norm_layers_2):
        qkv = (att.conv_q, att.conv_k, att.conv_v)
        parts += [torch.cat([_tap_major(c) for c in qkv], dim=1),
                  torch.cat([c.bias for c in qkv]),
                  att.emb_rel_k[0], att.emb_rel_v[0],
                  _tap_major(att.conv_o), att.conv_o.bias, ln1.gamma,
                  ln1.beta, _tap_major(ffn.conv_1), ffn.conv_1.bias,
                  _tap_major(ffn.conv_2), ffn.conv_2.bias, ln2.gamma,
                  ln2.beta]
    parts += [_tap_major(enc.proj_m), enc.proj_m.bias]
    parts += [_tap_major(dp.conv_1), dp.conv_1.bias, dp.norm_1.gamma,
              dp.norm_1.beta, _tap_major(dp.conv_2), dp.conv_2.bias,
              dp.norm_2.gamma, dp.norm_2.beta, _tap_major(dp.proj),
              dp.proj.bias]
    device = enc.emb.weight.device if device is None else device
    flat = torch.cat([p.detach().float().reshape(-1) for p in parts])
    packed = PackedGlowEncoder(flat.to(device).contiguous(), dims)
    unpack(packed)  # the layout and the parts agree
    return packed


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          k: int) -> torch.Tensor:
    """SAME conv of (B, T, C_in) with tap-major w (k * C_in, N): the taps
    concatenated along channels, zero rows beyond each item's edges."""
    if k > 1:
        h, T = k // 2, x.shape[1]
        xp = F.pad(x, (0, 0, h, h))
        x = torch.cat([xp[:, j:j + T] for j in range(k)], dim=-1)
    return x @ w + b


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), g, b, 1e-4)


def _diagonal_rows(T: int, off: int) -> slice:
    """The query rows i of the diagonal j = i + off of a (T, T) matrix."""
    return slice(max(0, -off), T - max(0, off))


def _attention(qkv: torch.Tensor, erk: torch.Tensor, erv: torch.Tensor,
               key_ok: torch.Tensor, heads: int) -> torch.Tensor:
    """Rel-pos multi-head attention of (B, T, 3C) q | k | v -> (B, T, C)."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    kc = C // heads
    q, k, v = qkv.view(B, T, 3, heads, kc).permute(2, 0, 3, 1, 4)
    scale = 1.0 / math.sqrt(kc)
    scores = (q @ k.transpose(-1, -2)) * scale              # (B, H, T, T)
    rel = (q @ erk.t()) * scale                             # (B, H, T, 2W+1)
    for r in range(2 * REL_W + 1):
        off = r - REL_W
        torch.diagonal(scores, off, -2, -1).add_(
            rel[..., _diagonal_rows(T, off), r])
    scores = scores.masked_fill(~key_ok[:, None, None, :], -1e4)
    p = torch.softmax(scores, dim=-1)
    out = p @ v
    band = p.new_zeros(B, heads, T, 2 * REL_W + 1)
    for r in range(2 * REL_W + 1):
        off = r - REL_W
        band[..., _diagonal_rows(T, off), r] = torch.diagonal(p, off, -2, -1)
    out = out + band @ erv
    return out.permute(0, 2, 1, 3).reshape(B, T, C)


def glow_encoder_torch(packed: PackedGlowEncoder, emb: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """The plain version: emb (B, T, C) the embedded text, mask (B, T) 1/0
    -> (B, T, 2 n_out + 1) means | log-scales (zero) | log-durations,
    float32."""
    d, p = packed.dims, unpack(packed)
    m = mask.to(emb.dtype)[..., None]
    x = emb
    y = x
    for i in range(d.n_pre):
        y = _conv(y * m, p[f"pre{i}.w"], p[f"pre{i}.b"], d.k_pre)
        y = torch.relu(_ln(y, p[f"pre{i}.g"], p[f"pre{i}.beta"]))
    x = (x + y @ p["pre.proj.w"] + p["pre.proj.b"]) * m
    key_ok = mask > 0
    for i in range(d.layers):
        qkv = (x * m) @ p[f"l{i}.qkv.w"] + p[f"l{i}.qkv.b"]
        att = _attention(qkv, p[f"l{i}.erk"], p[f"l{i}.erv"], key_ok,
                         d.heads)
        x = _ln(x + att @ p[f"l{i}.o.w"] + p[f"l{i}.o.b"], p[f"l{i}.ln1.g"],
                p[f"l{i}.ln1.b"])
        y = torch.relu(_conv(x * m, p[f"l{i}.f1.w"], p[f"l{i}.f1.b"],
                             d.k_ffn))
        y = _conv(y * m, p[f"l{i}.f2.w"], p[f"l{i}.f2.b"], d.k_ffn) * m
        x = _ln(x + y, p[f"l{i}.ln2.g"], p[f"l{i}.ln2.b"])
    x = x * m
    mean = (x @ p["mean.w"] + p["mean.b"]) * m
    y = x
    for name in ("dp1", "dp2"):
        y = torch.relu(_conv(y * m, p[f"{name}.w"], p[f"{name}.b"], d.k_dp))
        y = _ln(y, p[f"{name}.g"], p[f"{name}.beta"])
    dur = ((y * m) @ p["dp.proj.w"] + p["dp.proj.b"]) * m
    return torch.cat([mean, torch.zeros_like(mean), dur], dim=-1)


def fused_glow_encoder(enc, packed: PackedGlowEncoder, text: torch.Tensor,
                       text_lengths: torch.Tensor):
    """Drop-in for ``enc(text, text_lengths)`` in eval mode: (o_mean,
    o_log_scale, o_dur_log, x_mask), the first three (B, C, T) and the mask
    (B, 1, T). The kernel for CUDA tensors, the plain version for CPU
    tensors. Raises when autograd would need a graph: it has none."""
    emb = enc.emb(text) * math.sqrt(enc.hidden_channels)
    if emb.requires_grad:
        raise RuntimeError("fused_glow_encoder: the fused encoder has no "
                           "backward; call it under torch.no_grad() (the "
                           "module computes gradients)")
    mask = sequence_mask(text_lengths, text.shape[1]).to(emb.dtype)
    if emb.device.type == "cpu":
        out = glow_encoder_torch(packed, emb, mask)
    else:
        out = glow_encoder_cuda.glow_encoder_cuda(packed.flat, packed.dims,
                                                  emb.contiguous(), mask)
    n = packed.dims.n_out
    out = out.transpose(1, 2)
    return out[:, :n], out[:, n:2 * n], out[:, 2 * n:], mask[:, None]
