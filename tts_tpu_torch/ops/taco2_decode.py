"""The whole greedy Tacotron2 decode (≙ tts_tpu/ops/pallas/
fused_taco2_decode.py: ``pack_decoder_params``, ``fused_decode``).

Each step, with h, c, context, alignment and cumulative alignment carried
from zeros:

1. prenet: relu(relu(last_frame pw1) pw2), no bias (eval: no dropout);
2. attention LSTM on [prenet, context] -> query h1;
3. energies v . tanh(h1 qk + processed_inputs + loc), masked with -1e9,
   where loc is the location conv (k=31, SAME: 15 zeros each side;
   channel 0 the previous alignment, channel 1 the cumulative one)
   followed by the location dense layer;
4. softmax in float32; 5. cum += alignment; 6. context = sum_t align enc;
7. decoder LSTM on [h1, context] -> h2;
8. frames_full = [h2, context] projw + projb (all r_init * n_mels);
9. stop = [h2, frames_full] . stopw + stopb;
10. frames = frames_full[:, :r * n_mels]; the next input is their last
    n_mels values.

The math is ported, not the TPU layout: tts_tpu folds the location conv and
dense layer into a banded (2T, T, A) matrix for its matrix unit, which does
about 5x the operations at T=128 and depends on the text bucket; the port
packs the conv as it is (``kloc`` (31, 2, F)).

``fused_decode`` dispatches by device: a CUDA tensor runs the hand-written
kernels (``ops/cuda/taco2_decode.cu``), a CPU tensor the plain version
``decode_torch``. Both take float32 operands only (tts_tpu's
``compute_dtype=float32``); bf16 waits for tensor-core kernels, and asking
for it raises. The attention's ``v`` bias is not an operand: under softmax
it is a constant shift.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from tts_tpu_torch.ops.bilstm import lstm_cell
from tts_tpu_torch.ops.cuda import taco2_decode as decode_cuda

Packed = Dict[str, torch.Tensor]


def _lstm_pack(cell: torch.nn.LSTMCell) -> Tuple[torch.Tensor, torch.Tensor]:
    w = torch.cat([cell.weight_ih.t(), cell.weight_hh.t()], dim=0)
    return w.contiguous(), (cell.bias_ih + cell.bias_hh).contiguous()


@torch.no_grad()
def pack_decoder_params(decoder) -> Packed:
    """A port ``Decoder`` (softmax location attention, prenet "original")
    -> the decode's float32 operands: prenet pw1 (n_mels, 256), pw2
    (256, 256); attention LSTM aw (256 + D + H, 4H), ab (4H); qk (H, A);
    kloc (31, 2, F); ld (F, A); v (A); decoder LSTM dw (H + D + H2, 4H2),
    db; projw (H2 + D, r_init * n_mels), projb; stopw (H2 + r_init *
    n_mels), stopb (1). LSTM gates i, f, g, o; biases b_ih + b_hh."""
    att = decoder.attention
    loc = att.location_layer
    pre = decoder.prenet.linear_layers
    aw, ab = _lstm_pack(decoder.attention_rnn)
    dw, db = _lstm_pack(decoder.decoder_rnn)
    stop = decoder.stopnet[1].linear_layer
    proj = decoder.linear_projection.linear_layer
    packed = dict(
        pw1=pre[0].linear_layer.weight.t(), pw2=pre[1].linear_layer.weight.t(),
        aw=aw, ab=ab,
        qk=att.query_layer.linear_layer.weight.t(),
        kloc=loc.location_conv1d.weight.permute(2, 1, 0),
        ld=loc.location_dense.linear_layer.weight.t(),
        v=att.v.linear_layer.weight[0],
        dw=dw, db=db,
        projw=proj.weight.t(), projb=proj.bias,
        stopw=stop.weight[0], stopb=stop.bias)
    return {k: v.detach().float().contiguous() for k, v in packed.items()}


def _check_operands(enc, pi, mask, packed, r, n_mels, compute_dtype):
    if compute_dtype != torch.float32:
        raise ValueError(f"fused_decode: only float32 operands are ported, "
                         f"not {compute_dtype} (bf16 waits for tensor cores)")
    for name, t in (("enc", enc), ("processed_inputs", pi),
                    *((k, packed[k]) for k in decode_cuda.WEIGHTS)):
        if t.dtype != torch.float32:
            raise ValueError(f"fused_decode: {name} must be float32, got "
                             f"{t.dtype}")
    B, T, D = enc.shape
    if tuple(pi.shape[:2]) != (B, T) or tuple(mask.shape) != (B, T):
        raise ValueError(f"fused_decode: processed_inputs {tuple(pi.shape)} "
                         f"and mask {tuple(mask.shape)} do not match enc "
                         f"{(B, T, D)}")
    n_proj = packed["projw"].shape[1]
    if r * n_mels > n_proj:
        raise ValueError(f"fused_decode: r * n_mels = {r * n_mels} exceeds "
                         f"the projection's {n_proj} outputs")


def decode_torch(enc: torch.Tensor, processed_inputs: torch.Tensor,
                 mask: torch.Tensor, packed: Packed, steps: int, r: int,
                 n_mels: int = 80, compute_dtype=torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: enc (B, T, D), processed_inputs (B, T, A), mask
    (B, T) -> frames (steps, B, r * n_mels), stop logits (steps, B),
    alignments (steps, B, T), float32."""
    _check_operands(enc, processed_inputs, mask, packed, r, n_mels,
                    compute_dtype)
    p = packed
    B, T, D = enc.shape
    H, H2 = p["ab"].shape[0] // 4, p["db"].shape[0] // 4
    K = p["kloc"].shape[0]
    conv_w = p["kloc"].permute(2, 1, 0)                 # (F, 2, K)
    valid = mask.bool()
    h1 = c1 = enc.new_zeros(B, H)
    h2 = c2 = enc.new_zeros(B, H2)
    context = enc.new_zeros(B, D)
    align = enc.new_zeros(B, T)
    cum = enc.new_zeros(B, T)
    last = enc.new_zeros(B, n_mels)
    frames, stops, aligns = [], [], []
    for _ in range(steps):
        x = torch.relu(torch.relu(last @ p["pw1"]) @ p["pw2"])
        h1, c1 = lstm_cell(torch.cat([x, context], dim=1), h1, c1,
                           p["aw"], p["ab"])
        loc = F.conv1d(torch.stack([align, cum], dim=1), conv_w,
                       padding=(K - 1) // 2)            # (B, F, T)
        loc = loc.transpose(1, 2) @ p["ld"]             # (B, T, A)
        e = torch.tanh((h1 @ p["qk"])[:, None, :] + processed_inputs + loc)
        e = torch.where(valid, e @ p["v"], torch.full_like(cum, -1e9))
        align = torch.softmax(e, dim=-1)
        cum = cum + align
        context = torch.einsum("bt,btd->bd", align, enc)
        h2, c2 = lstm_cell(torch.cat([h1, context], dim=1), h2, c2,
                           p["dw"], p["db"])
        full = torch.cat([h2, context], dim=1) @ p["projw"] + p["projb"]
        stops.append(torch.cat([h2, full], dim=1) @ p["stopw"]
                     + p["stopb"][0])
        frames.append(full[:, :r * n_mels])
        aligns.append(align)
        last = frames[-1][:, -n_mels:]
    return (torch.stack(frames), torch.stack(stops), torch.stack(aligns))


def fused_decode(enc: torch.Tensor, processed_inputs: torch.Tensor,
                 mask: torch.Tensor, packed: Packed, steps: int, r: int,
                 n_mels: int = 80, compute_dtype=torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode of ``steps`` steps: the kernels for CUDA tensors (they
    raise on what they do not take), the plain version for CPU tensors."""
    _check_operands(enc, processed_inputs, mask, packed, r, n_mels,
                    compute_dtype)
    if enc.device.type == "cpu":
        return decode_torch(enc, processed_inputs, mask, packed, steps, r,
                            n_mels)
    return decode_cuda.decode_cuda(enc, processed_inputs, mask, packed, steps,
                                   r, n_mels)
