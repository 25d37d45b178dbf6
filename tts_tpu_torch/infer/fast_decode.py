"""Serving fast path: Tacotron2 inference through the hand-written kernels
(≙ tts_tpu/infer/fast_decode.py: ``taco2_fused_encode``,
``supports_fused_decode``, ``taco2_fused_inference``).

The embedding, the ConvBN stack, the attention's input projection and the
postnet run as plain PyTorch (large batched convs and one matmul, as tts_tpu
leaves them to XLA); the BiLSTM runs through ``ops.bilstm.bilstm`` (B7) and
the whole autoregressive loop through ``ops.taco2_decode.fused_decode``
(B8), float32. The weights the kernels take are packed once per set of
weights and kept on the model.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tts_tpu_torch.models.tacotron2 import Tacotron2
from tts_tpu_torch.ops.attention import LocationSensitiveAttention
from tts_tpu_torch.ops.taco2_decode import fused_decode, pack_decoder_params


def supports_fused_decode(model: Tacotron2) -> bool:
    """The configuration the fused decode computes exactly: one speaker
    and no GST (B8 takes no speaker or style channels, as tts_tpu's check
    says), location-sensitive softmax attention without forward attention
    (Graves attention is refused, as tts_tpu refuses any ``attn_type`` but
    "original"), and a plain prenet. Windowing and the "bn" prenet are refused too
    (tts_tpu's check misses both, ROADMAP C12 and C13): ``inference``
    windows the energies and normalises the prenet, the fused decode does
    neither."""
    att = model.decoder.attention
    return (model.num_speakers == 1 and not model.use_gst
            and isinstance(att, LocationSensitiveAttention)
            and att.use_location and att.norm == "softmax"
            and not att.use_forward_attn and not att.windowing
            and model.decoder.prenet.prenet_type == "original")


def _weights_key(model: torch.nn.Module) -> tuple:
    return tuple((p.data_ptr(), p._version) for p in model.parameters())


@torch.no_grad()
def packed_weights(model: Tacotron2) -> Tuple[tuple, Dict[str, torch.Tensor],
                                              torch.Tensor]:
    """(the encoder LSTM's fused weights, the decode's packed weights, the
    attention's input projection (C, A)), made once and kept on the model
    until a parameter is moved or updated in place."""
    key = _weights_key(model)
    cached = model.__dict__.get("_fused_weights")
    if cached is None or cached[0] != key:
        att = model.decoder.attention
        cached = (key, model.encoder.packed_lstm(),
                  pack_decoder_params(model.decoder),
                  att.inputs_layer.linear_layer.weight.t().contiguous())
        model.__dict__["_fused_weights"] = cached
    return cached[1:]


@torch.no_grad()
def taco2_fused_inference(model: Tacotron2, text: torch.Tensor,
                          text_lengths: Optional[torch.Tensor] = None,
                          max_decoder_steps: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
    """Drop-in for ``model.inference`` on the configurations that
    ``supports_fused_decode`` accepts: the full static step budget (no early
    exit), the same stop masking and ``mel_lengths``."""
    if not supports_fused_decode(model):
        raise ValueError("this Tacotron2 configuration is not supported by "
                         "the fused decode; use model.inference")
    B = text.shape[0]
    if text_lengths is None:
        text_lengths = torch.full((B,), text.shape[1], dtype=torch.int32,
                                  device=text.device)
    steps = max_decoder_steps or model.max_decoder_steps
    lstm, packed, w_in = packed_weights(model)
    enc, mask = model.encode(text, text_lengths, mask_pads=True,
                             packed_lstm=lstm)
    frames, stops, aligns = fused_decode(enc, enc @ w_in, mask, packed, steps,
                                         model.r, model.n_mels)
    frames = frames.transpose(0, 1).reshape(B, steps * model.r, model.n_mels)
    return model.finish(frames, stops.t(), aligns.transpose(0, 1))
