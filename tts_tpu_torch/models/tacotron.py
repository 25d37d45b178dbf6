"""Tacotron (v1): CBHG encoder and post-net, a GRU decoder fed from a
memory queue, and a linear-spectrogram head (≙ tts_tpu/models/tacotron.py:
``BatchNormConv1d``, ``Highway``, ``CBHG``, ``TacotronEncoder``,
``PostCBHG``, ``TacotronDecoderCell``, ``Tacotron``), with Mozilla TTS's
module names (``encoder.cbhg.cbhg``, ``postnet.cbhg``, ``conv1d_banks``,
``conv1d_projections``, ``pre_highway``, ``highways``, ``gru``,
``decoder.attention_rnn``, ``project_to_decoder_in``, ``decoder_rnns``,
``proj_to_mel``, ``stopnet.linear``, ``last_linear``) so that a Mozilla
state dict loads as it is.

Where tts_tpu and Mozilla differ, the port computes tts_tpu's function:

- ``BatchNormConv1d`` is a bias-free conv, then the activation, then
  BatchNorm (flax ``momentum=0.99``: the running statistics move 0.01 of
  the way, to the biased variance; eps 1e-5). Its conv pads as flax's
  ``SAME`` does: (k - 1) // 2 before and k // 2 after, so the bank's even
  kernels put the extra pad at the end;
- the CBHG has no max-pool (neither tts_tpu nor the reference applies
  one); its bidirectional GRU reads the whole padded sequence, the
  backward direction starting from the padded end, as flax's
  ``nn.Bidirectional`` without ``seq_lengths`` does;
- every GRU is flax's ``GRUCell``: no hidden-side bias on r and z
  (``layers.hold_gru_rz_bias``); its state starts float32, as flax's
  carry, so in mixed precision the CBHG GRUs and everything after the
  encoder compute in float32 (``train.trainer_tts.mixed_params``);
- the attention is location-sensitive with the configured norm; under
  the sigmoid norm its ``v`` bias trains (tts_tpu's ``use_v_bias``).

``forward`` is the teacher-forced pass: the decoder's prenet reads the
memory of ``memory_inputs`` (zeros at step 0; then without a queue the
last frame of the previous r-group, with a queue of ``memory_size`` frames
the newest groups first, cut to ``memory_size`` frames: for a queue no
longer than r that is the *oldest* frames of the previous group, a
reference quirk tts_tpu keeps). ``inference`` decodes over a static step
budget with the same queue rule, masks the frames after each item's stop
and reports ``mel_lengths``. ``postnet_outputs`` is the linear spectrogram
(``fft_size / 2 + 1`` bins); ``decoder_outputs`` the mel.

In ``train()`` mode the dropouts are tts_tpu's: 0.5 after each layer of
both prenets and 0.1 before the stop logit, every mask drawn from the
``torch.Generator`` that ``set_generator`` gives the model. No TPU kernel
runs Tacotron v1 in tts_tpu, and none runs it here: B7 and B8 compute
Tacotron2 only.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.dropout import Dropout, set_generator
from tts_tpu_torch.models.gst import GST
from tts_tpu_torch.models.layers import BatchNorm1d, Prenet, hold_gru_rz_bias
from tts_tpu_torch.ops.attention import init_attn
from tts_tpu_torch.ops.masking import sequence_mask

Carry = Dict[str, object]
EMBEDDING_DIM = 256          # character embedding, encoder and decoder width
SPEAKER_EMBEDDING_DIM = 256  # tts_tpu's Tacotron v1 speaker table width


class BatchNormConv1d(nn.Module):
    """conv (bias-free, SAME) -> activation -> BatchNorm, on (B, C, T)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, activation: Optional[str] = None):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv1d = nn.Conv1d(in_channels, out_channels, kernel_size,
                                bias=False)
        self.bn = BatchNorm1d(out_channels, momentum=0.01)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1d(F.pad(x, self.pad))
        if self.activation == "relu":
            x = torch.relu(x)
        return self.bn(x)


class Highway(nn.Module):
    """relu(H x) * t + x * (1 - t), t = sigmoid(T x); T's bias starts at
    -1."""

    def __init__(self, features: int):
        super().__init__()
        self.H = nn.Linear(features, features)
        self.T = nn.Linear(features, features)
        nn.init.constant_(self.T.bias, -1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.sigmoid(self.T(x))
        return torch.relu(self.H(x)) * t + x * (1.0 - t)


class CBHG(nn.Module):
    """Conv bank (k = 1..K) -> 2 conv projections -> residual ->
    (``pre_highway``) -> highways -> bidirectional GRU. (B, T, in_features)
    -> (B, T, 2 gru_features)."""

    def __init__(self, in_features: int, K: int = 16,
                 conv_bank_features: int = 128,
                 conv_projections: Sequence[int] = (128, 128),
                 highway_features: int = 128, gru_features: int = 128,
                 num_highways: int = 4):
        super().__init__()
        self.conv1d_banks = nn.ModuleList(
            BatchNormConv1d(in_features, conv_bank_features, k, "relu")
            for k in range(1, K + 1))
        dims = [K * conv_bank_features, *conv_projections]
        self.conv1d_projections = nn.ModuleList(
            BatchNormConv1d(dims[i], dims[i + 1], 3,
                            "relu" if i < len(conv_projections) - 1 else None)
            for i in range(len(conv_projections)))
        if conv_projections[-1] != highway_features:
            self.pre_highway = nn.Linear(conv_projections[-1],
                                         highway_features, bias=False)
        self.highways = nn.ModuleList(Highway(highway_features)
                                      for _ in range(num_highways))
        self.gru = nn.GRU(highway_features, gru_features, batch_first=True,
                          bidirectional=True)
        hold_gru_rz_bias(self.gru.bias_hh_l0, gru_features)
        hold_gru_rz_bias(self.gru.bias_hh_l0_reverse, gru_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x.transpose(1, 2)                             # (B, C, T)
        y = torch.cat([conv(inputs) for conv in self.conv1d_banks], dim=1)
        for conv in self.conv1d_projections:
            y = conv(y)
        y = y.transpose(1, 2) + x
        if hasattr(self, "pre_highway"):
            y = self.pre_highway(y)
        for highway in self.highways:
            y = highway(y)
        # the GRU computes in its weights' dtype (float32 in mixed
        # precision, as tts_tpu's float32 carry makes its flax GRU)
        return self.gru(y.to(self.gru.weight_hh_l0.dtype))[0]


class EncoderCBHG(nn.Module):
    """Mozilla's wrapper (its ``cbhg``): K 16, 128 wide throughout."""

    def __init__(self):
        super().__init__()
        self.cbhg = CBHG(128, K=16, conv_bank_features=128,
                         conv_projections=(128, 128), highway_features=128,
                         gru_features=128)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbhg(x)


class TacotronEncoder(nn.Module):
    """Prenet (256, 128) -> CBHG: (B, T, 256) -> (B, T, 256)."""

    def __init__(self, in_features: int = EMBEDDING_DIM):
        super().__init__()
        self.prenet = Prenet(in_features, out_features=(256, 128))
        self.cbhg = EncoderCBHG()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbhg(self.prenet(x))


class PostCBHG(nn.Module):
    """CBHG over the mel, K 8, projections (256, n_mels): (B, T, n_mels)
    -> (B, T, 256)."""

    def __init__(self, mel_dim: int = 80):
        super().__init__()
        self.cbhg = CBHG(mel_dim, K=8, conv_bank_features=128,
                         conv_projections=(256, mel_dim),
                         highway_features=128, gru_features=128)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbhg(x)


class StopNet(nn.Module):
    """Dropout 0.1 -> one logit."""

    def __init__(self, in_features: int):
        super().__init__()
        self.dropout = Dropout(0.1)
        self.linear = nn.Linear(in_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.dropout(x))[:, 0]


class Decoder(nn.Module):
    """One r-frame step (≙ ``TacotronDecoderCell``): memory-queue prenet ->
    attention GRU (256) -> attention -> ``project_to_decoder_in`` -> two
    residual GRUs (256) -> ``proj_to_mel`` (sized by ``r_init``, cut to r)
    and the stop logit on [h, all r_init frames] (detached with
    ``separate_stopnet``)."""

    def __init__(self, in_features: int = EMBEDDING_DIM, n_mels: int = 80,
                 r: int = 7, r_init: int = 0, memory_size: int = -1,
                 prenet_type: str = "original", prenet_dropout: bool = True,
                 attn_type: str = "original", attn_K: int = 5,
                 location_attn: bool = True, use_forward_attn: bool = False,
                 use_transition_agent: bool = False,
                 forward_attn_mask: bool = False, attn_norm: str = "sigmoid",
                 windowing: bool = False, separate_stopnet: bool = True):
        super().__init__()
        self.n_mels = n_mels
        self.r = r
        self.r_init = max(r_init, r)
        self.memory_size = memory_size
        self.separate_stopnet = separate_stopnet
        self.query_dim = 256
        self.prenet = Prenet(self.memory_frames * n_mels, prenet_type,
                             prenet_dropout, out_features=(256, 128))
        self.attention_rnn = nn.GRUCell(128 + in_features, self.query_dim)
        hold_gru_rz_bias(self.attention_rnn.bias_hh, self.query_dim)
        self.attention = init_attn(
            attn_type, query_dim=self.query_dim, embedding_dim=in_features,
            attn_dim=128, attn_K=attn_K, location_attention=location_attn,
            use_forward_attn=use_forward_attn,
            use_transition_agent=use_transition_agent,
            forward_attn_mask=forward_attn_mask, norm=attn_norm,
            windowing=windowing, use_v_bias=attn_norm == "sigmoid")
        self.project_to_decoder_in = nn.Linear(self.query_dim + in_features,
                                               256)
        self.decoder_rnns = nn.ModuleList(nn.GRUCell(256, 256)
                                          for _ in range(2))
        for cell in self.decoder_rnns:
            hold_gru_rz_bias(cell.bias_hh, 256)
        self.proj_to_mel = nn.Linear(256, self.r_init * n_mels)
        self.stopnet = StopNet(256 + self.r_init * n_mels)

    @property
    def memory_frames(self) -> int:
        """The prenet reads ``memory_size`` frames with the queue on
        (``memory_size`` > 0), else the one last frame."""
        return self.memory_size if self.memory_size > 0 else 1

    def init_carry(self, enc: torch.Tensor, mask: torch.Tensor) -> Carry:
        """The first step's state; the GRU states and the context are
        float32 whatever ``enc``'s dtype, as tts_tpu's ``jnp.zeros``."""
        B, T, D = enc.shape

        def zeros(*shape):
            return torch.zeros(shape, device=enc.device)

        return {"inputs": enc,
                "processed_inputs": self.attention.preprocess_inputs(enc),
                "mask": mask,
                "attn_rnn": zeros(B, self.query_dim),
                "dec_rnns": (zeros(B, 256), zeros(B, 256)),
                "attn_state": self.attention.init_state(B, T, enc.device),
                "context": zeros(B, D)}

    def next_memory(self, memory: torch.Tensor, frames: torch.Tensor
                    ) -> torch.Tensor:
        """The inference queue's update from a step's ``frames`` (B, r *
        n_mels): without a queue the last frame; with ``memory_size`` <= r
        the first ``memory_size`` frames; else the new frames in front of
        the queue's newest ``memory_size - r``."""
        C, M = self.n_mels, self.memory_size
        if M <= 0:
            return frames[:, (self.r - 1) * C:]
        if M <= self.r:
            return frames[:, :M * C]
        return torch.cat([frames, memory[:, :(M - self.r) * C]], dim=-1)

    def forward(self, carry: Carry, memory: torch.Tensor,
                use_windowing: bool = False
                ) -> Tuple[Carry, Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
        """One step from the prenet's memory (B, memory_frames * n_mels)
        -> (new carry, (frames (B, r * n_mels), stop logit (B,), alignment
        (B, T)))."""
        query = self.attention_rnn(
            torch.cat([self.prenet(memory), carry["context"]], dim=-1),
            carry["attn_rnn"])
        context, attn_state = self.attention(
            query, carry["inputs"], carry["processed_inputs"],
            carry["attn_state"], carry["mask"], use_windowing=use_windowing)
        h = self.project_to_decoder_in(torch.cat([query, context], dim=-1))
        states = []
        for cell, state in zip(self.decoder_rnns, carry["dec_rnns"]):
            state = cell(h, state)
            h = h + state
            states.append(state)
        proj_full = self.proj_to_mel(h)
        stop_input = torch.cat([h, proj_full], dim=-1)
        if self.separate_stopnet:
            stop_input = stop_input.detach()
        stop = self.stopnet(stop_input)
        new = dict(carry)
        new.update(attn_rnn=query, dec_rnns=tuple(states),
                   attn_state=attn_state, context=context)
        return new, (proj_full[:, :self.r * self.n_mels], stop,
                     attn_state["attention_weights"])


class Tacotron(nn.Module):
    """(≙ Tacotron): character embedding (256) -> CBHG encoder -> r-frame
    GRU decoder (mel) -> PostCBHG -> ``last_linear`` (linear_dim bins).
    With ``num_speakers`` > 1 a learned speaker vector (256) and with
    ``use_gst`` the GST style vector are concatenated to the encoder's
    outputs, as in tts_tpu (each only when the call passes its input)."""

    def __init__(self, num_chars: int = 200, num_speakers: int = 1,
                 n_mels: int = 80, linear_dim: int = 1025, r: int = 7,
                 r_init: int = 0, memory_size: int = -1,
                 use_gst: bool = False, gst_num_style_tokens: int = 10,
                 gst_embedding_dim: int = 256, gst_num_heads: int = 4,
                 prenet_type: str = "original", prenet_dropout: bool = True,
                 attn_type: str = "original", attn_K: int = 5,
                 location_attn: bool = True, use_forward_attn: bool = False,
                 use_transition_agent: bool = False,
                 forward_attn_mask: bool = False, attn_norm: str = "sigmoid",
                 windowing: bool = False, separate_stopnet: bool = True,
                 max_decoder_steps: int = 500, stop_threshold: float = 0.5):
        super().__init__()
        self.n_mels = n_mels
        self.num_speakers = num_speakers
        self.use_gst = use_gst
        self.max_decoder_steps = max_decoder_steps
        self.stop_threshold = stop_threshold
        self.embedding = nn.Embedding(num_chars, EMBEDDING_DIM)
        nn.init.normal_(self.embedding.weight, 0.0, 0.3)
        self.encoder = TacotronEncoder()
        dec_in = EMBEDDING_DIM
        if num_speakers > 1:
            dec_in += SPEAKER_EMBEDDING_DIM
            self.speaker_embedding = nn.Embedding(num_speakers,
                                                  SPEAKER_EMBEDDING_DIM)
        if use_gst:
            dec_in += gst_embedding_dim
            self.gst_layer = GST(n_mels, gst_num_heads, gst_num_style_tokens,
                                 gst_embedding_dim)
        self.decoder = Decoder(
            dec_in, n_mels=n_mels, r=r, r_init=r_init,
            memory_size=memory_size, prenet_type=prenet_type,
            prenet_dropout=prenet_dropout, attn_type=attn_type,
            attn_K=attn_K, location_attn=location_attn,
            use_forward_attn=use_forward_attn,
            use_transition_agent=use_transition_agent,
            forward_attn_mask=forward_attn_mask, attn_norm=attn_norm,
            windowing=windowing, separate_stopnet=separate_stopnet)
        self.postnet = PostCBHG(n_mels)
        self.last_linear = nn.Linear(256, linear_dim)

    @property
    def r(self) -> int:
        return self.decoder.r

    def set_r(self, r: int) -> None:
        """Run at reduction factor ``r`` (1..r_init): the projection keeps
        its ``r_init`` frames and is cut to ``r``."""
        if not 1 <= r <= self.decoder.r_init:
            raise ValueError(f"r {r} outside 1..r_init "
                             f"{self.decoder.r_init}")
        self.decoder.r = r

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every dropout mask from ``generator`` (on the model's
        device)."""
        set_generator(self, generator)

    def encode(self, text: torch.Tensor, text_lengths: torch.Tensor,
               speaker_ids: Optional[torch.Tensor] = None,
               style_mel: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """text (B, T) ids -> (encoder outputs (B, T, C), mask (B, T)). The
        pads are not masked: the CBHG's convs and GRU read them, as in
        tts_tpu."""
        enc = self.encoder(self.embedding(text))
        B, T, _ = enc.shape
        parts = [enc]
        if self.num_speakers > 1 and speaker_ids is not None:
            parts.append(self.speaker_embedding(speaker_ids.long()))
        if self.use_gst and style_mel is not None:
            parts.append(self.gst_layer(style_mel))
        if len(parts) > 1:
            enc = torch.cat([enc] + [p[:, None].expand(B, T, -1)
                                     for p in parts[1:]], dim=-1)
        return enc, sequence_mask(text_lengths, T)

    def memory_inputs(self, mel: torch.Tensor) -> torch.Tensor:
        """The teacher-forced prenet memory (B, steps, memory_frames *
        n_mels) of mel (B, T_mel, n_mels): step 0 reads zeros; step t
        without a queue the last frame of group t - 1; with a queue
        [group t - 1, group t - 2, ...] cut to ``memory_size`` frames."""
        B, T_mel, C = mel.shape
        r, M = self.r, self.decoder.memory_size
        steps = T_mel // r
        groups = mel[:, :steps * r].reshape(B, steps, r * C)
        if M <= 0:
            return F.pad(groups[:, :-1, (r - 1) * C:], (0, 0, 1, 0))
        shifted = [F.pad(groups, (0, 0, j, 0))[:, :steps]
                   for j in range(1, -(-M // r) + 1)]
        return torch.cat(shifted, dim=-1)[:, :, :M * C]

    def linear_head(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) -> the linear spectrogram (B, T, linear_dim)."""
        return self.last_linear(self.postnet(mel))

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                mel: torch.Tensor, mel_lengths: Optional[torch.Tensor] = None,
                speaker_ids: Optional[torch.Tensor] = None,
                speaker_embeddings: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The teacher-forced pass (≙ ``Tacotron.__call__``): mel (B, T_mel,
        n_mels), T_mel // r steps -> ``decoder_outputs`` (B, steps * r,
        n_mels), ``postnet_outputs`` (B, steps * r, linear_dim),
        ``alignments`` (B, steps, T), ``stop_logits`` (B, steps).
        ``mel_lengths`` and ``speaker_embeddings`` are not read (tts_tpu's
        signature); with GST the style mel is ``mel``."""
        B = mel.shape[0]
        enc, mask = self.encode(text, text_lengths, speaker_ids,
                                mel if self.use_gst else None)
        memory = self.memory_inputs(mel)
        carry = self.decoder.init_carry(enc, mask)
        frames, stops, aligns = [], [], []
        for t in range(memory.shape[1]):
            carry, (fr, stop, align) = self.decoder(carry, memory[:, t])
            frames.append(fr)
            stops.append(stop)
            aligns.append(align)
        frames = torch.stack(frames, dim=1).reshape(B, -1, self.n_mels)
        return {"decoder_outputs": frames,
                "postnet_outputs": self.linear_head(frames),
                "alignments": torch.stack(aligns, dim=1),
                "stop_logits": torch.stack(stops, dim=1)}

    @torch.no_grad()
    def inference(self, text: torch.Tensor,
                  text_lengths: Optional[torch.Tensor] = None,
                  speaker_ids: Optional[torch.Tensor] = None,
                  style_mel: Optional[torch.Tensor] = None,
                  max_decoder_steps: Optional[int] = None,
                  use_windowing: bool = True) -> Dict[str, torch.Tensor]:
        """Greedy decode over ``max_decoder_steps`` (the model's budget by
        default), no early exit: an item is active until the step after
        its first stop logit above ``stop_threshold``; the frames after it
        are zeroed, before the post-net and after the linear head, and
        ``mel_lengths`` counts the active steps times r."""
        B = text.shape[0]
        if text_lengths is None:
            text_lengths = torch.full((B,), text.shape[1], dtype=torch.int32,
                                      device=text.device)
        steps = max_decoder_steps or self.max_decoder_steps
        enc, mask = self.encode(text, text_lengths, speaker_ids, style_mel)
        carry = self.decoder.init_carry(enc, mask)
        memory = enc.new_zeros(B, self.decoder.memory_frames * self.n_mels)
        frames, stops, aligns = [], [], []
        for _ in range(steps):
            carry, (fr, stop, align) = self.decoder(carry, memory,
                                                    use_windowing)
            memory = self.decoder.next_memory(memory, fr)
            frames.append(fr)
            stops.append(stop)
            aligns.append(align)
        stops = torch.stack(stops, dim=1)
        done = (torch.sigmoid(stops) > self.stop_threshold).int()
        active = (torch.cumsum(done, dim=1) - done) == 0
        frame_mask = active.repeat_interleave(self.r, dim=1)[..., None]
        frames = torch.stack(frames, dim=1).reshape(B, -1, self.n_mels)
        frames = frames * frame_mask
        return {"decoder_outputs": frames,
                "postnet_outputs": self.linear_head(frames) * frame_mask,
                "alignments": torch.stack(aligns, dim=1),
                "stop_logits": stops,
                "mel_lengths": active.sum(dim=1, dtype=torch.int32) * self.r}
