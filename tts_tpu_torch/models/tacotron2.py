"""Tacotron2: conv + BiLSTM encoder, autoregressive decoder with
location-sensitive attention, postnet (≙ tts_tpu/models/tacotron2.py:
``DecoderCell``, ``Tacotron2._encode``, ``_init_carry``, ``_run_decoder``,
``__call__``, ``inference``), with Mozilla TTS's module names.

``forward`` is the teacher-forced pass that training takes: the decoder
runs one step per r frames of the target mel, fed a zero go-frame and then
the last frame of each r-group, and with double decoder consistency a
coarse decoder (r = ``ddc_r``) runs on the same mel, padded to a multiple
of ``ddc_r``; a backward decoder, when configured, runs on the mel flipped
in time. In ``train()`` mode the dropouts are tts_tpu's: 0.5 after each
prenet layer and each ConvBN block, 0.1 on the attention LSTM's output
(the query) and, drawn apart, on its cell state, 0.1 on the decoder LSTM's
output, and 0.1 before the stop logit; every mask comes from the
``torch.Generator`` that ``set_generator`` gives the model.

``inference`` is the plain path: a Python loop over a static step budget,
as tts_tpu's scan (no early exit). As there, an item stays active until the
step after its first stop logit above ``stop_threshold``: frames after it
are masked, and ``mel_lengths`` counts the active steps times r. The
serving fast path for the configuration it supports is
``infer/fast_decode.py::taco2_fused_inference`` (the B7 and B8 kernels).

Inference never runs the coarse or the backward decoder, as in tts_tpu.

Speakers and style join after the encoder, as in tts_tpu: with
``num_speakers`` > 1 a speaker vector (a learned ``speaker_embedding``, 64
wide, or with ``external_speaker_dim`` > 0 the caller's d-vectors) and
with ``use_gst`` the GST style vector of a style mel (the target mel in
training) are broadcast over the text and concatenated to the encoder's
outputs, so the decoder reads ``encoder_dim`` + those widths.
Such models are refused by ``infer/fast_decode.py::supports_fused_decode``
(B8 takes no conditioning); their encoder still runs B7 at eval. So is
Graves attention (``attn_type="graves"``, ``attn_K`` mixture components).

``inference_truncated`` is the streaming decode (``infer/streaming.py``):
the attention state starts afresh for each text chunk while the LSTM
states, the context and the last frame carry over in ``decoder_state``.
It runs the plain loop, as tts_tpu does: B8 takes no carried state. Its
encoder runs B7 on the card (eval, no grad).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from tts_tpu_torch.models.dropout import Dropout, set_generator
from tts_tpu_torch.models.gst import GST
from tts_tpu_torch.models.layers import Encoder, Linear, Postnet, Prenet
from tts_tpu_torch.ops.attention import init_attn
from tts_tpu_torch.ops.masking import sequence_mask

Carry = Dict[str, object]
SPEAKER_EMBEDDING_DIM = 64      # tts_tpu's learned speaker table width


class Decoder(nn.Module):
    """One decoder step: prenet -> attention LSTM -> attention -> decoder
    LSTM -> frame projection and stop logit (≙ DecoderCell). The projection
    is sized by ``r_init`` and cut to the active ``r``; the stopnet sees all
    ``r_init`` frames, detached from the decoder with ``separate_stopnet``
    (the stopnet then trains on its own loss only)."""

    def __init__(self, in_features: int, n_mels: int = 80, r: int = 7,
                 r_init: int = 0, query_dim: int = 1024,
                 decoder_rnn_dim: int = 1024, prenet_type: str = "original",
                 prenet_dropout: bool = True, attn_type: str = "original",
                 attn_dim: int = 128, attn_K: int = 5,
                 location_attn: bool = True,
                 use_forward_attn: bool = False,
                 use_transition_agent: bool = False,
                 forward_attn_mask: bool = False, attn_norm: str = "softmax",
                 windowing: bool = False, separate_stopnet: bool = True):
        super().__init__()
        self.n_mels = n_mels
        self.separate_stopnet = separate_stopnet
        self.r = r
        self.r_init = max(r_init, r)
        self.query_dim = query_dim
        self.decoder_rnn_dim = decoder_rnn_dim
        self.prenet = Prenet(n_mels, prenet_type, prenet_dropout, bias=False)
        self.attention_rnn = nn.LSTMCell(256 + in_features, query_dim)
        self.attention_rnn.bias_hh.requires_grad_(False)
        self.attention = init_attn(
            attn_type, query_dim=query_dim, embedding_dim=in_features,
            attn_dim=attn_dim, attn_K=attn_K, location_attention=location_attn,
            use_forward_attn=use_forward_attn,
            use_transition_agent=use_transition_agent,
            forward_attn_mask=forward_attn_mask, norm=attn_norm,
            windowing=windowing)
        self.decoder_rnn = nn.LSTMCell(query_dim + in_features,
                                       decoder_rnn_dim)
        self.decoder_rnn.bias_hh.requires_grad_(False)
        self.linear_projection = Linear(decoder_rnn_dim + in_features,
                                        self.r_init * n_mels)
        self.stopnet = nn.Sequential(
            Dropout(0.1),
            Linear(decoder_rnn_dim + self.r_init * n_mels, 1))
        self.query_dropout = Dropout(0.1)
        self.decoder_dropout = Dropout(0.1)

    def init_carry(self, enc: torch.Tensor, mask: torch.Tensor) -> Carry:
        B, T, D = enc.shape
        zeros_q = enc.new_zeros(B, self.query_dim)
        zeros_d = enc.new_zeros(B, self.decoder_rnn_dim)
        return {"inputs": enc,
                "processed_inputs": self.attention.preprocess_inputs(enc),
                "mask": mask,
                "attn_rnn": (zeros_q, zeros_q),
                "dec_rnn": (zeros_d, zeros_d),
                "attn_state": self.attention.init_state(B, T, enc.device),
                "context": enc.new_zeros(B, D)}

    def forward(self, carry: Carry, memory: torch.Tensor,
                use_windowing: bool = False
                ) -> Tuple[Carry, Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
        """One step from the previous frame ``memory`` (B, n_mels) ->
        (new carry, (frames (B, r * n_mels), stop logit (B,), alignment
        (B, T)))."""
        x = torch.cat([self.prenet(memory), carry["context"]], dim=-1)
        query, attn_c = self.attention_rnn(x, carry["attn_rnn"])
        # the dropped query is carried as h; the cell state takes a mask
        # of its own
        query = self.query_dropout(query)
        attn_c = self.query_dropout(attn_c)
        context, attn_state = self.attention(
            query, carry["inputs"], carry["processed_inputs"],
            carry["attn_state"], carry["mask"], use_windowing=use_windowing)
        dec_out, dec_c = self.decoder_rnn(
            torch.cat([query, context], dim=-1), carry["dec_rnn"])
        dec_out = self.decoder_dropout(dec_out)
        frames_full = self.linear_projection(
            torch.cat([dec_out, context], dim=-1))
        stop_input = torch.cat([dec_out, frames_full], dim=-1)
        if self.separate_stopnet:
            stop_input = stop_input.detach()
        stop = self.stopnet(stop_input)[:, 0]
        new = dict(carry)
        new.update(attn_rnn=(query, attn_c), dec_rnn=(dec_out, dec_c),
                   attn_state=attn_state, context=context)
        return new, (frames_full[:, :self.r * self.n_mels], stop,
                     attn_state["attention_weights"])


class Tacotron2(nn.Module):
    """(≙ Tacotron2)."""

    def __init__(self, num_chars: int = 200, num_speakers: int = 1,
                 n_mels: int = 80, r: int = 7,
                 r_init: int = 0, encoder_dim: int = 512,
                 embedding_dim: int = 512, external_speaker_dim: int = 0,
                 use_gst: bool = False,
                 gst_num_style_tokens: int = 10, gst_embedding_dim: int = 512,
                 gst_num_heads: int = 4, prenet_type: str = "original",
                 prenet_dropout: bool = True, attn_type: str = "original",
                 attn_dim: int = 128, attn_K: int = 5,
                 location_attn: bool = True,
                 use_forward_attn: bool = False,
                 use_transition_agent: bool = False,
                 forward_attn_mask: bool = False, attn_norm: str = "softmax",
                 windowing: bool = False, separate_stopnet: bool = True,
                 bidirectional_decoder: bool = False,
                 double_decoder_consistency: bool = False, ddc_r: int = 6,
                 max_decoder_steps: int = 1000,
                 stop_threshold: float = 0.5):
        super().__init__()
        if embedding_dim != encoder_dim:
            raise ValueError("the encoder keeps the embedding width: "
                             f"embedding_dim {embedding_dim} != encoder_dim "
                             f"{encoder_dim}")
        self.n_mels = n_mels
        self.num_speakers = num_speakers
        self.external_speaker_dim = external_speaker_dim
        self.use_gst = use_gst
        self.max_decoder_steps = max_decoder_steps
        self.stop_threshold = stop_threshold
        self.embedding = nn.Embedding(num_chars, embedding_dim)
        nn.init.normal_(self.embedding.weight, 0.0, 0.3)
        self.encoder = Encoder(encoder_dim)
        dec_in = encoder_dim
        if num_speakers > 1:
            dec_in += external_speaker_dim or SPEAKER_EMBEDDING_DIM
            if not external_speaker_dim:
                self.speaker_embedding = nn.Embedding(num_speakers,
                                                      SPEAKER_EMBEDDING_DIM)
                nn.init.normal_(self.speaker_embedding.weight, 0.0, 0.3)
        if use_gst:
            dec_in += gst_embedding_dim
            self.gst_layer = GST(n_mels, gst_num_heads, gst_num_style_tokens,
                                 gst_embedding_dim)
        dec_kwargs = dict(
            n_mels=n_mels, prenet_type=prenet_type,
            prenet_dropout=prenet_dropout, attn_type=attn_type,
            attn_dim=attn_dim, attn_K=attn_K, location_attn=location_attn,
            use_forward_attn=use_forward_attn,
            use_transition_agent=use_transition_agent,
            forward_attn_mask=forward_attn_mask, attn_norm=attn_norm,
            windowing=windowing, separate_stopnet=separate_stopnet)
        self.decoder = Decoder(dec_in, r=r, r_init=r_init, **dec_kwargs)
        if double_decoder_consistency:
            self.coarse_decoder = Decoder(dec_in, r=ddc_r, **dec_kwargs)
        if bidirectional_decoder:
            self.backward_decoder = Decoder(dec_in, r=r, r_init=r_init,
                                            **dec_kwargs)
        self.postnet = Postnet(n_mels)

    @property
    def r(self) -> int:
        return self.decoder.r

    def set_r(self, r: int) -> None:
        """Run at reduction factor ``r`` (a gradual-training step's, or a
        checkpoint's trained r): the projections keep their ``r_init``
        frames and are cut to ``r``. The coarse decoder keeps ``ddc_r``."""
        if not 1 <= r <= self.decoder.r_init:
            raise ValueError(f"r {r} outside 1..r_init "
                             f"{self.decoder.r_init}")
        self.decoder.r = r
        if hasattr(self, "backward_decoder"):
            self.backward_decoder.r = r

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every dropout mask from ``generator`` (on the model's
        device)."""
        set_generator(self, generator)

    def encode(self, text: torch.Tensor, text_lengths: torch.Tensor,
               mask_pads: bool = False, packed_lstm=None,
               speaker_ids: Optional[torch.Tensor] = None,
               speaker_embeddings: Optional[torch.Tensor] = None,
               style_mel: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """text (B, T) ids -> (encoder outputs (B, T, C), mask (B, T)),
        with the speaker vector (ids, or the external d-vectors (B, D)) and
        the style vector of ``style_mel`` (B, T_mel, n_mels) concatenated
        on a model that has them. ``packed_lstm``: the encoder's
        ``packed_lstm()``, when kept."""
        x = self.embedding(text).transpose(1, 2)
        enc = self.encoder(x, text_lengths, mask_pads=mask_pads,
                           packed=packed_lstm)
        parts = [enc]
        if self.num_speakers > 1:
            spk = (speaker_embeddings if self.external_speaker_dim
                   else self.speaker_embedding(speaker_ids.long()))
            parts.append(spk)
        if self.use_gst:
            parts.append(self.gst_layer(style_mel))
        if len(parts) > 1:
            B, T, _ = enc.shape
            enc = torch.cat([enc] + [p[:, None].expand(B, T, -1)
                                     for p in parts[1:]], dim=-1)
        return enc, sequence_mask(text_lengths, enc.shape[1])

    def finish(self, frames: torch.Tensor, stop_logits: torch.Tensor,
               alignments: torch.Tensor) -> Dict[str, torch.Tensor]:
        """frames (B, steps * r, n_mels), stop logits (B, steps) and
        alignments (B, steps, T) of a static step budget -> the inference
        outputs: an item is active until the step after its first stop,
        frames after it are zeroed, and the postnet runs on the rest."""
        done = torch.sigmoid(stop_logits) > self.stop_threshold
        active = (torch.cumsum(done.int(), dim=1) - done.int()) == 0
        frame_mask = active.repeat_interleave(self.r, dim=1)[..., None]
        frames = frames * frame_mask
        post = frames + self.postnet(frames.transpose(1, 2)).transpose(1, 2)
        return {"decoder_outputs": frames,
                "postnet_outputs": post * frame_mask,
                "alignments": alignments,
                "stop_logits": stop_logits,
                "mel_lengths": active.sum(dim=1, dtype=torch.int32) * self.r}

    def _decode(self, text: torch.Tensor,
                text_lengths: Optional[torch.Tensor], steps: Optional[int],
                use_windowing: bool, decoder_state: Optional[Carry],
                **conditioning) -> Tuple[Dict[str, torch.Tensor], Carry,
                                         torch.Tensor]:
        """The plain greedy decode, one decoder step per loop turn, over
        ``steps`` (the model's budget by default) from the LSTM states,
        context and last frame of ``decoder_state`` (zeros when None; the
        attention always set up afresh) -> (``finish``'s outputs, the
        final carry, the last frame)."""
        B = text.shape[0]
        if text_lengths is None:
            text_lengths = torch.full((B,), text.shape[1], dtype=torch.int32,
                                      device=text.device)
        steps = steps or self.max_decoder_steps
        enc, mask = self.encode(text, text_lengths, mask_pads=True,
                                **conditioning)
        carry = self.decoder.init_carry(enc, mask)
        memory = enc.new_zeros(B, self.n_mels)
        if decoder_state is not None:
            carry.update({k: decoder_state[k]
                          for k in ("attn_rnn", "dec_rnn", "context")})
            memory = decoder_state["last_frame"]
        frames, stops, aligns = [], [], []
        for _ in range(steps):
            carry, (fr, stop, align) = self.decoder(carry, memory,
                                                    use_windowing)
            memory = fr[:, -self.n_mels:]
            frames.append(fr)
            stops.append(stop)
            aligns.append(align)
        frames = torch.stack(frames, dim=1).reshape(B, steps * self.r,
                                                    self.n_mels)
        out = self.finish(frames, torch.stack(stops, dim=1),
                          torch.stack(aligns, dim=1))
        return out, carry, memory

    @torch.no_grad()
    def inference(self, text: torch.Tensor,
                  text_lengths: Optional[torch.Tensor] = None,
                  speaker_ids: Optional[torch.Tensor] = None,
                  speaker_embeddings: Optional[torch.Tensor] = None,
                  style_mel: Optional[torch.Tensor] = None,
                  max_decoder_steps: Optional[int] = None,
                  use_windowing: bool = True) -> Dict[str, torch.Tensor]:
        """Greedy decode over ``max_decoder_steps`` (the model's budget by
        default) in plain PyTorch, one decoder step per loop turn."""
        return self._decode(text, text_lengths, max_decoder_steps,
                            use_windowing, None, speaker_ids=speaker_ids,
                            speaker_embeddings=speaker_embeddings,
                            style_mel=style_mel)[0]

    @torch.no_grad()
    def inference_truncated(self, text: torch.Tensor,
                            text_lengths: Optional[torch.Tensor] = None,
                            decoder_state: Optional[Carry] = None,
                            speaker_ids: Optional[torch.Tensor] = None,
                            speaker_embeddings: Optional[torch.Tensor] = None,
                            style_mel: Optional[torch.Tensor] = None,
                            max_decoder_steps: Optional[int] = None
                            ) -> Dict[str, object]:
        """One chunk of a streamed decode (≙ ``inference_truncated``):
        ``inference``'s outputs for ``text``, decoded without windowing
        from the attention LSTM and decoder LSTM states, context and last
        frame of ``decoder_state`` (the previous chunk's; zeros when None),
        the attention set up afresh; plus the new ``decoder_state``."""
        out, carry, last_frame = self._decode(
            text, text_lengths, max_decoder_steps, False, decoder_state,
            speaker_ids=speaker_ids, speaker_embeddings=speaker_embeddings,
            style_mel=style_mel)
        result: Dict[str, object] = dict(out)
        result["decoder_state"] = {"attn_rnn": carry["attn_rnn"],
                                   "dec_rnn": carry["dec_rnn"],
                                   "context": carry["context"],
                                   "last_frame": last_frame}
        return result

    def teacher_forced(self, decoder: Decoder, enc: torch.Tensor,
                       mask: torch.Tensor, mel: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``decoder`` over mel (B, T_mel, n_mels), T_mel a multiple of its
        r, one step per r frames -> (frames (B, T_mel, n_mels), stop logits
        (B, steps), alignments (B, steps, T))."""
        B, T_mel, _ = mel.shape
        r = decoder.r
        steps = T_mel // r
        memory = torch.cat([mel.new_zeros(B, 1, self.n_mels),
                            mel[:, r - 1::r][:, :steps - 1]], dim=1)
        carry = decoder.init_carry(enc, mask)
        frames, stops, aligns = [], [], []
        for t in range(steps):
            carry, (fr, stop, align) = decoder(carry, memory[:, t])
            frames.append(fr)
            stops.append(stop)
            aligns.append(align)
        return (torch.stack(frames, dim=1).reshape(B, T_mel, self.n_mels),
                torch.stack(stops, dim=1), torch.stack(aligns, dim=1))

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                mel: torch.Tensor, mel_lengths: Optional[torch.Tensor] = None,
                speaker_ids: Optional[torch.Tensor] = None,
                speaker_embeddings: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The teacher-forced pass (≙ ``Tacotron2.__call__``): text (B, T)
        ids, mel (B, T_mel, n_mels) with T_mel a multiple of r ->
        ``decoder_outputs`` and ``postnet_outputs`` (B, T_mel, n_mels),
        ``alignments`` (B, T_mel / r, T), ``stop_logits`` (B, T_mel / r);
        with double decoder consistency ``coarse_decoder_outputs`` and
        ``coarse_alignments``, with the backward decoder
        ``backward_decoder_outputs`` and ``backward_alignments``.
        ``mel_lengths`` is not read (tts_tpu's signature). With GST the
        style mel is ``mel`` itself."""
        enc, mask = self.encode(text, text_lengths, speaker_ids=speaker_ids,
                                speaker_embeddings=speaker_embeddings,
                                style_mel=mel if self.use_gst else None)
        frames, stops, aligns = self.teacher_forced(self.decoder, enc, mask,
                                                    mel)
        post = frames + self.postnet(frames.transpose(1, 2)).transpose(1, 2)
        out = {"decoder_outputs": frames, "postnet_outputs": post,
               "alignments": aligns, "stop_logits": stops}
        T_mel = mel.shape[1]
        if hasattr(self, "coarse_decoder"):
            pad = -T_mel % self.coarse_decoder.r
            frames_c, _, aligns_c = self.teacher_forced(
                self.coarse_decoder, enc, mask,
                torch.nn.functional.pad(mel, (0, 0, 0, pad)))
            out["coarse_decoder_outputs"] = frames_c[:, :T_mel]
            out["coarse_alignments"] = aligns_c
        if hasattr(self, "backward_decoder"):
            frames_b, _, aligns_b = self.teacher_forced(
                self.backward_decoder, enc, mask, mel.flip(1))
            out["backward_decoder_outputs"] = frames_b.flip(1)
            out["backward_alignments"] = aligns_b
        return out
