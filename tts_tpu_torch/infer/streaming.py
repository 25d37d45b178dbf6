"""Chunked (streaming) Tacotron2 synthesis: the first audio leaves after
one text chunk's decode instead of the whole sentence's (≙
tts_tpu/infer/streaming.py: ``chunk_words``, ``attention_end_step``,
``stream_mel_chunks``).

A sentence is cut at word boundaries into chunks of at most
``chunk_chars`` characters; each chunk is decoded by
``Tacotron2.inference_truncated`` in a fixed budget of ``decoder_steps``
steps, its LSTM states, context and last frame carried to the next chunk
while the attention starts afresh. A chunk's frames end where the
attention's peak first reaches its last symbol (a mid-sentence chunk
never fires the stopnet); the last chunk keeps the stopnet's length when
it fired inside the budget. The encoder of each chunk runs B7 on the card;
the decode is the plain loop (B8 takes no carried state), as in tts_tpu.
At eval nothing is drawn at random (dropout is off), so no generator is
needed.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from tts_tpu_torch.infer.synthesis import bucket_text_length, text_to_seqvec


def chunk_words(text: str, chunk_chars: int) -> List[str]:
    """Split at word boundaries into pieces of at most ``chunk_chars``
    characters (a single longer word is a chunk of its own)."""
    chunks: List[str] = []
    cur: List[str] = []
    n = 0
    for w in text.split():
        if cur and n + 1 + len(w) > chunk_chars:
            chunks.append(" ".join(cur))
            cur, n = [], 0
        cur.append(w)
        n += len(w) + (1 if n else 0)
    if cur:
        chunks.append(" ".join(cur))
    return chunks or [text]


def attention_end_step(alignments: np.ndarray, text_len: int) -> int:
    """The number of decoder steps to keep: up to and including the first
    whose attention peak reaches the chunk's last symbol; all steps when
    none does. ``alignments`` (steps, T)."""
    hits = np.nonzero(np.argmax(alignments, axis=-1) >= text_len - 1)[0]
    return int(hits[0]) + 1 if len(hits) else alignments.shape[0]


def stream_mel_chunks(model, text: str, c: Dict, device: torch.device, *,
                      chunk_chars: int = 48,
                      decoder_steps: int = 128,
                      speaker_id: Optional[int] = None
                      ) -> Iterator[Dict[str, Any]]:
    """Yield {"mel": (frames, n_mels) numpy, "chunk_text", "final"} for
    each chunk of ``text``, the decoder state threaded through. The
    configuration's model must be of the Tacotron family (ValueError
    otherwise); Tacotron v1 has no ``inference_truncated`` and fails with
    AttributeError, as in tts_tpu (ROADMAP C25)."""
    model_name = c.get("model", "tacotron2").lower()
    if model_name not in ("tacotron2", "tacotron"):
        raise ValueError(f"streaming decode is for the tacotron family "
                         f"(parallel models emit full mels at once), got "
                         f"{model_name}")
    chunks = chunk_words(text, chunk_chars)
    kwargs: Dict[str, Any] = {}
    if speaker_id is not None:
        kwargs["speaker_ids"] = torch.tensor([speaker_id], device=device)
    state = None
    for i, chunk_text in enumerate(chunks):
        seq = text_to_seqvec(chunk_text, c)
        n = len(seq)
        padded = np.zeros((1, bucket_text_length(n)), np.int64)
        padded[0, :n] = seq
        out = model.inference_truncated(
            torch.from_numpy(padded).to(device),
            torch.tensor([n], dtype=torch.int32, device=device),
            decoder_state=state, max_decoder_steps=decoder_steps, **kwargs)
        state = out["decoder_state"]
        align = out["alignments"][0].cpu().numpy()       # (steps, bucket)
        final = i == len(chunks) - 1
        n_frames = None
        if final:
            # the last chunk may fire the stopnet: keep its length if so
            n_frames = int(out["mel_lengths"][0])
            if n_frames <= 0 or n_frames >= align.shape[0] * model.r:
                n_frames = None
        if n_frames is None:
            n_frames = attention_end_step(align, n) * model.r
        mel = out["postnet_outputs"][0, :n_frames].float().cpu().numpy()
        yield {"mel": mel, "chunk_text": chunk_text, "final": final}
