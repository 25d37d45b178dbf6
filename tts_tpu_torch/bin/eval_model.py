"""Objective metrics of a TTS checkpoint on a corpus (≙
tts_tpu/bin/eval_model.py): teacher-forced mel L1 and largest error,
mel-cepstral distortion (MCD), the alignment's diagonality, monotonicity and
coverage, and with a second checkpoint the largest difference between the
two models' mels.

Usage:
  python -m tts_tpu_torch.bin.eval_model --config_path c.json \
      --checkpoint model.pt [--ref_checkpoint other.pt] [--num_items 32] \
      [--data_path DIR] [--out metrics.json] [--device cpu]

Checkpoints are the port's or tts_tpu's (``infer/synthesizer.py::
load_checkpoint``); a Tacotron's r is the checkpoint's, else the config's.
The teacher-forced forward runs in eval mode without autograd on the
device (CUDA by default), so on the card Glow-TTS's alignment is the MAS
kernel (B4, one launch a batch) and Tacotron2's encoder the BiLSTM kernel
(B7, 1 + the text bucket's length launches a batch). A flow model's mel is
the inverse flow of its MAS-aligned latent means (``GlowTTS.decode_mean``);
so is the reference checkpoint's (tts_tpu takes that one's
``postnet_outputs``, which a flow model does not have).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from tts_tpu_torch import DeviceLike, resolve_device


def _dct_ortho(n: int, coeffs: int) -> np.ndarray:
    """Rows 1..coeffs of the orthonormal DCT-II matrix of size n."""
    k = np.arange(1, coeffs + 1)[:, None]
    i = np.arange(n)[None, :]
    return np.sqrt(2.0 / n) * np.cos(np.pi * k * (2 * i + 1) / (2 * n))


def mel_cepstral_distortion(mel_ref: np.ndarray, mel_hat: np.ndarray,
                            n_coeffs: int = 13) -> float:
    """MCD (dB) over the DCT-II cepstra of (T, n_mels) frames, coefficients
    1..n_coeffs (c0 left out, Kubichek's form); the DCT is applied to the
    frames as they are (log or normalized)."""
    basis = _dct_ortho(mel_ref.shape[-1], n_coeffs)
    diff = (np.asarray(mel_ref, np.float64)
            - np.asarray(mel_hat, np.float64)) @ basis.T
    return float((10.0 / np.log(10.0)) * np.mean(
        np.sqrt(2.0 * np.sum(diff * diff, axis=-1))))


def _forward(model, batch: Dict[str, np.ndarray], device: torch.device
             ) -> Dict[str, np.ndarray]:
    """The teacher-forced outputs as numpy, with ``mel_hat`` (B, T, n_mels):
    the post-net's output, or a flow model's ``decode_mean``."""
    from tts_tpu_torch.models.glow_tts import GlowTTS
    if isinstance(model, GlowTTS):
        from tts_tpu_torch.train.trainer_glow import batch_to_device
        db = batch_to_device(batch, device)
        out = model(db["text"], db["text_lengths"], db["mel"],
                    db["mel_lengths"])
        out["mel_hat"] = model.decode_mean(out["y_mean"], out["y_mask"])
    else:
        from tts_tpu_torch.train.trainer_tts import batch_to_device
        db = batch_to_device(batch, device)
        out = model(db["text"], db["text_lengths"], db["mel"],
                    db["mel_lengths"])
        out["mel_hat"] = out["postnet_outputs"]
    return {k: v.float().cpu().numpy() for k, v in out.items()
            if k in ("mel_hat", "alignments")}


def _load(path: str, c: Dict, device: torch.device):
    from tts_tpu_torch.infer.synthesizer import load_checkpoint
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols
    model = setup_model(num_symbols(c.get("use_phonemes", False)),
                        c.get("num_speakers", 1), c)
    ckpt = load_checkpoint(path, c)
    model.load_state_dict(ckpt["model"])
    if not isinstance(model, GlowTTS):
        model.set_r(int(ckpt.get("r") or c.get("r", 1) or 1))
    return model.to(device).eval()


@torch.no_grad()
def evaluate(config_path: str, checkpoint: str,
             ref_checkpoint: Optional[str] = None, num_items: int = 32,
             data_path: Optional[str] = None,
             device: DeviceLike = None) -> Dict:
    """tts_tpu's metrics of ``checkpoint`` on the first ``num_items``
    held-out items (the training items where none is held out), in full
    batches of up to 8."""
    from tts_tpu_torch.audio import AudioProcessor
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.data import TTSDataset, load_meta_data
    from tts_tpu_torch.utils.measures import alignment_diagonal_score

    dev = resolve_device(device)
    c = load_config(config_path)
    if data_path:
        c["datasets"][0]["path"] = data_path
    ap = AudioProcessor(**c.audio)
    meta_train, meta_eval = load_meta_data(c["datasets"])
    items = (meta_eval or meta_train)[:num_items]
    model = _load(checkpoint, c, dev)
    ref_model = _load(ref_checkpoint, c, dev) if ref_checkpoint else None
    r = getattr(model, "r", 1)
    ds = TTSDataset(ap, items, outputs_per_step=r,
                    text_cleaner=c.get("text_cleaner", "english_cleaners"),
                    use_phonemes=c.get("use_phonemes", False),
                    min_seq_len=0, max_seq_len=float("inf"))

    metrics = {"mel_l1": [], "mel_max_abs_err": [], "mcd": [],
               "alignment_score": [], "attn_monotonicity": [],
               "attn_coverage": []}
    n_items = 0
    parity = []
    for batch in ds.batches(batch_size=min(8, len(items))):
        out = _forward(model, batch, dev)
        mel_hat, mel_ref = out["mel_hat"], batch["mel"]
        lens, tlens = batch["mel_lengths"], batch["text_lengths"]
        for b in range(mel_ref.shape[0]):
            t = min(int(lens[b]) // r * r, mel_hat.shape[1])
            ref_b, hat_b = mel_ref[b, :t], mel_hat[b, :t]
            metrics["mel_l1"].append(float(np.abs(ref_b - hat_b).mean()))
            metrics["mel_max_abs_err"].append(
                float(np.abs(ref_b - hat_b).max()))
            metrics["mcd"].append(mel_cepstral_distortion(ref_b, hat_b))
            n_items += 1
        # each item over its valid decoder steps and text only
        al = out["alignments"]
        for b in range(al.shape[0]):
            a = al[b, :max(int(lens[b]) // r, 1), :max(int(tlens[b]), 1)]
            metrics["alignment_score"].append(
                alignment_diagonal_score(a[None]))
            arg = a.argmax(-1)
            metrics["attn_monotonicity"].append(
                float((np.diff(arg) >= 0).mean()) if len(arg) > 1 else 1.0)
            metrics["attn_coverage"].append(
                float((arg.max() - arg.min() + 1) / a.shape[1]))
        if ref_model is not None:
            ref_mel = _forward(ref_model, batch, dev)["mel_hat"]
            parity.append(float(np.abs(ref_mel - mel_hat).max()))

    result = {
        "checkpoint": checkpoint,
        "n_items": n_items,
        "mel_l1": float(np.mean(metrics["mel_l1"])),
        "mel_max_abs_err": float(np.max(metrics["mel_max_abs_err"])),
        "mcd_db": float(np.mean(metrics["mcd"])),
        "alignment_diagonal_score":
            float(np.mean(metrics["alignment_score"])),
        "attn_monotonicity": float(np.mean(metrics["attn_monotonicity"])),
        "attn_coverage": float(np.mean(metrics["attn_coverage"])),
    }
    if parity:
        result["vs_ref_max_abs_diff"] = float(np.max(parity))
        result["vs_ref_allclose_1e3"] = bool(np.max(parity) <= 1e-3)
    return result


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--ref_checkpoint", default=None,
                        help="a second checkpoint to compare the mels with")
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--num_items", type=int, default=32)
    parser.add_argument("--out", default=None, help="write the metrics here")
    parser.add_argument("--device", default=None,
                        help="torch device (CUDA by default)")
    args = parser.parse_args(argv)
    result = evaluate(args.config_path, args.checkpoint,
                      ref_checkpoint=args.ref_checkpoint,
                      num_items=args.num_items, data_path=args.data_path,
                      device=args.device)
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
