"""Checkpoint save/restore (≙ tts_tpu/train/checkpoint.py: ``save_checkpoint``,
``load_checkpoint``, ``save_best_model``, ``latest_checkpoint``).

A port checkpoint is ``torch.save({"model": state_dict, "optimizer":
optimizer state, "step", "epoch", "model_loss", "config"[, "r"]})`` with
plain types only (``"r"``: a Tacotron2 run's reduction factor), so it loads with ``torch.load(weights_only=True)``; the
``Synthesizer`` serves it as it is (it reads ``"model"``). The config is
written beside it as ``config.json`` too.

tts_tpu's own checkpoints (flax msgpack) are read by
``load_tts_tpu_checkpoint`` without flax or msgpack (``compat/msgpack.py``);
``is_torch_checkpoint`` tells the formats apart by their first bytes: a
zip archive (``PK``, ``torch.save`` since torch 1.6) or a pickle (``0x80``,
a legacy ``torch.save`` file such as a Mozilla TTS ``.pth.tar``) is torch's,
a non-empty msgpack map is tts_tpu's.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional

import torch


def _plain(config: Optional[Dict]) -> Optional[Dict]:
    """A config as plain dicts, lists and scalars (loadable with
    weights_only=True)."""
    return None if config is None else json.loads(json.dumps(config,
                                                              default=str))


def save_checkpoint(output_dir: str, *, model: torch.nn.Module,
                    optimizer: Any = None, step: int = 0, epoch: int = 0,
                    model_loss: Optional[float] = None,
                    config: Optional[Dict] = None,
                    prefix: str = "checkpoint",
                    r: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Writes ``<output_dir>/<prefix>_<step>.pt``; returns its path.
    ``extra``: more entries of plain types or tensors (the speaker
    encoder's ``"criterion"``)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{prefix}_{step}.pt")
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": (None if optimizer is None else
                      _to_cpu(optimizer.state_dict())),
        "step": step,
        "epoch": epoch,
        "model_loss": model_loss,
        "config": _plain(config),
    }
    if r is not None:
        payload["r"] = r
    payload.update(_to_cpu(extra or {}))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if config is not None:
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            json.dump(payload["config"], f, indent=2)
    return path


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint_multihost(output_dir: str, **kwargs) -> Optional[str]:
    """``save_checkpoint`` by rank 0 alone, then a barrier of every rank, so
    that none reads a half-written file (≙ tts_tpu's
    ``save_checkpoint_multihost``; the reference's rank-0 saves). Returns
    the path on rank 0, None on the others."""
    import torch.distributed as dist
    path = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        path = save_checkpoint(output_dir, **kwargs)
    if dist.is_initialized():
        dist.barrier()
    return path


def restore_for_mesh(path: str, device=None) -> Dict[str, Any]:
    """The checkpoint at ``path`` with its model tensors on ``device`` (this
    rank's, ``parallel/mesh.py::device()``, by default): every rank loads
    the same file, so each holds the same values (≙ tts_tpu's
    ``restore_for_mesh``)."""
    from tts_tpu_torch.parallel.mesh import device as rank_device
    ckpt = load_checkpoint(path)
    dev = rank_device() if device is None else torch.device(device)
    ckpt["model"] = {k: v.to(dev) for k, v in ckpt["model"].items()}
    return ckpt


def is_torch_checkpoint(path: str) -> bool:
    """True for a ``torch.save`` file: a zip archive (``PK``) or a legacy
    pickle (protocol 2 and later start with the PROTO opcode ``0x80``).
    False for a tts_tpu checkpoint: a msgpack map of 1-15 keys (fixmap
    0x81-0x8F; 0x80, the empty map, cannot hold ``params``), map16 (0xDE) or
    map32 (0xDF). Raises for anything else."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK" or head[:1] == b"\x80":
        return True
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return False
    raise ValueError(f"{path}: neither a torch.save file nor a tts_tpu "
                     f"(flax msgpack) checkpoint")


def load_tts_tpu_checkpoint(path: str) -> Dict[str, Any]:
    """A tts_tpu checkpoint (``tts_tpu/train/checkpoint.py::save_checkpoint``)
    -> {"params", "batch_stats", "meta"}: nested dicts of numpy arrays (a
    bfloat16 leaf as a torch tensor) and the meta dict (step, epoch, r,
    model_loss, date)."""
    from tts_tpu_torch.compat.msgpack import msgpack_restore
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: a msgpack file without 'params'")
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats") or {},
            "meta": tree.get("meta") or {}}


def save_best_model(current_loss: float, best_loss: float, output_dir: str,
                    **kwargs) -> float:
    """Keep ``best_model.pt`` at the lowest loss seen; returns the best."""
    if current_loss < best_loss:
        kwargs.pop("prefix", None)
        path = save_checkpoint(output_dir, model_loss=current_loss,
                               prefix="best_model_tmp", **kwargs)
        os.replace(path, os.path.join(output_dir, "best_model.pt"))
        return current_loss
    return best_loss


def latest_checkpoint(output_dir: str, prefix: str = "checkpoint"
                      ) -> Optional[str]:
    """The checkpoint ``<prefix>_<step>.pt`` with the highest step, or None
    (``checkpoint_disc_<step>.pt`` is not a ``checkpoint``)."""
    pattern = re.compile(re.escape(prefix) + r"_(\d+)\.pt$")
    steps = {}
    for path in glob.glob(os.path.join(output_dir, f"{prefix}_*.pt")):
        m = pattern.match(os.path.basename(path))
        if m:
            steps[path] = int(m.group(1))
    return max(steps, key=steps.get) if steps else None
