"""tts_tpu_torch: the PyTorch/CUDA port of ``tts_tpu``.

The layout mirrors ``tts_tpu``: each module sits at the same path as its JAX
counterpart. The port imports nothing of ``tts_tpu`` (nor JAX or flax); the
pure-Python modules it needs (text frontend, config loader, numpy audio) are
copied. Every Pallas kernel of ``tts_tpu`` (on the ported paths: serving
Glow-TTS or Tacotron2, one speaker or many, + Multiband-MelGAN from the
synthesis CLI or the server, training Glow-TTS, Tacotron2, the GAN vocoders
and the speaker encoder) has a hand-written CUDA kernel under ``ops/cuda/``
beside a plain PyTorch version of the same function.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one. Raises when CUDA is asked for (or defaulted to) and absent,
    instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tts_tpu_torch runs on a CUDA device, and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
