"""Run chosen phases of chip_smoke.py on the card, after building the
kernels: the quick way to check a slice's phases without the whole script.

    python scripts/run_phases.py multi_device_phase [more phase names]

Each phase is called as ``fn(dev, root, card)`` with a fresh temporary
directory (``batched_phase(dev, card)`` and the kernel phases ``fn(dev)``
take what their signatures ask for); phases that take earlier phases'
results are given None. Prints the card's name and power limit first.
"""

import inspect
import os
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def main(names) -> int:
    if not torch.cuda.is_available():
        print("run_phases: no CUDA device", file=sys.stderr)
        return 1
    from tts_tpu_torch.ops.cuda import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_identity()
    chip_smoke.log(card)
    chip_smoke.log({"kernel_build_s": build.build_all()})
    dev = torch.device("cuda")
    for name in names:
        fn = getattr(chip_smoke, name)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            given = {"dev": dev, "root": root, "card": card}
            fn(*[given.get(p, None)
                 for p in inspect.signature(fn).parameters])
        chip_smoke.log({"phase_fn": name,
                        "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
