"""Run one phase of chip_smoke.py from two checkouts in turns on one card.

    python3 scripts/compare_phase.py OLD_TREE NEW_TREE PHASE [PHASE ...]

PHASE names a function of chip_smoke.py that takes the CUDA device alone
(``gan_kernel_phase``, ``glow_encoder_kernel_phase``, ``mas_phase``,
``kernel_phase``, ``taco2_kernel_phase``). The trees run in the order old,
new, new, old, each in a fresh process that imports that tree's own
chip_smoke.py and tts_tpu_torch, builds that tree's kernels and calls the
phase with TF32 off. Every line the phase prints comes out prefixed with
``[old]`` or ``[new]`` and the run's number; the card's name and power limit
come first. Exits non-zero if a run fails.
"""

import os
import subprocess
import sys

RUN = """
import sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
for name in {phases!r}:
    getattr(chip_smoke, name)(torch.device("cuda"))
"""


def main(argv) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new, phases = (os.path.abspath(argv[0]), os.path.abspath(argv[1]),
                        argv[2:])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    failed = 0
    for i, (label, tree) in enumerate((("old", old), ("new", new),
                                       ("new", new), ("old", old))):
        proc = subprocess.run(
            [sys.executable, "-c", RUN.format(tree=tree, phases=phases)],
            cwd=tree, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            print(f"[{label} {i}] {line}", flush=True)
        if proc.returncode != 0:
            failed += 1
            print(f"[{label} {i}] exit {proc.returncode}:\n{proc.stderr}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
