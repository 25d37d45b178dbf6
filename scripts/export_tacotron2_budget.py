"""Time ``bin/export_model --kind tts`` on Tacotron2 at several decoder-step
budgets, up to configs/tacotron2_ljspeech.json's own (1,000 steps, every
step unrolled into the exported graph).

    python scripts/export_tacotron2_budget.py [--steps 10 100 1000]
        [--timeout 900] [--out_dir DIR]

Each budget runs in a process of its own under ``--timeout`` seconds, on
a seeded full-width model (the shipped config, its r) and a text of 64
symbols, on the CPU as the export does. Prints one JSON line per budget:
the export's seconds and its check against eager as ``export_model``
prints them, the process's wall seconds and exit code, and the last error
line where it failed or ran out of time.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_LENGTH = 64    # symbols in the exported program's input


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, nargs="+",
                        default=[10, 100, 1000])
    parser.add_argument("--timeout", type=float, default=900.0)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--config", default=os.path.join(
        HERE, "configs", "tacotron2_ljspeech.json"))
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols

    root = args.out_dir or tempfile.mkdtemp()
    os.makedirs(root, exist_ok=True)
    c = load_config(args.config)
    torch.manual_seed(0)
    model = setup_model(num_symbols(c.get("use_phonemes", False)), 1, c)
    ckpt = os.path.join(root, "tacotron2.pt")
    torch.save({"model": model.state_dict()}, ckpt)
    for steps in args.steps:
        cfg = os.path.join(root, f"tacotron2_{steps}.json")
        with open(cfg, "w") as f:
            json.dump(dict(c, max_decoder_steps=steps), f)
        cmd = [sys.executable, "-m", "tts_tpu_torch.bin.export_model",
               "--config_path", cfg, "--checkpoint_path", ckpt,
               "--output_path", os.path.join(root, f"tacotron2_{steps}.pt2"),
               "--kind", "tts", "--frames", str(TEXT_LENGTH)]
        t0 = time.perf_counter()
        try:
            run = subprocess.run(cmd, cwd=HERE, capture_output=True,
                                 text=True, timeout=args.timeout)
            rc, out, err = run.returncode, run.stdout, run.stderr
        except subprocess.TimeoutExpired as e:
            rc = None
            out = e.stdout.decode() if isinstance(e.stdout, bytes) else ""
            err = "timed out"
        wall = time.perf_counter() - t0
        line = {"decoder_steps": steps, "returncode": rc, "wall_s": wall,
                "r": c.get("r"), "text_length": TEXT_LENGTH}
        for text in (out or "").splitlines():
            if "exported" in text:
                line["export_model"] = text.strip()
        if rc != 0:
            tail = [t for t in (err or "").splitlines() if t.strip()]
            line["error"] = tail[-1][:400] if tail else err
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
