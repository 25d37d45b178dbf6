"""Start N ranks of a ``tts_tpu_torch.bin`` script on this machine (≙
tts_tpu/bin/distribute.py; the reference's per-GPU launcher).

    python -m tts_tpu_torch.bin.distribute --script train_tts \
        [--num_processes N] [--backend nccl|gloo] [--port P] \
        -- --config_path C.json --output_path runs/

Each rank runs ``python -m tts_tpu_torch.bin.<script> <args>
--coordinator_address localhost:<port> --num_processes N --process_id r``
(and ``--backend`` where given), one process per GPU: rank r on
``cuda:{r % device count}``. N defaults to the visible CUDA devices; more
ranks than devices need ``--backend gloo`` (NCCL refuses two ranks on one
card), and CPU ranks (``-- --device cpu``) gloo too. The port is a free one
unless ``--port`` names it.

Rank 0 keeps stdout; every rank keeps stderr. When a rank exits with an
error the others are ended, so nothing waits on a dead peer; the
launcher's exit code is the OR of the ranks' codes (a rank ended by a
signal counts 128 + the signal).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

POLL_S = 0.2
GRACE_S = 10.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _code(rc: int) -> int:
    return rc if rc >= 0 else 128 - rc


def wait_all(procs) -> int:
    """Wait for every rank; the first to fail ends the others. Returns the
    OR of the exit codes."""
    codes = [None] * len(procs)
    while any(c is None for c in codes):
        for i, p in enumerate(procs):
            if codes[i] is None and p.poll() is not None:
                codes[i] = _code(p.returncode)
                if codes[i]:
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
                    deadline = time.monotonic() + GRACE_S
                    for q in procs:
                        try:
                            q.wait(max(deadline - time.monotonic(), 0.1))
                        except subprocess.TimeoutExpired:
                            q.kill()
                            q.wait()
        time.sleep(POLL_S)
    out = 0
    for c in codes:
        out |= c
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--script", default="train_tts",
                        help="tts_tpu_torch.bin module to run on every rank")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="ranks (default: the visible CUDA devices)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("args", nargs=argparse.REMAINDER,
                        help="arguments for the script, after --")
    args = parser.parse_args(argv)
    fwd = args.args[1:] if args.args[:1] == ["--"] else args.args

    import torch
    n_dev = torch.cuda.device_count()
    n = args.num_processes if args.num_processes is not None else n_dev
    if n < 1:
        parser.error("no CUDA device is visible: give --num_processes, and "
                     "--backend gloo for CPU ranks")
    if n > n_dev and args.backend != "gloo":
        parser.error(f"{n} ranks on {n_dev} CUDA device(s) need "
                     f"--backend gloo (NCCL takes one rank a device)")
    port = args.port or free_port()
    procs = []
    for rank in range(n):
        cmd = [sys.executable, "-m", f"tts_tpu_torch.bin.{args.script}",
               *fwd, "--coordinator_address", f"localhost:{port}",
               "--num_processes", str(n), "--process_id", str(rank)]
        if args.backend:
            cmd += ["--backend", args.backend]
        procs.append(subprocess.Popen(
            cmd, env=dict(os.environ),
            stdout=None if rank == 0 else subprocess.DEVNULL))
    try:
        return wait_all(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(main())
