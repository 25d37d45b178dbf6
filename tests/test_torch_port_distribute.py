"""The port's launcher (``bin/distribute.py``) and the data-parallel
trainers at a gloo world of 2 on the CPU, and what they refuse.

- ``bin/distribute`` runs the port's ``_dist_smoke`` (an all-reduce of
  every rank, the DP Tacotron2 step against the single-process step, a
  rank-0 checkpoint restored equal on every rank);
- ``bin/train_tts`` and ``bin/train_glow_tts`` train at a world of 2
  through the launcher with ``use_data_parallel`` on a tiny synthetic
  corpus (Tacotron2 at its shipped widths, 2 items a rank; Glow at a
  global batch of 4): every loss rank 0 prints is finite, and the run
  holds one run folder with the one checkpoint rank 0 wrote;
- a rank that fails ends the launch with a non-zero code while its peer
  waits in a collective, and nothing hangs;
- refused: NCCL asked for on CPU ranks, CUDA ranks without CUDA, more ranks
  than CUDA devices without gloo, a mesh or a DP step without a process
  group, a Glow batch the ranks do not divide.

Each launch starts 2 ranks of one script (one thread each); the ranks'
own checks against tts_tpu are ``test_torch_port_parallel.py``'s.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from tests.fixtures import make_ljspeech_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def launch(script, *args, env=None, n=2):
    """``bin/distribute`` over ``n`` CPU ranks of ``script``: (exit code,
    stdout, stderr, seconds)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **(env or {}))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tts_tpu_torch.bin.distribute", "--script",
         script, "--num_processes", str(n), "--backend", "gloo", "--",
         *args, "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=LAUNCH_TIMEOUT_S)
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t0


def test_launcher_runs_the_dist_smoke_on_two_ranks():
    rc, out, err, _ = launch("_dist_smoke")
    assert rc == 0, err
    assert "dist_smoke OK: 2 processes, backend gloo, all_reduce=3.0" in out
    assert "written=['checkpoint_7.pt']" in out


def test_a_failing_rank_fails_the_launch_without_a_hang(tmp_path):
    """Rank 0 cannot write its checkpoint (its folder is a file's child)
    while rank 1 waits for it at the barrier: the launcher ends rank 1 and
    exits non-zero within seconds, not at the group's timeout."""
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    rc, out, err, seconds = launch(
        "_dist_smoke", env={"TTS_TPU_TORCH_SMOKE_CKPT_DIR":
                            str(blocker / "checkpoints")})
    assert rc != 0
    assert "dist_smoke OK" not in out
    assert "NotADirectoryError" in err or "FileExistsError" in err, err
    assert seconds < LAUNCH_TIMEOUT_S / 2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_corpus")
    return str(tmp), make_ljspeech_fixture(str(tmp / "lj"), n_items=10)


def _config(corpus, name, **overrides):
    from tts_tpu_torch.config import load_config
    root, lj = corpus
    c = load_config(os.path.join(ROOT, "configs", f"{name}.json"))
    c.update(datasets=[{"name": "ljspeech", "path": lj,
                        "meta_file_train": "metadata.csv"}],
             phoneme_cache_path=os.path.join(root, "phonemes"), epochs=1,
             use_data_parallel=True, print_step=1, **overrides)
    path = os.path.join(root, f"{name}_dp.json")
    with open(path, "w") as f:
        json.dump(c, f)
    return path


def _losses(stdout, key="loss"):
    return [float(v) for v in re.findall(rf"\| > {key}: (\S+)", stdout)]


@pytest.mark.parametrize("script,name,overrides,files", [
    ("train_tts", "tacotron2_ljspeech",
     dict(gradual_training=[[0, 7, 2]], run_eval=False,
          run_test_sentences=False), {"checkpoint_2.pt"}),
    ("train_glow_tts", "glow_tts_ljspeech", dict(batch_size=4),
     {"checkpoint_2.pt", "best_model.pt"}),
])
def test_trainers_train_data_parallel_through_the_launcher(
        corpus, tmp_path, script, name, overrides, files):
    from tts_tpu_torch.train.checkpoint import load_checkpoint
    cfg = _config(corpus, name, **overrides)
    runs = tmp_path / "runs"
    rc, out, err, _ = launch(script, "--config_path", cfg, "--output_path",
                             str(runs))
    assert rc == 0, err
    assert "torch.distributed: 2 rank(s), backend gloo" in out
    [folder] = os.listdir(runs)
    written = set(os.listdir(runs / folder))
    assert files <= written
    assert not {f for f in written if f.endswith(".pt")} - files
    ckpt = load_checkpoint(str(runs / folder / "checkpoint_2.pt"))
    assert ckpt["step"] == 2
    key = "avg_loss" if script == "train_glow_tts" else "loss"
    losses = _losses(out, key)
    assert losses and all(math.isfinite(v) for v in losses), out


def test_refusals(monkeypatch, tmp_path):
    import torch.distributed as dist
    from tts_tpu_torch.bin import distribute
    from tts_tpu_torch.parallel import make_dp_train_step, make_mesh
    from tts_tpu_torch.parallel import mesh as M
    from tts_tpu_torch.train import trainer_glow

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="NCCL backend needs CUDA ranks"):
        M.initialize_multihost(f"file://{tmp_path}/store", 1, 0,
                               backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.initialize_multihost(f"file://{tmp_path}/store", 1, 0)
    with pytest.raises(SystemExit):
        distribute.main(["--script", "_dist_smoke", "--num_processes", "2"])
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_dp_train_step(torch.nn.Linear(1, 1), None, None)
    monkeypatch.setattr(trainer_glow, "data_mesh", lambda c: object())
    monkeypatch.setattr(trainer_glow, "rank_and_world", lambda: (0, 2))
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        trainer_glow.GlowTTSTrainer({"batch_size": 3}, str(tmp_path),
                                    device="cpu")
