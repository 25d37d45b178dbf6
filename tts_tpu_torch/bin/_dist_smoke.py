"""Multi-process check of the data-parallel layer (≙
tts_tpu/bin/_dist_smoke.py), run through the launcher:

    python -m tts_tpu_torch.bin.distribute --script _dist_smoke \
        --num_processes 2 --backend gloo -- --device cpu

Each rank checks, and rank 0 prints ``dist_smoke OK`` when all pass:

1. an all-reduce sees every rank's contribution (rank + 1);
2. the data-parallel Tacotron2 step (``make_dp_train_step``, eval mode,
   items of one length) on the ranks' contiguous parts of a global batch
   equals the single-process step on the whole batch, which every rank
   computes on a copy of the model: loss rtol 1e-5, parameters atol 1e-6
   rtol 1e-4 (tts_tpu's tolerances);
3. a checkpoint written by rank 0 alone (``save_checkpoint_multihost``)
   restores equal on every rank.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def _batch(B: int, t_text: int = 8, t_mel: int = 8, r: int = 2):
    rng = np.random.default_rng(0)
    stop = np.zeros((B, t_mel // r), np.float32)
    stop[:, -1] = 1.0
    return {"text": torch.from_numpy(rng.integers(1, 32, (B, t_text))),
            "text_lengths": torch.full((B,), t_text, dtype=torch.int32),
            "mel": torch.from_numpy(rng.standard_normal(
                (B, t_mel, 80)).astype(np.float32)),
            "mel_lengths": torch.full((B,), t_mel, dtype=torch.int32),
            "stop_targets": torch.from_numpy(stop)}


def _model(dev):
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    torch.manual_seed(0)
    return Tacotron2(num_chars=32, r=2, encoder_dim=32, embedding_dim=32,
                     attn_dim=16).to(dev)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    from tts_tpu_torch.parallel import mesh as M
    M.add_arguments(parser)
    args = parser.parse_args(argv)
    dev = M.initialize_multihost(args.coordinator_address,
                                 args.num_processes, args.process_id,
                                 backend=args.backend, device=args.device)
    if dev is None:
        raise SystemExit("run through tts_tpu_torch.bin.distribute")
    import torch.distributed as dist

    from tts_tpu_torch.parallel import make_dp_train_step, make_mesh
    from tts_tpu_torch.parallel.data_parallel import shard_batch
    from tts_tpu_torch.train.checkpoint import (restore_for_mesh,
                                                save_checkpoint_multihost)
    from tts_tpu_torch.train.optim import make_optimizer
    from tts_tpu_torch.train.trainer_tts import train_step

    rank, n = dist.get_rank(), dist.get_world_size()
    assert n == args.num_processes, (n, args.num_processes)
    mesh = make_mesh((("data", -1),))

    # 1. every rank's contribution
    x = torch.tensor([float(rank + 1)], device=dev)
    dist.all_reduce(x)
    total = float(x)
    assert total == n * (n + 1) / 2, total

    # 2. the data-parallel step against the single-process step
    batch = {k: v.to(dev) for k, v in _batch(2 * n).items()}
    single, dp_model = _model(dev), _model(dev)
    with torch.backends.cudnn.flags(enabled=False):  # as the DP step's
        want = train_step(single.eval(), make_optimizer(single, lr=1e-3),
                          batch, {"r": 2})                # eval mode
    step = make_dp_train_step(dp_model, make_optimizer(dp_model, lr=1e-3),
                              mesh, {"r": 2}, train=False)
    got = step(shard_batch(batch, mesh))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for (name, a), b in zip(single.state_dict().items(),
                            dp_model.state_dict().values()):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                   atol=1e-6, rtol=1e-4,
                                   err_msg=f"diverged at {name}")

    # 3. rank 0 writes, every rank restores the same values
    ckpt_dir = os.environ.get("TTS_TPU_TORCH_SMOKE_CKPT_DIR") or \
        M.broadcast_object(tempfile.mkdtemp() if rank == 0 else None)
    path = save_checkpoint_multihost(ckpt_dir, model=dp_model, step=7)
    assert (path is not None) == (rank == 0)
    restored = restore_for_mesh(os.path.join(ckpt_dir, "checkpoint_7.pt"))
    for name, value in dp_model.state_dict().items():
        assert torch.equal(restored["model"][name], value), name
    written = sorted(os.listdir(ckpt_dir))
    if rank == 0:
        print(f"dist_smoke OK: {n} processes, backend "
              f"{dist.get_backend()}, all_reduce={total}, "
              f"loss={got['loss']:.6f}, written={written}", flush=True)
    M.finalize()


if __name__ == "__main__":
    main()
