"""Data-parallel training over torch.distributed (≙
tts_tpu/parallel/data_parallel.py).

tts_tpu ``pmean``s the gradients over the mesh's data axis inside its
compiled step (≙ the reference's ``apply_gradient_allreduce``: an
all-reduce SUM divided by the world size). Here each rank runs the forward
and backward on its part of the batch, then ``average_gradients`` flattens
the gradients into buckets, all-reduces each with SUM and divides by the
size of the data dim: the mean before the optimizer, so the port's
``RAdamW`` clips the averaged gradients, as optax's chain does after
``pmean``. The losses are averaged with one collective. Only collectives
that NCCL and gloo both have are used (``all_reduce`` SUM, ``broadcast``;
gloo has no AVG).

``DistributedDataParallel`` is not used: it broadcasts rank 0's buffers at
each forward where tts_tpu averages BatchNorm's running statistics
(``average_running_stats``), and in the GAN step it would all-reduce
discriminator gradients that tts_tpu never takes (the generator's loss
back-propagates through the frozen discriminator).

Each rank draws its dropout masks from a generator seeded with
``rank_seed(seed, rank)`` (≙ ``fold_in(axis_index)``): ranks drop different
units, so the step is not the single-device step in train mode. With
``train=False`` and items of one length, the mean of the ranks' masked
means is the global batch's, and the step equals the single-device step on
the global batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tts_tpu_torch.parallel.mesh import axis_group, replicate_global

BUCKET_BYTES = 25 * 2 ** 20     # DDP's default bucket
Batch = Dict[str, Any]


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed of its own for each rank of a seed (≙
    ``jax.random.fold_in(key, axis_index)``)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def rank_generator(model: nn.Module, seed: int, rank: int
                   ) -> torch.Generator:
    """A generator on ``model``'s device seeded with ``rank_seed``."""
    dev = next(model.parameters()).device
    return torch.Generator(dev).manual_seed(rank_seed(seed, rank))


def replicate(module: nn.Module, mesh=None, axis: str = "data") -> nn.Module:
    """Rank 0's parameters and buffers on every rank of ``mesh``'s data dim
    (or of the whole group), in place: every rank starts the same."""
    group = axis_group(mesh, axis)[0] if mesh is not None else None
    replicate_global(list(module.parameters()) + list(module.buffers()),
                     group)
    return module


def unreplicate(tree):
    """One copy of a replicated tree on the host: tensors detached onto the
    CPU, a module as its state dict."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: unreplicate(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unreplicate(v) for v in tree)
    return tree


def shard_batch(batch: Batch, mesh, axis: str = "data") -> Batch:
    """This rank's contiguous slice of the leading dim of every tensor and
    array of ``batch`` (≙ ``shard_batch``'s ``P(axis)``); other entries
    (``item_idxs``) are kept whole. Refuses a batch the data dim does not
    divide."""
    _, n, rank = axis_group(mesh, axis)

    def part(x):
        if not hasattr(x, "ndim") or x.ndim < 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{n} ranks of {axis!r}")
        per = x.shape[0] // n
        return x[rank * per:(rank + 1) * per]

    return {k: part(v) if k != "item_idxs" else v for k, v in batch.items()}


def all_reduce_mean_(tensors: List[torch.Tensor], group, n: int,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Each tensor replaced by its mean over the ``n`` ranks of ``group``:
    flattened into buckets of one dtype up to ``bucket_bytes``, each
    all-reduced with SUM and divided by ``n``."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        buckets: List[List[torch.Tensor]] = [[]]
        size = 0
        for t in same:
            nbytes = t.numel() * t.element_size()
            if buckets[-1] and size + nbytes > bucket_bytes:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += nbytes
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            flat.div_(n)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def average_gradients(params: Iterable[torch.Tensor], group, n: int) -> None:
    """The ranks' mean gradient in every parameter's ``.grad`` (a missing
    gradient counts as zero, as in the optimizer, so every rank reduces the
    same buckets)."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_mean_([p.grad for p in params], group, n)


def running_stats(module: nn.Module) -> List[torch.Tensor]:
    """Every BatchNorm's running mean and variance under ``module``."""
    return [t for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._NormBase)
            and m.track_running_stats
            for t in (m.running_mean, m.running_var)]


def average_running_stats(module: nn.Module, group, n: int) -> None:
    """BatchNorm's running statistics averaged over the ranks (≙ the
    ``pmean`` of ``batch_stats``); each rank normalised by its own batch's
    statistics (no SyncBatchNorm)."""
    stats = running_stats(module)
    if stats:
        all_reduce_mean_(stats, group, n)


def average_losses(losses: Dict[str, torch.Tensor], group,
                   n: int) -> Dict[str, float]:
    """The ranks' mean of each loss, with one collective, as floats."""
    keys = list(losses)
    flat = torch.stack([losses[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return dict(zip(keys, (flat / n).tolist()))


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the parameters' gradients (≙
    ``optax_global_norm``)."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def require_group(mesh, axis: str):
    if not dist.is_initialized():
        raise RuntimeError("a data-parallel step needs a process group: "
                           "call parallel.mesh.initialize_multihost first")
    return axis_group(mesh, axis)


def make_dp_train_step(model: nn.Module, optimizer, mesh,
                       loss_kwargs: Optional[Dict] = None, *,
                       seed: int = 54321,
                       generator: Optional[torch.Generator] = None,
                       axis: str = "data",
                       mixed_precision: bool = False,
                       train: bool = True) -> Callable[[Batch], Dict]:
    """The Tacotron-family step on this rank's part of the batch (≙
    ``make_dp_train_step``): forward (in bfloat16 with
    ``mixed_precision``, as ``trainer_tts.forward``), ``tacotron_loss``,
    backward, gradients averaged over the data dim, one optimizer step on
    the mean, BatchNorm's running statistics averaged, the losses averaged
    with ``grad_norm``, the global norm of the averaged gradients, added.
    Returns step(batch) -> losses as floats (before the update).

    ``train=False`` runs the model in eval mode (no dropout, running
    statistics used and kept), the deterministic step of tts_tpu's
    ``train=False``; it runs without cuDNN, whose RNN has no backward in
    eval mode. Dropout draws from ``generator``, by default one seeded
    with ``rank_seed(seed, rank)``."""
    from tts_tpu_torch.losses.tts_losses import tacotron_loss
    from tts_tpu_torch.train.trainer_tts import forward

    group, n, rank = require_group(mesh, axis)
    loss_kwargs = dict(loss_kwargs or {})
    loss_kwargs.setdefault("r", model.r)
    dtype = torch.bfloat16 if mixed_precision else torch.float32
    model.set_generator(generator or rank_generator(model, seed, rank))
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Batch) -> Dict[str, float]:
        model.train(train)
        optimizer.zero_grad()
        # cuDNN's RNN has no backward in eval mode: the eval-mode step
        # takes PyTorch's own kernels
        with torch.backends.cudnn.flags(enabled=train):
            losses = tacotron_loss(forward(model, batch, dtype), batch,
                                   **loss_kwargs)
            losses["loss"].backward()
        average_gradients(params, group, n)
        optimizer.step()
        average_running_stats(model, group, n)
        out = average_losses(losses, group, n)
        out["grad_norm"] = float(global_norm(params))
        return out

    return step


def make_glow_dp_train_step(model: nn.Module, optimizer, mesh, *,
                            seed: int = 54321,
                            generator: Optional[torch.Generator] = None,
                            axis: str = "data",
                            train: bool = True) -> Callable[[Batch], Dict]:
    """The Glow-TTS step on this rank's part of the batch (≙
    ``make_glow_dp_train_step``): the forward with monotonic alignment
    search per rank (B4 on the card), ``glow_tts_loss``, backward,
    gradients and losses averaged over the data dim, one optimizer step.
    ActNorm's data-dependent init is the caller's, on the first global
    batch before ``replicate`` (``trainer_glow.GlowTTSTrainer``). Returns
    step(batch) -> losses as floats (before the update)."""
    from tts_tpu_torch.models.glow_tts import glow_tts_loss

    group, n, rank = require_group(mesh, axis)
    model.set_generator(generator or rank_generator(model, seed, rank))
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Batch) -> Dict[str, float]:
        model.train(train)
        optimizer.zero_grad()
        out = model(batch["text"], batch["text_lengths"], batch["mel"],
                    batch["mel_lengths"], batch.get("speaker_ids"),
                    batch.get("speaker_embeddings"))
        losses = glow_tts_loss(out, batch["text_lengths"])
        losses["loss"].backward()
        average_gradients(params, group, n)
        optimizer.step()
        average_running_stats(model, group, n)
        return average_losses(losses, group, n)

    return step
