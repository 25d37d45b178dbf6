"""Data-parallel serving: a batch of utterances split over the ranks of a
mesh's data dim (≙ tts_tpu/infer/serving_dp.py).

tts_tpu ``shard_map``s a synthesis function over a data mesh, its Pallas
kernels running per device. Here every rank holds the same model and runs
the function on its contiguous slice of the batch, the port's kernels (B3
in Glow's encoder, B1/B2 in the vocoder) running on its card; the outputs
are all-gathered along dim 0, so every rank returns what the function
returns on the whole batch.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from tts_tpu_torch.parallel.data_parallel import require_group


def _gather(x, group, n: int):
    """``x`` (a tensor, or a tuple, list or dict of them) gathered over the
    group along dim 0, the ranks' parts in rank order. Every rank's part
    must have the same shape."""
    if isinstance(x, dict):
        return {k: _gather(v, group, n) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_gather(v, group, n) for v in x)
    shape = torch.tensor(list(x.shape), device=x.device)
    shapes = [torch.empty_like(shape) for _ in range(n)]
    dist.all_gather(shapes, shape, group=group)
    if any(not torch.equal(s, shape) for s in shapes):
        raise ValueError(f"the ranks' outputs differ in shape "
                         f"({[s.tolist() for s in shapes]}): give the "
                         f"function a fixed output length")
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def make_dp_serving(fn: Callable, mesh, axis: str = "data") -> Callable:
    """``fn(*batch_tensors) -> outputs`` wrapped to run on this rank's
    contiguous slice of every batch tensor's leading dim and return the
    outputs of the whole batch (tensors with a leading batch dim; a tuple,
    list or dict of them). Every rank must call the wrapper with the same
    batch, whose size the data dim must divide."""
    group, n, rank = require_group(mesh, axis)

    def serve(*batch):
        sizes = {int(b.shape[0]) for b in batch}
        if len(sizes) != 1:
            raise ValueError(f"batch tensors of different sizes {sizes}")
        size = sizes.pop()
        if size % n:
            raise ValueError(f"a batch of {size} does not split over {n} "
                             f"ranks of {axis!r}")
        per = size // n
        out = fn(*(b[rank * per:(rank + 1) * per] for b in batch))
        return _gather(out, group, n)

    return serve
