"""Process group, device mesh and rank helpers (≙ tts_tpu/parallel/mesh.py).

tts_tpu runs one SPMD program over a ``jax.sharding.Mesh``; PyTorch runs
one process per GPU. Here a rank joins a ``torch.distributed`` process
group (``initialize_multihost``), takes its device (``cuda:{rank %
device_count}`` unless the caller asks for the CPU), and
``make_mesh`` lays the ranks out as a ``DeviceMesh`` with named dims
(``"data"``, and ``"model"`` for the channel-sharded vocoder), the
counterpart of tts_tpu's mesh axes. Every process group has a timeout, so
a dead peer ends a collective with an error instead of a hang.

The backend is NCCL for CUDA ranks and gloo for CPU ranks, or gloo where
the caller names it (several ranks sharing one card: NCCL refuses two ranks
on one device). It is never chosen quietly: rank 0 prints it. Nothing falls
back: NCCL asked for on the CPU, or CUDA asked for where there is none,
raises.
"""

from __future__ import annotations

import datetime
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
# the device this process's rank runs on, set by initialize_multihost
_rank_device: Optional[torch.device] = None


def rank_device(rank: int, device=None) -> torch.device:
    """``cuda:{rank % device_count}`` for ``device`` None or ``"cuda"``; the
    CPU, or a named CUDA device, where the caller asks for it. Raises where
    CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank was asked for and no CUDA device is "
                           "available; pass device='cpu' for CPU ranks")
    if dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S
                         ) -> Optional[torch.device]:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (≙ ``jax.distributed.initialize``; a no-op that returns
    None without a coordinator, as in tts_tpu). ``coordinator_address`` is
    ``host:port`` (TCP) or a URL such as ``file:///path``. Returns the
    rank's device, which becomes its current CUDA device."""
    global _rank_device
    if coordinator_address is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    dev = rank_device(process_id, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the NCCL backend needs CUDA ranks; rank "
                             f"{process_id} runs on {dev}")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL backend")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device = dev
    if process_id == 0:
        print(f" > torch.distributed: {num_processes} rank(s), backend "
              f"{backend}, rank 0 on {dev}", flush=True)
    return dev


def device() -> torch.device:
    """This rank's device (the CPU when no process group was joined)."""
    return _rank_device or torch.device("cpu")


def make_mesh(axes: Sequence[Tuple[str, int]] = (("data", -1),)):
    """A ``DeviceMesh`` over the process group's ranks from (dim name,
    size) pairs; -1 infers the remainder (at most one). Default: one
    ``"data"`` dim over every rank. Raises where no process group was
    joined: a mesh is never a quiet world of one."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost "
                           "first")
    n = dist.get_world_size()
    sizes = [s for _, s in axes]
    n_infer = sum(1 for s in sizes if s == -1)
    assert n_infer <= 1, "at most one inferred axis"
    known = int(np.prod([s for s in sizes if s != -1])) if any(
        s != -1 for s in sizes) else 1
    if n_infer:
        assert n % known == 0, f"{n} ranks not divisible by {known}"
        sizes = [n // known if s == -1 else s for s in sizes]
    assert int(np.prod(sizes)) == n, f"mesh {sizes} != {n} ranks"
    return init_device_mesh(device().type, tuple(sizes),
                            mesh_dim_names=tuple(name for name, _ in axes))


def data_mesh(config) -> Optional[Any]:
    """A trainer's mesh: a ``"data"`` dim over every rank where the config
    sets ``use_data_parallel`` and a process group was joined; else None,
    and the trainer runs its single-device step (said once where
    ``use_data_parallel`` is set)."""
    if not config.get("use_data_parallel", False):
        return None
    if not dist.is_initialized():
        print(" > use_data_parallel without a process group: one device "
              "(bin/distribute.py launches one rank per GPU)")
        return None
    return make_mesh((("data", -1),))


def axis_group(mesh, axis: str) -> Tuple[Any, int, int]:
    """(process group, size, this rank's index) of ``mesh``'s dim
    ``axis``."""
    return (mesh.get_group(axis), mesh[axis].size(),
            mesh.get_local_rank(axis))


def is_primary() -> bool:
    """Rank 0, or a process outside any group (≙ ``jax.process_index() ==
    0``): it alone prints, logs and writes checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_and_world() -> Tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank; ``obj`` itself without a
    process group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def finalize() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def add_arguments(parser) -> None:
    """The multi-process flags of the training CLIs (``bin/distribute.py``
    passes the first three)."""
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port (or file:// URL) of rank 0's store")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="default: nccl for CUDA ranks, gloo for CPU")


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(per-rank batch, this rank's offset) of a global batch."""
    rank, n = rank_and_world()
    assert global_batch % n == 0, (global_batch, n)
    per = global_batch // n
    return per, per * rank


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate_global(tree, group=None):
    """Every tensor of ``tree`` (nested dicts, lists, a module's state) set
    to rank 0's values on every rank, in place (≙ ``replicate_global``:
    there every process holds the same values; here rank 0's are
    broadcast, so they are the same bit for bit). Returns ``tree``."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    for t in _tensors(tree):
        # NCCL takes contiguous tensors only (a flow's 1x1 weight is a view)
        buf = t.data if t.is_contiguous() else t.data.contiguous()
        dist.broadcast(buf, src=src, group=group)
        if buf is not t.data:
            t.data.copy_(buf)
    return tree


def host_local_to_global(tree, mesh, axis: str = "data"):
    """Each rank's local batch (leading dim) -> the global batch on every
    rank, the ranks' parts in rank order along dim 0 (≙
    ``host_local_to_global``). Tensors of ndim 0 and other leaves are kept
    as they are."""
    group, n, _ = axis_group(mesh, axis)

    def gather(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    if isinstance(tree, dict):
        return {k: host_local_to_global(v, mesh, axis) if isinstance(
            v, (dict, list, tuple)) else gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_local_to_global(v, mesh, axis) for v in tree)
    return gather(tree)
