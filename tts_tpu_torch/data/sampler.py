"""Per-rank data sharding (≙ tts_tpu/data/sampler.py, the reference's
non-shuffling DistributedSampler).

Each rank of a data-parallel run loads only its stride-slice of the
(shuffled or length-sorted) index list, so the order within a shard is the
list's order.
"""

from __future__ import annotations

from typing import List, Sequence


def shard_indices(indices: Sequence[int], num_shards: int,
                  shard_id: int) -> List[int]:
    """Pad to a multiple of ``num_shards`` (wrapping round to the list's
    start), then stride-slice: ``indices[shard_id::num_shards]``. Every
    shard has the same length."""
    assert 0 <= shard_id < num_shards
    indices = list(indices)
    total = ((len(indices) + num_shards - 1) // num_shards) * num_shards
    indices = indices + indices[: total - len(indices)]
    return indices[shard_id::num_shards]
