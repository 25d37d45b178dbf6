"""Profiling hooks on ``torch.profiler`` (≙ tts_tpu/utils/profiler.py:
``trace``, ``annotate``, ``memory_stats``).

``trace`` writes a Chrome/Perfetto trace of the enclosed block (CPU
activity, and the card's where CUDA is available); ``annotate`` names a
region of it. tts_tpu's ``start_server`` (an on-demand profiling server
for TensorBoard's capture tool) has no torch counterpart and is not
ported."""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write its trace to
    ``<log_dir>/trace.json``; yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield


def memory_stats() -> Optional[Dict[str, dict]]:
    """``torch.cuda.memory_stats`` of each CUDA device, by device name;
    None without CUDA."""
    if not torch.cuda.is_available():
        return None
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
