"""Generic training utilities: run directories, running averages, timers
(≙ the parts of tts_tpu/utils/generic.py that the trainers use)."""

from __future__ import annotations

import datetime
import os
import subprocess
import time
from typing import Dict


def get_commit_hash() -> str:
    try:
        out = subprocess.check_output(["git", "rev-parse", "--short", "HEAD"],
                                      stderr=subprocess.DEVNULL)
        return out.decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "0000000"


def create_experiment_folder(root_path: str, model_name: str) -> str:
    """<root>/<model>-<date>-<githash>/."""
    date_str = datetime.datetime.now().strftime("%B-%d-%Y_%I+%M%p")
    output_folder = os.path.join(root_path,
                                 f"{model_name}-{date_str}-{get_commit_hash()}")
    os.makedirs(output_folder, exist_ok=True)
    return output_folder


class KeepAverage:
    """Running means of a loss dict, under ``avg_values``."""

    def __init__(self):
        self.avg_values: Dict[str, float] = {}
        self.iters: Dict[str, int] = {}

    def update_values(self, value_dict: Dict[str, float]) -> None:
        for key, value in value_dict.items():
            n = self.iters.get(key, 0)
            self.avg_values[key] = (self.avg_values.get(key, 0.0) * n
                                    + float(value)) / (n + 1)
            self.iters[key] = n + 1


class StepTimer:
    """step_time / loader_time measurement, on the host clock."""

    def __init__(self):
        self._t = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self._t
        self._t = now
        return dt
