"""Console + TensorBoard logging (≙ the parts of tts_tpu/utils/loggers.py
that the trainers use). TensorBoard is optional: without tensorboardX the
logger writes nothing."""

from __future__ import annotations

from typing import Dict, Optional


class _Colors:
    BOLD = "\033[1m"
    RED = "\033[91m"
    GREEN = "\033[92m"
    END = "\033[0m"


def _tcolor_delta(value: float, prev: Optional[float]) -> str:
    if prev is None:
        return f"{value:.5f}"
    diff = value - prev
    color = _Colors.GREEN if diff <= 0 else _Colors.RED
    return f"{value:.5f} {color}({diff:+.5f}){_Colors.END}"


class ConsoleLogger:
    def __init__(self):
        self.old_train_loss_dict: Optional[Dict[str, float]] = None

    def print_epoch_start(self, epoch: int, max_epoch: int) -> None:
        print(f"\n{_Colors.BOLD} > EPOCH: {epoch}/{max_epoch}{_Colors.END}")

    def print_train_epoch_end(self, global_step: int, epoch: int,
                              epoch_time: float,
                              avg_loss_dict: Dict[str, float]) -> None:
        print(f"   --> TRAIN PERFORMANCE -- EPOCH TIME: {epoch_time:.2f} sec "
              f"-- GLOBAL_STEP: {global_step}")
        for key, value in avg_loss_dict.items():
            prev = (self.old_train_loss_dict or {}).get(key)
            print(f"     | > {key}: {_tcolor_delta(float(value), prev)}")
        self.old_train_loss_dict = {k: float(v) for k, v in avg_loss_dict.items()}


class TensorboardLogger:
    """tensorboardX writer wrapper; tolerates a missing tensorboardX."""

    def __init__(self, log_dir: str, model_name: str = "TTS"):
        self.model_name = model_name
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(log_dir)
        except ImportError:
            self.writer = None

    def _scalars(self, scope: str, stats: Dict, step: int) -> None:
        if self.writer is None:
            return
        for key, value in stats.items():
            self.writer.add_scalar(f"{scope}/{key}", float(value), step)

    def tb_train_iter_stats(self, step: int, stats: Dict) -> None:
        self._scalars(f"{self.model_name}_TrainIterStats", stats, step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
