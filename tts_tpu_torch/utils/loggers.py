"""Console + TensorBoard logging (≙ the parts of tts_tpu/utils/loggers.py
that the trainers use). TensorBoard is optional: without tensorboardX the
logger writes nothing."""

from __future__ import annotations

import datetime
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
        self.old_eval_loss_dict: Optional[Dict[str, float]] = None

    def print_epoch_start(self, epoch: int, max_epoch: int) -> None:
        print(f"\n{_Colors.BOLD} > EPOCH: {epoch}/{max_epoch}{_Colors.END}")

    def print_train_start(self) -> None:
        now = datetime.datetime.now().strftime("%H:%M:%S")
        print(f"\n{_Colors.BOLD} > TRAINING ({now}) {_Colors.END}")

    def print_train_step(self, batch_steps: int, step: int, global_step: int,
                         loss_dict: Dict[str, float],
                         avg_loss_dict: Dict[str, float]) -> None:
        print(f"\n   --> STEP: {step}/{batch_steps} -- GLOBAL_STEP: "
              f"{global_step}")
        for key, value in loss_dict.items():
            avg = avg_loss_dict.get(f"avg_{key}")
            extra = f" ({avg:.5f})" if avg is not None else ""
            print(f"     | > {key}: {float(value):.5f}{extra}")

    def print_train_epoch_end(self, global_step: int, epoch: int,
                              epoch_time: float,
                              avg_loss_dict: Dict[str, float]) -> None:
        print(f"   --> TRAIN PERFORMANCE -- EPOCH TIME: {epoch_time:.2f} sec "
              f"-- GLOBAL_STEP: {global_step}")
        for key, value in avg_loss_dict.items():
            prev = (self.old_train_loss_dict or {}).get(key)
            print(f"     | > {key}: {_tcolor_delta(float(value), prev)}")
        self.old_train_loss_dict = {k: float(v) for k, v in avg_loss_dict.items()}

    def print_eval_start(self) -> None:
        print(f"\n{_Colors.BOLD} > EVALUATION {_Colors.END}\n")

    def print_epoch_end(self, epoch: int,
                        avg_loss_dict: Dict[str, float]) -> None:
        print("\n  --> EVAL PERFORMANCE")
        for key, value in avg_loss_dict.items():
            prev = (self.old_eval_loss_dict or {}).get(key)
            print(f"     | > {key}: {_tcolor_delta(float(value), prev)}")
        self.old_eval_loss_dict = {k: float(v) for k, v in avg_loss_dict.items()}


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

    def tb_eval_stats(self, step: int, stats: Dict) -> None:
        self._scalars(f"{self.model_name}_EvalStats", stats, step)

    def tb_eval_audios(self, step: int, audios: Dict,
                       sample_rate: int) -> None:
        """Mono waveforms as audio summaries, encoded as 16-bit WAV by the
        port (tensorboardX's ``add_audio`` needs soundfile)."""
        if self.writer is None:
            return
        from tensorboardX.proto.summary_pb2 import Summary

        from tts_tpu_torch.audio.processor import wav_to_bytes
        for key, wav in audios.items():
            audio = Summary.Audio(
                sample_rate=sample_rate, num_channels=1,
                length_frames=len(wav), content_type="audio/wav",
                encoded_audio_string=wav_to_bytes(wav, sample_rate))
            tag = f"{self.model_name}_EvalAudios/{key}"
            self.writer._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)

    def tb_eval_figures(self, step: int, figures: Dict) -> None:
        """matplotlib figures as image summaries; each figure is closed."""
        for key, fig in figures.items():
            if self.writer is not None:
                self.writer.add_figure(f"{self.model_name}_EvalFigures/{key}",
                                       fig, step)
            import matplotlib.pyplot as plt
            plt.close(fig)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


class NullLogger:
    """A console or TensorBoard logger that does nothing: what a
    data-parallel rank other than 0 logs through."""

    def __getattr__(self, name: str):
        return lambda *args, **kwargs: None
