"""Speaker-encoder trainer (≙ tts_tpu/train/trainer_encoder.py, on one
device): N speakers x M utterances a batch, the (N * M, D) d-vectors
reshaped to (N, M, D), GE2E or AngleProto, and one ``RAdamW`` over the
encoder's parameters and the loss's ``w`` and ``b`` (held together in one
module, ``module``: the gradient clip spans both, as optax's over tts_tpu's
``{"enc", "loss"}`` tree), with tts_tpu's skip of non-finite steps.

Weights start from ``config["seed"]`` (54321 by default; Mozilla's init);
the dataset draws from its own seed (0), as tts_tpu's does, so the two
packages train on the same batches. A background thread draws the next
batches (in order) while the device runs the step. ``compute_embeddings``
gives the sliding-window d-vectors that a multi-speaker TTS model reads
from ``speakers.json``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import torch
from torch import nn

from tts_tpu_torch import DeviceLike, resolve_device
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.data import load_meta_data
from tts_tpu_torch.data.prefetch import prefetch
from tts_tpu_torch.data.speaker_dataset import SpeakerEncoderDataset
from tts_tpu_torch.losses.ge2e import AngleProtoLoss, GE2ELoss
from tts_tpu_torch.models.speaker_encoder import SpeakerEncoder
from tts_tpu_torch.train import checkpoint as ckpt_io
from tts_tpu_torch.train.optim import RAdamW, make_optimizer
from tts_tpu_torch.utils.generic import KeepAverage, StepTimer
from tts_tpu_torch.utils.loggers import ConsoleLogger, TensorboardLogger

def train_step(module: nn.ModuleDict, optimizer: RAdamW, mels: torch.Tensor,
               num_speakers: int, num_utters: int) -> torch.Tensor:
    """Forward, loss, backward and one optimizer step on (N * M, T, n_mel)
    mels, speaker-major. Returns the loss before the update (on the
    device)."""
    optimizer.zero_grad()
    emb = module["model"](mels)
    loss = module["criterion"](emb.view(num_speakers, num_utters, -1))
    loss.backward()
    optimizer.step()
    return loss.detach()


class SpeakerEncoderTrainer:
    def __init__(self, config: Dict[str, Any], output_path: str,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.c = config
        self.output_path = output_path
        os.makedirs(output_path, exist_ok=True)
        self.ap = AudioProcessor(**config["audio"])

        items, _ = load_meta_data(config["datasets"], eval_split_size=0.0)
        storage = config.get("storage", {})
        self.dataset = SpeakerEncoderDataset(
            self.ap, items,
            voice_len_seconds=config.get("voice_len", 1.6),
            num_speakers_in_batch=config["num_speakers_in_batch"],
            num_utters_per_speaker=config["num_utters_per_speaker"],
            skip_speakers=config.get("skip_speakers", True),
            storage_size=storage.get("storage_size", 8),
            sample_from_storage_p=storage.get("sample_from_storage_p", 0.5),
            additive_noise=storage.get("additive_noise", 1e-5))

        mcfg = config.get("model", {})
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.get("seed", 54321))
            model = SpeakerEncoder(
                input_dim=mcfg.get("input_dim",
                                   config["audio"].get("num_mels", 40)),
                proj_dim=mcfg.get("proj_dim", 256),
                lstm_dim=mcfg.get("lstm_dim", 768),
                num_lstm_layers=mcfg.get("num_lstm_layers", 3))
        criterion = (GE2ELoss() if config.get("loss", "ge2e") == "ge2e"
                     else AngleProtoLoss())
        self.module = nn.ModuleDict({"model": model, "criterion": criterion}
                                    ).to(self.device)
        self.optimizer = make_optimizer(self.module,
                                        lr=config.get("lr", 1e-4),
                                        grad_clip=config.get("grad_clip", 3.0))

        self.console = ConsoleLogger()
        self.tb = TensorboardLogger(output_path, "speaker_encoder")
        self.global_step = 0
        self.step_stats: List[Dict[str, float]] = []

    @property
    def model(self) -> SpeakerEncoder:
        return self.module["model"]

    def train(self, num_steps: int) -> Dict[str, float]:
        c = self.c
        N, M = c["num_speakers_in_batch"], c["num_utters_per_speaker"]
        self.module.train()
        keep = KeepAverage()
        timer = StepTimer()
        for batch in prefetch(lambda _: self.dataset.next_batch(),
                              num_steps):
            loader_time = timer.lap()
            mels = torch.from_numpy(batch["mels"]).to(self.device)
            loss = float(train_step(self.module, self.optimizer, mels, N, M))
            stats = {"loss": loss, "step_time": timer.lap(),
                     "loader_time": loader_time}
            keep.update_values({"avg_loss": loss})
            self.step_stats.append(stats)
            self.global_step += 1
            self.tb.tb_train_iter_stats(self.global_step, {"loss": loss})
            if self.global_step % c.get("print_step", 25) == 0:
                print(f" | > step {self.global_step}  loss {loss:.5f}  "
                      f"step {stats['step_time']:.3f}s  loader "
                      f"{loader_time:.3f}s", flush=True)
            if self.global_step % c.get("save_step", 10000) == 0:
                self.save_checkpoint()
        return keep.avg_values

    @torch.no_grad()
    def compute_embeddings(self, mels, **kwargs) -> torch.Tensor:
        """Sliding-window d-vectors of mels (B, T, n_mel), numpy or a
        tensor, on the trainer's device; ``kwargs`` go to
        ``SpeakerEncoder.compute_embedding`` (num_frames, overlap)."""
        model = self.model
        was_training = model.training
        model.eval()
        try:
            x = torch.as_tensor(mels, dtype=torch.float32, device=self.device)
            return model.compute_embedding(x, **kwargs)
        finally:
            model.train(was_training)

    def save_checkpoint(self) -> str:
        """``checkpoint_<step>.pt`` with the encoder as ``"model"`` and the
        loss's ``w``/``b`` as ``"criterion"`` (Mozilla's layout)."""
        return ckpt_io.save_checkpoint(
            self.output_path, model=self.model, optimizer=self.optimizer,
            step=self.global_step, config=self.c,
            extra={"criterion": self.module["criterion"].state_dict()})
