"""Tacotron2 and Tacotron (v1) trainer (≙ tts_tpu/train/trainer_tts.py and
the step of tts_tpu/train/state.py, on one device).

Per epoch: the reduction factor r and the batch size from the
gradual-training schedule (``Tacotron2.set_r``; a dataset per split and r),
then per batch the teacher-forced forward (with the DDC coarse decoder and
the backward decoder where configured), ``tacotron_loss``, backward and
one optimizer step (``train_step``). The training step runs no TPU kernel
in tts_tpu either: the encoder's LSTM runs as cuDNN on the card (the B7
kernel has no backward). After each epoch, ``eval_epoch`` on the held-out
split (dropout off, BatchNorm's running statistics, no grad), the best
model by ``avg_postnet_loss``, and from ``test_delay_epochs`` on
``test_run``: the test sentences through ``infer/synthesis.py``, so B7 and
B8 run on the card, with Griffin-Lim audio and, as in tts_tpu, each
sentence's spectrogram and alignment figures logged to TensorBoard. As in
tts_tpu, a sentence that raises is reported (`` [!] test sentence
failed: ...``) and the next one runs: a bad sentence does not end
training. Where matplotlib is missing the figures are skipped (said once)
and the audio is logged all the same.

Tacotron v1 (``model`` "tacotron") trains the same way, as tts_tpu's
trainer does: gradual r, eval epochs, checkpoints; no DDC or backward
decoder (v1 has neither). Its batches carry the linear spectrogram
(``compute_linear_spec``) and its post-net loss is against it
(``use_linear``); its test sentences are Griffin-Lim of the linear output
(``infer/synthesis.py::inv_spectrogram``). No kernel runs in its step or its
test sentences: B7 and B8 compute Tacotron2 only.

With ``use_speaker_embedding`` the model is multi-speaker as in tts_tpu:
one learned embedding per speaker of the training split, or with
``use_external_speaker_embedding_file`` the d-vectors of that speakers.json
(keyed by wav path; the speakers are its names), which the batches carry.
``use_gst`` adds the GST layer, its style mel the target mel. The test
sentences of such a model are skipped: tts_tpu's ``test_run`` passes no
speaker and no style, and each of its sentences fails (ROADMAP C19).

``mixed_precision`` is tts_tpu's: bfloat16 copies of the parameters run the
forward (``torch.func.functional_call``) on a bfloat16 mel; the outputs
return to float32 before the loss, and the float32 masters take the
gradients. BatchNorm's running statistics stay float32. Weights start from
``config["seed"]`` (54321 by default); every dropout mask comes from the
trainer's ``torch.Generator``. In mixed precision the layers from the
encoder's RNN on compute in float32 on the bfloat16-rounded weights, as
flax's float32 RNN carries make tts_tpu's do (``mixed_params``); external
d-vectors stay float32.

With ``use_data_parallel`` in a process group (``bin/distribute.py``
launches one rank per GPU) the step is ``parallel.make_dp_train_step``:
each rank trains on its stride shard of the items at ``batch_size`` a
rank (``num_shards`` / ``shard_id``, as tts_tpu's trainer shards by
process), its dropout generator seeded from (seed, rank), gradients,
losses and BatchNorm's running statistics averaged over the ranks. Rank 0
alone prints, logs, evaluates, runs the test sentences (B7 and B8 there)
and writes checkpoints; every rank waits at a barrier after a write.
Without a process group ``use_data_parallel`` trains on the one device.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from tts_tpu_torch import DeviceLike, resolve_device
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.config import check_config_tts
from tts_tpu_torch.data import TTSDataset, load_meta_data
from tts_tpu_torch.data.formatters import get_speakers
from tts_tpu_torch.infer.synthesis import synthesis
from tts_tpu_torch.losses.tts_losses import tacotron_loss
from tts_tpu_torch.models.registry import setup_model
from tts_tpu_torch.parallel.data_parallel import rank_seed, replicate
from tts_tpu_torch.parallel.mesh import data_mesh, is_primary, rank_and_world
from tts_tpu_torch.text import num_symbols
from tts_tpu_torch.train import checkpoint as ckpt_io
from tts_tpu_torch.train.gan import cast_params
from tts_tpu_torch.train.optim import (RAdamW, gradual_training_schedule,
                                       make_optimizer)
from tts_tpu_torch.utils.generic import KeepAverage, StepTimer
from tts_tpu_torch.utils.loggers import (ConsoleLogger, NullLogger,
                                        TensorboardLogger)
from tts_tpu_torch.utils.speakers import load_speaker_mapping
from tts_tpu_torch.utils.visual import (figures_available, plot_alignment,
                                        plot_spectrogram)

Batch = Dict[str, torch.Tensor]


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                    ) -> Batch:
    """A collated numpy batch -> tensors on ``device``; the mel stays
    time-major (B, T, n_mels), as the model's outputs; ``speaker_ids`` and
    ``speaker_embeddings`` where the batch has them."""
    keys = ("text_lengths", "mel", "mel_lengths", "stop_targets", "linear",
            "speaker_ids", "speaker_embeddings")
    out = {key: torch.from_numpy(batch[key]).to(device)
           for key in keys if key in batch}
    out["text"] = torch.from_numpy(batch["text"]).long().to(device)
    return out


# What tts_tpu computes in float32 under mixed precision: flax's RNN
# carries are float32, so its RNNs (the encoders', GST's) promote their
# bfloat16 parameters, and every layer that reads their outputs does too.
FLOAT32_RNNS = ("encoder.lstm.", "encoder.cbhg.cbhg.gru.",
                "gst_layer.encoder.recurrence.", "gst_layer.style_token_layer.")
FLOAT32_PARTS = ("decoder", "coarse_decoder", "backward_decoder", "postnet",
                 "last_linear")


def mixed_params(model: torch.nn.Module, dtype: torch.dtype
                 ) -> Dict[str, torch.Tensor]:
    """The parameters for a forward in ``dtype``: copies in ``dtype`` (≙
    tts_tpu's ``_cast_floats``), but float32 copies of the ``dtype``-rounded
    values where tts_tpu's layers meet a float32 input: the encoder's RNN
    and GST's GRU and style tokens, then the decoders but their prenets
    (which read the ``dtype`` mel), the postnet and v1's linear head."""
    params = cast_params(model, dtype, frozen=False)
    for name, p in params.items():
        if (name.startswith(FLOAT32_RNNS)
                or (name.split(".")[0] in FLOAT32_PARTS
                    and ".prenet." not in name)):
            params[name] = p.float()
    return params


def forward(model: torch.nn.Module, batch: Batch,
            dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The teacher-forced outputs in float32; with ``dtype`` bfloat16, from
    the parameters of ``mixed_params`` on a bfloat16 mel: the convolutions
    before the encoder's RNN in bfloat16, what follows it in float32, as in
    tts_tpu. External d-vectors stay float32."""
    args = (batch["text"], batch["text_lengths"], batch["mel"],
            batch["mel_lengths"])
    kwargs = {key: batch[key] for key in ("speaker_ids",
                                          "speaker_embeddings")
              if key in batch}
    if dtype == torch.float32:
        return model(*args, **kwargs)
    out = functional_call(model, mixed_params(model, dtype),
                          (*args[:2], args[2].to(dtype), args[3]), kwargs)
    return {key: value.float() for key, value in out.items()}


def loss_kwargs_from_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """``tacotron_loss``'s switches and weights from a training config (r
    aside: the step's)."""
    return dict(
        loss_masking=config.get("loss_masking", True),
        seq_len_norm=config.get("seq_len_norm", False),
        decoder_alpha=config.get("decoder_loss_alpha", 0.25),
        postnet_alpha=config.get("postnet_loss_alpha", 0.25),
        ga_alpha=config.get("ga_alpha", 0.0),
        decoder_diff_spec_alpha=config.get("decoder_diff_spec_alpha", 0.0),
        postnet_diff_spec_alpha=config.get("postnet_diff_spec_alpha", 0.0),
        use_linear=config["model"].lower() == "tacotron")


def train_step(model: torch.nn.Module, optimizer: RAdamW, batch: Batch,
               loss_kwargs: Dict[str, Any],
               dtype: torch.dtype = torch.float32) -> Dict[str, float]:
    """Forward, loss, backward and one optimizer step on a device batch, in
    the model's current mode and r. Returns the losses before the update."""
    optimizer.zero_grad()
    losses = tacotron_loss(forward(model, batch, dtype), batch,
                           **loss_kwargs)
    losses["loss"].backward()
    optimizer.step()
    values = torch.stack([v.detach() for v in losses.values()]).tolist()
    return dict(zip(losses.keys(), values))


class TTSTrainer:
    DEFAULT_TEST_SENTENCES = [
        "It took me quite a long time to develop a voice, and now that I "
        "have it I'm not going to be silent.",
        "Be a voice, not an echo.",
    ]

    def __init__(self, config: Dict[str, Any], output_path: str,
                 device: DeviceLike = None):
        check_config_tts(config)
        if config["model"].lower() not in ("tacotron2", "tacotron"):
            raise ValueError(f"this trainer trains Tacotron and Tacotron2, "
                             f"not {config['model']}")
        self.device = resolve_device(device)
        self.mesh = data_mesh(config)
        self.rank, self.world = (rank_and_world() if self.mesh is not None
                                 else (0, 1))
        self.primary = is_primary()
        self.c = config
        self.output_path = output_path
        os.makedirs(output_path, exist_ok=True)
        self.ap = AudioProcessor(**config["audio"])
        self.meta_train, self.meta_eval = load_meta_data(config["datasets"])
        self.num_speakers = 1
        self.speaker_mapping = None
        self.speaker_embedding_mapping = None
        self.speaker_embedding_dim = 0
        if config.get("use_speaker_embedding", False):
            if config.get("use_external_speaker_embedding_file", False):
                mapping = load_speaker_mapping(
                    config["external_speaker_embedding_file"])
                self.speaker_embedding_mapping = {
                    k: v["embedding"] for k, v in mapping.items()}
                self.num_speakers = len({v["name"]
                                         for v in mapping.values()})
                self.speaker_embedding_dim = len(
                    next(iter(self.speaker_embedding_mapping.values())))
            else:
                speakers = get_speakers(self.meta_train)
                self.speaker_mapping = {s: i for i, s in enumerate(speakers)}
                self.num_speakers = len(speakers)

        seed = config.get("seed", 54321)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = setup_model(
                num_symbols(config.get("use_phonemes", False)),
                self.num_speakers, config,
                speaker_embedding_dim=self.speaker_embedding_dim)
        self.model = model.to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(
            seed if self.mesh is None else rank_seed(seed, self.rank))
        self.model.set_generator(self.generator)
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        self._dp_steps: Dict[int, Any] = {}
        self.r = self.model.r
        self.optimizer = make_optimizer(
            self.model,
            lr=config.get("lr", 1e-4),
            grad_clip=config.get("grad_clip", 5.0),
            weight_decay=config.get("wd", 0.0),
            use_noam=config.get("noam_schedule", False),
            warmup_steps=config.get("warmup_steps", 4000))
        self.loss_kwargs = loss_kwargs_from_config(config)
        self.dtype = (torch.bfloat16 if config.get("mixed_precision", False)
                      else torch.float32)

        self.console = ConsoleLogger() if self.primary else NullLogger()
        self.tb = (TensorboardLogger(output_path, config["model"])
                   if self.primary else NullLogger())
        self.said_no_figures = False
        self.global_step = 0
        self.epoch = 0
        self.best_loss = float("inf")
        self.step_stats: List[Dict[str, float]] = []
        self._datasets: Dict[tuple, TTSDataset] = {}

    def dataset(self, is_eval: bool, r: int) -> TTSDataset:
        """The split's dataset at reduction factor ``r``, built once."""
        key = (is_eval, r)
        if key not in self._datasets:
            c = self.c
            self._datasets[key] = TTSDataset(
                self.ap, self.meta_eval if is_eval else self.meta_train,
                outputs_per_step=r,
                text_cleaner=c.get("text_cleaner", "english_cleaners"),
                compute_linear_spec=c["model"].lower() == "tacotron",
                min_seq_len=0 if is_eval else c.get("min_seq_len", 0),
                max_seq_len=(float("inf") if is_eval
                             else c.get("max_seq_len", float("inf"))),
                use_phonemes=c.get("use_phonemes", False),
                phoneme_cache_path=c.get("phoneme_cache_path"),
                phoneme_language=c.get("phoneme_language", "en-us"),
                enable_eos_bos=c.get("enable_eos_bos_chars", False),
                speaker_id_mapping=self.speaker_mapping,
                speaker_embedding_mapping=self.speaker_embedding_mapping)
        return self._datasets[key]

    def train_epoch(self) -> Dict[str, float]:
        c = self.c
        batch_size = c["batch_size"]
        if c.get("gradual_training"):
            self.r, batch_size = gradual_training_schedule(
                self.global_step, c["gradual_training"])
        self.model.set_r(self.r)
        ds = self.dataset(is_eval=False, r=self.r)
        loss_kwargs = dict(self.loss_kwargs, r=self.r)
        self.model.train()
        keep = KeepAverage()
        start = time.time()
        timer = StepTimer()
        self.console.print_train_start()
        shard = dict(num_shards=self.world, shard_id=self.rank)
        n_batches = len(ds.batch_indices(batch_size, **shard))
        for i, batch in enumerate(ds.batches(batch_size, shuffle=True,
                                             seed=self.epoch, **shard)):
            loader_time = timer.lap()
            db = batch_to_device(batch, self.device)
            if self.mesh is None:
                losses = train_step(self.model, self.optimizer, db,
                                    loss_kwargs, self.dtype)
            else:
                losses = self.dp_step(loss_kwargs)(db)
            losses["step_time"] = timer.lap()
            losses["loader_time"] = loader_time
            keep.update_values({f"avg_{k}": v for k, v in losses.items()})
            self.step_stats.append(dict(losses, r=self.r,
                                        batch_size=batch_size))
            self.global_step += 1
            if self.global_step % c.get("print_step", 25) == 0:
                self.console.print_train_step(n_batches, i, self.global_step,
                                              losses, keep.avg_values)
            if (self.global_step % c.get("save_step", 10000) == 0
                    and c.get("checkpoint", True)):
                self.save_checkpoint()
            self.tb.tb_train_iter_stats(self.global_step, losses)
        self.console.print_train_epoch_end(self.global_step, self.epoch,
                                           time.time() - start,
                                           keep.avg_values)
        return keep.avg_values

    def dp_step(self, loss_kwargs: Dict[str, Any]):
        """The data-parallel step at the current r, built once per r."""
        if self.r not in self._dp_steps:
            from tts_tpu_torch.parallel import make_dp_train_step
            self._dp_steps[self.r] = make_dp_train_step(
                self.model, self.optimizer, self.mesh, loss_kwargs,
                generator=self.generator,
                mixed_precision=self.dtype == torch.bfloat16)
        return self._dp_steps[self.r]

    @torch.no_grad()
    def eval_epoch(self) -> Dict[str, float]:
        """The losses on the held-out split, at the current r, in float32."""
        ds = self.dataset(is_eval=True, r=self.r)
        self.model.eval()
        keep = KeepAverage()
        self.console.print_eval_start()
        bs = min(self.c.get("eval_batch_size", 16), max(len(ds), 1))
        for batch in ds.batches(bs):
            db = batch_to_device(batch, self.device)
            losses = tacotron_loss(forward(self.model, db), db,
                                   **self.loss_kwargs, r=self.r)
            values = torch.stack(list(losses.values())).tolist()
            keep.update_values({f"avg_{k}": v
                                for k, v in zip(losses.keys(), values)})
        self.console.print_epoch_end(self.epoch, keep.avg_values)
        self.tb.tb_eval_stats(self.global_step, keep.avg_values)
        return keep.avg_values

    def test_run(self) -> Dict[str, np.ndarray]:
        """The test sentences (the config's, or tts_tpu's two) synthesized
        at the current r and turned to audio by Griffin-Lim; a sentence
        that raises is reported and skipped. A model with speakers or GST
        gets none (see the module's docstring)."""
        self.model.eval()
        if self.model.num_speakers > 1 or self.model.use_gst:
            print(" [!] test sentences skipped: the model needs a speaker "
                  "or a style, and test sentences pass neither")
            return {}
        sentences = (self.c.get("test_sentences")
                     or self.DEFAULT_TEST_SENTENCES)
        draw = figures_available()
        if not draw and not self.said_no_figures:
            print(" [!] matplotlib is not installed: test sentences log "
                  "audio without figures")
            self.said_no_figures = True
        audios, figures = {}, {}
        for i, sentence in enumerate(sentences):
            try:
                result = synthesis(self.model, sentence, self.c, self.device,
                                   ap=self.ap, use_griffin_lim=True)
            except Exception as e:  # a bad sentence must not end training
                print(f" [!] test sentence failed: {e}")
                continue
            audios[f"test_{i}"] = result["wav"]
            if draw:
                figures[f"test_{i}_spectrogram"] = plot_spectrogram(
                    result["postnet_outputs"])
                figures[f"test_{i}_alignment"] = plot_alignment(
                    result["alignments"])
        self.tb.tb_eval_audios(self.global_step, audios, self.ap.sample_rate)
        self.tb.tb_eval_figures(self.global_step, figures)
        return audios

    def fit(self) -> None:
        c = self.c
        for self.epoch in range(self.epoch, c["epochs"]):
            self.console.print_epoch_start(self.epoch, c["epochs"])
            self.train_epoch()
            if not self.primary:
                continue
            if c.get("run_eval", True):
                stats = self.eval_epoch()
                self.best_loss = ckpt_io.save_best_model(
                    stats.get("avg_postnet_loss", float("inf")),
                    self.best_loss, self.output_path, model=self.model,
                    optimizer=self.optimizer, step=self.global_step,
                    epoch=self.epoch, r=self.r)
            if (c.get("run_test_sentences", False)
                    and self.epoch >= c.get("test_delay_epochs", 0)):
                self.test_run()
        if c.get("checkpoint", True):
            self.save_checkpoint()
        self.tb.close()

    def save_checkpoint(self) -> Optional[str]:
        """Rank 0 writes; with a process group every rank waits for it."""
        return ckpt_io.save_checkpoint_multihost(
            self.output_path, model=self.model, optimizer=self.optimizer,
            step=self.global_step, epoch=self.epoch, config=self.c, r=self.r)

    def restore(self, path: str) -> None:
        ckpt = ckpt_io.load_checkpoint(path)
        self.model.load_state_dict(ckpt["model"])
        if ckpt.get("optimizer") is not None:
            self.optimizer.load_state_dict(ckpt["optimizer"])
        self.global_step = ckpt.get("step", 0)
        self.epoch = ckpt.get("epoch", 0)
        self.r = ckpt.get("r") or self.r
        self.model.set_r(self.r)
