"""The speaker encoder in the port against tts_tpu, on the CPU.

A small encoder (2 LSTM layers of 32, projections of 16) with numpy-seeded
tts_tpu parameters carried over by ``speaker_encoder_state_dict_from_jax``;
the same numpy inputs go through both packages. Tolerances, float32 with
other summation orders in the two packages:

- the d-vectors (forward and sliding-window ``compute_embedding``), the
  losses and their gradients: 1e-5 absolute;
- one training step's parameter updates: 1e-3 relative to the largest
  update of the step;
- the dataset's batches, the prepared VoxCeleb csv: exactly equal.
"""

import csv
import hashlib
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tests.torch_port_params import module_params
from tts_tpu.audio import AudioProcessor as JAudioProcessor
from tts_tpu.data.speaker_dataset import \
    SpeakerEncoderDataset as JSpeakerEncoderDataset
from tts_tpu.losses.ge2e import AngleProtoLoss as JAngleProtoLoss
from tts_tpu.losses.ge2e import GE2ELoss as JGE2ELoss
from tts_tpu.models.speaker_encoder import SpeakerEncoder as JSpeakerEncoder
from tts_tpu.train.optim import make_optimizer as j_make_optimizer
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.audio.processor import write_wav
from tts_tpu_torch.bin import prepare_voxceleb as P
from tts_tpu_torch.compat.from_jax import (
    speaker_encoder_state_dict_from_jax, speaker_loss_state_dict_from_jax,
    state_dict_from_tts_tpu)
from tts_tpu_torch.data import load_meta_data
from tts_tpu_torch.data.speaker_dataset import SpeakerEncoderDataset
from tts_tpu_torch.losses.ge2e import AngleProtoLoss, GE2ELoss
from tts_tpu_torch.models.speaker_encoder import SpeakerEncoder
from tts_tpu_torch.train.checkpoint import (load_checkpoint,
                                            load_tts_tpu_checkpoint)
from tts_tpu_torch.train.optim import make_optimizer
from tts_tpu_torch.train.trainer_encoder import train_step

torch.set_num_threads(1)

ATOL = 1e-5
WIDTHS = dict(input_dim=40, proj_dim=16, lstm_dim=32, num_lstm_layers=2)
N, M, T = 3, 4, 30
AUDIO = {"sample_rate": 16000, "num_mels": 40, "fft_size": 400,
         "hop_length": 160, "win_length": 400, "preemphasis": 0.97,
         "min_level_db": -100, "ref_level_db": 20, "power": 1.5,
         "griffin_lim_iters": 10, "signal_norm": True, "symmetric_norm": True,
         "max_norm": 4.0, "clip_norm": True, "mel_fmin": 0.0,
         "mel_fmax": 8000.0, "do_trim_silence": False}


@pytest.fixture(scope="module")
def enc():
    jm = JSpeakerEncoder(**WIDTHS)
    params = module_params(jm, 0, jnp.zeros((1, T, 40)))
    tm = SpeakerEncoder(**WIDTHS)
    tm.load_state_dict(speaker_encoder_state_dict_from_jax(params),
                       strict=True)
    x = np.random.default_rng(1).standard_normal((N * M, T, 40))
    return {"jm": jm, "params": params, "tm": tm.eval(),
            "x": x.astype(np.float32)}


def _np(t):
    return t.detach().numpy()


def test_forward_matches(enc):
    want = enc["jm"].apply({"params": enc["params"]}, jnp.asarray(enc["x"]))
    got = enc["tm"](torch.from_numpy(enc["x"]))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(_np(got), axis=-1), 1.0,
                               atol=ATOL)


@pytest.mark.parametrize("num_frames", [10, 12, T, 40])
def test_compute_embedding_matches(enc, num_frames):
    """Windows at hop num_frames / 2 (one window past a whole mel; the
    last partial window dropped at 12), averaged and renormalized."""
    want = enc["jm"].apply({"params": enc["params"]}, jnp.asarray(enc["x"]),
                           num_frames=num_frames, overlap=0.5,
                           method=JSpeakerEncoder.compute_embedding)
    got = enc["tm"].compute_embedding(torch.from_numpy(enc["x"]),
                                      num_frames=num_frames, overlap=0.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_lstm_bias_hh_fixed(enc):
    """The whole gate bias sits in bias_ih (tts_tpu's one bias per gate);
    bias_hh is zero and not trained."""
    for layer in enc["tm"].layers:
        assert not layer.lstm.bias_hh_l0.requires_grad
        assert not layer.lstm.bias_hh_l0.abs().max()


LOSSES = [("ge2e_softmax", lambda: JGE2ELoss(), lambda: GE2ELoss()),
          ("ge2e_contrast", lambda: JGE2ELoss(loss_method="contrast"),
           lambda: GE2ELoss("contrast")),
          ("angleproto", lambda: JAngleProtoLoss(), lambda: AngleProtoLoss())]


@pytest.mark.parametrize("name,jloss,tloss", LOSSES,
                         ids=[n for n, _, _ in LOSSES])
@pytest.mark.parametrize("w", [10.0, -0.5])
def test_loss_value_and_gradients(name, jloss, tloss, w):
    """The value and the gradients of the d-vectors, w and b against
    jax.grad; w = -0.5 takes the floor at 1e-6 (no gradient to w)."""
    rng = np.random.default_rng(2)
    d = rng.standard_normal((N, M, 8)).astype(np.float32)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(-5.0)}
    jl = jloss()
    (val, (gp, gd)) = jax.value_and_grad(
        lambda p, x: jl.apply({"params": p}, x), argnums=(0, 1))(
            params, jnp.asarray(d))
    tl = tloss()
    tl.load_state_dict(speaker_loss_state_dict_from_jax(params))
    x = torch.from_numpy(d).requires_grad_(True)
    out = tl(x)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(val), atol=ATOL)
    np.testing.assert_allclose(_np(x.grad), np.asarray(gd), atol=ATOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(float(getattr(tl, k).grad),
                                   float(gp[k]), atol=ATOL, err_msg=k)


def test_training_step_matches(enc):
    """One step of tts_tpu's encoder trainer (value_and_grad over
    {"enc", "loss"}, its optax chain: clip 3.0, RAdam, lr 1e-4) and of the
    port's (``train_step`` over the encoder and the loss in one module):
    the loss, then every parameter's update, twice in a row."""
    jm, jl = enc["jm"], JGE2ELoss()
    params = {"enc": enc["params"],
              "loss": {"w": jnp.asarray(10.0), "b": jnp.asarray(-5.0)}}
    tx = j_make_optimizer(lr=1e-4, grad_clip=3.0)

    @jax.jit
    def step(params, opt_state, mels):
        def loss_fn(p):
            emb = jm.apply({"params": p["enc"]}, mels)
            return jl.apply({"params": p["loss"]}, emb.reshape(N, M, -1))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    tm = SpeakerEncoder(**WIDTHS)
    tm.load_state_dict(speaker_encoder_state_dict_from_jax(enc["params"]))
    module = nn.ModuleDict({"model": tm, "criterion": GE2ELoss()})
    opt = make_optimizer(module, lr=1e-4, grad_clip=3.0)
    rng = np.random.default_rng(3)
    opt_state = tx.init(params)
    for _ in range(2):
        mels = rng.standard_normal((N * M, T, 40)).astype(np.float32)
        before = {k: v.clone() for k, v in module.state_dict().items()}
        new, opt_state, loss = step(params, opt_state, jnp.asarray(mels))
        got = train_step(module, opt, torch.from_numpy(mels), N, M)
        np.testing.assert_allclose(float(got), float(loss), atol=ATOL)
        want = {f"model.{k}": v for k, v in
                speaker_encoder_state_dict_from_jax(
                    jax.tree_util.tree_map(np.asarray, new["enc"])).items()}
        want.update({f"criterion.{k}": v for k, v in
                     speaker_loss_state_dict_from_jax(new["loss"]).items()})
        old = {f"model.{k}": v for k, v in
               speaker_encoder_state_dict_from_jax(
                   jax.tree_util.tree_map(np.asarray, params["enc"])).items()}
        old.update({f"criterion.{k}": v for k, v in
                    speaker_loss_state_dict_from_jax(params["loss"]).items()})
        deltas = {k: (module.state_dict()[k] - before[k]).numpy()
                  for k in want}
        want_d = {k: (want[k] - old[k]).numpy() for k in want}
        peak = max(float(np.abs(v).max()) for v in want_d.values())
        assert peak > 0
        for k in want:
            np.testing.assert_allclose(deltas[k], want_d[k], rtol=0,
                                       atol=1e-3 * peak, err_msg=k)
        params = new


def _voxceleb_tree(root, n_speakers=4, n_utts=3, sr=16000):
    """voxceleb1 layout: <root>/wav/id1000{s}/<clip>/<n>.wav, each speaker
    a tone of its own pitch; lengths 0.4-0.7 s."""
    rng = np.random.default_rng(7)
    for s in range(n_speakers):
        f0 = 110 + 40 * s
        for u in range(n_utts):
            n = int(sr * (0.4 + 0.1 * u))
            t = np.arange(n) / sr
            y = 0.3 * np.sin(2 * np.pi * f0 * t) \
                + 0.02 * rng.standard_normal(n)
            path = os.path.join(root, "wav", f"id1000{s}", f"clip{u % 2}",
                                f"{u:05d}.wav")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_wav(path, y.astype(np.float32), sr)
    return root


def test_dataset_batches_equal(tmp_path):
    """Same files, same seed: the same speakers, utterances, crops, noise
    and storage replays as tts_tpu's dataset, batch after batch."""
    root = _voxceleb_tree(str(tmp_path))
    items, _ = load_meta_data([{"name": "voxceleb1", "path": root}],
                              eval_split_size=0.0)
    kw = dict(voice_len_seconds=0.3, num_speakers_in_batch=2,
              num_utters_per_speaker=2, storage_size=3,
              sample_from_storage_p=0.5, additive_noise=1e-5)
    ours = SpeakerEncoderDataset(AudioProcessor(**AUDIO), items, **kw)
    theirs = JSpeakerEncoderDataset(JAudioProcessor(**AUDIO), items, **kw)
    drawn, replays = [], 0
    for _ in range(8):
        a, b = ours.next_batch(), theirs.next_batch()
        assert a["speaker_names"] == b["speaker_names"]
        np.testing.assert_array_equal(a["mels"], b["mels"])
        replays += any(a is d for d in drawn)
        drawn.append(a)
    assert a["mels"].shape[0] == 4 and a["mels"].shape[2] == 40
    assert 0 < replays < 8


def test_trainer_cli_on_cpu(tmp_path):
    """bin/train_encoder on the CPU: 3 steps (a storage replay among them),
    finite losses, the checkpoint with the encoder and the loss's w/b, and
    sliding-window d-vectors from it."""
    from tts_tpu_torch.bin.train_encoder import main

    root = _voxceleb_tree(str(tmp_path / "vox"))
    c = {"run_name": "enc", "audio": AUDIO, "num_speakers_in_batch": 2,
         "num_utters_per_speaker": 2, "voice_len": 0.3, "loss": "ge2e",
         "lr": 1e-3, "grad_clip": 3.0, "save_step": 100,
         "model": WIDTHS, "storage": {"sample_from_storage_p": 0.5,
                                      "storage_size": 3},
         "datasets": [{"name": "voxceleb1", "path": root,
                       "meta_file_train": None}]}
    cfg = tmp_path / "enc.json"
    cfg.write_text(json.dumps(c))
    trainer = main(["--config_path", str(cfg), "--output_path",
                    str(tmp_path / "runs"), "--num_steps", "3",
                    "--device", "cpu"])
    losses = [s["loss"] for s in trainer.step_stats]
    assert len(losses) == 3 and np.isfinite(losses).all()
    ckpt = load_checkpoint(os.path.join(trainer.output_path,
                                        "checkpoint_3.pt"))
    assert set(ckpt["criterion"]) == {"w", "b"}
    model = SpeakerEncoder(**WIDTHS)
    model.load_state_dict(ckpt["model"])
    mel = np.random.default_rng(4).standard_normal((2, 50, 40))
    emb = trainer.compute_embeddings(mel, num_frames=20, overlap=0.5)
    want = model.eval().compute_embedding(torch.from_numpy(mel).float(),
                                          num_frames=20)
    np.testing.assert_allclose(_np(emb), _np(want), atol=ATOL)


def test_tts_tpu_encoder_checkpoint_loads(tmp_path, enc):
    """A tts_tpu encoder checkpoint ({"enc", "loss"} params, flax msgpack)
    read without flax and converted by the encoder config."""
    from tts_tpu.train.checkpoint import save_checkpoint

    params = {"enc": enc["params"],
              "loss": {"w": np.asarray(9.5, np.float32),
                       "b": np.asarray(-4.5, np.float32)}}
    path = save_checkpoint(str(tmp_path), params=params, step=1)
    ckpt = load_tts_tpu_checkpoint(path)
    c = {"model": dict(WIDTHS)}
    model = SpeakerEncoder(**WIDTHS)
    model.load_state_dict(state_dict_from_tts_tpu(ckpt, c), strict=True)
    x = torch.from_numpy(enc["x"])
    np.testing.assert_array_equal(_np(model.eval()(x)), _np(enc["tm"](x)))
    loss = speaker_loss_state_dict_from_jax(ckpt["params"]["loss"])
    assert float(loss["w"]) == 9.5 and float(loss["b"]) == -4.5


# ---------------------------------------------------------------------------
# prepare_voxceleb: the offline steps
# ---------------------------------------------------------------------------

def _wav(path, n):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(path, np.zeros(n, np.float32), 16000)


def test_prepare_voxceleb_parts_md5_extract(tmp_path):
    blob = b""
    parts = []
    for i, chunk in enumerate([b"abc", b"defg", b"h"]):
        p = tmp_path / f"data_parta{chr(ord('a') + i)}"
        p.write_bytes(chunk)
        parts.append(str(p))
        blob += chunk
    out = P.concatenate_parts(parts[::-1], str(tmp_path / "data.zip"))
    assert open(out, "rb").read() == blob
    P.verify_md5(out, hashlib.md5(blob).hexdigest())
    with pytest.raises(ValueError, match="md5sum"):
        P.verify_md5(out, "0" * 32)
    single = tmp_path / "only.zip"
    single.write_bytes(b"z")
    assert P.concatenate_parts([str(single)], "x.zip") == str(single)
    z = tmp_path / "arch.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("wav_root/id1/s/a.txt", "x")
    dst = P.extract_zip(str(z), str(tmp_path / "out"), "vox1_test_wav")
    assert os.path.isfile(os.path.join(dst, "id1", "s", "a.txt"))


def test_prepare_voxceleb_csv_and_resume(tmp_path):
    """The csv's rows, with dense first-seen speaker ids; a resumed run
    reads the csv back and the next subset's ids continue after it."""
    base = tmp_path / "vox1_test_wav"
    _wav(str(base / "id10001" / "c1" / "00001.wav"), 1600)
    _wav(str(base / "id10001" / "c2" / "00002.wav"), 3200)
    _wav(str(base / "id10002" / "c3" / "00001.wav"), 800)
    ids = {}
    path = P.processor(str(tmp_path), "vox1_test_wav", speaker_id_dict=ids)
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert [r["speaker_name"] for r in rows] == ["id10001"] * 2 + ["id10002"]
    assert [int(r["speaker_id"]) for r in rows] == [0, 0, 1]
    assert [int(r["wav_length_ms"]) for r in rows] == [1600, 3200, 800]
    resumed = {}
    assert P.processor(str(tmp_path), "vox1_test_wav",
                       speaker_id_dict=resumed) == path
    assert resumed == ids == {"id10001": 0, "id10002": 1}
    other = tmp_path / "vox2_test_aac"
    _wav(str(other / "id20001" / "c" / "00001.wav"), 400)
    _wav(str(other / "id10002" / "c" / "00002.wav"), 400)
    path2 = P.convert_audio_and_make_label(str(tmp_path), "vox2_test_aac",
                                           str(tmp_path), "v2.csv", resumed)
    with open(path2, newline="") as f:
        rows2 = list(csv.DictReader(f, delimiter="\t"))
    assert {r["speaker_name"]: int(r["speaker_id"]) for r in rows2} == {
        "id10002": 1, "id20001": 2}
    with pytest.raises(ValueError, match="not in voxceleb"):
        P.processor(str(tmp_path), "vox3")
