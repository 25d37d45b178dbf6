"""Multi-speaker Glow-TTS and Tacotron2 (speaker ids, external d-vectors,
GST) in the port against tts_tpu, on the CPU.

Small models with numpy-seeded tts_tpu parameters (and BatchNorm
statistics) carried over by ``glow_tts_state_dict_from_jax`` /
``tacotron2_state_dict_from_jax``: Glow hidden 32 (1 encoder layer, 1 flow
block of 2 WN layers) with 3 speakers; Tacotron2's reduced model of
``test_torch_port_tacotron2.py`` (encoder 64, attention 32) with 3 speaker
ids, 16-wide d-vectors, or GST 32 wide with 2 heads and 5 tokens. TF32 off.
Tolerances, float32 with other summation orders:

- GST (eval at odd and even mel lengths, train mode with its running
  statistics): 1e-5 absolute;
- Glow's forward and inference, Tacotron2's teacher-forced forward and
  inference: 1e-4 absolute (durations, alignments of Glow and mel lengths
  exactly);
- one training step: losses 1e-4, each tensor's update within 1e-3 of its
  largest reference update plus one float32 spacing;
- the d-vector Tacotron2's bf16 forward (tts_tpu's casts, its d-vectors
  float32): 2e-3 of the reference's norm;
- collated batches: exactly.

Also: the registry builds the four models from configs, B3's and B8's
checks refuse them, the server and the CLI pass ``speaker_id`` (a bad id
is refused on the host, 400 at the server), and where
tts_tpu cannot run a combination its failure is shown (ROADMAP C19-C21).
"""

import json
import os
import threading
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from tests.fixtures import make_libritts_fixture
from tests.test_torch_port_tacotron2 import N_CHARS, SMALL
from tests.torch_port_params import module_params, random_params
from tts_tpu.audio import AudioProcessor as JAudioProcessor
from tts_tpu.data import TTSDataset as JTTSDataset
from tts_tpu.infer.synthesis import synthesis as j_synthesis
from tts_tpu.losses import tts_losses as JL
from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.models.glow_tts import glow_tts_loss as j_glow_tts_loss
from tts_tpu.models.gst import GST as JGST
from tts_tpu.models.registry import setup_model as j_setup_model
from tts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from tts_tpu.train.optim import make_optimizer as j_make_optimizer
from tts_tpu.train.state import TrainState, make_train_step
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.compat.from_jax import (glow_tts_state_dict_from_jax,
                                           gst_state_dict_from_jax,
                                           tacotron2_state_dict_from_jax)
from tts_tpu_torch.data import TTSDataset, load_meta_data
from tts_tpu_torch.infer.fast_decode import supports_fused_decode
from tts_tpu_torch.infer.synthesis import run_model
from tts_tpu_torch.losses import tts_losses as L
from tts_tpu_torch.models.glow_tts import GlowTTS, glow_tts_loss
from tts_tpu_torch.models.gst import GST
from tts_tpu_torch.models.registry import setup_model
from tts_tpu_torch.models.tacotron2 import Tacotron2
from tts_tpu_torch.ops.glow_encoder import supports_fused_encoder
from tts_tpu_torch.text import num_symbols
from tts_tpu_torch.train import trainer_glow, trainer_tts
from tts_tpu_torch.train.optim import make_optimizer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOW = dict(num_chars=40, num_speakers=3, hidden_channels_enc=32,
            hidden_channels_dec=32, filter_channels=64, filter_channels_dp=32,
            num_layers_enc=1, num_flow_blocks_dec=1, num_block_layers=2)
GST_KW = dict(gst_embedding_dim=32, gst_num_heads=2, gst_num_style_tokens=5)
TACO = {"ids": dict(num_speakers=3),
        "dvec": dict(num_speakers=3, external_speaker_dim=16),
        "gst": dict(use_gst=True, **GST_KW)}
STEPS = 6
OPT = dict(lr=1.0, grad_clip=1.0, weight_decay=0.01)
LOSS = dict(r=SMALL["r"])


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _np(t):
    return t.detach().numpy()


def _close(got, want, atol=1e-4, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def _stats(shapes, rng):
    """Seeded BatchNorm statistics: means 0.1 N(0, 1), variances
    0.5 + |N(0, 1)| (as test_torch_port_tacotron2's)."""
    def stat(path, leaf):
        x = rng.standard_normal(leaf.shape)
        x = 0.5 + np.abs(x) if path[-1].key == "var" else 0.1 * x
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(stat, shapes)


def _speaker_inputs(kind, B):
    rng = np.random.default_rng(5)
    if kind == "ids":
        return {"speaker_ids": np.array([2, 0, 1][:B], np.int32)}
    if kind == "dvec":
        d = rng.standard_normal((B, 16)).astype(np.float32)
        return {"speaker_embeddings": d / np.linalg.norm(d, axis=1,
                                                         keepdims=True)}
    return {}


def _optax_step(grads, params):
    """The parameters after one step of tts_tpu's optax chain (OPT), as
    numpy (one jit: the chain run op by op compiles every leaf's ops)."""
    tx = j_make_optimizer(**OPT)

    @jax.jit
    def step(g, p):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    return jax.tree_util.tree_map(np.asarray, step(grads, params))


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    out = {k: torch.from_numpy(v) for k, v in d.items()}
    for k in ("text", "speaker_ids"):
        if k in out:
            out[k] = out[k].long()
    return out


# ---------------------------------------------------------------------------
# GST
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gst():
    jm = JGST(num_mel=80, num_heads=2, num_style_tokens=5,
              gst_embedding_dim=32)
    key = jax.random.PRNGKey(0)
    shapes = unfreeze(jax.eval_shape(lambda: jm.init(
        key, jnp.zeros((1, 16, 80)), train=False)))
    rng = np.random.default_rng(0)
    params = random_params(shapes["params"], rng)
    stats = _stats(shapes["batch_stats"], rng)
    return jm, params, stats


def _port_gst(params, stats):
    m = GST(80, 2, 5, 32)
    m.load_state_dict(gst_state_dict_from_jax(params, stats), strict=True)
    return m


@pytest.mark.parametrize("T", [13, 16])
def test_gst_eval_odd_and_even_lengths(gst, T):
    """flax's SAME padding: (1, 1) on odd axes, (0, 1) on even ones, at
    every one of the six stride-2 convs (time and mel)."""
    jm, params, stats = gst
    x = np.random.default_rng(T).standard_normal((3, T, 80)).astype(
        np.float32)
    want = jax.jit(lambda p, s, x: jm.apply(
        {"params": p, "batch_stats": s}, x, train=False))(
            params, stats, jnp.asarray(x))
    with torch.no_grad():
        got = _port_gst(params, stats).eval()(torch.from_numpy(x))
    _close(_np(got), want, atol=1e-5)


def test_gst_train_mode_running_stats(gst):
    """Train mode: batch statistics, and the running ones moved as flax's
    BatchNorm(momentum=0.9) moves them (biased variance); the GRU's r/z
    hidden bias gets no gradient (tts_tpu has none)."""
    jm, params, stats = gst
    x = np.random.default_rng(3).standard_normal((3, 15, 80)).astype(
        np.float32)
    want, mutated = jax.jit(lambda p, s, x: jm.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, jnp.asarray(x))
    model = _port_gst(params, stats).train()
    got = model(torch.from_numpy(x))
    _close(_np(got), want, atol=1e-5)
    new = mutated["batch_stats"]["ref_encoder"]
    for i, bn in enumerate(model.encoder.bns):
        _close(_np(bn.running_mean), new[f"bn_{i}"]["mean"], 1e-5)
        _close(_np(bn.running_var), new[f"bn_{i}"]["var"], 1e-5)
    got.sum().backward()
    g = model.encoder.recurrence.bias_hh_l0.grad
    H = g.shape[0] // 3
    assert not g[:2 * H].abs().max() and g[2 * H:].abs().max() > 0


# ---------------------------------------------------------------------------
# multi-speaker Glow-TTS
# ---------------------------------------------------------------------------

def _glow_batch():
    rng = np.random.default_rng(1)
    return {"text": rng.integers(1, 40, (3, 13)).astype(np.int32),
            "text_lengths": np.array([13, 9, 4], np.int32),
            "mel": rng.standard_normal((3, 40, 80)).astype(np.float32),
            "mel_lengths": np.array([40, 31, 17], np.int32),
            "speaker_ids": np.array([2, 0, 1], np.int32)}


@pytest.fixture(scope="module")
def glow():
    jm = JGlowTTS(**GLOW)
    params = module_params(jm, 0, jnp.zeros((1, 8), jnp.int32),
                           jnp.array([8], jnp.int32), jnp.zeros((1, 12, 80)),
                           jnp.array([12], jnp.int32),
                           speaker_ids=jnp.array([0]), train=False)
    assert "emb_g" in params
    return jm, params


def _port_glow(params):
    m = GlowTTS(**GLOW)
    m.load_state_dict(glow_tts_state_dict_from_jax(params), strict=True)
    return m.eval()


def _glow_loss_fn(jm, batch):
    def loss_fn(p):
        out = jm.apply({"params": p}, batch["text"], batch["text_lengths"],
                       batch["mel"], batch["mel_lengths"],
                       speaker_ids=batch["speaker_ids"], train=False)
        losses = j_glow_tts_loss(out, batch["text_lengths"])
        return losses["loss"], (losses, out)
    return loss_fn


@pytest.fixture(scope="module")
def glow_step(glow):
    """tts_tpu's losses, outputs and gradients (one jit, train=False: no
    dropout) and its optax chain's updated parameters."""
    jm, params = glow
    grads, (losses, out) = jax.jit(jax.grad(
        _glow_loss_fn(jm, _jnp(_glow_batch())), has_aux=True))(params)
    return losses, out, _optax_step(grads, params)


def test_glow_forward_with_speaker_ids(glow, glow_step):
    _, params = glow
    losses, want, _ = glow_step
    tb = trainer_glow.batch_to_device(_glow_batch(), torch.device("cpu"))
    with torch.no_grad():
        out = _port_glow(params)(tb["text"], tb["text_lengths"], tb["mel"],
                                 tb["mel_lengths"], tb["speaker_ids"])
        got = glow_tts_loss(out, tb["text_lengths"])
    np.testing.assert_array_equal(_np(out["alignments"]),
                                  np.asarray(want["alignments"]))
    for key in ("z", "y_mean", "o_dur_log", "o_attn_dur"):
        _close(_np(out[key]).transpose(0, 2, 1), want[key], msg=key)
    _close(_np(out["logdet"]), want["logdet"], 1e-4 * float(
        np.abs(want["logdet"]).max()))
    for key in ("log_mle", "loss_dur", "loss"):
        _close(float(got[key]), float(losses[key]), msg=key)


def test_glow_inference_with_speaker_ids(glow):
    """Durations exactly first, then the mel, for two sets of speakers:
    the speaker moves both."""
    jm, params = glow
    batch = _glow_batch()
    infer = jax.jit(lambda p, t, l, ids: jm.apply(
        {"params": p}, t, l, speaker_ids=ids, noise_scale=0.0,
        y_max_length=96, method=JGlowTTS.inference))
    model = _port_glow(params)
    model.store_inverse()
    mels = []
    for spk in ([0, 1, 2], [2, 2, 2]):
        ids = np.array(spk, np.int32)
        want = infer(params, jnp.asarray(batch["text"]),
                     jnp.asarray(batch["text_lengths"]), jnp.asarray(ids))
        got = model.inference(torch.from_numpy(batch["text"]).long(),
                              torch.from_numpy(batch["text_lengths"]),
                              speaker_ids=torch.from_numpy(ids),
                              noise_scale=0.0, y_max_length=96)
        np.testing.assert_array_equal(_np(got["mel_lengths"]),
                                      np.asarray(want["mel_lengths"]))
        _close(_np(got["durations_log"]), want["durations_log"])
        _close(_np(got["model_outputs"]), want["model_outputs"], 1e-3)
        mels.append(_np(got["model_outputs"]))
    assert np.abs(mels[0][0] - mels[1][0]).max() > 1e-3


def test_glow_train_step_matches(glow, glow_step):
    """One step of tts_tpu's Glow trainer (its grad + optax chain,
    train=False) and the port's ``train_step``, with speaker ids."""
    _, params = glow
    losses, _, new = glow_step
    old = {k: _np(v) for k, v in glow_tts_state_dict_from_jax(params).items()}
    new = {k: _np(v) for k, v in glow_tts_state_dict_from_jax(new).items()}
    model = _port_glow(params)
    opt = make_optimizer(model, **OPT)
    got = trainer_glow.train_step(model, opt, trainer_glow.batch_to_device(
        _glow_batch(), torch.device("cpu")))
    for key in ("log_mle", "loss_dur", "loss"):
        _close(got[key], float(losses[key]), msg=key)
    for name, p in model.named_parameters():
        upd = float(np.abs(new[name] - old[name]).max())
        atol = 1e-3 * upd + float(np.spacing(np.abs(new[name]).max()))
        _close(_np(p), new[name], atol, msg=name)
    assert float(np.abs(new["emb_g.weight"] - old["emb_g.weight"]).max()) > 0


# ---------------------------------------------------------------------------
# Tacotron2 with speaker ids, d-vectors and GST
# ---------------------------------------------------------------------------

def _taco_batch(kind):
    rng = np.random.default_rng(11)
    text_lengths, mel_lengths, T_mel = (16, 11), (12, 9), 12
    stop = np.zeros((2, T_mel), np.float32)
    for b, n in enumerate(mel_lengths):
        stop[b, n - 1:] = 1.0
    batch = {"text": rng.integers(1, N_CHARS, (2, 16)).astype(np.int32),
             "text_lengths": np.asarray(text_lengths, np.int32),
             "mel": rng.standard_normal((2, T_mel, 80)).astype(np.float32),
             "mel_lengths": np.asarray(mel_lengths, np.int32),
             "stop_targets": stop.reshape(2, -1, SMALL["r"]).max(-1)}
    batch.update(_speaker_inputs(kind, 2))
    return batch


_TACO_CACHE = {}


def taco_model(kind):
    """(kind, tts_tpu model, seeded params, seeded statistics), built once
    per kind."""
    if kind in _TACO_CACHE:
        return _TACO_CACHE[kind]
    jm = JTacotron2(num_chars=N_CHARS, max_decoder_steps=STEPS,
                    stop_threshold=2.0, **SMALL, **TACO[kind])
    key = jax.random.PRNGKey(0)
    extra = {k: jnp.asarray(v[:1]) for k, v in
             _speaker_inputs(kind, 1).items()}
    shapes = unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 8), jnp.int32),
        jnp.array([8]), jnp.zeros((1, 12, 80)), jnp.array([12]), **extra)))
    rng = np.random.default_rng(0)
    params = random_params(shapes["params"], rng)
    stats = _stats(shapes["batch_stats"], rng)
    _TACO_CACHE[kind] = (kind, jm, params, stats)
    return _TACO_CACHE[kind]


@pytest.fixture(params=list(TACO))
def taco(request):
    return taco_model(request.param)


def _port_taco(kind, params, stats):
    m = Tacotron2(num_chars=N_CHARS, max_decoder_steps=STEPS,
                  stop_threshold=2.0, **SMALL, **TACO[kind])
    m.load_state_dict(tacotron2_state_dict_from_jax(params, stats),
                      strict=True)
    return m.eval()


def _taco_loss_fn(jm, stats, jb):
    spk = {k: jb[k] for k in ("speaker_ids", "speaker_embeddings")
           if k in jb}

    def loss_fn(params):
        out = jm.apply({"params": params, "batch_stats": stats}, jb["text"],
                       jb["text_lengths"], jb["mel"], jb["mel_lengths"],
                       train=False, **spk)
        losses = JL.tacotron_loss(out, jb, **LOSS)
        return losses["loss"], (out, losses)
    return loss_fn


_TACO_OUT = {}


def taco_outputs(kind):
    """tts_tpu's teacher-forced outputs (train=False); for the d-vector
    model also its losses and the parameters after one step of its optax
    chain (from one jitted grad)."""
    if kind not in _TACO_OUT:
        _, jm, params, stats = taco_model(kind)
        loss_fn = _taco_loss_fn(jm, stats, _jnp(_taco_batch(kind)))
        if kind != "dvec":
            _TACO_OUT[kind] = (jax.jit(loss_fn)(params)[1][0], None, None)
        else:
            grads, (out, losses) = jax.jit(jax.grad(loss_fn, has_aux=True))(
                params)
            _TACO_OUT[kind] = (out, losses, _optax_step(grads, params))
    return _TACO_OUT[kind]


def test_taco2_teacher_forced_forward(taco):
    """train=False on both sides; with GST the style mel is the target."""
    kind, _, params, stats = taco
    want = taco_outputs(kind)[0]
    with torch.no_grad():
        got = trainer_tts.forward(_port_taco(kind, params, stats),
                                  _torch(_taco_batch(kind)))
    assert set(got) == set(want)
    for key in want:
        _close(_np(got[key]), want[key], msg=key)


def test_taco2_inference(taco):
    """The plain decode (B8 refuses these models) with the speaker or the
    style mel, 6 steps."""
    kind, jm, params, stats = taco
    batch = _taco_batch(kind)
    cond = {k: v for k, v in batch.items()
            if k in ("speaker_ids", "speaker_embeddings")}
    if kind == "gst":
        cond["style_mel"] = np.random.default_rng(9).standard_normal(
            (2, 21, 80)).astype(np.float32)
    want = jax.jit(lambda p, s, t, l, c: jm.apply(
        {"params": p, "batch_stats": s}, t, l, max_decoder_steps=STEPS,
        method=JTacotron2.inference, **c))(
            params, stats, jnp.asarray(batch["text"]),
            jnp.asarray(batch["text_lengths"]), _jnp(cond))
    model = _port_taco(kind, params, stats)
    assert not supports_fused_decode(model)
    got = model.inference(torch.from_numpy(batch["text"]).long(),
                          torch.from_numpy(batch["text_lengths"]),
                          **_torch(cond))
    np.testing.assert_array_equal(_np(got["mel_lengths"]),
                                  np.asarray(want["mel_lengths"]))
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        _close(_np(got[key]), want[key], msg=key)


def test_dvector_taco2_train_step_matches():
    """One step (tts_tpu's loss, jax.grad and optax chain, train=False)
    with the d-vectors in the batch: the losses, then every parameter
    after the update."""
    kind, _, params, stats = taco_model("dvec")
    _, want, new = taco_outputs(kind)
    old = {k: _np(v) for k, v in
           tacotron2_state_dict_from_jax(params, stats).items()}
    new = {k: _np(v) for k, v in
           tacotron2_state_dict_from_jax(new, stats).items()}
    model = _port_taco(kind, params, stats)
    opt = make_optimizer(model, **OPT)
    got = trainer_tts.train_step(model, opt, _torch(_taco_batch(kind)),
                                 dict(LOSS))
    assert set(got) == set(want)
    for key, value in got.items():
        _close(value, float(want[key]), msg=key)
    for name, p in model.named_parameters():
        atol = (1e-3 * float(np.abs(new[name] - old[name]).max())
                + float(np.spacing(np.abs(new[name]).max())))
        _close(_np(p), new[name], atol, msg=name)


def test_dvector_taco2_bfloat16_forward_matches_tts_tpu():
    """The mixed-precision forward with d-vectors against tts_tpu's
    (``make_train_step``'s casts: bfloat16 parameters and mel, the batch's
    d-vectors float32, so its decoder and postnet promote to float32):
    each output within 2e-3 of the reference's norm. Both encoders round to
    bfloat16 in their own order (~1e-3 apart here); a forward that also
    casts the d-vectors, and so keeps the decoder in bfloat16, is 4e-3 to
    5e-3 away on the decoder's and the postnet's outputs."""
    from tts_tpu.train.state import _cast_floats

    kind, jm, params, stats = taco_model("dvec")
    batch = _taco_batch(kind)
    jb = _jnp(batch)
    want = jax.jit(lambda p: _cast_floats(jm.apply(
        {"params": _cast_floats(p, jnp.bfloat16), "batch_stats": stats},
        jb["text"], jb["text_lengths"], jb["mel"].astype(jnp.bfloat16),
        jb["mel_lengths"], train=False,
        speaker_embeddings=jb["speaker_embeddings"]), jnp.float32))(params)
    got = trainer_tts.forward(_port_taco(kind, params, stats),
                              _torch(batch), torch.bfloat16)
    for key in ("decoder_outputs", "postnet_outputs", "alignments"):
        assert got[key].dtype == torch.float32, key
        ref = np.asarray(want[key])
        rel = (np.linalg.norm(got[key].detach().numpy() - ref)
               / np.linalg.norm(ref))
        assert rel < 2e-3, (key, rel)


# ---------------------------------------------------------------------------
# the registry, B3/B8 refusals, data, serving
# ---------------------------------------------------------------------------

def _config(name, **kw):
    path = ("configs/glow_tts_ljspeech.json" if name == "glow_tts"
            else "configs/tacotron2_ljspeech.json")
    from tts_tpu_torch.config import load_config
    c = load_config(os.path.join(ROOT, path))
    c.update(kw)
    return c


def _registry_pair(n_spk, dvec, c):
    return (j_setup_model(40, n_spk, c, speaker_embedding_dim=dvec),
            setup_model(40, n_spk, c, speaker_embedding_dim=dvec))


def test_registry_builds_the_four_and_fused_paths_refuse():
    """From the shipped configs (narrowed): multi-speaker Glow-TTS,
    Tacotron2 with speaker ids, with 16-wide d-vectors, and with GST
    (the registry's gst defaults: 10 tokens, 512 wide, 4 heads), built as
    tts_tpu's registry builds them; B3's and B8's checks refuse each, and
    accept the one-speaker model of the same config."""
    g = _config("glow_tts", hidden_channels_encoder=32,
                hidden_channels_decoder=32)
    jm, tm = _registry_pair(4, 0, g)
    assert tm.num_speakers == jm.num_speakers == 4
    assert tuple(tm.emb_g.weight.shape) == (4, 64)
    assert tm.encoder.duration_predictor.conv_1.in_channels == 32 + 64
    assert all(hasattr(f.wn, "cond_layer") for f in tm.decoder.flows[2::3])
    assert not supports_fused_encoder(tm.encoder)
    assert supports_fused_encoder(setup_model(40, 1, g).encoder)

    t = _config("tacotron2", encoder_dim=64, embedding_dim=64, attn_dim=32)
    for n_spk, dvec, gst, has_table in ((4, 0, False, True),
                                        (4, 16, False, False),
                                        (1, 0, True, False)):
        c = dict(t, use_gst=gst)
        jm, tm = _registry_pair(n_spk, dvec, c)
        width = jm._decoder_in_dim()
        assert width == 64 + (64 if has_table else dvec) + (512 if gst
                                                            else 0)
        assert tm.decoder.attention_rnn.input_size == 256 + width
        assert hasattr(tm, "speaker_embedding") == has_table
        assert hasattr(tm, "gst_layer") == gst
        if gst:
            assert tuple(tm.gst_layer.style_token_layer.style_tokens.shape
                         ) == (10, 512 // 4)
        assert not supports_fused_decode(tm)
    assert supports_fused_decode(setup_model(40, 1, t))


def test_dataset_speaker_ids_and_dvectors_equal(tmp_path):
    """The collated batches' speaker ids (sorted names) and d-vectors
    (speakers.json rows by wav path) as tts_tpu's."""
    root = make_libritts_fixture(str(tmp_path), n_speakers=2,
                                 n_per_speaker=2, dur=0.4)
    ds_cfg = [{"name": "libri_tts", "path": root}]
    items, _ = load_meta_data(ds_cfg, eval_split_size=0.0)
    ids = {s: i for i, s in enumerate(sorted({it[2] for it in items}))}
    rng = np.random.default_rng(0)
    dvecs = {it[1]: rng.standard_normal(8).tolist() for it in items}
    kw = dict(outputs_per_step=2, use_phonemes=False,
              speaker_id_mapping=ids, speaker_embedding_mapping=dvecs)
    ours = TTSDataset(AudioProcessor(**_config("tacotron2").audio), items,
                      **kw)
    theirs = JTTSDataset(JAudioProcessor(**_config("tacotron2").audio),
                         items, **kw)
    a = ours.collate([ours[i] for i in range(len(items))])
    b = theirs.collate([theirs[i] for i in range(len(items))])
    assert sorted(set(a["speaker_ids"].tolist())) == [0, 1]
    for key in ("text", "mel", "speaker_ids", "speaker_embeddings"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A seeded 2-speaker Glow-TTS (hidden 32) as a port checkpoint, its
    config with num_speakers 2 and characters."""
    root = tmp_path_factory.mktemp("served")
    c = _config("glow_tts", hidden_channels_encoder=32,
                hidden_channels_decoder=32, use_phonemes=False,
                num_speakers=2)
    c["audio"]["griffin_lim_iters"] = 4
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = setup_model(num_symbols(False), 2, c)
    with torch.no_grad():
        model.emb_g.weight.mul_(20.0)      # speakers far apart
    cfg = root / "glow.json"
    cfg.write_text(json.dumps(c))
    ckpt = root / "glow.pt"
    torch.save({"model": model.state_dict()}, ckpt)
    return {"config": str(cfg), "tts": str(ckpt), "root": root}


def test_server_and_cli_pass_speaker_id(served):
    """GET /api/tts?speaker_id=N and the CLI's --speaker_id reach the
    model: speakers 0 and 1 give different audio, each equal to
    Synthesizer.tts for that speaker (16-bit WAV rounding)."""
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.bin.synthesize import main as synthesize
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.server.server import create_server

    synth = Synthesizer(served["tts"], served["config"], device="cpu")
    text = "Hello world."
    direct = {k: synth.tts(text, speaker_id=k) for k in (0, 1)}
    assert direct[0].shape != direct[1].shape or \
        np.abs(direct[0] - direct[1]).max() > 1e-3
    server = create_server(synth, port=0, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for k in (0, 1):
            url = (f"http://127.0.0.1:{port}/api/tts?"
                   + urllib.parse.urlencode({"text": text, "speaker_id": k}))
            with urllib.request.urlopen(url, timeout=60) as r:
                wav, _ = read_wav(r.read())
            np.testing.assert_allclose(wav, direct[k], atol=2.0 / 32767)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    path = synthesize([text, served["config"], served["tts"],
                       str(served["root"] / "cli"), "--speaker_id", "1",
                       "--device", "cpu"])
    wav, _ = read_wav(path)
    np.testing.assert_allclose(wav, direct[1], atol=2.0 / 32767)


def test_bad_speaker_id_is_refused_on_the_host(served):
    """An id outside the model's speakers raises ValueError in run_model and
    Synthesizer.tts before the model runs; the server answers 400 for it
    and for a non-integer id, and the next request is served."""
    import urllib.error

    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.server.server import create_server

    synth = Synthesizer(served["tts"], served["config"], device="cpu")
    for bad in (2, -1):
        with pytest.raises(ValueError, match="speaker_id"):
            run_model(synth.model, torch.tensor([[3, 7, 11]]),
                      synth.tts_config, speaker_id=bad)
        with pytest.raises(ValueError, match="speaker_id"):
            synth.tts("Hello.", speaker_id=bad)
    server = create_server(synth, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}/api/tts?"
           "text=Hello.&speaker_id=")
    try:
        for bad in ("2", "-1", "x", "1.5"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url + bad, timeout=60)
            assert e.value.code == 400, bad
        with urllib.request.urlopen(url + "1", timeout=60) as r:
            wav, _ = read_wav(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    np.testing.assert_allclose(wav, synth.tts("Hello.", speaker_id=1),
                               atol=2.0 / 32767)


# ---------------------------------------------------------------------------
# combinations tts_tpu cannot run (ROADMAP C19-C21)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ids", "gst"])
def test_tts_tpu_cannot_synthesize_without_the_models_conditioning(kind):
    """C19 and C21: tts_tpu's ``synthesis`` (what its trainer's test_run
    calls, with no speaker and no style) fails for a model with speaker
    ids or with GST; so does the port's (it adds no default speaker or
    style). C19: the port's trainer skips such test sentences."""
    kind, jm, params, stats = taco_model(kind)
    c = {"model": "tacotron2", "use_phonemes": False, "use_gst": kind == "gst",
         "text_cleaner": "english_cleaners"}
    c["audio"] = dict(_config("tacotron2").audio)
    with pytest.raises((AttributeError, TypeError)):
        j_synthesis(jm, {"params": params, "batch_stats": stats}, "Hello.",
                    c, JAudioProcessor(**c["audio"]), max_decoder_steps=2,
                    style_wav=None)
    # the port's run_model (what its synthesis calls) on in-range ids
    with pytest.raises((AttributeError, TypeError)):
        run_model(_port_taco(kind, params, stats),
                  torch.tensor([[3, 7, 11, 2]]), c, max_decoder_steps=2)


def test_tts_tpu_synthesizer_cannot_serve_external_dvectors():
    """C20: tts_tpu's Synthesizer builds its model with
    ``setup_model(chars, num_speakers, config)``, no d-vector width, so a
    config that trained on external d-vectors serves a model with a
    learned speaker table instead: the trained parameters do not fit it,
    and ``tts`` passes only ``speaker_id``. The port's Synthesizer builds
    the same way and fails to load the checkpoint."""
    c = _config("tacotron2", encoder_dim=64, embedding_dim=64, attn_dim=32,
                num_speakers=3, use_speaker_embedding=True,
                use_external_speaker_embedding_file=True)
    served_j = j_setup_model(40, 3, c)
    trained_j = j_setup_model(40, 3, c, speaker_embedding_dim=16)
    assert served_j.external_speaker_dim == 0
    assert trained_j.external_speaker_dim == 16
    trained = Tacotron2(num_chars=40, num_speakers=3, external_speaker_dim=16,
                        encoder_dim=64, embedding_dim=64, attn_dim=32)
    with pytest.raises(RuntimeError, match="speaker_embedding|size mismatch"):
        setup_model(40, 3, c).load_state_dict(trained.state_dict())
