"""Glow-TTS's gated-conv and time-depth-separable encoders in the port
against tts_tpu's, on the CPU.

A small Glow (hidden 32, 2 encoder layers, so 5 gated-conv or separable
layers; 2 flow blocks of 2 WN layers) with numpy-seeded parameters
(``tests/torch_port_params.py``) and, for the separable encoder, seeded
BatchNorm statistics, carried over by ``glow_tts_state_dict_from_jax``;
ragged text and mel lengths, TF32 off. tts_tpu runs with ``train=False``
and the port in ``eval()`` mode unless a test says otherwise.

Tolerances, float32 with another order of summation: outputs, losses and
the encoder's statistics 1e-4 of the largest reference magnitude (as
``test_torch_port_glow_train.py``); gradients 1e-4 of each tensor's
largest reference gradient; BatchNorm's running statistics after a
train-mode update 1e-6; the alignment, durations, ``mel_lengths`` and the
weights' round trip exactly.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.fixtures import make_ljspeech_fixture
from tests.torch_port_params import init_shapes, random_params
from tts_tpu.compat.torch_port import port_glow_tts, port_glow_tts_batch_stats
from tts_tpu.models.glow.encoder import \
    TimeDepthSeparableConvBlock as JTDSBlock
from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.models.glow_tts import glow_tts_loss as j_glow_tts_loss
from tts_tpu_torch.compat.from_jax import glow_tts_state_dict_from_jax
from tts_tpu_torch.models import glow_tts as G
from tts_tpu_torch.models.glow.encoder import (GatedConvBlock,
                                               TimeDepthSeparableConvBlock)
from tts_tpu_torch.models.glow_tts import GlowTTS, glow_tts_loss
from tts_tpu_torch.ops.glow_encoder import supports_fused_encoder
from tts_tpu_torch.train.optim import make_optimizer
from tts_tpu_torch.train.trainer_glow import batch_to_device, train_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_chars=40, hidden_channels_enc=32, hidden_channels_dec=32,
          filter_channels=64, filter_channels_dp=32, num_layers_enc=2,
          num_flow_blocks_dec=2, num_block_layers=2)
TYPES = ("gatedconv", "time-depth-separable")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _ncw(x):
    return np.asarray(x).transpose(0, 2, 1)


def _init_args():
    return (jnp.zeros((1, 8), jnp.int32), jnp.array([8], jnp.int32),
            jnp.zeros((1, 12, 80)), jnp.array([12], jnp.int32))


@pytest.fixture(scope="module", params=TYPES)
def g(request):
    """tts_tpu's forward, losses and gradients for one encoder type, on
    seeded params (and statistics: means 0.1 N(0, 1), variances 0.5 +
    |N(0, 1)|)."""
    encoder_type = request.param
    jm = JGlowTTS(**KW, encoder_type=encoder_type)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key, "noise": key}, *_init_args(),
        train=False))
    rng = np.random.default_rng(0)
    params = random_params(unfreeze(shapes)["params"], rng)
    stats = {}
    if "batch_stats" in shapes:
        stats = jax.tree_util.tree_map_with_path(
            lambda path, leaf: (0.5 + np.abs(rng.standard_normal(leaf.shape))
                                if path[-1].key == "var"
                                else 0.1 * rng.standard_normal(leaf.shape)
                                ).astype(np.float32),
            dict(shapes["batch_stats"]))
    drng = np.random.default_rng(1)
    np_batch = {
        "text": drng.integers(1, KW["num_chars"], (3, 13)).astype(np.int32),
        "text_lengths": np.array([13, 9, 4], np.int32),
        "mel": drng.standard_normal((3, 40, 80)).astype(np.float32),
        "mel_lengths": np.array([40, 31, 17], np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    variables = {"batch_stats": stats} if stats else {}

    def loss_fn(p):
        out = jm.apply({"params": p, **variables}, jb["text"],
                       jb["text_lengths"], jb["mel"], jb["mel_lengths"],
                       train=False)
        losses = j_glow_tts_loss(out, jb["text_lengths"])
        return losses["loss"], (losses, out)

    (_, (losses, out)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"type": encoder_type, "jm": jm, "params": params, "stats": stats,
            "np_batch": np_batch, "losses": losses, "out": out,
            "grads": grads,
            "tb": batch_to_device(np_batch, torch.device("cpu"))}


def _port(g, **kw) -> GlowTTS:
    model = GlowTTS(**KW, encoder_type=g["type"], **kw)
    model.load_state_dict(
        glow_tts_state_dict_from_jax(g["params"], g["stats"] or None),
        strict=True)
    return model.eval()


def test_encoder_body_and_prenet(g):
    """The gated convs take no prenet; the separable encoder does; both
    stack 3 + num_layers layers; B3 refuses both."""
    model = _port(g)
    enc = model.encoder
    depth = 3 + KW["num_layers_enc"]
    if g["type"] == "gatedconv":
        assert isinstance(enc.encoder, GatedConvBlock)
        assert not hasattr(enc, "pre")
        assert len(enc.encoder.conv_layers) == depth
    else:
        assert isinstance(enc.encoder, TimeDepthSeparableConvBlock)
        assert hasattr(enc, "pre")
        assert len(enc.encoder.layers) == depth
    assert not supports_fused_encoder(enc)


def test_forward_and_loss_match(g):
    """The training forward at eval (MAS included) and the losses."""
    model = _port(g)
    with torch.no_grad():
        out = model(*(g["tb"][k] for k in ("text", "text_lengths", "mel",
                                            "mel_lengths")))
        losses = glow_tts_loss(out, g["tb"]["text_lengths"])
    want = g["out"]
    np.testing.assert_array_equal(out["alignments"].numpy(),
                                  np.asarray(want["alignments"]))
    for key in ("z", "y_mean", "o_attn_dur", "o_dur_log"):
        _close(_ncw(out[key].numpy()), want[key])
    _close(out["logdet"].numpy(), want["logdet"])
    for key in ("log_mle", "loss_dur", "loss"):
        np.testing.assert_allclose(float(losses[key]),
                                   float(g["losses"][key]), rtol=0, atol=TOL)


def test_gradients_match_jax_grad(g):
    model = _port(g)
    out = model(*(g["tb"][k] for k in ("text", "text_lengths", "mel",
                                        "mel_lengths")))
    glow_tts_loss(out, g["tb"]["text_lengths"])["loss"].backward()
    want = glow_tts_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, g["grads"]), g["stats"] or None)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _close(p.grad.numpy(), want[name].numpy())


def test_inference_runs_the_encoder_module_and_matches(g, monkeypatch):
    """Inference with noise 0 and pinned durations (ceil must not flip on
    an ulp): the encoder runs as its module, never B3's entry; durations,
    ``mel_lengths`` and the mel match tts_tpu's."""
    params = jax.tree_util.tree_map(np.copy, g["params"])
    proj = params["encoder"]["duration_predictor"]["proj"]
    proj["kernel"] = np.zeros_like(proj["kernel"])
    proj["bias"] = np.full_like(proj["bias"], 1.5)
    g = dict(g, params=params)
    variables = {"params": params}
    if g["stats"]:
        variables["batch_stats"] = g["stats"]
    text = g["np_batch"]["text"]
    lengths = g["np_batch"]["text_lengths"]
    want = jax.jit(lambda v, t, n: g["jm"].apply(
        v, t, n, noise_scale=0.0, y_max_length=96,
        method=JGlowTTS.inference))(variables, jnp.asarray(text),
                                    jnp.asarray(lengths))

    def no_b3(*args, **kwargs):
        raise AssertionError("B3 called for a non-transformer encoder")

    monkeypatch.setattr(G, "fused_glow_encoder", no_b3)
    model = _port(g)
    model.store_inverse()
    got = model.inference(torch.from_numpy(text).long(),
                          torch.from_numpy(lengths), noise_scale=0.0,
                          y_max_length=96)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                  np.asarray(want["mel_lengths"]))
    _close(got["model_outputs"].numpy(), want["model_outputs"])


def test_weights_round_trip_through_port_glow_tts(g):
    """The port's state dict, read back by tts_tpu's ``port_glow_tts`` (and
    ``port_glow_tts_batch_stats`` for the separable encoder's BatchNorms),
    gives the seeded params and statistics exactly."""
    model = _port(g)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = port_glow_tts(sd, g["params"], num_layers_enc=KW["num_layers_enc"],
                           num_flow_blocks=KW["num_flow_blocks_dec"],
                           num_coupling_layers=KW["num_block_layers"],
                           encoder_type=g["type"])
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(g["params"]))
    got = dict(flat(params))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), leaf, rtol=0,
                                   atol=1e-6, err_msg=str(path))
    if g["stats"]:
        stats = port_glow_tts_batch_stats(sd, g["stats"],
                                          3 + KW["num_layers_enc"])
        for path, leaf in flat(g["stats"]):
            np.testing.assert_array_equal(
                np.asarray(dict(flat(stats))[path]), leaf)


def test_separable_block_train_mode_matches_flax_batchnorm():
    """The separable layers in train mode: the output (batch statistics)
    and every running statistic after one update (flax momentum 0.9 on
    the biased variance)."""
    jm = JTDSBlock(16, kernel_size=5, num_layers=2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    mask = (np.arange(11)[None] < np.array([11, 7])[:, None]
            ).astype(np.float32)[..., None]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), jnp.asarray(mask),
                                            train=False))
    params = random_params(dict(shapes["params"]), rng)
    stats = jax.tree_util.tree_map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
        dict(shapes["batch_stats"]))
    want, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(mask))
    block = TimeDepthSeparableConvBlock(16, 5, 2)
    sd = {}
    for i in range(2):
        p, st = params[f"layer_{i}"], stats[f"layer_{i}"]
        for name in ("time_conv", "depth_conv", "time_conv2"):
            sd[f"layers.{i}.{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(p[name]["kernel"].transpose(2, 1, 0)))
            sd[f"layers.{i}.{name}.bias"] = torch.from_numpy(p[name]["bias"])
        for j in (1, 2, 3):
            dst, bn = f"layers.{i}.norm{j}", p[f"norm{j}"]
            sd[f"{dst}.weight"] = torch.from_numpy(bn["scale"])
            sd[f"{dst}.bias"] = torch.from_numpy(bn["bias"])
            sd[f"{dst}.running_mean"] = torch.from_numpy(st[f"norm{j}"]["mean"])
            sd[f"{dst}.running_var"] = torch.from_numpy(st[f"norm{j}"]["var"])
            sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)
    block.load_state_dict(sd, strict=True)
    got = block.train()(torch.from_numpy(_ncw(x).copy()),
                        torch.from_numpy(_ncw(mask).copy()))
    _close(_ncw(got.detach().numpy()), want)
    new = mutated["batch_stats"]
    for i in range(2):
        for j in (1, 2, 3):
            bn = getattr(block.layers[i], f"norm{j}")
            for ours, theirs in (("running_mean", "mean"),
                                 ("running_var", "var")):
                np.testing.assert_allclose(
                    getattr(bn, ours).numpy(),
                    np.asarray(new[f"layer_{i}"][f"norm{j}"][theirs]),
                    rtol=0, atol=1e-6)


def test_tts_tpu_trainer_cannot_train_the_separable_encoder():
    """tts_tpu's Glow trainer applies ``{"params": p}`` alone
    (``tts_tpu/train/trainer_glow.py``), which a BatchNorm in train mode
    cannot read: a separable encoder fails there. The port trains it,
    moving the statistics (the next test; ROADMAP C27)."""
    jm = JGlowTTS(**KW, encoder_type="time-depth-separable")
    params = random_params(init_shapes(jm, *_init_args(), train=False),
                           np.random.default_rng(0))
    with pytest.raises(Exception, match="batch_stats"):
        jm.apply({"params": params}, *_init_args(),
                 rngs={"dropout": jax.random.PRNGKey(0)})


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_ljspeech_fixture(str(tmp_path_factory.mktemp("ljspeech")))


@pytest.mark.parametrize("encoder_type", TYPES)
def test_trainer_trains_and_serves_each_encoder(encoder_type, corpus,
                                                tmp_path, monkeypatch):
    """bin/train_glow_tts on the CPU (hidden 32, batch 4, one epoch): every
    loss finite; for the separable encoder every BatchNorm's running
    statistics moved and the checkpoint holds them; the checkpoint serves
    through the Synthesizer, its encoder as a module."""
    from tts_tpu_torch.bin.train_glow_tts import main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.layers import BatchNorm1d
    from tts_tpu_torch.train.checkpoint import latest_checkpoint

    c = load_config(os.path.join(ROOT, "configs", "glow_tts_ljspeech.json"))
    c.update(encoder_type=encoder_type, hidden_channels_encoder=32,
             hidden_channels_decoder=32, batch_size=4, epochs=1,
             run_eval=False, use_phonemes=False, print_step=1)
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv"}]
    c["phoneme_cache_path"] = str(tmp_path / "phonemes")
    cfg = tmp_path / "glow.json"
    cfg.write_text(json.dumps(c))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    trainer = main(["--config_path", str(cfg), "--output_path",
                    str(tmp_path / "runs"), "--device", "cpu"])
    assert trainer.model.encoder.encoder_type == encoder_type
    assert trainer.step_stats
    for stats in trainer.step_stats:
        assert all(np.isfinite(v) for v in stats.values()), stats
    ckpt = latest_checkpoint(trainer.output_path)
    saved = torch.load(ckpt, weights_only=True)["model"]
    norms = [(n, m) for n, m in trainer.model.named_modules()
             if isinstance(m, BatchNorm1d)]
    assert bool(norms) == (encoder_type == "time-depth-separable")
    for name, m in norms:
        assert float(m.running_var.sub(1.0).abs().max()) > 0, name
        assert torch.equal(saved[f"{name}.running_var"], m.running_var)
        assert torch.equal(saved[f"{name}.running_mean"], m.running_mean)

    def no_b3(*args, **kwargs):
        raise AssertionError("B3 called for a non-transformer encoder")

    monkeypatch.setattr(G, "fused_glow_encoder", no_b3)
    wav = Synthesizer(ckpt, str(cfg), device="cpu").tts("Be a voice.")
    assert np.isfinite(wav).all() and len(wav) > 10000
