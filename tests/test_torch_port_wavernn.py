"""WaveRNN in the port against tts_tpu, on the CPU: the teacher-forced
logits in bits and mold mode, the losses and gradients, the weights bridge
both ways, the registry's overloaded ``mode``, ``generate``'s samples
against tts_tpu's teacher-forced cell, mu-law, and serving a tts_tpu
msgpack WaveRNN checkpoint through the Synthesizer.

Parameters come from numpy seeds in tts_tpu's shapes
(``tests/torch_port_params.py``; BatchNorm statistics seeded too) and go
across with ``compat/from_jax.py``. Small widths: rnn 32, fc 24, 20 mel
bins, compute and res-out 16, 2 res blocks, pad 2, upsample (2, 2) (hop
4), 8 bits, 4 mixtures in mold mode. Tolerances: logits within 1e-5 of
their largest magnitude, losses and gradients within 1e-4 of theirs
(float32, another summation order).

``generate`` draws its uniforms from torch generators, so its samples are
not tts_tpu's. Its self-consistency is checked instead: the port's sampled
sequence, fed back teacher-forced through tts_tpu's ``__call__``, gives
logits from which the same uniforms draw the same samples; where a class
id differs, the uniform lies within 1e-5 of a class boundary.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.torch_port_params import random_params
from tts_tpu.compat.torch_port import port_wavernn
from tts_tpu.models.vocoder import wavernn as J
from tts_tpu.models.vocoder.registry import \
    setup_generator as j_setup_generator
from tts_tpu.train.checkpoint import save_checkpoint as save_tts_tpu
from tts_tpu_torch.compat.from_jax import wavernn_state_dict_from_jax
from tts_tpu_torch.config import load_config
from tts_tpu_torch.models.vocoder import wavernn as W
from tts_tpu_torch.models.vocoder.registry import setup_generator

SMALL = dict(rnn_dims=32, fc_dims=24, feat_dims=20, compute_dims=16,
             res_out_dims=16, res_blocks=2, pad=2, upsample_factors=(2, 2))
BITS, NR_MIX = 8, 4
FRAMES = 12                       # mel frames after the context padding
HOP = 4
MODES = ("bits", "mold")
LOGIT_TOL, LOSS_TOL = 1e-5, 1e-4
BOUNDARY = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def jax_model(mode):
    return J.WaveRNN(bits=BITS, mode=mode, nr_mix=NR_MIX, **SMALL)


def port_model(mode):
    return W.WaveRNN(bits=BITS, mode=mode, nr_mix=NR_MIX, **SMALL).eval()


def seeded_variables(mode, seed=0):
    """tts_tpu's (params, batch_stats) in its shapes, from a numpy seed:
    running means near 0, variances in [0.5, 1.5]."""
    jm = jax_model(mode)
    T = FRAMES * HOP
    shapes = unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, T)),
        jnp.zeros((1, FRAMES + 2 * SMALL["pad"], SMALL["feat_dims"])))))
    rng = np.random.default_rng(seed)
    params = random_params(shapes["params"], rng)

    def stat(path, leaf):
        if path[-1].key == "mean":
            return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"])
    return params, stats


def inputs(seed=1, batch=2):
    mel = _rand(seed, (batch, FRAMES + 2 * SMALL["pad"], SMALL["feat_dims"]))
    x = np.random.default_rng(seed + 1).uniform(
        -1, 1, (batch, FRAMES * HOP)).astype(np.float32)
    return mel, x


def _ncw(mel):
    return torch.from_numpy(np.ascontiguousarray(mel.transpose(0, 2, 1)))


def loaded(mode, params, stats):
    m = port_model(mode)
    m.load_state_dict(wavernn_state_dict_from_jax(params, stats), strict=True)
    return m


@pytest.mark.parametrize("mode", MODES)
def test_teacher_forced_logits_match_tts_tpu(mode):
    params, stats = seeded_variables(mode)
    mel, x = inputs()
    want = jax_model(mode).apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), jnp.asarray(mel))
    with torch.no_grad():
        got = loaded(mode, params, stats)(torch.from_numpy(x), _ncw(mel))
    assert float(np.asarray(want).std()) > 1e-2
    _close(got.numpy(), want, LOGIT_TOL)


def _bin_mass(y_hat, y, num_classes=65536):
    """The mixture's probability mass in each sample's bin (float64): the
    NLL switches to its density branch where it falls to 1e-5."""
    nr = y_hat.shape[-1] // 3
    s = np.exp(-np.maximum(y_hat[..., 2 * nr:].astype(np.float64),
                           W.LOG_SCALE_MIN))
    c = y[..., None] - y_hat[..., nr:2 * nr]
    half = 1.0 / (num_classes - 1)
    return 0.5 * (np.tanh(0.5 * s * (c + half))
                  - np.tanh(0.5 * s * (c - half)))


def test_losses_and_their_gradients_match_jax():
    """Cross entropy and the mixture NLL and their gradients. The mixture's
    samples sit at both clipped edges, in the middle, and on both sides of
    the switch to the density branch (a bin mass of 1e-5), but none within
    5 % of it: there the float32 rounding of either package may pick the
    other branch, a discontinuity of the function itself."""
    logits = _rand(3, (2, 16, 2 ** BITS), 2.0)
    ids = np.random.default_rng(4).integers(0, 2 ** BITS, (2, 16))
    y_hat = _rand(5, (2, 16, 3 * NR_MIX))
    y_hat[..., 2 * NR_MIX:] -= 4.0
    y = np.random.default_rng(6).uniform(-1, 1, (2, 16)).astype(np.float32)
    while True:
        near = (np.abs(_bin_mass(y_hat, y) / 1e-5 - 1) < 0.05).any(-1)
        if not near.any():
            break
        y[near] += np.float32(0.003)
    y[0, :3] = (-1.0, 1.0, 0.9995)
    mass = _bin_mass(y_hat, y)
    assert (mass > 1e-5).any() and (mass < 1e-5).any()

    for j_fn, t_fn, args in (
            (J.wavernn_loss, W.wavernn_loss, (logits, ids)),
            (J.discretized_mix_logistic_loss, W.discretized_mix_logistic_loss,
             (y_hat, y))):
        want, want_grad = jax.value_and_grad(j_fn)(jnp.asarray(args[0]),
                                                   jnp.asarray(args[1]))
        first = torch.from_numpy(args[0]).requires_grad_(True)
        got = t_fn(first, torch.from_numpy(args[1]))
        got.backward()
        _close(got.detach().numpy(), want, LOSS_TOL)
        _close(first.grad.numpy(), want_grad, LOSS_TOL)


def test_model_gradients_match_jax_grad():
    """The cross entropy of the teacher-forced bits model (eval-mode
    BatchNorm) differentiated by every parameter: the port's ``.grad``s
    against ``jax.grad`` carried over by the converter (the GRUs' r and z
    input-side bias gradients are torch's ``bias_ih`` and ``bias_hh``
    gradients each)."""
    params, stats = seeded_variables("bits", seed=2)
    mel, x = inputs(seed=7)
    ids = np.random.default_rng(8).integers(0, 2 ** BITS, x.shape)
    jm = jax_model("bits")

    def loss(p):
        logits = jm.apply({"params": p, "batch_stats": stats},
                          jnp.asarray(x), jnp.asarray(mel))
        return J.wavernn_loss(logits, jnp.asarray(ids))

    grads = jax.grad(loss)(params)
    want = wavernn_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), stats)
    model = loaded("bits", params, stats)
    W.wavernn_loss(model(torch.from_numpy(x), _ncw(mel)),
                   torch.from_numpy(ids)).backward()
    R = SMALL["rnn_dims"]
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        if ".bias_hh" in name:
            ih = dict(model.named_parameters())[name.replace("hh", "ih")]
            _close(g[:2 * R], ih.grad.numpy()[:2 * R], LOSS_TOL)
            g, w = g[2 * R:], want[name].numpy()[2 * R:]
        else:
            w = want[name].numpy()
        _close(g, w, LOSS_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_weights_round_trip_to_tts_tpu(mode):
    """tts_tpu tree -> port state dict -> ``port_wavernn`` -> the same
    tree, BatchNorm statistics included."""
    params, stats = seeded_variables(mode, seed=3)
    sd = {k: v.numpy() for k, v in loaded(mode, params, stats)
          .state_dict().items()}
    back_p, back_s = port_wavernn(sd, res_blocks=SMALL["res_blocks"],
                                  upsample_factors=SMALL["upsample_factors"])
    for want, got in ((params, back_p), (stats, back_s)):
        w, g = (jax.tree_util.tree_leaves_with_path(t) for t in (want, got))
        assert [p for p, _ in w] == [p for p, _ in g]
        for (path, a), (_, b) in zip(w, g):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=0, atol=1e-7, err_msg=str(path))


@pytest.mark.parametrize("mode,bits,classes", [
    (9, 9, 512), ("mold", 10, 30), (None, 10, 1024)])
def test_registry_reads_the_overloaded_mode(mode, bits, classes):
    c = {"generator_model": "wavernn", "audio": {"num_mels": 20},
         "generator_model_params": dict(SMALL)}
    c["generator_model_params"].pop("feat_dims")
    if mode is not None:
        c["mode"] = mode
    gen = setup_generator(c)
    jgen = j_setup_generator(c)
    assert (gen.mode, gen.bits, gen.n_classes) == (
        jgen.mode, jgen.bits, classes)
    assert gen.hop == 4 and gen.fc3.out_features == classes


@pytest.mark.parametrize("mode", MODES)
def test_generate_is_self_consistent_with_tts_tpu(mode):
    params, stats = seeded_variables(mode, seed=4)
    mel, _ = inputs(seed=9)
    model = loaded(mode, params, stats)
    u = model.draws(2, FRAMES * HOP, torch.Generator().manual_seed(0),
                    torch.device("cpu"))
    samples = model.sample_loop(_ncw(mel), u)
    x_in = model.previous_samples(samples).numpy()
    logits = torch.from_numpy(np.array(jax_model(mode).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x_in),
        jnp.asarray(mel))))
    if mode == "bits":
        redrawn = W.draw_bits(logits, u[0])
        differ = redrawn != samples
        near = W.boundary_distance(logits, u[0]) < BOUNDARY
    else:
        redrawn = W.draw_mold(logits, u[0], u[1])
        differ = (redrawn - samples).abs() > 1e-4
        near = W.boundary_distance(logits[..., :NR_MIX], u[0]) < BOUNDARY
    assert len(torch.unique(samples)) > 8                 # not a constant
    assert not bool((differ & ~near).any()), int(differ.sum())
    wav = model.waveform(samples)
    assert wav.shape == (2, FRAMES * HOP)
    assert float(wav.abs().max()) <= 1.0


def test_generate_draws_from_its_generator_only():
    params, stats = seeded_variables("bits", seed=5)
    mel, _ = inputs(seed=10, batch=1)
    model = loaded("bits", params, stats)
    a = model.generate(_ncw(mel), torch.Generator().manual_seed(3))
    torch.manual_seed(123)
    b = model.generate(_ncw(mel), torch.Generator().manual_seed(3))
    c = model.generate(_ncw(mel), torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # one mixture step: both draws from the generator, in [-1, 1]
    y_hat = torch.from_numpy(_rand(12, (64, 3 * NR_MIX)))
    x = W.sample_from_discretized_mix_logistic(
        y_hat, torch.Generator().manual_seed(5))
    u = torch.rand((2, 64), generator=torch.Generator().manual_seed(5))
    assert torch.equal(x, W.draw_mold(y_hat, u[0], u[1]))
    assert float(x.abs().max()) <= 1.0 and len(torch.unique(x)) > 8


def test_mulaw_matches_tts_tpu_and_stays_in_range():
    x = np.linspace(-1, 1, 4001, dtype=np.float32)
    for bits in (8, 9, 10):
        ids = W.mulaw_encode(torch.from_numpy(x), 2 ** bits)
        np.testing.assert_array_equal(
            ids.numpy(), np.asarray(J.mulaw_encode_jnp(jnp.asarray(x),
                                                       2 ** bits)))
        every = torch.arange(2 ** bits)
        y = W.mulaw_decode(every, 2 ** bits)
        _close(y.numpy(), J.mulaw_decode_jnp(jnp.asarray(every.numpy()),
                                             2 ** bits), 1e-6)
        assert float(y.min()) >= -1.0 and float(y.max()) <= 1.0
        _close(W.label_to_float(every, bits).numpy(),
               J.label_to_float(jnp.asarray(every.numpy()), bits), 1e-7)


def _vocoder_config(tmp_path, factors, name="wavernn.json"):
    c = dict(load_config("configs/multiband_melgan.json"))
    c["audio"] = dict(c["audio"], hop_length=4, win_length=16, fft_size=64,
                      num_mels=80)
    c["generator_model"] = "wavernn"
    c["mode"] = BITS
    c["generator_model_params"] = dict(SMALL, upsample_factors=factors)
    c["generator_model_params"].pop("feat_dims")
    path = tmp_path / name
    path.write_text(json.dumps(c, default=dict))
    return c, str(path)


def test_synthesizer_serves_a_tts_tpu_wavernn_checkpoint(tmp_path):
    """A tts_tpu msgpack WaveRNN checkpoint behind a small Glow-TTS: the
    weights arrive as ``wavernn_state_dict_from_jax`` gives them, the audio
    is ``generate`` on the edge-padded bucketed mel with a generator
    seeded 0, cut to n * hop, the same on every request; a vocoder config
    whose upsampling is not its hop is refused at load."""
    from tests.test_torch_port_pwgan import small_glow_checkpoint
    from tts_tpu_torch.infer.synthesis import synthesis
    from tts_tpu_torch.infer.synthesizer import Synthesizer, load_checkpoint

    c, voc_cfg = _vocoder_config(tmp_path, (2, 2))
    jgen = j_setup_generator(c)
    shapes = unfreeze(jax.eval_shape(lambda: jgen.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8)),
        jnp.zeros((1, 6, 80)))))
    rng = np.random.default_rng(11)
    params = random_params(shapes["params"], rng)
    stats = jax.tree_util.tree_map(
        lambda leaf: rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32),
        shapes["batch_stats"])
    save_tts_tpu(str(tmp_path / "voc"), params=params, batch_stats=stats,
                 step=2)
    ckpt = str(tmp_path / "voc" / "checkpoint_2.ckpt")
    sd = load_checkpoint(ckpt, c)["model"]
    want_sd = wavernn_state_dict_from_jax(params, stats)
    assert sd.keys() == want_sd.keys()
    assert all(torch.equal(sd[k], want_sd[k]) for k in sd)

    glow, glow_cfg = small_glow_checkpoint(tmp_path)
    synth = Synthesizer(glow, glow_cfg, ckpt, voc_cfg, device="cpu")
    assert isinstance(synth.vocoder_model, W.WaveRNN)
    text = "Hello world."
    wav = synth.tts(text)
    np.testing.assert_array_equal(wav, synth.tts(text))
    out = synthesis(synth.model, text, synth.tts_config, synth.device,
                    generator=torch.Generator().manual_seed(0), ap=synth.ap)
    m = torch.from_numpy(np.ascontiguousarray(out["postnet_outputs"],
                                              np.float32))
    n = m.shape[0]
    nb = max(32, -(-n // 32) * 32)
    m = torch.cat([m, m[-1:].expand(nb - n, -1)])
    m = torch.cat([m[:1], m[:1], m, m[-1:], m[-1:]])[None].transpose(1, 2)
    gen = synth.vocoder_model
    want = gen.generate(m, torch.Generator().manual_seed(0))[0].numpy()
    want = want[: n * HOP] if n < nb else want
    assert len(wav) == len(want) + 10000          # the inter-sentence gap
    np.testing.assert_array_equal(wav[: len(want)], want)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
    assert np.abs(wav).max() <= 1.0

    _, bad_cfg = _vocoder_config(tmp_path, (2, 4), "wavernn_bad.json")
    with pytest.raises(ValueError, match="hop_length"):
        Synthesizer(glow, glow_cfg, ckpt, bad_cfg, device="cpu")
