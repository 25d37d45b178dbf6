"""The fused Glow-TTS encoder (B3) in the port against tts_tpu, on the CPU.

The port's plain version of B3 (``glow_encoder_torch``, which CPU tensors
take) is held to tts_tpu's Pallas B3 in interpret mode and to its flax
``GlowTTSEncoder`` in eval mode, on the same seeded weights carried over by
``glow_tts_state_dict_from_jax``, at atol 2e-5 / rtol 1e-4 (tts_tpu's own
B3 test's tolerances: float32, other summation orders). Also: the port's
module against the plain version, bucket padding, repacking after the
weights change, the eval/grad dispatch of ``GlowTTS.encode``, and
``GlowTTS.inference`` against tts_tpu's with the duration head pinned
(1e-3 on mels after the inverse flows, durations exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.models.glow.encoder import GlowTTSEncoder as JEncoder
from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.ops.pallas.fused_glow_encoder import (
    fused_glow_encoder_apply, pack_glow_encoder_params as j_pack)
from tts_tpu_torch.compat.from_jax import glow_tts_state_dict_from_jax
from tts_tpu_torch.models import glow_tts as glow_module
from tts_tpu_torch.models.glow_tts import GlowTTS
from tts_tpu_torch.ops import glow_encoder as GE

from tests.torch_port_params import module_params

KW = dict(num_chars=40, hidden_channels_enc=32, hidden_channels_dec=16,
          filter_channels=64, filter_channels_dp=48, num_layers_enc=2,
          num_flow_blocks_dec=2, num_block_layers=2)
ATOL, RTOL = 2e-5, 1e-4
B, T = 4, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(pin_durations=False):
    params = module_params(JGlowTTS(**KW), 0, jnp.zeros((1, 8), jnp.int32),
                           jnp.array([8], jnp.int32), jnp.zeros((1, 12, 80)),
                           jnp.array([12], jnp.int32), train=False)
    if pin_durations:
        proj = params["encoder"]["duration_predictor"]["proj"]
        proj["kernel"][:] = 0.0
        proj["bias"][:] = np.log(3.5)
    return params


def _port(params) -> GlowTTS:
    model = GlowTTS(**KW)
    model.load_state_dict(glow_tts_state_dict_from_jax(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def glow():
    params = _jax_params()
    jenc = JEncoder(num_chars=40, out_channels=80, hidden_channels=32,
                    filter_channels=64, filter_channels_dp=48, num_heads=2,
                    num_layers=2, kernel_size=3, rel_attn_window_size=4,
                    mean_only=True)
    rng = np.random.default_rng(1)
    text = rng.integers(1, 40, size=(B, T)).astype(np.int32)
    return {"params": params, "jenc": jenc, "model": _port(params),
            "text": text}


def _fused(model, text, lengths):
    enc = model.encoder
    with torch.no_grad():
        out = GE.fused_glow_encoder(enc, enc.packed_weights(),
                                    torch.from_numpy(text).long(),
                                    torch.from_numpy(lengths))
    return [t.numpy().transpose(0, 2, 1) for t in out]


@pytest.mark.parametrize("lengths", [[T] * B, [T, 21, 9, 1]],
                         ids=["uniform", "ragged"])
def test_plain_matches_pallas_and_flax(glow, lengths):
    """All four outputs, padded rows included: B3 in interpret mode (4
    items stacked in one grid step, attention in groups of 2) and the flax
    module, on weights where nothing is zero (the prenet's projection
    included)."""
    lengths = np.asarray(lengths, np.int32)
    enc_params = glow["params"]["encoder"]
    text, tl = jnp.asarray(glow["text"]), jnp.asarray(lengths)
    flax = glow["jenc"].apply({"params": enc_params}, text, tl, train=False)
    pallas = fused_glow_encoder_apply(
        glow["jenc"], enc_params, j_pack(glow["jenc"], enc_params), text, tl,
        ipb=4, att_group=2, interpret=True)
    got = _fused(glow["model"], glow["text"], lengths)
    for name, g, p, f in zip(("mean", "log_scale", "dur", "mask"), got,
                             pallas, flax):
        np.testing.assert_allclose(g, np.asarray(p), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} vs Pallas")
        np.testing.assert_allclose(g, np.asarray(f), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} vs flax")
    assert np.abs(got[0]).max() > 0.1 and np.abs(got[2]).max() > 0.1


def test_module_in_eval_matches_plain(glow):
    lengths = np.array([T, 17, 5, 24], np.int32)
    with torch.no_grad():
        want = glow["model"].encoder(torch.from_numpy(glow["text"]).long(),
                                     torch.from_numpy(lengths))
    got = _fused(glow["model"], glow["text"], lengths)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w.numpy().transpose(0, 2, 1),
                                   atol=ATOL, rtol=RTOL)


def test_bucket_padding_is_inert(glow):
    """The same texts at their length and padded with zeros to the next
    text bucket (32) give the same valid outputs; padded rows are 0."""
    lengths = np.array([T, 21, 9, 1], np.int32)
    short = _fused(glow["model"], glow["text"], lengths)
    padded_text = np.pad(glow["text"], ((0, 0), (0, 32 - T)))
    padded = _fused(glow["model"], padded_text, lengths)
    for s, p in zip(short, padded):
        np.testing.assert_allclose(p[:, :T], s, atol=1e-5, rtol=0)
        assert not p[:, T:].any()


def test_pack_follows_the_weights(glow):
    """The pack is kept while the weights are; an in-place update (an
    optimizer step) or load_state_dict repacks, so inference never runs
    stale weights (ROADMAP C6)."""
    model = _port(glow["params"])
    enc = model.encoder
    lengths = np.array([T, 21, 9, 1], np.int32)
    first = enc.packed_weights()
    assert enc.packed_weights() is first
    before = _fused(model, glow["text"], lengths)
    opt = torch.optim.SGD(enc.parameters(), lr=0.1)
    for p in enc.parameters():
        p.grad = torch.full_like(p, 0.01)
    opt.step()
    assert enc.packed_weights() is not first
    stepped = _fused(model, glow["text"], lengths)
    with torch.no_grad():
        want = enc(torch.from_numpy(glow["text"]).long(),
                   torch.from_numpy(lengths))
    np.testing.assert_allclose(stepped[0], want[0].numpy().transpose(0, 2, 1),
                               atol=ATOL, rtol=RTOL)
    assert np.abs(stepped[0] - before[0]).max() > 1e-3
    model.load_state_dict(glow_tts_state_dict_from_jax(glow["params"]))
    reloaded = _fused(model, glow["text"], lengths)
    for r, b in zip(reloaded, before):
        np.testing.assert_array_equal(r, b)


def test_dispatch(glow, monkeypatch):
    """eval + no_grad: the fused call; training mode or grad mode: the
    module (with its dropout); a window other than 4: the module; the fused
    call refuses to run where autograd would need a graph."""
    model = _port(glow["params"])
    calls = []
    real = glow_module.fused_glow_encoder

    def spy(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(glow_module, "fused_glow_encoder", spy)
    text = torch.from_numpy(glow["text"]).long()
    lengths = torch.tensor([T, 21, 9, 1])
    with torch.no_grad():
        model.encode(text, lengths)
    assert calls == [1]
    model.train()
    with torch.no_grad():
        model.encode(text, lengths)
    model.eval()
    out = model.encode(text, lengths)           # grad mode
    assert out[0].requires_grad and calls == [1]
    with pytest.raises(RuntimeError, match="no_grad"):
        GE.fused_glow_encoder(model.encoder, model.encoder.packed_weights(),
                              text, lengths)
    assert GE.supports_fused_encoder(model.encoder)
    for window in (2, None):
        other = GlowTTS(**KW, rel_attn_window_size=window).eval()
        assert not GE.supports_fused_encoder(other.encoder)
        with torch.no_grad():
            other.encode(text, lengths)
    assert calls == [1]
    with pytest.raises(ValueError, match="window 4"):
        GE.pack_glow_encoder_params(other.encoder)


def test_inference_matches_tts_tpu():
    """GlowTTS.inference (its encoder through the plain B3) against
    tts_tpu's, the duration head pinned to 3 frames per symbol."""
    params = _jax_params(pin_durations=True)
    model = _port(params)
    rng = np.random.default_rng(2)
    text = rng.integers(1, 40, size=(3, 13)).astype(np.int32)
    lengths = np.array([13, 9, 4], np.int32)
    jm = JGlowTTS(**KW)
    want = jax.jit(lambda p, t, n: jm.apply(
        {"params": p}, t, n, method=JGlowTTS.inference, noise_scale=0.0,
        y_max_length=64))(params, jnp.asarray(text), jnp.asarray(lengths))
    got = model.inference(torch.from_numpy(text).long(),
                          torch.from_numpy(lengths), noise_scale=0.0,
                          y_max_length=64)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                  np.asarray(want["mel_lengths"]))
    np.testing.assert_allclose(got["durations_log"].numpy(),
                               np.asarray(want["durations_log"]), atol=ATOL)
    np.testing.assert_allclose(got["model_outputs"].numpy(),
                               np.asarray(want["model_outputs"]), atol=1e-3)
