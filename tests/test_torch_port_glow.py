"""Glow-TTS inference in the port against tts_tpu at small width.

The same parameters (a tts_tpu tree, carried over by
``glow_tts_state_dict_from_jax``) and the same numpy inputs go through both
packages. Tolerances: 1e-4 absolute for the encoder and single layers
(float32, different summation order), 1e-3 for mels after the inverse flows.
Integer durations are compared for equality before any mel: a last-ulp
difference in ceil(expm1(.)) would shift every later frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.compat.torch_port import port_glow_tts
from tts_tpu.models.glow.decoder import FlowDecoder as JFlowDecoder
from tts_tpu.models.glow.flows import _closed_form_inv as j_inv
from tts_tpu.models.glow.transformer import \
    RelativePositionMultiHeadAttention as JAttn
from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.ops.mas import generate_path as j_generate_path
from tts_tpu_torch.compat.from_jax import glow_tts_state_dict_from_jax
from tts_tpu_torch.models.glow.flows import _closed_form_inv as t_inv
from tts_tpu_torch.models.glow.transformer import \
    RelativePositionMultiHeadAttention as TAttn
from tts_tpu_torch.models.glow_tts import GlowTTS as TGlowTTS
from tts_tpu_torch.ops.mas import generate_path as t_generate_path

from tests.torch_port_params import module_params

torch.set_num_threads(1)

KW = dict(num_chars=40, hidden_channels_enc=32, hidden_channels_dec=32,
          filter_channels=64, filter_channels_dp=32, num_layers_enc=2,
          num_flow_blocks_dec=3, num_block_layers=2)


def _tree(node):
    return {k: _tree(v) if hasattr(v, "items") else np.array(v, np.float32)
            for k, v in node.items()}


@pytest.fixture(scope="module")
def glow():
    jm = JGlowTTS(**KW)
    params = module_params(jm, 0, jnp.zeros((1, 8), jnp.int32),
                           jnp.array([8], jnp.int32), jnp.zeros((1, 12, 80)),
                           jnp.array([12], jnp.int32), train=False)
    tm = TGlowTTS(**KW)
    tm.load_state_dict(glow_tts_state_dict_from_jax(params), strict=True)
    tm.eval()
    rng = np.random.default_rng(1)
    text = rng.integers(1, KW["num_chars"], size=(3, 13)).astype(np.int32)
    lens = np.array([13, 9, 4], np.int32)
    return {"jm": jm, "params": params, "tm": tm, "text": text,
            "lens": lens}


def _jax_inference(g, params, **kw):
    return g["jm"].apply({"params": params}, jnp.asarray(g["text"]),
                         jnp.asarray(g["lens"]), method=JGlowTTS.inference,
                         **kw)


def _torch_inference(g, model, **kw):
    return model.inference(torch.from_numpy(g["text"]).long(),
                           torch.from_numpy(g["lens"]), **kw)


def test_encoder_outputs(glow):
    want = glow["jm"].apply({"params": glow["params"]},
                            jnp.asarray(glow["text"]),
                            jnp.asarray(glow["lens"]),
                            method=lambda m, t, l: m.encoder(t, l, train=False))
    got = glow["tm"].encoder(torch.from_numpy(glow["text"]).long(),
                             torch.from_numpy(glow["lens"]))
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.detach().numpy().transpose(0, 2, 1),
                                   np.asarray(w), atol=1e-4)


def test_rel_pos_attention_window():
    """T > 2W+1, so the zero-outside-window band is exercised."""
    C, H, W, T, B = 16, 2, 4, 14, 2
    jm = JAttn(C, H, rel_attn_window_size=W)
    x = np.random.default_rng(2).standard_normal((B, T, C)).astype(np.float32)
    mask = np.ones((B, 1, T, T), bool)
    mask[1, :, :, 10:] = False
    params = module_params(jm, 3, jnp.asarray(x), jnp.asarray(mask),
                           train=False)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                    train=False)
    tm = TAttn(C, H, W)
    sd = {}
    for ours, theirs in (("q", "conv_q"), ("k", "conv_k"), ("v", "conv_v"),
                         ("out", "conv_o")):
        sd[f"{theirs}.weight"] = torch.from_numpy(
            params[ours]["kernel"].T[:, :, None].copy())
        sd[f"{theirs}.bias"] = torch.from_numpy(params[ours]["bias"])
    sd["emb_rel_k"] = torch.from_numpy(params["emb_rel_k"][None])
    sd["emb_rel_v"] = torch.from_numpy(params["emb_rel_v"][None])
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).transpose(1, 2),
                 torch.from_numpy(mask)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_closed_form_inverse():
    w = np.linalg.qr(np.random.default_rng(4).standard_normal((4, 4)))[0]
    w = w.astype(np.float32)
    np.testing.assert_allclose(t_inv(torch.from_numpy(w)).numpy(),
                               np.asarray(j_inv(jnp.asarray(w))), atol=1e-6)


def test_generate_path():
    rng = np.random.default_rng(5)
    dur = rng.integers(0, 4, size=(2, 6)).astype(np.int32)
    mask = np.ones((2, 6, 20), np.float32)
    mask[1, 4:] = 0
    want = j_generate_path(jnp.asarray(dur), jnp.asarray(mask))
    got = t_generate_path(torch.from_numpy(dur), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reverse_flows(glow):
    dec_params = glow["params"]["decoder"]
    jd = JFlowDecoder(in_channels=80, hidden_channels=32,
                      num_flow_blocks=KW["num_flow_blocks_dec"],
                      num_coupling_layers=KW["num_block_layers"])
    rng = np.random.default_rng(6)
    z = rng.standard_normal((2, 24, 80)).astype(np.float32)
    mask = np.ones((2, 24, 1), np.float32)
    mask[1, 18:] = 0
    want, _, want_mask = jd.apply({"params": dec_params}, jnp.asarray(z),
                                  jnp.asarray(mask), reverse=True,
                                  train=False)
    with torch.no_grad():
        got, got_mask = glow["tm"].decoder.reverse(
            torch.from_numpy(z).transpose(1, 2),
            torch.from_numpy(mask).transpose(1, 2))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got_mask.numpy().transpose(0, 2, 1),
                                  np.asarray(want_mask))


def test_inference_durations_then_mels(glow):
    want = _jax_inference(glow, glow["params"], noise_scale=0.0,
                          y_max_length=96)
    got = _torch_inference(glow, glow["tm"], noise_scale=0.0,
                           y_max_length=96)
    # integer durations first
    j_dur = np.asarray(want["alignments"]).sum(axis=1)
    t_dur = got["alignments"].numpy().sum(axis=1)
    np.testing.assert_array_equal(t_dur, j_dur)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                  np.asarray(want["mel_lengths"]))
    np.testing.assert_allclose(got["durations_log"].numpy(),
                               np.asarray(want["durations_log"]), atol=1e-4)
    np.testing.assert_allclose(got["model_outputs"].numpy(),
                               np.asarray(want["model_outputs"]), atol=1e-3)


def test_inference_pinned_durations(glow):
    """Duration head pinned to 6 frames per symbol (as bench.py does): the
    mel comparison then cannot hinge on a rounding flip."""
    params = _tree(glow["params"])
    proj = params["encoder"]["duration_predictor"]["proj"]
    proj["kernel"][:] = 0.0
    proj["bias"][:] = np.log(6.5)
    tm = TGlowTTS(**KW)
    tm.load_state_dict(glow_tts_state_dict_from_jax(params), strict=True)
    tm.eval()
    want = _jax_inference(glow, params, noise_scale=0.0, y_max_length=96)
    got = _torch_inference(glow, tm, noise_scale=0.0, y_max_length=96)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                  [78, 54, 24])
    np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                  np.asarray(want["mel_lengths"]))
    np.testing.assert_allclose(got["model_outputs"].numpy(),
                               np.asarray(want["model_outputs"]), atol=1e-3)


def test_weights_round_trip(glow):
    """tts_tpu's Mozilla -> flax mapping inverts the port's flax -> torch
    one: port_glow_tts(glow_tts_state_dict_from_jax(p)) == p."""
    sd = {k: v.numpy() for k, v in glow_tts_state_dict_from_jax(
        glow["params"]).items()}
    back = port_glow_tts(sd, glow["params"],
                         num_layers_enc=KW["num_layers_enc"],
                         num_flow_blocks=KW["num_flow_blocks_dec"],
                         num_coupling_layers=KW["num_block_layers"])
    want_leaves, want_def = jax.tree_util.tree_flatten(glow["params"])
    got_leaves, got_def = jax.tree_util.tree_flatten(_tree(back))
    assert got_def == want_def
    for w, g in zip(want_leaves, got_leaves):
        np.testing.assert_array_equal(g, w)
