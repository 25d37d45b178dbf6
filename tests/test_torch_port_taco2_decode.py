"""The port's Tacotron2 fast path (infer/fast_decode.py, with the B7 and B8
kernels' plain versions on the CPU) against tts_tpu's fused decode (the
Pallas kernels in interpret mode, float32) and against tts_tpu's
``Tacotron2.inference``, on the reduced model of
``test_torch_port_tacotron2.py``.

r = 2 < r_init = 3 throughout: the stopnet sees all r_init * 80 projected
values and the frames are cut to r * 80. Tolerance: 1e-4 absolute;
``mel_lengths`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_tacotron2 import (
    SMALL, STEPS, assert_outputs_match, jax_inference, jax_variables,
    port_model, text_inputs, with_mixed_stops)
from tts_tpu.infer.fast_decode import \
    taco2_fused_inference as jtaco2_fused_inference
from tts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from tts_tpu.ops.pallas.fused_taco2_decode import fused_decode as jfused_decode
from tts_tpu.ops.pallas.fused_taco2_decode import \
    pack_decoder_params as jpack_decoder_params
from tts_tpu_torch.config import load_config
from tts_tpu_torch.infer.fast_decode import (packed_weights,
                                             supports_fused_decode,
                                             taco2_fused_inference)
from tts_tpu_torch.infer.synthesis import run_model
from tts_tpu_torch.models.registry import setup_model
from tts_tpu_torch.ops.taco2_decode import fused_decode, pack_decoder_params

torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(scope="module")
def jmodel():
    return JTacotron2(num_chars=40, max_decoder_steps=STEPS,
                      stop_threshold=0.5, **SMALL)


@pytest.fixture(scope="module")
def variables(jmodel):
    params, stats = jax_variables(jmodel)
    return with_mixed_stops(params), stats


@pytest.fixture(scope="module")
def model(variables):
    return port_model(*variables, **SMALL)


def test_decode_matches_pallas_kernel(variables, model):
    """The decode alone on random encoder outputs and a ragged mask."""
    params, _ = variables
    rng = np.random.default_rng(11)
    B, T = 2, 16
    enc = rng.standard_normal((B, T, 64)).astype(np.float32)
    pi = rng.standard_normal((B, T, 32)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([16, 9])[:, None])
    want = jfused_decode(
        jnp.asarray(enc), jnp.asarray(pi), jnp.asarray(mask),
        jpack_decoder_params(params, t_in=T, attn_dim=32), steps=STEPS,
        r=SMALL["r"], compute_dtype=jnp.float32, interpret=True)
    got = fused_decode(torch.from_numpy(enc), torch.from_numpy(pi),
                       torch.from_numpy(mask),
                       pack_decoder_params(model.decoder), STEPS, SMALL["r"])
    for name, g, w in zip(("frames", "stop", "align"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def port_fast(model):
    text, lengths = text_inputs()
    return taco2_fused_inference(model, torch.from_numpy(text).long(),
                                 torch.from_numpy(lengths))


@pytest.fixture(scope="module")
def jax_fast(jmodel, variables):
    params, stats = variables
    text, lengths = text_inputs()
    out = jtaco2_fused_inference(
        jmodel, {"params": params, "batch_stats": stats}, jnp.asarray(text),
        jnp.asarray(lengths), compute_dtype=jnp.float32, interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


def test_matches_tts_tpu_fused_inference(jax_fast, port_fast):
    """Mixed stops at threshold 0.5: masking and mel_lengths too."""
    assert len(set(jax_fast["mel_lengths"])) > 1, jax_fast["mel_lengths"]
    assert_outputs_match(port_fast, jax_fast)


def test_matches_tts_tpu_inference(jmodel, variables, port_fast):
    """The function tts_tpu's Synthesizer serves (``Tacotron2.inference``),
    which the fast path replaces."""
    want = jax_inference(jmodel, *variables, *text_inputs())
    assert_outputs_match(port_fast, want)


def test_windowing_config_takes_model_inference(jmodel, variables,
                                               jax_fast):
    """C12: tts_tpu's supports_fused_decode ignores windowing, so its
    drop-in would serve an unwindowed decode for a windowing config. The
    port refuses it, and run_model serves ``model.inference``, which windows
    as tts_tpu's ``Tacotron2.inference`` does."""
    params, stats = variables
    text, lengths = text_inputs()
    want = jax_inference(jmodel.clone(windowing=True), params, stats, text,
                         lengths)
    assert not np.allclose(jax_fast["alignments"], want["alignments"],
                           atol=1e-2)

    model = port_model(params, stats, windowing=True, **SMALL)
    assert not supports_fused_decode(model)
    cfg = {"model": "tacotron2"}
    inputs = torch.from_numpy(text).long()
    got = run_model(model, inputs, cfg, text_lengths=torch.from_numpy(lengths))
    plain = model.inference(inputs, torch.from_numpy(lengths))
    for key in got:
        assert torch.equal(got[key], plain[key]), key
    assert_outputs_match(got, want)


@pytest.mark.parametrize("flags,supported", [
    ({}, True),
    ({"windowing": True}, False),
    ({"attention_norm": "sigmoid"}, False),
    ({"use_forward_attn": True}, False),
    ({"prenet_type": "bn"}, False),
])
def test_supports_fused_decode(flags, supported):
    """The shipped config (r 7, r_init 7 from gradual training, DDC) at
    reduced widths, and one flag changed at a time."""
    c = load_config("configs/tacotron2_ljspeech.json")
    c.update(encoder_dim=16, embedding_dim=16, attn_dim=8, **flags)
    model = setup_model(20, 1, c)
    assert model.r == 7 and model.decoder.r_init == 7
    assert model.coarse_decoder.r == 7
    assert supports_fused_decode(model) is supported


def test_refuses_bf16(model):
    enc = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="float32"):
        fused_decode(enc, torch.zeros(1, 4, 32), torch.ones(1, 4),
                     pack_decoder_params(model.decoder), 2, 2,
                     compute_dtype=torch.bfloat16)


def test_cached_weights_follow_updates(model):
    """The packed weights are made once per set of weights: an in-place
    update of a parameter packs them anew (exact scalings by 2 and 1/2)."""
    first = packed_weights(model)
    assert packed_weights(model)[1] is first[1]
    w = model.decoder.prenet.linear_layers[0].linear_layer.weight
    before = first[1]["pw1"].clone()
    with torch.no_grad():
        w.mul_(2.0)
    torch.testing.assert_close(packed_weights(model)[1]["pw1"], 2.0 * before)
    with torch.no_grad():
        w.mul_(0.5)
    torch.testing.assert_close(packed_weights(model)[1]["pw1"], before)
