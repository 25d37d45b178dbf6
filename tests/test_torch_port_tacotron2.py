"""The port's Tacotron2 at eval against tts_tpu's, module by module and as a
whole, on a reduced model (embedding and encoder 64, attention 32; the
1024-wide decoder LSTMs are fixed in tts_tpu's DecoderCell) with seeded
weights and seeded, non-trivial BatchNorm statistics carried over by
``tacotron2_state_dict_from_jax``.

Tolerance: 1e-4 absolute (float32, other summation orders in the two
packages); ``mel_lengths`` exactly. The helpers here are shared by the
other Tacotron2 test files of the port.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.torch_port_params import random_params
from tts_tpu.compat.torch_port import port_tacotron2
from tts_tpu.models.layers import ConvBNBlock as JConvBN
from tts_tpu.models.layers import Postnet as JPostnet
from tts_tpu.models.layers import Prenet as JPrenet
from tts_tpu.models.layers import Tacotron2Encoder as JEncoder
from tts_tpu.models.tacotron2 import DecoderCell as JDecoderCell
from tts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from tts_tpu.ops.attention import LocationSensitiveAttention as JAttention
from tts_tpu_torch.compat.from_jax import tacotron2_state_dict_from_jax
from tts_tpu_torch.models.tacotron2 import Tacotron2
from tts_tpu_torch.ops.attention import LocationSensitiveAttention

torch.set_num_threads(1)

ATOL = 1e-4
N_CHARS = 40
SMALL = dict(r=2, r_init=3, encoder_dim=64, embedding_dim=64, attn_dim=32)
LENGTHS = (16, 11)
STEPS = 8
# mixed stops at threshold 0.5: a steeper stopnet whose bias puts item 0's
# first stop at step 4 and item 1's at step 5 (margins of 6.5e-3 in the
# logit; the two packages agree to ~1e-6)
STOP_GAIN, STOP_BIAS = 30.0, -0.249


def jax_variables(model, seed: int = 0):
    """Seeded params (tests/torch_port_params.py) and BatchNorm statistics:
    means 0.1 N(0, 1), variances 0.5 + |N(0, 1)|."""
    key = jax.random.PRNGKey(0)
    shapes = unfreeze(jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 8), jnp.int32),
        jnp.array([8]), jnp.zeros((1, 12, 80)), jnp.array([12]))))
    rng = np.random.default_rng(seed)
    params = random_params(shapes["params"], rng)

    def stat(path, leaf):
        x = rng.standard_normal(leaf.shape)
        x = 0.5 + np.abs(x) if path[-1].key == "var" else 0.1 * x
        return x.astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"])
    return params, stats


def with_mixed_stops(params):
    p = copy.deepcopy(params)
    stop = p["decoder"]["stopnet"]["linear"]
    stop["kernel"] = stop["kernel"] * STOP_GAIN
    stop["bias"] = np.full_like(stop["bias"], STOP_BIAS)
    return p


def port_model(params, stats, **kwargs) -> Tacotron2:
    model = Tacotron2(num_chars=N_CHARS, max_decoder_steps=STEPS, **kwargs)
    model.load_state_dict(tacotron2_state_dict_from_jax(params, stats))
    return model.eval()


def text_inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, N_CHARS, (len(LENGTHS), max(LENGTHS)))
    return text.astype(np.int32), np.asarray(LENGTHS, np.int32)


def jax_inference(model, params, stats, text, lengths, **kwargs):
    out = model.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(text), jnp.asarray(lengths),
                      max_decoder_steps=STEPS, method=JTacotron2.inference,
                      **kwargs)
    return {k: np.asarray(v) for k, v in out.items()}


def assert_outputs_match(got, want, atol=ATOL):
    """The inference outputs: values within ``atol``, mel_lengths exact."""
    np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                  want["mel_lengths"])
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=atol,
                                   err_msg=key)


@pytest.fixture(scope="module")
def jmodel():
    return JTacotron2(num_chars=N_CHARS, max_decoder_steps=STEPS,
                      stop_threshold=2.0, **SMALL)


@pytest.fixture(scope="module")
def variables(jmodel):
    return jax_variables(jmodel)


@pytest.fixture(scope="module")
def model(variables):
    return port_model(*variables, stop_threshold=2.0, **SMALL)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_convbn_block(variables, model):
    params, stats = variables
    x = np.random.default_rng(2).standard_normal((2, 16, 64), np.float32)
    want = JConvBN(64, 5, activation="relu").apply(
        {"params": params["encoder"]["conv_1"],
         "batch_stats": stats["encoder"]["conv_1"]}, jnp.asarray(x),
        train=False)
    with torch.no_grad():
        got = model.encoder.convolutions[1](torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("prenet_type", ["original", "bn"])
def test_prenet(variables, prenet_type):
    """Both prenet types, at eval (no dropout); the "bn" type's seeded
    BatchNorms travel through ``tacotron2_state_dict_from_jax``."""
    params, stats = variables
    tree = copy.deepcopy(params)
    stats = dict(stats)
    pre = tree["decoder"]["prenet"]
    rng = np.random.default_rng(8)
    if prenet_type == "bn":
        pre_stats = {}
        for i in range(2):
            pre[f"bn_{i}"] = {
                "scale": (1 + 0.1 * rng.standard_normal(256)).astype("f4"),
                "bias": (0.1 * rng.standard_normal(256)).astype("f4")}
            pre_stats[f"bn_{i}"] = {
                "mean": (0.1 * rng.standard_normal(256)).astype("f4"),
                "var": (0.5 + rng.random(256)).astype("f4")}
        stats["decoder"] = {"prenet": pre_stats}
    port = port_model(tree, stats, prenet_type=prenet_type, **SMALL)
    x = rng.standard_normal((3, 80)).astype(np.float32)
    want = JPrenet((256, 256), prenet_type, use_bias=False).apply(
        {"params": pre, "batch_stats": stats.get("decoder", {}).get(
            "prenet", {})}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = port.decoder.prenet(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_postnet(variables, model):
    params, stats = variables
    x = np.random.default_rng(3).standard_normal((2, 12, 80), np.float32)
    want = JPostnet(80).apply({"params": params["postnet"],
                               "batch_stats": stats["postnet"]},
                              jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.postnet(torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want),
                               atol=ATOL)


def test_encoder_with_masked_pads(variables, model):
    """Padded input beyond each length: the pads are masked through the
    conv stack; the outputs agree inside each item's length."""
    params, stats = variables
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    lengths = np.array(LENGTHS, np.int32)
    want = np.asarray(JEncoder(64).apply(
        {"params": params["encoder"], "batch_stats": stats["encoder"]},
        jnp.asarray(x), jnp.asarray(lengths), train=False, mask_pads=True))
    with torch.no_grad():
        got = _np(model.encoder(torch.from_numpy(x).transpose(1, 2),
                                torch.from_numpy(lengths), mask_pads=True))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL)


ATTENTION_CASES = {
    "softmax": dict(),
    "sigmoid": dict(norm="sigmoid"),
    "windowing": dict(windowing=True),
    "forward_ta_mask": dict(use_forward_attn=True, use_transition_agent=True,
                            forward_attn_mask=True),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_step(variables, case):
    """One step of every variant from a non-trivial state: previous and
    cumulative alignments, forward attention's alpha and u, a mask."""
    flags = ATTENTION_CASES[case]
    params, stats = variables
    rng = np.random.default_rng(5)
    tree = copy.deepcopy(params)
    att_p = tree["decoder"]["attention"]
    if flags.get("use_transition_agent"):
        att_p["transition_agent"] = {
            "kernel": (rng.standard_normal((64 + 1024, 1)) / 32
                       ).astype(np.float32),
            "bias": np.array([0.1], np.float32)}
    sd = tacotron2_state_dict_from_jax(tree, stats)
    prefix = "decoder.attention."
    port = LocationSensitiveAttention(1024, 64, attn_dim=32, **flags)
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                          if k.startswith(prefix)})
    jatt = JAttention(attn_dim=32, **flags)

    B, T = 2, 16
    f32 = np.float32
    query = rng.standard_normal((B, 1024)).astype(f32)
    inputs = rng.standard_normal((B, T, 64)).astype(f32)
    prev = rng.random((B, T)).astype(f32)
    prev /= prev.sum(-1, keepdims=True)
    state = {"attention_weights": prev,
             "attention_cum": (3 * rng.random((B, T))).astype(f32)}
    if flags.get("use_forward_attn"):
        alpha = rng.random((B, T)).astype(f32)
        state["alpha"] = alpha / alpha.sum(-1, keepdims=True)
        state["u"] = rng.random((B, 1)).astype(f32)
    mask = np.arange(T)[None] < np.array(LENGTHS)[:, None]

    variables_j = {"params": att_p}
    pi_j = jatt.apply(variables_j, jnp.asarray(inputs),
                      method=JAttention.preprocess_inputs)
    ctx_j, state_j = jatt.apply(
        variables_j, jnp.asarray(query), jnp.asarray(inputs), pi_j,
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(mask),
        use_windowing=True)
    with torch.no_grad():
        inputs_t = torch.from_numpy(inputs)
        ctx, new = port(torch.from_numpy(query), inputs_t,
                        port.preprocess_inputs(inputs_t),
                        {k: torch.from_numpy(v) for k, v in state.items()},
                        torch.from_numpy(mask), use_windowing=True)
    np.testing.assert_allclose(_np(ctx), np.asarray(ctx_j), atol=ATOL)
    assert set(new) == set(state_j)
    for key in new:
        np.testing.assert_allclose(_np(new[key]), np.asarray(state_j[key]),
                                   atol=ATOL, err_msg=key)


def test_decoder_step(variables, model):
    """One DecoderCell step from non-zero LSTM states, context and
    alignments (flax carries (c, h), torch (h, c))."""
    params, _ = variables
    rng = np.random.default_rng(6)
    B, T, f32 = 2, 16, np.float32

    def rand(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f32)

    enc = rand(B, T, 64)
    mask = np.arange(T)[None] < np.array(LENGTHS)[:, None]
    h1, c1, h2, c2 = (rand(B, 1024, scale=0.5) for _ in range(4))
    context, memory = rand(B, 64), rand(B, 80)
    prev = rng.random((B, T)).astype(f32)
    prev /= prev.sum(-1, keepdims=True)
    cum = (2 * rng.random((B, T))).astype(f32)

    jdec = JDecoderCell(n_mels=80, r=2, r_init=3, encoder_dim=64,
                        attn_dim=32)
    jvars = {"params": params["decoder"]}
    pi = jdec.apply(jvars, jnp.asarray(enc),
                    method=lambda m, x: m.attention.preprocess_inputs(x))
    carry = {"inputs": jnp.asarray(enc), "processed_inputs": pi,
             "mask": jnp.asarray(mask),
             "attn_rnn": (jnp.asarray(c1), jnp.asarray(h1)),
             "dec_rnn": (jnp.asarray(c2), jnp.asarray(h2)),
             "attn_state": {"attention_weights": jnp.asarray(prev),
                            "attention_cum": jnp.asarray(cum)},
             "context": jnp.asarray(context)}
    new_j, (frames_j, stop_j, align_j) = jdec.apply(
        jvars, carry, jnp.asarray(memory), False, True)

    dec = model.decoder
    with torch.no_grad():
        enc_t = torch.from_numpy(enc)
        tcarry = {"inputs": enc_t,
                  "processed_inputs": dec.attention.preprocess_inputs(enc_t),
                  "mask": torch.from_numpy(mask),
                  "attn_rnn": (torch.from_numpy(h1), torch.from_numpy(c1)),
                  "dec_rnn": (torch.from_numpy(h2), torch.from_numpy(c2)),
                  "attn_state": {"attention_weights": torch.from_numpy(prev),
                                 "attention_cum": torch.from_numpy(cum)},
                  "context": torch.from_numpy(context)}
        new, (frames, stop, align) = dec(tcarry, torch.from_numpy(memory))
    for got, want in ((frames, frames_j), (stop, stop_j), (align, align_j),
                      (new["context"], new_j["context"]),
                      (new["attn_rnn"][0], new_j["attn_rnn"][1]),
                      (new["attn_rnn"][1], new_j["attn_rnn"][0]),
                      (new["dec_rnn"][0], new_j["dec_rnn"][1]),
                      (new["dec_rnn"][1], new_j["dec_rnn"][0])):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_inference_without_stops(jmodel, variables, model):
    """stop_threshold 2.0: no item ever stops; every step is compared."""
    text, lengths = text_inputs()
    want = jax_inference(jmodel, *variables, text, lengths)
    got = model.inference(torch.from_numpy(text).long(),
                          torch.from_numpy(lengths))
    assert (want["mel_lengths"] == STEPS * SMALL["r"]).all()
    assert_outputs_match(got, want)


def test_inference_with_mixed_stops(jmodel, variables):
    """stop_threshold 0.5 with items stopping at different steps: frames
    after each item's stop are zeroed and mel_lengths agree exactly."""
    params, stats = variables
    params = with_mixed_stops(params)
    text, lengths = text_inputs()
    want = jax_inference(jmodel.clone(stop_threshold=0.5), params, stats,
                         text, lengths)
    lens = want["mel_lengths"]
    assert len(set(lens)) > 1 and lens.max() < STEPS * SMALL["r"], lens
    got = port_model(params, stats, stop_threshold=0.5, **SMALL).inference(
        torch.from_numpy(text).long(), torch.from_numpy(lengths))
    assert_outputs_match(got, want)


def test_weights_round_trip(variables, model):
    """port_tacotron2 (tts_tpu's Mozilla -> flax map) of the port's state
    dict gives back the tts_tpu params and statistics."""
    params, stats = variables
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back_p, back_s = port_tacotron2(sd)
    flat = jax.tree_util.tree_leaves_with_path
    want_p = {k: params[k] for k in back_p}
    assert set(back_p) == {"embedding", "encoder", "decoder", "postnet"}
    for (path, a), (path_b, b) in zip(flat(want_p), flat(back_p)):
        assert path == path_b
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))
    for (path, a), (path_b, b) in zip(flat(stats), flat(back_s)):
        assert path == path_b
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))


def test_coarse_decoder_loads_and_is_not_run(variables, model):
    """Double decoder consistency: the coarse decoder (r = ddc_r) is part
    of the state dict, so a DDC checkpoint loads; inference ignores it.
    With ddc_r = r_init = 3 tts_tpu's coarse subtree has the decoder's
    shapes, so a perturbed copy of the decoder's stands in for it."""
    params, stats = variables
    coarse = jax.tree_util.tree_map(lambda x: 1.5 * x, params["decoder"])
    ddc = port_model(dict(params, coarse_decoder=coarse), stats,
                     stop_threshold=2.0, double_decoder_consistency=True,
                     ddc_r=3, **SMALL)
    assert ddc.coarse_decoder.r == 3
    text, lengths = text_inputs()
    a = ddc.inference(torch.from_numpy(text).long(),
                      torch.from_numpy(lengths), max_decoder_steps=2)
    b = model.inference(torch.from_numpy(text).long(),
                        torch.from_numpy(lengths), max_decoder_steps=2)
    for key in a:
        assert torch.equal(a[key], b[key]), key
