"""Graves attention and streaming Tacotron2 synthesis in the port against
tts_tpu, on the CPU.

The reduced Tacotron2 of ``test_torch_port_tacotron2.py`` (embedding and
encoder 64, attention 32, r 2 with r_init 3; the 1024-wide decoder LSTMs
fixed in tts_tpu) with numpy-seeded weights and BatchNorm statistics
carried over by ``tacotron2_state_dict_from_jax``; with Graves attention
(5 components) for the attention tests, location-sensitive for streaming.

Tolerances, float32 with another order of summation: 1e-4 absolute for
every output (Graves's means accumulate over 24 steps of one chain, so a
softplus or clamp that differed would drift past it), the streamed chunks
included; ``mel_lengths``, chunk lengths, ``chunk_words`` and
``attention_end_step`` exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_tacotron2 import jax_variables
from tts_tpu.infer import streaming as JS
from tts_tpu.models.tacotron import Tacotron as JTacotron
from tts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from tts_tpu.ops.attention import GravesAttention as JGraves
from tts_tpu_torch.compat.from_jax import tacotron2_state_dict_from_jax
from tts_tpu_torch.infer import fast_decode
from tts_tpu_torch.infer import streaming as S
from tts_tpu_torch.models import layers
from tts_tpu_torch.models.tacotron2 import Tacotron2
from tts_tpu_torch.ops.attention import GravesAttention
from tts_tpu_torch.text import num_symbols

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
SMALL = dict(r=2, r_init=3, encoder_dim=64, embedding_dim=64, attn_dim=32)
GRAVES = dict(SMALL, attn_type="graves", attn_K=5)
N_CHARS = num_symbols(False)
STEPS = 24
CONFIG = {"model": "tacotron2", "use_phonemes": False,
          "text_cleaner": "english_cleaners"}
TEXT = ("the quick brown fox jumps over the lazy dog while seven small "
        "birds sing")


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def graves():
    jm = JTacotron2(num_chars=N_CHARS, max_decoder_steps=STEPS,
                    stop_threshold=2.0, **GRAVES)
    params, stats = jax_variables(jm)
    model = Tacotron2(num_chars=N_CHARS, max_decoder_steps=STEPS,
                      stop_threshold=2.0, **GRAVES)
    model.load_state_dict(tacotron2_state_dict_from_jax(params, stats),
                          strict=True)
    return jm, params, stats, model.eval()


@pytest.fixture(scope="module")
def location():
    jm = JTacotron2(num_chars=N_CHARS, max_decoder_steps=16,
                    stop_threshold=2.0, **SMALL)
    params, stats = jax_variables(jm, seed=3)
    model = Tacotron2(num_chars=N_CHARS, max_decoder_steps=16,
                      stop_threshold=2.0, **SMALL)
    model.load_state_dict(tacotron2_state_dict_from_jax(params, stats),
                          strict=True)
    return jm, params, stats, model.eval()


def _text(lengths=(21, 14), seed=1):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, N_CHARS, (len(lengths), max(lengths)))
    return text.astype(np.int32), np.asarray(lengths, np.int32)


# ---------------------------------------------------------------------------
# Graves attention
# ---------------------------------------------------------------------------

def test_graves_attention_steps_match(graves):
    """24 chained steps of the attention alone on random queries over a
    ragged batch: context, alignment and the cumulative means each step."""
    _, params, _, model = graves
    att = model.decoder.attention
    assert isinstance(att, GravesAttention)
    rng = np.random.default_rng(7)
    B, T = 2, 19
    inputs = rng.standard_normal((B, T, 64)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([19, 12])[:, None]
    jatt = JGraves(K=5, query_dim=1024)
    jp = {"params": params["decoder"]["attention"]}
    jstate = jatt.init_state(B, T)
    state = att.init_state(B, T, torch.device("cpu"))
    japply = jax.jit(lambda *a: jatt.apply(jp, a[0], a[1], None, *a[2:]))
    for step in range(STEPS):
        q = (2.0 * rng.standard_normal((B, 1024))).astype(np.float32)
        jctx, jstate = japply(jnp.asarray(q), jnp.asarray(inputs), jstate,
                              jnp.asarray(mask))
        with torch.no_grad():
            ctx, state = att(torch.from_numpy(q), torch.from_numpy(inputs),
                             None, state, torch.from_numpy(mask))
        np.testing.assert_allclose(_np(ctx), np.asarray(jctx), atol=ATOL,
                                   err_msg=f"context, step {step}")
        for key in ("mu_prev", "attention_weights"):
            np.testing.assert_allclose(_np(state[key]),
                                       np.asarray(jstate[key]), atol=ATOL,
                                       err_msg=f"{key}, step {step}")
        assert float(_np(state["attention_weights"])[1, 12:].max()) == 0.0


def test_graves_tacotron2_inference_matches(graves):
    """The whole greedy decode, 24 steps, ragged text, through
    ``run_model`` (the plain decode: ``supports_fused_decode`` refuses
    Graves, and B8's entry is never called; B7's plain version runs once)."""
    from tts_tpu_torch.infer.synthesis import run_model

    jm, params, stats, model = graves
    text, lengths = _text()
    want = jax.jit(lambda v, *a: jm.apply(v, *a,
                                          method=JTacotron2.inference))(
        {"params": params, "batch_stats": stats}, jnp.asarray(text),
        jnp.asarray(lengths))
    assert not fast_decode.supports_fused_decode(model)
    calls = {"decode": 0, "bilstm": 0}
    real_bilstm = layers.bilstm

    def count_bilstm(*args):
        calls["bilstm"] += 1
        return real_bilstm(*args)

    def no_decode(*args, **kwargs):
        calls["decode"] += 1
        raise AssertionError("B8 called for Graves attention")

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "bilstm", count_bilstm)
    mp.setattr(fast_decode, "fused_decode", no_decode)
    try:
        got = run_model(model, torch.from_numpy(text).long(), CONFIG,
                        text_lengths=torch.from_numpy(lengths))
    finally:
        mp.undo()
    assert calls == {"decode": 0, "bilstm": 1}
    np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                  np.asarray(want["mel_lengths"]))
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)


def test_registry_builds_graves_from_the_config():
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.registry import setup_model

    c = load_config(os.path.join(ROOT, "configs", "tacotron2_ljspeech.json"))
    c.update(attention_type="graves", attention_heads=3)
    model = setup_model(num_symbols(c["use_phonemes"]), 1, c)
    att = model.decoder.attention
    assert isinstance(att, GravesAttention) and att.K == 3
    assert att.N_a[2].out_features == 9
    assert isinstance(model.coarse_decoder.attention, GravesAttention)
    assert not fast_decode.supports_fused_decode(model)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,chars", [
    (TEXT, 20), (TEXT, 48), ("supercalifragilistic word", 5), ("", 8),
    ("one", 48)])
def test_chunk_words_matches(text, chars):
    assert S.chunk_words(text, chars) == JS.chunk_words(text, chars)


def test_attention_end_step_matches():
    rng = np.random.default_rng(3)
    for n in range(1, 12):
        align = rng.random((9, 11)).astype(np.float32)
        assert S.attention_end_step(align, n) == \
            JS.attention_end_step(align, n), n


def test_inference_truncated_carries_state_over_two_chunks(location):
    """Two chunks, the second decoded from each package's own state after
    the first: outputs of both chunks and the state after each (the LSTMs'
    h and c, the context, the last frame) within 1e-4."""
    jm, params, stats, model = location
    variables = {"params": params, "batch_stats": stats}
    j_state, state = None, None
    for seed, lengths in ((1, (17,)), (2, (9,))):
        text, lens = _text(lengths, seed)
        want = jax.jit(lambda v, t, n, s: jm.apply(
            v, t, n, decoder_state=s,
            method=JTacotron2.inference_truncated))(
            variables, jnp.asarray(text), jnp.asarray(lens), j_state)
        got = model.inference_truncated(torch.from_numpy(text).long(),
                                        torch.from_numpy(lens),
                                        decoder_state=state)
        j_state, state = want["decoder_state"], got["decoder_state"]
        np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                      np.asarray(want["mel_lengths"]))
        for key in ("decoder_outputs", "postnet_outputs", "alignments",
                    "stop_logits"):
            np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                                       atol=ATOL, err_msg=key)
        # flax's LSTM carry is (c, h); the port's (h, c)
        for ours, theirs in (("attn_rnn", "attn_rnn"), ("dec_rnn",
                                                        "dec_rnn")):
            h, c = state[ours]
            np.testing.assert_allclose(_np(h), np.asarray(j_state[theirs][1]),
                                       atol=ATOL, err_msg=ours)
            np.testing.assert_allclose(_np(c), np.asarray(j_state[theirs][0]),
                                       atol=ATOL, err_msg=ours)
        for key in ("context", "last_frame"):
            np.testing.assert_allclose(_np(state[key]),
                                       np.asarray(j_state[key]), atol=ATOL,
                                       err_msg=key)


def test_stream_mel_chunks_matches_tts_tpu_chunk_by_chunk(location):
    """A sentence of four 20-character chunks at 16 steps a chunk: the same
    chunk texts, the same trimmed lengths, the mels within 1e-4."""
    jm, params, stats, model = location
    want = list(JS.stream_mel_chunks(
        jm, {"params": params, "batch_stats": stats}, TEXT, CONFIG,
        chunk_chars=20, decoder_steps=16))
    got = list(S.stream_mel_chunks(model, TEXT, CONFIG, torch.device("cpu"),
                                   chunk_chars=20, decoder_steps=16))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g["chunk_text"] == w["chunk_text"]
        assert g["final"] == w["final"]
        assert g["mel"].shape == w["mel"].shape, g["chunk_text"]
        np.testing.assert_allclose(g["mel"], w["mel"], atol=ATOL,
                                   err_msg=g["chunk_text"])


def test_tacotron_v1_cannot_stream_in_either_package():
    """C25: tts_tpu's ``stream_mel_chunks`` accepts the "tacotron" model
    name, but its Tacotron has no ``inference_truncated``; the port fails
    alike, with AttributeError."""
    from tts_tpu_torch.models.tacotron import Tacotron

    c = dict(CONFIG, model="tacotron")
    jm = JTacotron(num_chars=N_CHARS, r=2, linear_dim=65)
    with pytest.raises(AttributeError, match="inference_truncated"):
        list(JS.stream_mel_chunks(jm, {"params": {}}, "hello world", c,
                                  decoder_steps=4))
    model = Tacotron(num_chars=N_CHARS, r=2, linear_dim=65).eval()
    with pytest.raises(AttributeError, match="inference_truncated"):
        list(S.stream_mel_chunks(model, "hello world", c,
                                 torch.device("cpu"), decoder_steps=4))
    with pytest.raises(ValueError, match="tacotron family"):
        list(S.stream_mel_chunks(model, "hello world",
                                 dict(CONFIG, model="glow_tts"),
                                 torch.device("cpu")))


def test_synthesizer_streams_chunks_through_the_vocoder(location, tmp_path):
    """``Synthesizer.tts_stream`` with a Multiband-MelGAN (base 64): one
    waveform per chunk of each sentence, each the vocoder's (``_vocode``)
    of the chunk's streamed mel, then the 10,000-sample gap; B7's plain
    version once a chunk, B2's entry once a chunk, B8's never. Without a
    vocoder the chunks are Griffin-Lim."""
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer import synthesizer as SY
    from tts_tpu_torch.models.vocoder.registry import setup_generator

    _, _, _, model = location
    c = load_config(os.path.join(ROOT, "configs", "tacotron2_ljspeech.json"))
    c.update(CONFIG, max_decoder_steps=16, gradual_training=[[0, 3, 4]], r=2,
             encoder_dim=64, embedding_dim=64, attn_dim=32,
             double_decoder_consistency=False)
    cfg = tmp_path / "taco2.json"
    cfg.write_text(json.dumps(c))
    ckpt = tmp_path / "taco2.pt"
    torch.save({"model": model.state_dict(), "r": 2}, ckpt)
    vc = load_config(os.path.join(ROOT, "configs", "multiband_melgan.json"))
    vc["generator_model_params"]["base_channels"] = 64
    vcfg = tmp_path / "mb.json"
    vcfg.write_text(json.dumps(vc))
    torch.manual_seed(0)
    gen = setup_generator(vc)
    vckpt = tmp_path / "mb.pt"
    torch.save({"model": gen.state_dict()}, vckpt)

    synth = SY.Synthesizer(str(ckpt), str(cfg), str(vckpt), str(vcfg),
                           device="cpu")
    calls = {"bilstm": 0, "vocoder": 0}
    real_bilstm, real_mega = layers.bilstm, SY.megakernel_inference

    def count_bilstm(*args):
        calls["bilstm"] += 1
        return real_bilstm(*args)

    def count_mega(*args):
        calls["vocoder"] += 1
        return real_mega(*args)

    def no_decode(*args, **kwargs):
        raise AssertionError("B8 called while streaming")

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "bilstm", count_bilstm)
    mp.setattr(SY, "megakernel_inference", count_mega)
    mp.setattr(fast_decode, "fused_decode", no_decode)
    text = TEXT + ". Two more words."
    try:
        pieces = list(synth.tts_stream(text, chunk_chars=20,
                                       decoder_steps=16))
    finally:
        mp.undo()
    mels = [p["mel"] for sentence in SY.split_into_sentences(text)
            for p in S.stream_mel_chunks(synth.model, sentence,
                                         synth.tts_config,
                                         torch.device("cpu"),
                                         chunk_chars=20, decoder_steps=16)]
    n_chunks = len(mels)
    assert n_chunks == len(S.chunk_words(TEXT + ".", 20)) + 1
    assert calls == {"bilstm": n_chunks, "vocoder": n_chunks}
    wavs = [p for p in pieces if not (len(p) == 10000 and not p.any())]
    gaps = [p for p in pieces if len(p) == 10000 and not p.any()]
    assert len(gaps) == 2 and len(wavs) == n_chunks
    for wav, mel in zip(wavs, mels):
        assert np.isfinite(wav).all()
        np.testing.assert_array_equal(wav, synth._vocode(mel))

    gl = SY.Synthesizer(str(ckpt), str(cfg), device="cpu")
    first = next(gl.tts_stream(TEXT, chunk_chars=20, decoder_steps=16))
    assert np.isfinite(first).all() and first.any()
