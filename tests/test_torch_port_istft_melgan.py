"""The port's DSP module and iSTFT MelGAN against tts_tpu, on the CPU.

- ``audio/dsp.py``: every function against ``tts_tpu.audio.dsp`` on
  numpy-seeded signals (Griffin-Lim from the same first phases). Tolerance
  1e-4 of the largest reference magnitude (float32 FFTs in another
  library; de-emphasis is a recursion there and blocks of products here);
  the inverse STFT where the window's summed squares are at least 1e-3 of
  their largest (``_well_covered``).
- ``istft_head``: against both packages' ``istft(center=False)`` and
  tts_tpu's head (1e-5 of the largest: a 16-point basis and 4 overlaps).
- The generator (base 32, factors 8-8, 2 residual blocks, head n_fft 16 /
  hop 4, 8 mel frames) in float32 within 1e-4 of the largest output, and
  in bfloat16 (parameters and mel cast, as the mixed-precision step does)
  with its head in float32 as tts_tpu's: the output is float32 and within
  ``BF16_TOL`` (1e-2) of the largest of tts_tpu's bfloat16 run: both
  bf16 bodies round in another order (measured 2.9e-3 apart, as far as
  tts_tpu's own bf16 run is from its float32 run, 3.0e-3).
- Weight-norm folding, the registry on the shipped config, tts_tpu
  checkpoints, and serving through the Synthesizer with its hop check.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tts_tpu.audio import dsp as jdsp
from tts_tpu.audio import mel as jmel
from tts_tpu.models.vocoder.istft_melgan import \
    ISTFTMelganGenerator as JISTFT
from tts_tpu.models.vocoder.istft_melgan import istft_head as j_istft_head
from tts_tpu.models.vocoder.registry import \
    setup_generator as j_setup_generator
from tts_tpu.train.checkpoint import save_checkpoint as save_tts_tpu
from tts_tpu.train.state import _cast_floats
from tts_tpu_torch.audio import dsp
from tts_tpu_torch.compat.from_jax import istft_melgan_state_dict_from_jax
from tts_tpu_torch.config import load_config
from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
from tts_tpu_torch.models.vocoder.istft_melgan import (ISTFTMelganGenerator,
                                                       istft_head)
from tts_tpu_torch.models.vocoder.registry import setup_generator

from tests.test_torch_port_pwgan import small_glow_checkpoint
from tests.test_torch_port_vocoder_family_train import scales_near_one
from tests.torch_port_params import init_shapes, module_params

TOL = 1e-4
HEAD_TOL = 1e-5
BF16_TOL = 1e-2
FRAMES = 8
GEN = dict(base_channels=32, upsample_factors=(8, 8), num_res_blocks=2,
           n_fft_head=16, hop_head=4)
ISTFT_CONFIG = "configs/istft_melgan.json"


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


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _ncw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# audio/dsp.py
# ---------------------------------------------------------------------------

STFT_CASES = [(1024, 256, 1024, 5000), (2048, 240, 1200, 4000),
              (512, 50, 240, 3001)]


@pytest.mark.parametrize("n_fft,hop,win,T", STFT_CASES)
def test_stft_istft_and_spectrograms(n_fft, hop, win, T):
    y = _rand(n_fft, (2, T), 0.3)
    want = jdsp.stft(jnp.asarray(y), n_fft, hop, win)
    got = dsp.stft(_t(y), n_fft, hop, win)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    _close(got.real, np.real(want))
    _close(got.imag, np.imag(want))
    _close(dsp.magnitude(got), jdsp.magnitude(want))
    _close(dsp.linear_spectrogram(_t(y), n_fft, hop, win),
           jdsp.linear_spectrogram(jnp.asarray(y), n_fft, hop, win))
    basis = jmel.mel_filterbank(22050, n_fft, 80, 50.0, 7600.0)
    _close(dsp.mel_spectrogram(_t(y), _t(basis), n_fft, hop, win),
           jdsp.mel_spectrogram(jnp.asarray(y), jnp.asarray(basis), n_fft,
                                hop, win))
    for center in (True, False):
        for length in (None, T - 7):
            spec = jdsp.stft(jnp.asarray(y), n_fft, hop, win, center=center)
            got = dsp.istft(_t(np.asarray(spec)), n_fft, hop, win,
                            length=length, center=center)
            want = np.asarray(jdsp.istft(spec, n_fft, hop, win, length=length,
                                         center=center))
            keep = _well_covered(n_fft, hop, win, spec.shape[-2], center,
                                 want.shape[-1])
            assert keep.mean() > 0.7
            _close(got.numpy()[:, keep], want[:, keep])


def _well_covered(n_fft, hop, win, n_frames, center, n_out):
    """Output samples whose window-sum-squares is at least 1e-3 of its
    largest: where it is smaller (the edges of an uncentred inverse, or a
    window shorter than n_fft) the division by it magnifies float32
    rounding of the overlap-add up to 1e10-fold, and both packages' values
    are rounding noise."""
    w = jmel.pad_center(jmel.hann_window(win), n_fft).astype(np.float64)
    wss = np.zeros(n_fft + hop * (n_frames - 1))
    for l in range(n_frames):
        wss[l * hop:l * hop + n_fft] += w ** 2
    if center:
        wss = wss[n_fft // 2:]
    return wss[:n_out] >= 1e-3 * wss.max()


def test_db_emphasis_normalization_and_mulaw():
    x = np.abs(_rand(1, (3, 500))) + 1e-7
    _close(dsp.amp_to_db(_t(x)), jdsp.amp_to_db(jnp.asarray(x)))
    d = _rand(2, (3, 500), 20.0)
    _close(dsp.db_to_amp(_t(d)), jdsp.db_to_amp(jnp.asarray(d)))
    y = _rand(3, (2, 1500), 0.3)
    pre = dsp.preemphasis(_t(y), 0.97)
    _close(pre, jdsp.preemphasis(jnp.asarray(y), 0.97))
    # 1,500 samples: three blocks of 512, the last one partial
    _close(dsp.deemphasis(pre, 0.97), jdsp.deemphasis(jnp.asarray(pre), 0.97))
    torch.testing.assert_close(dsp.deemphasis(pre, 0.97), _t(y), rtol=0,
                               atol=1e-5)
    s_db = _rand(4, (4, 80), 40.0) - 40.0
    for symmetric in (True, False):
        for clip in (True, False):
            kw = dict(min_level_db=-100.0, max_norm=4.0, symmetric=symmetric,
                      clip=clip)
            norm = dsp.normalize_spectrogram(_t(s_db), **kw)
            _close(norm, jdsp.normalize_spectrogram(jnp.asarray(s_db), **kw))
            _close(dsp.denormalize_spectrogram(norm, **kw),
                   jdsp.denormalize_spectrogram(jnp.asarray(norm.numpy()),
                                                **kw))
    w = np.clip(_rand(5, (2, 400), 0.4), -1, 1)
    for qc in (256, 512):
        enc = dsp.mulaw_encode(_t(w), qc)
        np.testing.assert_array_equal(enc.numpy(),
                                      jdsp.mulaw_encode(jnp.asarray(w), qc))
        _close(dsp.mulaw_decode(enc, qc),
               jdsp.mulaw_decode(jnp.asarray(enc.numpy()), qc))
    for bits in (9, 10):
        q = dsp.quantize(_t(w), bits)
        _close(q, jdsp.quantize(jnp.asarray(w), bits))
        _close(dsp.dequantize(q, bits),
               jdsp.dequantize(jnp.asarray(q.numpy()), bits))


def test_griffin_lim_from_the_same_phases():
    """tts_tpu draws its first phases from a key inside the function; the
    port takes them as ``angles``: the same draws give the same waveform
    after 8 iterations."""
    n_fft, hop, win = 512, 128, 512
    y = _rand(6, (1, 4000), 0.3)
    mag = jdsp.magnitude(jdsp.stft(jnp.asarray(y), n_fft, hop, win))
    key = jax.random.PRNGKey(3)
    want = jdsp.griffin_lim(mag, n_fft, hop, win, n_iter=8, key=key)
    angles = np.exp(2j * np.pi
                    * np.asarray(jax.random.uniform(key, mag.shape)))
    got = dsp.griffin_lim(_t(np.asarray(mag)), n_fft, hop, win, n_iter=8,
                          angles=_t(angles.astype(np.complex64)))
    _close(got, want)
    # phases from a generator, by default one seeded 0: the same audio
    a = dsp.griffin_lim(_t(np.asarray(mag)), n_fft, hop, win, n_iter=2,
                        generator=torch.Generator().manual_seed(0))
    b = dsp.griffin_lim(_t(np.asarray(mag)), n_fft, hop, win, n_iter=2)
    assert torch.equal(a, b) and a.shape == got.shape


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,n_frames", [(16, 4, 64), (16, 8, 9),
                                                (15, 5, 12)])
def test_istft_head_is_the_inverse_stft(n_fft, hop, n_frames):
    """The basis matmul plus ``conv_transpose1d`` overlap-add (no kernel
    flip, unlike lax.conv_transpose) equals the complex inverse STFT
    without centring, of the port and of tts_tpu, and tts_tpu's head."""
    bins = n_fft // 2 + 1
    re, im = _rand(1, (2, n_frames, bins)), _rand(2, (2, n_frames, bins))
    im[..., 0] = 0                      # DC (and Nyquist) are real
    if n_fft % 2 == 0:
        im[..., -1] = 0
    spec = (re + 1j * im).astype(np.complex64)
    spec_ri = np.concatenate([re, im], axis=-1)
    got = istft_head(_t(spec_ri.transpose(0, 2, 1)), n_fft, hop)
    port_ref = dsp.istft(_t(spec), n_fft, hop, n_fft, center=False)
    _close(got, port_ref, HEAD_TOL)
    _close(got, jdsp.istft(jnp.asarray(spec), n_fft, hop, n_fft,
                           center=False), HEAD_TOL)
    _close(got, j_istft_head(jnp.asarray(spec_ri), n_fft, hop), HEAD_TOL)
    assert got.shape == (2, n_fft + hop * (n_frames - 1))


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def _models(use_weight_norm=True, seed=0):
    jgen = JISTFT(**GEN, use_weight_norm=use_weight_norm)
    params = scales_near_one(module_params(
        jgen, seed, jnp.zeros((1, FRAMES, 80))), seed + 100)
    gen = ISTFTMelganGenerator(**GEN, use_weight_norm=use_weight_norm)
    sd = istft_melgan_state_dict_from_jax(
        _np(params), GEN["upsample_factors"], GEN["num_res_blocks"])
    if not use_weight_norm:     # the bridge writes weight_v = the kernel
        sd = {k.replace("weight_v", "weight"): v for k, v in sd.items()
              if not k.endswith("weight_g")}
    gen.load_state_dict(sd, strict=True)
    return jgen, params, gen


def test_generator_matches_tts_tpu_in_float32():
    jgen, params, gen = _models()
    c = _rand(7, (2, FRAMES, 80))
    want = jgen.apply({"params": params}, c)
    with torch.no_grad():
        got = gen(_ncw(c))
    assert got.shape == (2, 1, FRAMES * 256)
    assert float(np.asarray(want).std()) > 1e-2
    _close(got.numpy().transpose(0, 2, 1), want)
    # inference: 2 frames of edge padding a side
    want_inf = jgen.apply({"params": params}, c, method=jgen.inference)
    _close(gen.inference(_ncw(c)).numpy().transpose(0, 2, 1), want_inf)


def test_generator_in_bfloat16_runs_its_head_in_float32():
    """The mixed-precision forward: parameters and mel in bfloat16 on both
    sides (tts_tpu's ``_cast_floats``; the port's ``functional_call`` with
    cast parameters). A bfloat16 spectrum meets a float32 basis: tts_tpu
    promotes, the port casts, so the waveform is float32 on both."""
    jgen, params, gen = _models(use_weight_norm=False)
    c = _rand(8, (2, FRAMES, 80))
    want = jgen.apply({"params": _cast_floats(params, jnp.bfloat16)},
                      jnp.asarray(c, jnp.bfloat16))
    assert want.dtype == jnp.float32
    bf16 = {n: p.detach().to(torch.bfloat16)
            for n, p in gen.named_parameters()}
    with torch.no_grad():
        got = functional_call(gen, bf16, (_ncw(c).to(torch.bfloat16),))
        f32 = gen(_ncw(c))
    assert got.dtype == torch.float32
    _close(got.numpy().transpose(0, 2, 1), want, BF16_TOL)
    # it did run in bfloat16: apart from the float32 output by more than
    # float32 rounding
    assert float((got - f32).abs().max()) > 1e-3


def test_fold_weight_norm_and_registry():
    """The shipped config builds (the port raised KeyError before) with as
    many kernel and bias entries as tts_tpu's (the weight-norm magnitudes
    differ in number: torch norms a transposed conv per input channel,
    flax per output channel, ROADMAP C2); folding takes every weight-normed
    layer and the folded twin gives the same waveform."""
    c = load_config(ISTFT_CONFIG)
    gen = setup_generator(c)
    assert isinstance(gen, ISTFTMelganGenerator) and gen.hop == 256
    shapes = jax.tree_util.tree_leaves_with_path(
        init_shapes(j_setup_generator(c), jnp.zeros((1, 1, 80))))
    assert sum(p.numel() for n, p in gen.named_parameters()
               if not n.endswith("weight_g")) == sum(
        int(np.prod(x.shape)) for path, x in shapes
        if not jax.tree_util.keystr(path).endswith("/kernel/scale']"))
    torch.manual_seed(0)
    small = ISTFTMelganGenerator(**GEN)
    sd = fold_weight_norm(small.state_dict())
    assert not [k for k in sd if k.endswith(("weight_v", "weight_g"))]
    plain = ISTFTMelganGenerator(**GEN, use_weight_norm=False)
    plain.load_state_dict(sd, strict=True)
    mel = torch.randn(1, 80, FRAMES)
    with torch.no_grad():
        torch.testing.assert_close(plain(mel), small(mel), rtol=0, atol=1e-6)


def _voc_config(tmp_path, **params):
    c = dict(load_config(ISTFT_CONFIG))
    c["generator_model_params"] = dict(c["generator_model_params"],
                                       base_channels=32, **params)
    path = tmp_path / "istft.json"
    path.write_text(json.dumps(c, default=dict))
    return c, str(path)


def test_tts_tpu_checkpoint_routes_to_the_istft_converter(tmp_path):
    """A tts_tpu msgpack checkpoint of the iSTFT generator loads through
    the port's ``load_checkpoint`` (before, it went to the MelGAN converter,
    which looks for ``proj_out``) and gives tts_tpu's waveform."""
    from tts_tpu_torch.infer.synthesizer import load_checkpoint

    c, _ = _voc_config(tmp_path)
    jgen = j_setup_generator(c)
    params = scales_near_one(module_params(jgen, 9,
                                           jnp.zeros((1, FRAMES, 80))), 10)
    save_tts_tpu(str(tmp_path), params=params, step=5)
    sd = load_checkpoint(str(tmp_path / "checkpoint_5.ckpt"), c)["model"]
    gen = setup_generator(c)
    gen.load_state_dict(sd, strict=True)
    mel = _rand(11, (1, FRAMES, 80))
    with torch.no_grad():
        got = gen(_ncw(mel))
    _close(got.numpy().transpose(0, 2, 1), jgen.apply({"params": params}, mel))


def test_synthesizer_serves_the_module_and_checks_the_hop(tmp_path):
    """The Synthesizer serves the iSTFT generator through its module's
    ``inference`` with folded weights (before, every generator went to the
    MelGAN kernel paths), equal to the module on the served mel; a config
    whose total hop is not the audio's raises ValueError at load, as in
    tts_tpu."""
    from tts_tpu_torch.infer.synthesis import synthesis
    from tts_tpu_torch.infer.synthesizer import Synthesizer

    glow, glow_cfg = small_glow_checkpoint(tmp_path)
    c, cfg = _voc_config(tmp_path)
    torch.manual_seed(2)
    voc = setup_generator(c)
    path = tmp_path / "istft.pt"
    torch.save({"model": voc.state_dict()}, path)
    synth = Synthesizer(glow, glow_cfg, str(path), cfg, device="cpu")
    assert synth._packed is None and synth._stacks is None
    text = "Hello world."
    wav = synth.tts(text)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
    out = synthesis(synth.model, text, synth.tts_config, synth.device,
                    generator=torch.Generator().manual_seed(0), ap=synth.ap)
    m = torch.from_numpy(np.ascontiguousarray(out["postnet_outputs"],
                                              np.float32))
    n = m.shape[0]
    nb = max(32, -(-n // 32) * 32)
    m = torch.cat([m, m[-1:].expand(nb - n, -1)])[None].transpose(1, 2)
    want = voc.eval().inference(m)[0, 0].numpy()
    want = want[: n * 256] if n < nb else want
    np.testing.assert_allclose(wav[: len(want)], want, rtol=0, atol=1e-5)
    assert len(wav) == len(want) + 10000

    _, bad = _voc_config(tmp_path, hop_head=2)
    with pytest.raises(ValueError, match="total hop"):
        Synthesizer(glow, glow_cfg, str(path), bad, device="cpu")
