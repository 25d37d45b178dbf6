"""ParallelWaveGAN and the random window discriminators in the port against
tts_tpu, on the CPU: modules, the weights bridge both ways, weight-norm
folding, the registry on the shipped config, tts_tpu checkpoints, and
serving through the Synthesizer (ROADMAP C18).

Parameters come from numpy seeds in tts_tpu's shapes
(``tests/torch_port_params.py``, weight-norm scales redrawn near 1) and
go across with ``compat/from_jax.py``; inputs are numpy-seeded; both sides
get the same noise. Narrow models (4 residual blocks in 2 stacks; the
residual discriminator 6 layers in 2 stacks) on 8 mel frames (2,048
samples); the discriminators at tts_tpu's widths. Tolerance: 1e-4 of the
largest reference magnitude (float32, another summation order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import InvalidRngError

from tts_tpu.compat.torch_port import port_pwgan
from tts_tpu.models.vocoder.pwgan import (
    ParallelWaveganDiscriminator as JPD, ParallelWaveganGenerator as JPG,
    ResidualParallelWaveganDiscriminator as JRPD)
from tts_tpu.models.vocoder.registry import \
    setup_discriminator as j_setup_discriminator
from tts_tpu.models.vocoder.registry import \
    setup_generator as j_setup_generator
from tts_tpu.models.vocoder.rwd import RandomWindowDiscriminator as JRWD
from tts_tpu.train.checkpoint import save_checkpoint as save_tts_tpu
from tts_tpu_torch.compat.from_jax import (
    pwgan_discriminator_state_dict_from_jax, pwgan_state_dict_from_jax,
    residual_pwgan_discriminator_state_dict_from_jax, rwd_state_dict_from_jax)
from tts_tpu_torch.config import load_config
from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
from tts_tpu_torch.models.vocoder.pwgan import (
    ParallelWaveganDiscriminator, ParallelWaveganGenerator,
    ResidualParallelWaveganDiscriminator)
from tts_tpu_torch.models.vocoder.registry import (setup_discriminator,
                                                   setup_generator)
from tts_tpu_torch.models.vocoder.rwd import (RandomWindowDiscriminator,
                                              frame_rate_factors)

from tests.test_torch_port_vocoder_family_train import (rwd_offsets,
                                                         scales_near_one)
from tests.torch_port_params import init_shapes, module_params

TOL = 1e-4
FRAMES = 8
T_AUDIO = FRAMES * 256
GEN = dict(num_res_blocks=4, stacks=2, upsample_factors=(4, 4, 4, 4))
PWGAN_CONFIG = "configs/parallel_wavegan.json"
GLOW_CONFIG = "configs/glow_tts_ljspeech.json"


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


def _ncw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gen_params(jgen, seed=0):
    return scales_near_one(module_params(
        jgen, seed, jnp.zeros((1, T_AUDIO, 1)), jnp.zeros((1, FRAMES, 80))),
        seed + 100)


def _count(tree) -> int:
    return sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(tree))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_weight_norm", [True, False])
def test_generator_matches_tts_tpu_on_the_same_noise(use_weight_norm):
    jgen = JPG(**GEN, use_weight_norm=use_weight_norm)
    params = _gen_params(jgen)
    z, c = _rand(1, (2, T_AUDIO, 1)), _rand(2, (2, FRAMES, 80))
    want = jgen.apply({"params": params}, z, c)
    gen = ParallelWaveganGenerator(**GEN, use_weight_norm=use_weight_norm)
    gen.load_state_dict(pwgan_state_dict_from_jax(_np(params)), strict=True)
    with torch.no_grad():
        got = gen(_ncw(z), _ncw(c))
    assert float(np.asarray(want).std()) > 1e-2     # not a constant output
    _close(got.numpy().transpose(0, 2, 1), want)


def test_inference_pads_and_draws_noise_at_the_audio_rate():
    """``inference`` edge-pads 2 frames a side and draws (T + 4) * 256
    samples of noise from its generator: equal to tts_tpu's generator on
    the edge-padded mel with that noise; tts_tpu's own ``inference`` is its
    generator on ``normal(rng, ((T + 4) * 256, 1))`` and the padded mel."""
    jgen = JPG(**GEN)
    params = _gen_params(jgen)
    c = _rand(3, (1, FRAMES, 80))
    gen = ParallelWaveganGenerator(**GEN)
    gen.load_state_dict(pwgan_state_dict_from_jax(_np(params)))
    got = gen.inference(_ncw(c), torch.Generator().manual_seed(7))
    t_out = (FRAMES + 4) * 256
    assert got.shape == (1, 1, t_out)
    z = torch.randn((1, 1, t_out), generator=torch.Generator().manual_seed(7))
    c_pad = jnp.pad(c, ((0, 0), (2, 2), (0, 0)), mode="edge")
    want = jgen.apply({"params": params}, z.numpy().transpose(0, 2, 1), c_pad)
    _close(got.numpy().transpose(0, 2, 1), want)
    # tts_tpu's inference: the same length, its noise from the key
    key = jax.random.PRNGKey(1)
    j_inf = jgen.apply({"params": params}, c, rng=key, method=jgen.inference)
    j_ref = jgen.apply({"params": params},
                       jax.random.normal(key, (1, t_out, 1)), c_pad)
    np.testing.assert_array_equal(np.asarray(j_inf), np.asarray(j_ref))
    # the same seed gives the same audio; the draw follows the generator
    again = gen.inference(_ncw(c), torch.Generator().manual_seed(7))
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind", ["plain", "residual"])
def test_discriminators_match_tts_tpu(kind):
    if kind == "plain":
        jd, d = JPD(), ParallelWaveganDiscriminator()
        convert = pwgan_discriminator_state_dict_from_jax
    else:
        jd = JRPD(num_layers=6, stacks=2)
        d = ResidualParallelWaveganDiscriminator(num_layers=6, stacks=2)
        convert = residual_pwgan_discriminator_state_dict_from_jax
    params = scales_near_one(module_params(jd, 4, jnp.zeros((1, T_AUDIO, 1))),
                             5)
    d.load_state_dict(convert(_np(params)), strict=True)
    x = _rand(6, (2, T_AUDIO, 1), 0.3)
    want = jd.apply({"params": params}, x)
    with torch.no_grad():
        got = d(_ncw(x))
    _close(got.numpy().transpose(0, 2, 1), want)
    # weight norm where tts_tpu has it: every conv of the plain one, the
    # residual blocks only of the residual one
    names = dict(d.named_parameters())
    assert ("first_conv.0.weight" in names) == (kind == "residual")
    assert "conv_layers.0.conv.weight_v" in names or kind == "plain"


def test_random_window_discriminator_at_tts_tpu_offsets():
    """All five of tts_tpu's window sizes on 4,096 samples / 16 frames (the
    two largest clipped to the signal), each unconditional and conditional
    score at the offsets tts_tpu drew from its key."""
    T, F = 4096, 16
    jd = JRWD()
    key = jax.random.PRNGKey(5)
    params = module_params(jd, 7, jnp.zeros((1, T, 1)), jnp.zeros((1, F, 80)),
                           rng=key)
    x, c = _rand(8, (2, T, 1), 0.3), _rand(9, (2, F, 80))
    want, feats = jax.jit(jd.apply)({"params": params}, x, c, rng=key)
    assert feats == []
    offsets = rwd_offsets(jd, key, T, F)
    d = RandomWindowDiscriminator()
    d.load_state_dict(rwd_state_dict_from_jax(_np(params)), strict=True)
    with torch.no_grad():
        got, got_feats = d(_ncw(x), _ncw(c), offsets=offsets)
    assert got_feats == [] and len(got) == len(want) == 10
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert frame_rate_factors(256) == (8, 4, 4, 2)
    # the conditional branch downsamples 256x to the frame rate; channels
    # stop at 512
    assert d.cond_0.down_3.conv2.out_channels == 512
    assert [tuple(w) for w in d.windows(T, F)] == [
        (512, 2, 512), (1024, 4, 1024), (2048, 8, 2048), (4096, 16, 4096),
        (4096, 16, 4096)]


def test_random_window_offsets_are_drawn_from_the_generator():
    d = RandomWindowDiscriminator()
    T, F = 4096, 16
    a = d.draw_offsets(T, F, torch.Generator().manual_seed(0))
    b = d.draw_offsets(T, F, torch.Generator().manual_seed(0))
    assert a == b
    many = [d.draw_offsets(T, F, torch.Generator().manual_seed(s))
            for s in range(200)]
    for (ws, frames, _), i in zip(d.windows(T, F), range(5)):
        starts = {o[i][0] for o in many}
        f0s = {o[i][1] for o in many}
        assert min(starts) >= 0 and max(starts) <= T - ws
        assert min(f0s) >= 0 and max(f0s) <= F - frames
    assert len({o[0][0] for o in many}) > 100       # spread over 0..3584


# ---------------------------------------------------------------------------
# weights, registry, checkpoints
# ---------------------------------------------------------------------------

def test_port_pwgan_round_trip():
    """tts_tpu's ``port_pwgan`` (Mozilla names -> flax) takes the port's
    state dict back to the params it came from."""
    jgen = JPG(**GEN)
    params = _gen_params(jgen, 3)
    sd = {k: v.numpy() for k, v in
          pwgan_state_dict_from_jax(_np(params)).items()}
    template = init_shapes(jgen, jnp.zeros((1, T_AUDIO, 1)),
                           jnp.zeros((1, FRAMES, 80)))
    back = port_pwgan(sd, jax.tree_util.tree_map(np.zeros_like, template),
                      num_res_blocks=GEN["num_res_blocks"],
                      upsample_factors=GEN["upsample_factors"])
    flat_a = jax.tree_util.tree_leaves_with_path(_np(params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_fold_weight_norm_takes_every_layer():
    """Folding leaves no ``weight_v``/``weight_g`` (the Conv2d upsample
    layers included) and the ``use_weight_norm=False`` twin gives the same
    waveform."""
    torch.manual_seed(0)
    gen = ParallelWaveganGenerator(**GEN)
    sd = fold_weight_norm(gen.state_dict())
    assert not [k for k in sd if k.endswith(("weight_v", "weight_g"))]
    assert sd["upsample_net.upsample.up_layers.1.weight"].shape == (1, 1, 1, 9)
    plain = ParallelWaveganGenerator(**GEN, use_weight_norm=False)
    plain.load_state_dict(sd, strict=True)
    z, c = torch.randn(1, 1, T_AUDIO), torch.randn(1, 80, FRAMES)
    with torch.no_grad():
        torch.testing.assert_close(plain(z, c), gen(z, c), rtol=0,
                                   atol=1e-6)


def test_registry_builds_the_shipped_configs():
    """The shipped config's generator and discriminator, the residual
    discriminator and the random window discriminators (tts_tpu's
    defaults), each with as many parameters as tts_tpu's (a weight-norm
    pair counts as tts_tpu's kernel and scale). The port raised KeyError
    for all five before."""
    c = load_config(PWGAN_CONFIG)
    gen = setup_generator(c)
    assert isinstance(gen, ParallelWaveganGenerator)
    assert len(gen.conv_layers) == 30 and gen.hop == 256
    assert gen.conv_layers[29].conv.dilation == (512,)
    z, mel = jnp.zeros((1, 256, 1)), jnp.zeros((1, 1, 80))
    assert sum(p.numel() for p in gen.parameters()) == _count(
        init_shapes(j_setup_generator(c), z, mel))
    assert not setup_generator(c, use_weight_norm=False).state_dict().keys() \
        & {k for k in gen.state_dict() if k.endswith("weight_v")}
    for name, params, args, kw in (
            ("parallel_wavegan_discriminator", {"num_layers": 10},
             (z,), {}),
            ("residual_parallel_wavegan_discriminator", {}, (z,), {}),
            ("random_window_discriminator", {},
             (jnp.zeros((1, 8192, 1)), jnp.zeros((1, 32, 80))),
             {"rng": jax.random.PRNGKey(0)})):
        cfg = dict(c, discriminator_model=name,
                   discriminator_model_params=params)
        disc = setup_discriminator(cfg)
        want = _count(init_shapes(j_setup_discriminator(cfg), *args, **kw))
        assert sum(p.numel() for p in disc.parameters()) == want, name


def test_tts_tpu_checkpoint_routes_to_the_pwgan_converter(tmp_path):
    """A tts_tpu msgpack checkpoint of a PWGAN generator loads through the
    port's ``load_checkpoint`` (before, every generator went to the MelGAN
    converter) into a model that gives tts_tpu's waveform."""
    from tts_tpu_torch.infer.synthesizer import load_checkpoint

    jgen = JPG(**GEN)
    params = _gen_params(jgen, 4)
    save_tts_tpu(str(tmp_path), params=params, step=3)
    c = {"generator_model": "parallel_wavegan_generator",
         "generator_model_params": dict(GEN), "audio": {"num_mels": 80}}
    sd = load_checkpoint(str(tmp_path / "checkpoint_3.ckpt"), c)["model"]
    gen = setup_generator(c)
    gen.load_state_dict(sd, strict=True)
    z, mel = _rand(10, (1, T_AUDIO, 1)), _rand(11, (1, FRAMES, 80))
    with torch.no_grad():
        got = gen(_ncw(z), _ncw(mel))
    _close(got.numpy().transpose(0, 2, 1),
           jgen.apply({"params": params}, z, mel))


# ---------------------------------------------------------------------------
# serving (C18)
# ---------------------------------------------------------------------------

def small_glow_checkpoint(tmp_path) -> tuple:
    """The shipped Glow-TTS config at hidden width 32, seeded, its duration
    head pinned to 6 frames per symbol; (checkpoint, config) paths."""
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols

    c = dict(load_config(GLOW_CONFIG))
    c.update(hidden_channels_encoder=32, hidden_channels_decoder=32)
    cfg = tmp_path / "glow.json"
    cfg.write_text(json.dumps(c, default=dict))
    torch.manual_seed(0)
    model = setup_model(num_symbols(c.get("use_phonemes", False)), 1, c)
    proj = model.encoder.duration_predictor.proj
    with torch.no_grad():
        proj.weight.zero_()
        proj.bias.fill_(float(np.log(6.5)))
    path = tmp_path / "glow.pt"
    torch.save({"model": model.state_dict()}, path)
    return str(path), str(cfg)


def test_tts_tpu_cannot_serve_pwgan_and_the_port_serves_it_seeded(tmp_path):
    """C18: tts_tpu's Synthesizer serves a generator with ``inference``
    through ``gen.apply(variables, m, method=gen.inference)`` and passes no
    "noise" key, so PWGAN raises there. The port serves it through its
    module's ``inference`` with folded weights and noise from a CPU
    generator seeded 0 per sentence: the same request gives the same audio,
    equal to the module on the served mel."""
    from tts_tpu_torch.infer.synthesis import synthesis
    from tts_tpu_torch.infer.synthesizer import Synthesizer

    jgen = JPG(**GEN)
    params = _gen_params(jgen, 5)
    mel = jnp.asarray(_rand(12, (1, FRAMES, 80)))
    with pytest.raises(InvalidRngError):
        jgen.apply({"params": params}, mel, method=jgen.inference)

    glow, glow_cfg = small_glow_checkpoint(tmp_path)
    c = dict(load_config(PWGAN_CONFIG))
    c["generator_model_params"] = dict(c["generator_model_params"],
                                       num_res_blocks=3, stacks=3)
    voc_cfg = tmp_path / "pwgan.json"
    voc_cfg.write_text(json.dumps(c, default=dict))
    torch.manual_seed(1)
    voc = setup_generator(c)
    voc_path = tmp_path / "pwgan.pt"
    torch.save({"model": voc.state_dict()}, voc_path)

    synth = Synthesizer(glow, glow_cfg, str(voc_path), str(voc_cfg),
                        device="cpu")
    assert synth._packed is None and synth._stacks is None
    assert not synth.vocoder_model.state_dict().keys() & {
        k for k in voc.state_dict() if k.endswith("weight_v")}
    text = "Hello world."
    wav = synth.tts(text)
    assert np.array_equal(wav, synth.tts(text))
    assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
    out = synthesis(synth.model, text, synth.tts_config, synth.device,
                    generator=torch.Generator().manual_seed(0), ap=synth.ap)
    m = torch.from_numpy(np.ascontiguousarray(out["postnet_outputs"],
                                              np.float32))
    n = m.shape[0]
    nb = max(32, -(-n // 32) * 32)
    m = torch.cat([m, m[-1:].expand(nb - n, -1)])[None].transpose(1, 2)
    want = voc.eval().inference(m, torch.Generator().manual_seed(0))[0, 0]
    want = want.numpy()[: n * 256] if n < nb else want.numpy()
    np.testing.assert_allclose(wav[: len(want)], want, rtol=0, atol=1e-5)
    assert len(wav) == len(want) + 10000          # the inter-sentence gap
