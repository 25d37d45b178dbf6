"""GAN training of ParallelWaveGAN (with its discriminator and with the
random window discriminators) and of the iSTFT MelGAN in the port, against
tts_tpu, on the CPU; then the port's trainer CLI on both shipped configs.

One step each, discriminator on, against one tts_tpu
``make_gan_train_step``. The step's random inputs are the ones tts_tpu
derives from the keys it splits (``train/gan.py``: ``fold_in`` of the step,
then ``rng_g``, ``rng_d1``, ``rng_d2``): white noise from ``rng_g`` for the
generator update and from ``rng_d2`` for the discriminator update's
regenerated ``y_hat``, crop offsets from ``rng_d1`` (generator update) and
``rng_d2`` (discriminator update, fake and real alike). The port takes them
through ``GANTrainStep``'s ``draws``.

Generators are narrow (PWGAN 2 blocks in 1 stack; iSTFT base 32,
factors 8-8, head n_fft 16 / hop 4), discriminators at full width but
shallow where tts_tpu's compile time grows with depth (the multiscale
MelGAN one at one scale, the random window ones at one window size; all
three scales are held in tests/test_torch_port_gan_train.py, all five
windows in tests/test_torch_port_pwgan.py), signals 2,048 samples (8 mel
frames). The iSTFT generator runs without
weight norm in the step, as the MelGAN one in
``tests/test_torch_port_gan_train.py`` (flax norms a transposed conv per
output channel, torch per input channel: ROADMAP C2); PWGAN's convs are
weight-normed per output channel on both sides, so its (v, g) pairs are
compared after the update. The losses are the adversarial ones (and
feature matching where the discriminator has features); the STFT losses
are left out for the reason that file gives (float32 cannot decide their
gradient on a random generator's output). Tolerances are that file's:
losses 1e-4 relative; each parameter tensor's update within 1e-3 of its
largest reference update (plus 4 float32 ulps of the parameter).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.models.vocoder.istft_melgan import \
    ISTFTMelganGenerator as JISTFT
from tts_tpu.models.vocoder.melgan import \
    MelganMultiscaleDiscriminator as JMSD
from tts_tpu.models.vocoder.pwgan import (
    ParallelWaveganDiscriminator as JPD, ParallelWaveganGenerator as JPG)
from tts_tpu.models.vocoder.rwd import RandomWindowDiscriminator as JRWD
from tts_tpu.train.gan import GState, make_gan_train_step
from tts_tpu.train.optim import make_optimizer as j_make_optimizer
from tts_tpu_torch.compat.from_jax import (
    istft_melgan_state_dict_from_jax, melgan_discriminator_state_dict_from_jax,
    pwgan_discriminator_state_dict_from_jax, pwgan_state_dict_from_jax,
    rwd_state_dict_from_jax)
from tts_tpu_torch.models.vocoder.istft_melgan import ISTFTMelganGenerator
from tts_tpu_torch.models.vocoder.melgan import MelganMultiscaleDiscriminator
from tts_tpu_torch.models.vocoder.pwgan import (ParallelWaveganDiscriminator,
                                                ParallelWaveganGenerator)
from tts_tpu_torch.models.vocoder.rwd import RandomWindowDiscriminator
from tts_tpu_torch.train.gan import GANTrainStep
from tts_tpu_torch.train.optim import make_optimizer

from tests.fixtures import make_ljspeech_fixture
from tests.torch_port_params import module_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
UPDATE_TOL = 1e-3
T_AUDIO = 2048
FRAMES = T_AUDIO // 256
B = 2
GKW = dict(use_stft_loss=False, use_mse_gan_loss=True,
           use_feat_match_loss=True, mse_G_loss_weight=2.5,
           feat_match_loss_weight=10.0)
DKW = dict(use_mse_gan_loss=True)
LR, CLIP = 0.05, 10.0
PWGAN = dict(num_res_blocks=2, stacks=1, upsample_factors=(4, 4, 4, 4))
# one of tts_tpu's five window sizes: each size is a full-width pair of
# discriminators (unconditional and conditional), and all five made the
# jitted tts_tpu step take a minute to compile; tests/test_torch_port_pwgan.py
# holds all five, those past the signal clipped to it
RWD_WINDOWS = (1024,)
ISTFT = dict(base_channels=32, upsample_factors=(8, 8), num_res_blocks=2,
             n_fft_head=16, hop_head=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def scales_near_one(tree, seed):
    """``module_params`` draws a flax WeightNorm scale (leaf
    ``<conv>/kernel/scale``) as a bias, ~0.05: ten such layers shrink a
    signal by 1e-13 and the gradients vanish below float32. Redraw those
    scales near 1, as ``module_params`` does for other scales."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    (1.0 + 0.1 * rng.standard_normal(np.shape(v))
                     ).astype(np.float32) if k.endswith("/kernel/scale")
                    else v) for k, v in node.items()}
    return walk(tree)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ncw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def _plain(sd):
    """A converter's ``weight_v``/``weight_g`` pair for a generator built
    without weight norm -> plain ``weight`` (the MelGAN bridge writes
    weight_v = the kernel)."""
    return {k.replace("weight_v", "weight"): v for k, v in sd.items()
            if not k.endswith("weight_g")}


def rwd_offsets(disc: JRWD, rng, t_audio, t_frames):
    """The offsets tts_tpu's RandomWindowDiscriminator draws from ``rng``
    (``rwd.py``: three keys split per window; uncond start, cond frame)."""
    out = []
    for ws in disc.window_sizes:
        ws = min(ws, t_audio)
        key_u, key_c, rng = jax.random.split(rng, 3)
        start = int(jax.random.randint(key_u, (), 0, t_audio - ws + 1))
        frames = min(max(ws // disc.hop_length, 1), t_frames)
        f0 = int(jax.random.randint(key_c, (), 0, t_frames - frames + 1))
        out.append((start, f0))
    return out


# per case: tts_tpu's generator and discriminator, the port's, their
# converters, and tts_tpu's needs_noise and disc_takes_cond (the port's
# step reads both off its modules)
CASES = {
    "pwgan": dict(jgen=lambda: JPG(**PWGAN), jdisc=JPD,
                  gen=lambda: ParallelWaveganGenerator(**PWGAN),
                  disc=ParallelWaveganDiscriminator,
                  gen_sd=pwgan_state_dict_from_jax,
                  disc_sd=pwgan_discriminator_state_dict_from_jax,
                  noise=True, cond=False),
    "pwgan_rwd": dict(jgen=lambda: JPG(**PWGAN),
                      jdisc=lambda: JRWD(window_sizes=RWD_WINDOWS),
                      gen=lambda: ParallelWaveganGenerator(**PWGAN),
                      disc=lambda: RandomWindowDiscriminator(
                          window_sizes=RWD_WINDOWS),
                      gen_sd=pwgan_state_dict_from_jax,
                      disc_sd=rwd_state_dict_from_jax,
                      noise=True, cond=True),
    "istft": dict(jgen=lambda: JISTFT(**ISTFT, use_weight_norm=False),
                  jdisc=lambda: JMSD(num_scales=1),
                  gen=lambda: ISTFTMelganGenerator(**ISTFT,
                                                   use_weight_norm=False),
                  disc=lambda: MelganMultiscaleDiscriminator(num_scales=1),
                  gen_sd=lambda p: _plain(istft_melgan_state_dict_from_jax(
                      p, ISTFT["upsample_factors"], ISTFT["num_res_blocks"])),
                  disc_sd=melgan_discriminator_state_dict_from_jax,
                  noise=False, cond=False),
}


def _tts_tpu_step(case):
    """Seeded params, batches, one jitted tts_tpu step; plus the step's
    draws as the port takes them."""
    spec = CASES[case]
    jgen, jdisc = spec["jgen"](), spec["jdisc"]()
    mel0 = jnp.zeros((1, FRAMES, 80))
    y0 = jnp.zeros((1, T_AUDIO, 1))
    g_args = (y0, mel0) if spec["noise"] else (mel0,)
    d_kw = {"rng": jax.random.PRNGKey(0)} if spec["cond"] else {}
    d_args = (y0, mel0) if spec["cond"] else (y0,)
    g_params = scales_near_one(module_params(jgen, 0, *g_args), 2)
    d_params = scales_near_one(module_params(jdisc, 1, *d_args, **d_kw), 3)
    batches = {side: {"mel": _rand(seed, (B, FRAMES, 80)),
                      "audio": _rand(seed + 1, (B, T_AUDIO, 1), 0.3)}
               for side, seed in (("G", 10), ("D", 20))}
    step = make_gan_train_step(jgen, jdisc, hop_len=256, conv_pad=0,
                               needs_noise=spec["noise"],
                               disc_takes_cond=spec["cond"], train_disc=True,
                               gen_loss_kwargs=GKW, disc_loss_kwargs=DKW)
    tx = j_make_optimizer(lr=LR, grad_clip=CLIP)
    state_G = GState.create(apply_fn=jgen.apply, params=g_params, tx=tx)
    state_D = GState.create(apply_fn=jdisc.apply, params=d_params, tx=tx)
    jb = {s: {k: jnp.asarray(v) for k, v in b.items()}
          for s, b in batches.items()}
    rng = jax.random.PRNGKey(0)
    new_G, new_D, losses = step(state_G, state_D, jb["G"], jb["D"], rng)
    # the keys the step splits (train/gan.py), step 0
    rng_g, rng_d1, rng_d2 = jax.random.split(jax.random.fold_in(rng, 0), 3)
    draws = {"G": {}, "D": {}}
    if spec["noise"]:
        for side, key in (("G", rng_g), ("D", rng_d2)):
            draws[side]["noise"] = _ncw(jax.random.normal(key,
                                                          (B, T_AUDIO, 1)))
    if spec["cond"]:
        for side, key in (("G", rng_d1), ("D", rng_d2)):
            draws[side]["offsets"] = rwd_offsets(jdisc, key, T_AUDIO, FRAMES)
    return {"g_params": g_params, "d_params": d_params, "batches": batches,
            "new_G": _np(new_G.params), "new_D": _np(new_D.params),
            "losses": {k: float(v) for k, v in losses.items()},
            "draws": draws}


def _port_step(spec, gen, disc, **kw):
    return GANTrainStep(gen, disc, make_optimizer(gen, lr=LR, grad_clip=CLIP),
                        make_optimizer(disc, lr=LR, grad_clip=CLIP),
                        hop_len=256, conv_pad=0, gen_loss_kwargs=GKW,
                        disc_loss_kwargs=DKW, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gan_step_matches_tts_tpu(case):
    """Losses, then every parameter of both networks after one step with
    the discriminator on (G update with D frozen, D update on its own batch
    with y_hat regenerated by the updated G)."""
    spec = CASES[case]
    ref = _tts_tpu_step(case)
    gen, disc = spec["gen"](), spec["disc"]()
    gen.load_state_dict(spec["gen_sd"](_np(ref["g_params"])), strict=True)
    disc.load_state_dict(spec["disc_sd"](_np(ref["d_params"])), strict=True)
    before = {"G": {n: p.detach().clone() for n, p in gen.named_parameters()},
              "D": {n: p.detach().clone() for n, p in disc.named_parameters()}}
    batches = {s: {k: _ncw(v) for k, v in b.items()}
               for s, b in ref["batches"].items()}
    losses = _port_step(spec, gen, disc)(batches["G"], batches["D"],
                                         train_disc=True, draws=ref["draws"])
    assert set(losses) == set(ref["losses"])
    if case == "istft":                 # the MelGAN discriminator's features
        assert "G_feat_match_loss" in losses
    for key, want in ref["losses"].items():
        np.testing.assert_allclose(losses[key], want, rtol=TOL, err_msg=key)
    wants = {"G": spec["gen_sd"](ref["new_G"]),
             "D": spec["disc_sd"](ref["new_D"])}
    for side, model in (("G", gen), ("D", disc)):
        named = dict(model.named_parameters())
        assert set(named) == set(wants[side])
        moved = 0
        for name, p in named.items():
            p0 = before[side][name].numpy()
            delta = p.detach().numpy() - p0
            want = wants[side][name].numpy() - p0
            moved += bool(np.abs(want).max() > 0)
            atol = (UPDATE_TOL * float(np.abs(want).max())
                    + 4 * np.finfo(np.float32).eps * float(np.abs(p0).max()))
            np.testing.assert_allclose(delta, want, rtol=0, atol=atol,
                                       err_msg=f"{case} {side} {name}")
        assert moved > len(named) // 2, (case, side, moved, len(named))


def test_step_draws_from_its_generator():
    """Without ``draws`` the step draws noise and offsets from its two
    ``torch.Generator``s: the same seed gives the same update, another seed
    another; the D update's fake and real scores share one draw (the port
    calls ``draw`` once per side)."""
    spec = CASES["pwgan_rwd"]
    batches = {s: {"mel": _ncw(_rand(seed, (B, FRAMES, 80))),
                   "audio": _ncw(_rand(seed + 1, (B, T_AUDIO, 1), 0.3))}
               for s, seed in (("G", 10), ("D", 20))}
    results = []
    for seed in (3, 3, 4):
        torch.manual_seed(0)
        gen, disc = spec["gen"](), spec["disc"]()
        step = _port_step(spec, gen, disc,
                          generator=torch.Generator().manual_seed(seed),
                          crop_generator=torch.Generator().manual_seed(seed))
        calls = []
        draw = step.draw
        step.draw = lambda batch: calls.append(1) or draw(batch)
        losses = step(batches["G"], batches["D"], train_disc=True)
        assert len(calls) == 2
        assert all(np.isfinite(v) for v in losses.values())
        results.append(torch.cat([p.detach().flatten()
                                  for p in gen.parameters()]))
    assert torch.equal(results[0], results[1])
    assert not torch.equal(results[0], results[2])


def _train_cli(tmp_path, monkeypatch, config, **overrides):
    from tts_tpu_torch.bin.train_vocoder import main
    from tts_tpu_torch.config import load_config

    corpus = make_ljspeech_fixture(str(tmp_path / "ljspeech"))
    c = load_config(os.path.join(ROOT, "configs", config))
    c.update(data_path=os.path.join(corpus, "wavs"), batch_size=2,
             seq_len=4096, epochs=1, eval_split_size=2,
             steps_to_start_discriminator=1)
    c.update(overrides)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    cfg = tmp_path / "vocoder.json"
    cfg.write_text(json.dumps(c))
    trainer = main(["--config_path", str(cfg), "--output_path",
                    str(tmp_path / "runs"), "--device", "cpu"])
    assert trainer.global_step == 3
    assert [s["train_disc"] for s in trainer.step_stats] == [False, True, True]
    for stats in trainer.step_stats:
        assert all(np.isfinite(v) for k, v in stats.items()
                   if k.startswith(("G_", "D_"))), stats
    assert "D_loss" in trainer.step_stats[-1]
    return trainer


@pytest.mark.parametrize("config,overrides", [
    ("parallel_wavegan.json",
     {"generator_model_params": {"num_res_blocks": 3, "stacks": 3,
                                 "upsample_factors": [4, 4, 4, 4]}}),
    ("parallel_wavegan.json",
     {"generator_model_params": {"num_res_blocks": 3, "stacks": 3,
                                 "upsample_factors": [4, 4, 4, 4]},
      "discriminator_model": "random_window_discriminator",
      "discriminator_model_params": {"window_sizes": [512, 1024]}}),
    ("istft_melgan.json",
     {"generator_model_params": {"base_channels": 32,
                                 "upsample_factors": [8, 8],
                                 "num_res_blocks": 2, "n_fft_head": 16,
                                 "hop_head": 4}})],
    ids=["pwgan", "pwgan_rwd", "istft"])
def test_trainer_cli_trains_the_shipped_configs(tmp_path, monkeypatch, config,
                                               overrides):
    """The CLI trains each shipped config (narrowed generators; the iSTFT
    one in its bfloat16 mixed precision) for one epoch of 3 steps on the
    CPU, the discriminator from the second step; the trainer's generators
    drew the noise and the offsets (their states moved) and nothing else."""
    trainer = _train_cli(tmp_path, monkeypatch, config, **overrides)
    assert trainer.step.needs_noise == ("wavegan" in config)
    assert trainer.step.disc_takes_cond == ("discriminator_model" in overrides)
    fresh = torch.Generator().manual_seed(trainer.c.get("seed", 54321))
    for gen, drew in ((trainer.generator, trainer.step.needs_noise),
                      (trainer.crop_generator, trainer.step.disc_takes_cond)):
        assert (not torch.equal(gen.get_state(), fresh.get_state())) == drew
