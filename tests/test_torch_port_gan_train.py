"""Multiband-MelGAN GAN training in the port against tts_tpu, on the CPU.

Parameters come from numpy seeds in tts_tpu's shapes and go across with
``compat/from_jax.py``; inputs are numpy-seeded. The discriminator is at
full width (3 scales); the generator is narrow (base 32, factors 2-8-2-2,
2 residual blocks) and, in the step comparison, without weight norm: flax
norms a transposed conv's kernel per output channel and torch's
``weight_norm`` per input channel (ROADMAP C2), so those parameters cannot
be compared after an update. Signals are 2,048 samples (8 mel frames, no
conv_pad context, as in configs/multiband_melgan.json): the 2048-point
STFT's reflect padding needs more than 1,024. TF32 is off.

The step comparison runs the adversarial and feature-matching terms and
leaves the STFT losses out (``GKW``): a random generator's output has
|STFT| bins of 2.5e-5 beside 64, where float32 cannot decide the
log-magnitude gradient (the port's own float32 G gradients differ from its
float64 ones by up to 4 % there, and move with the summation order). The
STFT losses' values and their gradients with respect to the signals are
compared on their own, on noise, where they are well conditioned.
Tolerances (float32, another order of summation):

- discriminator scores and features, PQMF analysis: 1e-4 of the largest
  reference magnitude;
- losses: 1e-4 relative (STFT magnitudes via DFT banks against tts_tpu's
  FFT on the CPU); their gradients 3e-3 of the largest reference gradient
  (``GRAD_TOL``: on these noise inputs the port's own float32 gradients
  differ from its float64 ones by up to 2.3e-4 (full band) and 9.3e-4
  (subbands) of the largest, the log-magnitude terms weighting each bin by
  1 / |STFT|);
- parameters after one step: each tensor's update within 1e-3 of its
  largest reference update (an update is lr times a clipped gradient
  through G, PQMF synthesis and the full discriminator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tts_tpu.losses import vocoder_losses as JL
from tts_tpu.models.vocoder.melgan import \
    MelganMultiscaleDiscriminator as JDisc
from tts_tpu.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator as JGen
from tts_tpu.models.vocoder.pqmf import PQMF as JPQMF
from tts_tpu.train.gan import GState, make_gan_train_step
from tts_tpu.train.optim import make_optimizer as j_make_optimizer
from tts_tpu_torch.compat.from_jax import (
    melgan_discriminator_state_dict_from_jax, melgan_state_dict_from_jax)
from tts_tpu_torch.losses import vocoder_losses as L
from tts_tpu_torch.models.vocoder.melgan import MelganMultiscaleDiscriminator
from tts_tpu_torch.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator
from tts_tpu_torch.models.vocoder.pqmf import PQMF
from tts_tpu_torch.train.gan import GANTrainStep
from tts_tpu_torch.train.optim import make_optimizer

from tests.torch_port_params import module_params

TOL = 1e-4
T_AUDIO = 2048
GEN = dict(base_channels=32, upsample_factors=(2, 8, 2, 2), num_res_blocks=2)
GKW = dict(use_stft_loss=False, use_subband_stft_loss=False,
           use_mse_gan_loss=True, use_feat_match_loss=True,
           mse_G_loss_weight=2.5, feat_match_loss_weight=10.0)
DKW = dict(use_mse_gan_loss=True)
# a large learning rate, so that each update stands well above the float32
# rounding of the parameter it is added to (RAdam's first step is lr times
# the clipped gradient)
LR, CLIP = 0.05, 10.0
UPDATE_TOL = 1e-3
GRAD_TOL = 3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and PyTorch's thread pool spinning against them made this file's
    full-width steps many times slower than on an idle machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gen_state_dict(params):
    """tts_tpu generator params without weight norm -> the port's plain
    ``weight`` entries (the bridge writes weight_v = the kernel)."""
    sd = melgan_state_dict_from_jax(_np(params), GEN["upsample_factors"],
                                    GEN["num_res_blocks"])
    return {k.replace("weight_v", "weight"): v for k, v in sd.items()
            if not k.endswith("weight_g")}


@pytest.fixture(scope="module")
def g():
    jgen = JGen(**GEN, use_weight_norm=False)
    jdisc = JDisc()
    frames = T_AUDIO // 256
    g_params = module_params(jgen, 0, jnp.zeros((1, frames, 80)))
    d_params = module_params(jdisc, 1, jnp.zeros((1, T_AUDIO, 1)))
    batches = {side: {"mel": _rand(seed, (2, frames, 80)),
                      "audio": _rand(seed + 1, (2, T_AUDIO, 1), 0.3)}
               for side, seed in (("G", 10), ("D", 20))}
    step = make_gan_train_step(jgen, jdisc, hop_len=256, conv_pad=0,
                               use_pqmf=True, train_disc=True,
                               gen_loss_kwargs=GKW, disc_loss_kwargs=DKW)
    tx = j_make_optimizer(lr=LR, grad_clip=CLIP)
    state_G = GState.create(apply_fn=jgen.apply, params=g_params, tx=tx)
    state_D = GState.create(apply_fn=jdisc.apply, params=d_params, tx=tx)
    jb = {s: {k: jnp.asarray(v) for k, v in b.items()}
          for s, b in batches.items()}
    new_G, new_D, losses = step(state_G, state_D, jb["G"], jb["D"],
                                jax.random.PRNGKey(0))
    return {"jgen": jgen, "jdisc": jdisc, "g_params": g_params,
            "d_params": d_params, "batches": batches,
            "new_G": _np(new_G.params), "new_D": _np(new_D.params),
            "losses": {k: float(v) for k, v in losses.items()}}


def _port_models(g):
    gen = MultibandMelganGenerator(**GEN, use_weight_norm=False)
    gen.load_state_dict(_gen_state_dict(g["g_params"]), strict=True)
    disc = MelganMultiscaleDiscriminator()
    disc.load_state_dict(melgan_discriminator_state_dict_from_jax(
        _np(g["d_params"])), strict=True)
    return gen, disc


def _tbatch(batch):
    """numpy (B, T, C) -> the port's (B, C, T)."""
    return {k: torch.from_numpy(v.transpose(0, 2, 1).copy())
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_discriminator_matches_flax_at_every_scale(g):
    """Scores and all six features of each of the 3 scales (scales 1 and 2
    see the pooled signal, edges included)."""
    y = _rand(3, (2, T_AUDIO, 1), 0.3)
    want_scores, want_feats = jax.jit(g["jdisc"].apply)(
        {"params": g["d_params"]}, jnp.asarray(y))
    _, disc = _port_models(g)
    with torch.no_grad():
        scores, feats = disc(torch.from_numpy(y.transpose(0, 2, 1).copy()))
    assert len(scores) == len(want_scores) == 3
    for s in range(3):
        _close(scores[s].numpy().transpose(0, 2, 1), want_scores[s])
        assert len(feats[s]) == len(want_feats[s]) == 6
        for got, want in zip(feats[s], want_feats[s]):
            _close(got.numpy().transpose(0, 2, 1), want)


def test_pool_counts_the_padding_like_flax():
    """AvgPool1d(4, 2, padding 1, count_include_pad=True) = flax avg_pool
    with padding (1, 1): the edge windows divide by 4, not by 3."""
    x = np.arange(1, 11, dtype=np.float32).reshape(1, 10, 1)
    want = fnn.avg_pool(jnp.asarray(x), (4,), strides=(2,), padding=[(1, 1)])
    got = MelganMultiscaleDiscriminator(num_scales=1).pool(
        torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want,
                               rtol=0, atol=1e-6)
    assert float(got[0, 0, 0]) == pytest.approx((1 + 2 + 3) / 4)


def test_pqmf_analysis_matches_tts_tpu():
    y = _rand(4, (2, T_AUDIO, 1), 0.3)
    want = JPQMF(N=4).analysis(jnp.asarray(y))
    got = PQMF(N=4).analysis(torch.from_numpy(y.transpose(0, 2, 1).copy()))
    assert got.dtype == torch.float32
    _close(got.numpy().transpose(0, 2, 1), want)
    # analysis then synthesis gives the signal back, away from the edges
    back = PQMF(N=4).synthesis(got)[0, 0, 256:-256].numpy()
    assert np.abs(back - y[0, 256:-256, 0]).max() < 0.02


def test_losses_match_tts_tpu():
    """Generator loss with every term on (full-band and subband STFT, mse,
    hinge, feature matching), its gradients with respect to the signals,
    scores and features, and discriminator loss (mse and hinge)."""
    y_hat, y = _rand(5, (2, T_AUDIO, 1), 0.3), _rand(6, (2, T_AUDIO, 1), 0.3)
    sub_hat, sub = _rand(7, (2, 512, 4), 0.3), _rand(8, (2, 512, 4), 0.3)
    scores_f = [_rand(9 + i, (2, 8 >> i, 1)) for i in range(3)]
    scores_r = [_rand(12 + i, (2, 8 >> i, 1)) for i in range(3)]
    feats_f = [[_rand(20 + 3 * i + j, (2, 16 >> j, 4)) for j in range(3)]
               for i in range(3)]
    feats_r = [[_rand(40 + 3 * i + j, (2, 16 >> j, 4)) for j in range(3)]
               for i in range(3)]
    flags = dict(use_stft_loss=True, use_subband_stft_loss=True,
                 use_mse_gan_loss=True, use_hinge_gan_loss=True,
                 use_feat_match_loss=True)

    def ncw(a):
        return torch.from_numpy(a.transpose(0, 2, 1).copy())

    def j_loss(y_hat, scores_f, feats_f, sub_hat):
        out = JL.generator_loss(y_hat, y, scores_fake=scores_f,
                                feats_fake=feats_f, feats_real=feats_r,
                                y_hat_sub=sub_hat, y_sub=sub, **flags)
        return out["G_loss"], out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        y_hat, scores_f, feats_f, sub_hat)
    leaves = {"y_hat": ncw(y_hat), "sub_hat": ncw(sub_hat),
              "scores": [ncw(s) for s in scores_f],
              "feats": [[ncw(f) for f in ff] for ff in feats_f]}
    for t in jax.tree_util.tree_leaves(leaves):
        t.requires_grad_()
    got = L.generator_loss(
        leaves["y_hat"], ncw(y), scores_fake=leaves["scores"],
        feats_fake=leaves["feats"],
        feats_real=[[ncw(f) for f in ff] for ff in feats_r],
        y_hat_sub=leaves["sub_hat"], y_sub=ncw(sub), **flags)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=TOL, err_msg=key)
    got["G_loss"].backward()
    port_grads = [leaves["y_hat"], leaves["scores"], leaves["feats"],
                  leaves["sub_hat"]]
    for t, w in zip(jax.tree_util.tree_leaves(port_grads),
                    jax.tree_util.tree_leaves(want_grads)):
        _close(t.grad.numpy().transpose(0, 2, 1), w, tol=GRAD_TOL)
    want = JL.discriminator_loss([jnp.asarray(s) for s in scores_f],
                                 [jnp.asarray(s) for s in scores_r],
                                 use_hinge_gan_loss=True)
    got = L.discriminator_loss([ncw(s) for s in scores_f],
                               [ncw(s) for s in scores_r],
                               use_hinge_gan_loss=True)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=TOL, err_msg=key)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _step(gen, disc, gkw=GKW, **kw):
    return GANTrainStep(gen, disc, make_optimizer(gen, lr=LR, grad_clip=CLIP),
                        make_optimizer(disc, lr=LR, grad_clip=CLIP),
                        hop_len=256, conv_pad=0, use_pqmf=True,
                        gen_loss_kwargs=gkw, disc_loss_kwargs=DKW, **kw)


def test_train_step_matches_tts_tpu(g):
    """One step with the discriminator on (generator update with frozen D,
    then D update on its own batch with y_hat from the updated G) against
    one jitted tts_tpu step: losses, then both networks' parameters."""
    gen, disc = _port_models(g)
    before = {"G": {n: p.detach().clone() for n, p in gen.named_parameters()},
              "D": {n: p.detach().clone()
                    for n, p in disc.named_parameters()}}
    losses = _step(gen, disc)(_tbatch(g["batches"]["G"]),
                              _tbatch(g["batches"]["D"]), train_disc=True)
    assert set(losses) == set(g["losses"])
    for key, want in g["losses"].items():
        np.testing.assert_allclose(losses[key], want, rtol=TOL, err_msg=key)
    wants = {"G": _gen_state_dict(g["new_G"]),
             "D": melgan_discriminator_state_dict_from_jax(g["new_D"])}
    for side, model in (("G", gen), ("D", disc)):
        named = dict(model.named_parameters())
        assert set(named) == set(wants[side])
        moved = 0
        for name, p in named.items():
            p0 = before[side][name].numpy()
            delta = p.detach().numpy() - p0
            want = wants[side][name].numpy() - p0
            moved += bool(np.abs(want).max() > 0)
            # plus 4 float32 ulps of the parameter: an update below that
            # (the vanishing gradients of the first layers of scales 1-2)
            # rounds away in both packages
            atol = (UPDATE_TOL * float(np.abs(want).max())
                    + 4 * np.finfo(np.float32).eps * float(np.abs(p0).max()))
            np.testing.assert_allclose(delta, want, rtol=0, atol=atol,
                                       err_msg=f"{side} {name}")
        assert moved > len(named) // 2, (side, moved)


def test_warmup_and_mixed_precision_steps(g):
    """Port-only, with the config's losses (both STFT losses and mse): a
    warmup step updates G alone and reports the STFT losses only; a
    mixed-precision step (bf16 forwards, f32 masters) gives finite losses
    and moves both networks' float32 parameters."""
    gen, disc = _port_models(g)
    gkw = dict(use_stft_loss=True, use_mse_gan_loss=True)
    bG, bD = _tbatch(g["batches"]["G"]), _tbatch(g["batches"]["D"])
    d0 = {n: p.detach().clone() for n, p in disc.named_parameters()}
    losses = _step(gen, disc, gkw)(bG, bD, train_disc=False)
    assert set(losses) == {"G_stft_loss_sc", "G_stft_loss_mag",
                           "G_subband_stft_loss_sc",
                           "G_subband_stft_loss_mag", "G_loss"}
    assert all(torch.equal(p, d0[n]) for n, p in disc.named_parameters())

    g0 = {n: p.detach().clone() for n, p in gen.named_parameters()}
    losses = _step(gen, disc, gkw, mixed_precision=True)(bG, bD,
                                                         train_disc=True)
    assert "D_loss" in losses and "G_mse_fake_loss" in losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    for model, init in ((gen, g0), (disc, d0)):
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert any(not torch.equal(p, init[n])
                   for n, p in model.named_parameters())
