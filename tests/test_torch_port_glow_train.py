"""Glow-TTS training in the port against tts_tpu, on the CPU.

A small Glow (2 encoder layers, hidden 32, 2 flow blocks of 2 WN layers)
with numpy-seeded tts_tpu parameters, carried over by
``glow_tts_state_dict_from_jax``; the same numpy inputs go through both
packages, in eval mode (dropout off; tts_tpu with ``train=False``), with
TF32 off. Tolerances, all float32 with a different summation order in the
two packages:

- single flows, DDI statistics, forward outputs and losses: 1e-4 relative
  to the largest reference magnitude (absolute for the losses);
- gradients: 1e-4 relative to each tensor's largest reference gradient
  (backward through 2 flows and 2 attention layers adds rounding);
- parameters after optimizer steps: 1e-6 absolute (updates are at most
  ~1e-3, their rounding far below);
- the alignment (0/1) and collated batches: exact.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tts_tpu.audio import AudioProcessor as JAudioProcessor
from tts_tpu.data import TTSDataset as JTTSDataset
from tts_tpu.data import load_meta_data as j_load_meta_data
from tts_tpu.models.glow.flows import ActNorm as JActNorm
from tts_tpu.models.glow.flows import CouplingBlock as JCouplingBlock
from tts_tpu.models.glow.flows import InvConvNear as JInvConvNear
from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.models.glow_tts import apply_ddi as j_apply_ddi
from tts_tpu.models.glow_tts import glow_tts_loss as j_glow_tts_loss
from tts_tpu.train.optim import make_optimizer as j_make_optimizer
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.compat.from_jax import glow_tts_state_dict_from_jax
from tts_tpu_torch.data import TTSDataset, load_meta_data
from tts_tpu_torch.models.glow_tts import GlowTTS, apply_ddi, glow_tts_loss
from tts_tpu_torch.train.optim import decay_mask, make_optimizer
from tts_tpu_torch.train.trainer_glow import batch_to_device, train_step

from tests.fixtures import make_ljspeech_fixture
from tests.torch_port_params import module_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_chars=40, hidden_channels_enc=32, hidden_channels_dec=32,
          filter_channels=64, filter_channels_dp=32, num_layers_enc=2,
          num_flow_blocks_dec=2, num_block_layers=2)
TOL = 1e-4
# optimizer settings of the optimizer and train-step tests: noam warmup 3 and
# weight decay on, so that both reach every term of the chain
OPT = dict(lr=1e-3, grad_clip=5.0, weight_decay=0.01, use_noam=True,
           warmup_steps=3)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, rtol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1.0))


def _ncw(x):
    return np.asarray(x).transpose(0, 2, 1)


def _port_model(params, **kw):
    m = GlowTTS(**KW, **kw)
    m.load_state_dict(glow_tts_state_dict_from_jax(params), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def g():
    jm = JGlowTTS(**KW)
    params = module_params(jm, 0, jnp.zeros((1, 8), jnp.int32),
                           jnp.array([8], jnp.int32), jnp.zeros((1, 12, 80)),
                           jnp.array([12], jnp.int32), train=False)
    rng = np.random.default_rng(1)
    np_batch = {
        "text": rng.integers(1, KW["num_chars"], size=(3, 13)).astype(np.int32),
        "text_lengths": np.array([13, 9, 4], np.int32),
        "mel": rng.standard_normal((3, 40, 80)).astype(np.float32),
        "mel_lengths": np.array([40, 31, 17], np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}

    def loss_fn(p, batch):
        out = jm.apply({"params": p}, batch["text"], batch["text_lengths"],
                       batch["mel"], batch["mel_lengths"], train=False)
        losses = j_glow_tts_loss(out, batch["text_lengths"])
        return losses["loss"], (losses, out)

    # one jit each: loss, outputs and gradients; the optax init; one
    # optimizer step (tx.update, then apply_updates)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (losses, out)), grads = grad_fn(params, jb)
    tx = j_make_optimizer(**OPT)

    def opt_step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    return {"jm": jm, "params": params, "np_batch": np_batch, "jb": jb,
            "grad_fn": grad_fn, "losses": losses, "out": out, "grads": grads,
            "tb": batch_to_device(np_batch, torch.device("cpu")),
            "opt_init": jax.jit(tx.init), "opt_step": jax.jit(opt_step)}


def _port_forward(model, tb):
    out = model(tb["text"], tb["text_lengths"], tb["mel"], tb["mel_lengths"])
    return out, glow_tts_loss(out, tb["text_lengths"])


# ---------------------------------------------------------------------------
# flows, DDI, forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index,kind", [(0, "actnorm"), (1, "invconv"),
                                        (2, "coupling")])
def test_flow_forward(g, index, kind):
    """Each flow's forward output and logdet on squeezed-width input."""
    C = 160
    jmod = {"actnorm": JActNorm(channels=C),
            "invconv": JInvConvNear(channels=C, n_split=4),
            "coupling": JCouplingBlock(in_channels=C, hidden_channels=32,
                                       num_layers=2)}[kind]
    rng = np.random.default_rng(10 + index)
    x = rng.standard_normal((2, 20, C)).astype(np.float32)
    mask = np.ones((2, 20, 1), np.float32)
    mask[1, 13:] = 0
    kw = {"train": False} if kind == "coupling" else {}
    want_z, want_ld = jmod.apply(
        {"params": g["params"]["decoder"][f"{kind}_0"]}, jnp.asarray(x),
        jnp.asarray(mask), **kw)
    flow = _port_model(g["params"]).decoder.flows[index]
    with torch.no_grad():
        z, ld = flow(torch.from_numpy(_ncw(x).copy()),
                     torch.from_numpy(_ncw(mask).copy()))
    _close(_ncw(z.numpy()), want_z)
    _close(ld.numpy(), want_ld)


def test_ddi_matches_apply_ddi(g):
    """tts_tpu's apply_ddi runs with train=True: its decoder is built with
    dropout 0 here, so both sides see the same flow inputs."""
    jm = JGlowTTS(**KW, dropout_rate=0.0, dropout_rate_dec=0.0)
    ddi = jax.jit(lambda p, b, key: j_apply_ddi(jm, {"params": p}, b, key))
    want = ddi(g["params"], g["jb"], jax.random.PRNGKey(0))["params"]
    want = want["decoder"]
    model = _port_model(g["params"])
    with torch.no_grad():
        apply_ddi(model, g["tb"])
    for i in range(KW["num_flow_blocks_dec"]):
        actnorm = model.decoder.flows[3 * i]
        assert actnorm.initialized
        for name in ("logs", "bias"):
            _close(getattr(actnorm, name).detach().numpy()[0, :, 0],
                   want[f"actnorm_{i}"][name])


def test_forward_and_loss_match(g):
    with torch.no_grad():
        out, losses = _port_forward(_port_model(g["params"]), g["tb"])
    want = g["out"]
    # the alignment first: a flipped decision would move every later value
    np.testing.assert_array_equal(out["alignments"].numpy(),
                                  np.asarray(want["alignments"]))
    for key in ("z", "y_mean", "o_attn_dur", "o_dur_log"):
        _close(_ncw(out[key].numpy()), want[key])
    _close(out["logdet"].numpy(), want["logdet"])
    np.testing.assert_array_equal(out["y_lengths"].numpy(),
                                  np.asarray(want["y_lengths"]))
    for key in ("log_mle", "loss_dur", "loss"):
        np.testing.assert_allclose(float(losses[key]),
                                   float(g["losses"][key]), rtol=0, atol=TOL)


def test_gradients_match_jax_grad(g):
    model = _port_model(g["params"])
    _, losses = _port_forward(model, g["tb"])
    losses["loss"].backward()
    want = glow_tts_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               g["grads"]))
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _close(p.grad.numpy(), want[name].numpy())


def test_dropout_draws_from_the_model_generator(g):
    """Train mode: masks come from the generator given to set_generator
    (same seed, same loss; another seed, another loss), kept values are
    scaled by 1 / (1 - rate); eval mode is deterministic and dropout-free."""
    model = _port_model(g["params"], dropout_rate=0.1, dropout_rate_dec=0.05)

    def loss(seed):
        model.set_generator(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return float(_port_forward(model, g["tb"])[1]["loss"])

    model.train()
    a, b, other = loss(0), loss(0), loss(1)
    assert a == b and a != other
    model.eval()
    np.testing.assert_allclose(loss(0), float(g["losses"]["loss"]),
                               rtol=0, atol=TOL)
    drop = model.encoder.pre.dropout.train()
    drop.generator = torch.Generator().manual_seed(2)
    y = drop(torch.ones(20000))
    kept = y[y != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / (1 - 0.5)))
    assert abs(len(kept) / 20000 - 0.5) < 0.02


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------

def _grad_trees(params, n_steps, seed):
    """Fixed gradients: small (norm < 5) except step 2, whose norm clips,
    and step 4, which holds a nan."""
    rng = np.random.default_rng(seed)
    trees = []
    for step in range(n_steps):
        scale = 1.0 if step == 2 else 1e-3
        tree = jax.tree_util.tree_map(
            lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
            params)
        if step == 4:
            tree["decoder"]["invconv_0"]["weight"][0, 0] = np.nan
        trees.append(tree)
    return trees


def test_optimizer_matches_optax_chain(g):
    """8 steps: noam warmup 3, weight decay on, one clipped step, one
    non-finite step (skipped), and 7 applied steps, so RAdam's rho crosses
    5 (float32 rho_6 = 5.97) and the rectified update runs."""
    params = jax.tree_util.tree_map(np.asarray, g["params"])
    state = g["opt_init"](params)
    model = _port_model(g["params"])
    opt = make_optimizer(model, **OPT)
    named = dict(model.named_parameters())
    applied = []
    for grads in _grad_trees(params, 8, seed=2):
        params, state = g["opt_step"](grads, state, params)
        for name, grad in glow_tts_state_dict_from_jax(grads).items():
            named[name].grad = grad
        applied.append(opt.step())
    assert applied == [True] * 4 + [False] + [True] * 3
    assert opt.count == 7 and opt.total_notfinite == 1
    want = glow_tts_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_decay_mask_follows_tts_tpu_shapes(g):
    """ActNorm (1, C, 1) and weight_g (C, 1, 1) are vectors in tts_tpu."""
    mask = decay_mask(_port_model(g["params"]))
    assert not mask["decoder.flows.0.logs"]
    assert not mask["decoder.flows.0.bias"]
    assert not mask["decoder.flows.2.start.weight_g"]
    assert mask["decoder.flows.2.start.weight_v"]
    assert mask["decoder.flows.1.weight"]
    assert mask["encoder.duration_predictor.proj.weight"]
    assert not mask["encoder.pre.norm_layers.0.gamma"]


def test_train_step_matches_tts_tpu_step(g):
    """Two steps of ``train_step`` against tts_tpu's step function
    (grad of glow_tts_loss, tx.update, apply_updates) with train=False."""
    params = g["params"]
    state = g["opt_init"](params)
    model = _port_model(g["params"])
    opt = make_optimizer(model, **OPT)
    for _ in range(2):
        (_, (want_losses, _)), grads = g["grad_fn"](params, g["jb"])
        params, state = g["opt_step"](grads, state, params)
        losses = train_step(model, opt, g["tb"])
        for key in ("log_mle", "loss_dur", "loss"):
            np.testing.assert_allclose(losses[key], float(want_losses[key]),
                                       rtol=0, atol=TOL)
    want = glow_tts_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_inference_after_training_uses_current_weights(g):
    """The stale-inverse repair: a model whose 1x1 inverses were cached,
    then trained, synthesizes exactly as a fresh model with the new
    weights."""
    model = _port_model(g["params"])
    model.store_inverse()
    text = torch.from_numpy(g["np_batch"]["text"]).long()
    lens = torch.from_numpy(g["np_batch"]["text_lengths"])
    before = model.inference(text, lens, noise_scale=0.0,
                             y_max_length=64)["model_outputs"]
    train_step(model, make_optimizer(model, lr=0.05), g["tb"])
    got = model.inference(text, lens, noise_scale=0.0,
                          y_max_length=64)["model_outputs"]
    fresh = GlowTTS(**KW)
    fresh.load_state_dict(copy.deepcopy(model.state_dict()))
    fresh.eval().store_inverse()
    want = fresh.inference(text, lens, noise_scale=0.0,
                           y_max_length=64)["model_outputs"]
    assert not torch.equal(got, before)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# data and the trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_ljspeech_fixture(str(tmp_path_factory.mktemp("ljspeech")))


def test_collate_matches_tts_tpu(corpus, tmp_path):
    with open(os.path.join(ROOT, "configs", "glow_tts_ljspeech.json")) as f:
        from tts_tpu_torch.config import loads_config
        c = loads_config(f.read())
    datasets = [{"name": "ljspeech", "path": corpus,
                 "meta_file_train": "metadata.csv"}]
    kw = dict(outputs_per_step=2, text_cleaner=c["text_cleaner"],
              use_phonemes=True, min_seq_len=c["min_seq_len"],
              max_seq_len=c["max_seq_len"])
    items, _ = load_meta_data(datasets)
    j_items, _ = j_load_meta_data(datasets)
    assert items == j_items
    ds = TTSDataset(AudioProcessor(**c["audio"]), items,
                    phoneme_cache_path=str(tmp_path / "port"), **kw)
    jds = JTTSDataset(JAudioProcessor(**c["audio"]), j_items,
                      phoneme_cache_path=str(tmp_path / "jax"), **kw)
    got = ds.collate([ds[i] for i in range(len(ds))])
    want = jds.collate([jds[i] for i in range(len(jds))])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_trainer_one_epoch_on_cpu_then_serves(corpus, tmp_path, monkeypatch):
    """The CLI trains the repo config's full widths for one epoch (batch 4)
    on the CPU; the checkpoint serves through the port's Synthesizer. Without
    tensorboardX the trainer logs to the console only."""
    from tts_tpu_torch.bin.train_glow_tts import main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.train.checkpoint import latest_checkpoint
    from tts_tpu_torch.train.trainer_glow import GlowTTSTrainer

    c = load_config(os.path.join(ROOT, "configs", "glow_tts_ljspeech.json"))
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv"}]
    c["phoneme_cache_path"] = str(tmp_path / "phonemes")
    c["batch_size"], c["epochs"] = 4, 1
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    cfg = tmp_path / "glow.json"
    cfg.write_text(json.dumps(c))
    trainer = main(["--config_path", str(cfg), "--output_path",
                    str(tmp_path / "runs"), "--device", "cpu"])
    assert trainer.global_step >= 1
    assert all(np.isfinite(s["loss"]) for s in trainer.step_stats)
    ckpt = latest_checkpoint(trainer.output_path)
    assert ckpt is not None
    # a restored trainer resumes with the same weights and optimizer state
    resumed = GlowTTSTrainer(c, trainer.output_path, device="cpu")
    resumed.restore(ckpt)
    assert resumed.global_step == trainer.global_step
    assert resumed.optimizer.count == trainer.optimizer.count
    for (name, p), q in zip(trainer.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(p, q), name
    for a, b in zip(trainer.optimizer.nu, resumed.optimizer.nu):
        assert torch.equal(a, b)

    voc_cfg = {"generator_model": "multiband_melgan_generator",
               "generator_model_params": {"base_channels": 64,
                                          "upsample_factors": [2, 2, 2, 2],
                                          "num_res_blocks": 2},
               "audio": dict(c["audio"], hop_length=64)}
    voc_path = tmp_path / "melgan.json"
    voc_path.write_text(json.dumps(voc_cfg))
    torch.manual_seed(0)
    torch.save({"model": setup_generator(voc_cfg).state_dict()},
               tmp_path / "melgan.pt")
    synth = Synthesizer(ckpt, str(cfg), str(tmp_path / "melgan.pt"),
                        str(voc_path), device="cpu")
    wav = synth.tts("Hello world.")
    assert wav.ndim == 1 and np.isfinite(wav).all()


def test_trainer_cli_raises_without_cuda(tmp_path, monkeypatch):
    """The trainer runs on CUDA unless --device names another device; with
    no card it raises instead of training on the CPU."""
    from tts_tpu_torch.bin.train_glow_tts import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with open(os.path.join(ROOT, "configs", "glow_tts_ljspeech.json")) as f:
        cfg = tmp_path / "glow.json"
        cfg.write_text(f.read())
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config_path", str(cfg), "--output_path",
              str(tmp_path / "runs")])
