"""The port's data-parallel layer against tts_tpu's, on the CPU.

Sharding: ``data/sampler.py::shard_indices``, both datasets' shards and the
Glow trainer's contiguous part of a batch against tts_tpu's, item for item;
``gradual_training_schedule(num_replicas)`` against tts_tpu's.

The steps: this file, run as a script, is one rank of a gloo world of 2 on
the CPU (no JAX there); the module fixture starts both ranks once, and
while they run computes tts_tpu's side on a 2-device slice of conftest's 8
CPU devices. Each rank runs, from numpy-seeded tts_tpu parameters carried
over by ``compat/from_jax.py``:

- the Tacotron2 DP step (small widths, eval mode, items of one length),
  against ``tts_tpu.parallel.make_dp_train_step`` on the 2-device mesh and
  against the port's single-process step on the whole batch;
- the Glow DP step against ``make_glow_dp_train_step``;
- the GAN DP step (a narrow MelGAN, the multiscale discriminator) against
  ``make_gan_train_step(mesh=...)``;
- 3 train-mode steps of each (dropout from each rank's generator), after
  which the two ranks' parameters and buffers must be bitwise equal, and
  the Tacotron2 BatchNorm statistics after the first must be the mean of
  what each rank's batch alone gives;
- the refusal of a batch the world does not divide.

Tolerances are tts_tpu's own (``tests/test_distributed.py``): losses rtol
1e-5, parameters atol 1e-6 rtol 1e-4 (learning rate 1e-3).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SEED = 5
LOSS_RTOL, ATOL, RTOL = 1e-5, 1e-6, 1e-4
OPT = dict(lr=1e-3, grad_clip=5.0)
# Tacotron2 (reduced as in test_torch_port_tacotron2.py) and Glow (as in
# test_torch_port_glow_train.py); uniform lengths
N_CHARS = 40
TACO = dict(r=2, r_init=3, encoder_dim=64, embedding_dim=64, attn_dim=32)
TACO_B, TACO_TEXT, TACO_MEL = 4, 12, 16
GLOW = dict(num_chars=40, hidden_channels_enc=32, hidden_channels_dec=32,
            filter_channels=64, filter_channels_dp=32, num_layers_enc=2,
            num_flow_blocks_dec=2, num_block_layers=2)
GLOW_B, GLOW_TEXT, GLOW_MEL = 4, 13, 40
# a narrow MelGAN (tests/test_distributed.py's) and the discriminator
GEN = dict(base_channels=16, num_res_blocks=1, upsample_factors=(4, 4))
HOP, GAN_B, GAN_FRAMES = 16, 4, 8
GKW = dict(use_stft_loss=False, use_subband_stft_loss=False,
           use_mse_gan_loss=True, use_feat_match_loss=True)
DKW = dict(use_mse_gan_loss=True)
TRAIN_STEPS = 3


# ---------------------------------------------------------------------------
# one rank of the spawned world (runs without JAX)
# ---------------------------------------------------------------------------

def _port_gan(inputs, mesh):
    from tts_tpu_torch.models.vocoder.melgan import (
        MelganGenerator, MelganMultiscaleDiscriminator)
    from tts_tpu_torch.train.gan import GANTrainStep
    from tts_tpu_torch.train.optim import make_optimizer
    gen = MelganGenerator(**GEN, use_weight_norm=False)
    gen.load_state_dict(inputs["gan"]["G"])
    disc = MelganMultiscaleDiscriminator(num_scales=2)
    disc.load_state_dict(inputs["gan"]["D"])
    step = GANTrainStep(gen, disc, make_optimizer(gen, **OPT),
                        make_optimizer(disc, **OPT), hop_len=HOP,
                        conv_pad=0, gen_loss_kwargs=GKW,
                        disc_loss_kwargs=DKW, mesh=mesh)
    return gen, disc, step


def _state(*modules):
    return [{k: v.detach().clone() for k, v in m.state_dict().items()}
            for m in modules]


def worker(rank: int, world: int, url: str, workdir: str) -> None:
    """Every DP step of the file on this rank's part; writes
    ``rank<r>.pt``."""
    torch.set_num_threads(1)
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    from tts_tpu_torch.parallel import (make_dp_train_step,
                                        make_glow_dp_train_step, make_mesh)
    from tts_tpu_torch.parallel.data_parallel import running_stats, \
        shard_batch
    from tts_tpu_torch.parallel.mesh import (finalize, host_local_to_global,
                                             initialize_multihost,
                                             local_batch_slice)
    from tts_tpu_torch.train.optim import make_optimizer

    initialize_multihost(url, world, rank, device="cpu", timeout_s=120)
    mesh = make_mesh((("data", -1),))
    inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    out = {}

    def taco():
        m = Tacotron2(num_chars=N_CHARS, **TACO)
        m.load_state_dict(inputs["taco"]["state"])
        return m

    def glow():
        m = GlowTTS(**GLOW)
        m.load_state_dict(inputs["glow"]["state"])
        return m

    for name, build, maker, kw in (
            ("taco", taco, make_dp_train_step, dict(loss_kwargs={"r": 2})),
            ("glow", glow, make_glow_dp_train_step, {})):
        batch = shard_batch(inputs[name]["batch"], mesh)
        m = build()
        step = maker(m, make_optimizer(m, **OPT), mesh, train=False, **kw)
        out[name] = {"losses": step(batch), "state": _state(m)[0]}
        m = build()
        step = maker(m, make_optimizer(m, **OPT), mesh, seed=SEED,
                     train=True, **kw)
        for i in range(TRAIN_STEPS):
            step(batch)
            if i == 0:
                out[name]["stats_after_first"] = [
                    t.clone() for t in running_stats(m)]
        out[name]["train_state"] = _state(m)[0]

    gb = {side: shard_batch(inputs["gan"]["batch"][side], mesh)
          for side in "GD"}
    gen, disc, step = _port_gan(inputs, mesh)
    out["gan"] = {"losses": step(gb["G"], gb["D"], train_disc=True),
                  "state": _state(gen, disc)}
    for _ in range(TRAIN_STEPS - 1):
        step(gb["G"], gb["D"], train_disc=True)
    out["gan"]["train_state"] = _state(gen, disc)

    try:
        shard_batch({"x": torch.zeros(3, 2)}, mesh)
    except ValueError as e:
        out["refused"] = str(e)
    out["gathered"] = host_local_to_global(
        {"x": torch.full((2, 3), float(rank)), "n": torch.tensor(7)},
        mesh)
    out["slice"] = local_batch_slice(8)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finalize()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the reference side (the pytest process; JAX from here on)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tests.fixtures import make_ljspeech_fixture  # noqa: E402
from tests.test_torch_port_tacotron2 import jax_variables  # noqa: E402
from tests.torch_port_params import module_params  # noqa: E402
from tts_tpu import parallel as JP  # noqa: E402
from tts_tpu.data.sampler import shard_indices as j_shard_indices  # noqa
from tts_tpu.parallel.data_parallel import shard_batch as j_shard  # noqa
from tts_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa
from tts_tpu_torch.compat.from_jax import (  # noqa: E402
    glow_tts_state_dict_from_jax, melgan_discriminator_state_dict_from_jax,
    melgan_state_dict_from_jax, tacotron2_state_dict_from_jax)
from tts_tpu_torch.data.sampler import shard_indices  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _taco_batch():
    rng = np.random.default_rng(11)
    stop = np.zeros((TACO_B, TACO_MEL // TACO["r"]), np.float32)
    stop[:, -1] = 1.0
    return {"text": rng.integers(1, N_CHARS, (TACO_B, TACO_TEXT)
                                 ).astype(np.int32),
            "text_lengths": np.full(TACO_B, TACO_TEXT, np.int32),
            "mel": rng.standard_normal((TACO_B, TACO_MEL, 80)
                                       ).astype(np.float32),
            "mel_lengths": np.full(TACO_B, TACO_MEL, np.int32),
            "stop_targets": stop}


def _glow_batch():
    rng = np.random.default_rng(1)
    return {"text": rng.integers(1, GLOW["num_chars"], (GLOW_B, GLOW_TEXT)
                                 ).astype(np.int32),
            "text_lengths": np.full(GLOW_B, GLOW_TEXT, np.int32),
            "mel": rng.standard_normal((GLOW_B, GLOW_MEL, 80)
                                       ).astype(np.float32),
            "mel_lengths": np.full(GLOW_B, GLOW_MEL, np.int32)}


def _gan_batches():
    out = {}
    for side, seed in (("G", 10), ("D", 20)):
        rng = np.random.default_rng(seed)
        out[side] = {"mel": rng.standard_normal((GAN_B, GAN_FRAMES, 80)
                                                ).astype(np.float32),
                     "audio": (0.3 * rng.standard_normal(
                         (GAN_B, GAN_FRAMES * HOP, 1))).astype(np.float32)}
    return out


def _ncw(batch):
    """tts_tpu's (B, T, C) -> the port's (B, C, T)."""
    return {k: torch.from_numpy(v.transpose(0, 2, 1).copy())
            for k, v in batch.items()}


def _glow_port_batch(b):
    out = _t(b)
    out["text"] = out["text"].long()
    out["mel"] = out["mel"].transpose(1, 2).contiguous()
    return out


def _gen_state_dict(params):
    sd = melgan_state_dict_from_jax(_np(params), GEN["upsample_factors"],
                                    GEN["num_res_blocks"])
    return {k.replace("weight_v", "weight"): v for k, v in sd.items()
            if not k.endswith("weight_g")}


def _spawn(workdir):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    url = "file://" + os.path.join(workdir, "store")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD), url,
         workdir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' outputs, tts_tpu's results and the inputs."""
    from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
    from tts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
    from tts_tpu.models.vocoder.melgan import \
        MelganGenerator as JGen
    from tts_tpu.models.vocoder.melgan import \
        MelganMultiscaleDiscriminator as JDisc
    from tts_tpu.train.gan import GState, make_gan_train_step
    from tts_tpu.train.state import TrainState

    workdir = str(tmp_path_factory.mktemp("dp_world"))
    jtaco = JTacotron2(num_chars=N_CHARS, **TACO)
    t_params, t_stats = jax_variables(jtaco)
    jglow = JGlowTTS(**GLOW)
    g_params = module_params(jglow, 0, jnp.zeros((1, 8), jnp.int32),
                             jnp.array([8], jnp.int32),
                             jnp.zeros((1, 12, 80)),
                             jnp.array([12], jnp.int32), train=False)
    jgen, jdisc = JGen(**GEN, use_weight_norm=False), JDisc(num_scales=2)
    gen_params = module_params(jgen, 2, jnp.zeros((1, GAN_FRAMES, 80)))
    disc_params = module_params(jdisc, 3,
                                jnp.zeros((1, GAN_FRAMES * HOP, 1)))
    batches = {"taco": _taco_batch(), "glow": _glow_batch(),
               **_gan_batches()}
    taco_batch = _t(batches["taco"])
    taco_batch["text"] = taco_batch["text"].long()
    inputs = {
        "taco": {"state": tacotron2_state_dict_from_jax(t_params, t_stats),
                 "batch": taco_batch},
        "glow": {"state": glow_tts_state_dict_from_jax(g_params),
                 "batch": _glow_port_batch(batches["glow"])},
        "gan": {"G": _gen_state_dict(gen_params),
                "D": melgan_discriminator_state_dict_from_jax(
                    _np(disc_params)),
                "batch": {s: _ncw(batches[s]) for s in "GD"}},
    }
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    procs = _spawn(workdir)
    try:
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
        rng = jax.random.PRNGKey(0)
        want = {}
        jb = {k: jnp.asarray(v) for k, v in batches["taco"].items()}
        state = TrainState.create(apply_fn=jtaco.apply, params=t_params,
                                  batch_stats=t_stats,
                                  tx=j_make_optimizer(**OPT))
        s2, losses = JP.make_dp_train_step(jtaco, mesh, {"r": 2},
                                           train=False)(
            JP.replicate(state, mesh), j_shard(jb, mesh), rng)
        want["taco"] = {"loss": float(losses["loss"]),
                        "grad_norm": float(losses["grad_norm"]),
                        "state": tacotron2_state_dict_from_jax(
                            _np(s2.params), _np(s2.batch_stats))}
        tx = j_make_optimizer(**OPT)
        jb = {k: jnp.asarray(v) for k, v in batches["glow"].items()}
        step = JP.make_glow_dp_train_step(jglow, tx, mesh, train=False)
        p2, _, losses = step(JP.replicate(g_params, mesh),
                             JP.replicate(tx.init(g_params), mesh),
                             j_shard(jb, mesh), rng)
        want["glow"] = {"loss": float(losses["loss"]),
                        "state": glow_tts_state_dict_from_jax(_np(p2))}
        sg = GState.create(apply_fn=jgen.apply, params=gen_params, tx=tx)
        sd = GState.create(apply_fn=jdisc.apply, params=disc_params, tx=tx)
        step = make_gan_train_step(jgen, jdisc, hop_len=HOP, conv_pad=0,
                                   train_disc=True, gen_loss_kwargs=GKW,
                                   disc_loss_kwargs=DKW, mesh=mesh)
        jbg = {s: {k: jnp.asarray(v) for k, v in batches[s].items()}
               for s in "GD"}
        sg2, sd2, losses = step(JP.replicate(sg, mesh),
                                JP.replicate(sd, mesh),
                                j_shard(jbg["G"], mesh),
                                j_shard(jbg["D"], mesh), rng)
        want["gan"] = {"losses": {k: float(v) for k, v in losses.items()},
                       "state": [_gen_state_dict(_np(sg2.params)),
                                 melgan_discriminator_state_dict_from_jax(
                                     _np(sd2.params))]}
        for p in procs:
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"))
             for r in range(WORLD)]
    return {"ranks": ranks, "want": want, "inputs": inputs}


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shards", [(8, 2), (7, 2), (10, 4), (3, 4),
                                      (1, 3)])
def test_shard_indices_matches_tts_tpu(n, shards):
    idxs = list(np.random.default_rng(n).permutation(n))
    for r in range(shards):
        assert shard_indices(idxs, shards, r) == j_shard_indices(
            idxs, shards, r)


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_gradual_schedule_scales_the_step_as_tts_tpu(replicas):
    from tts_tpu.train.optim import gradual_training_schedule as j_sched
    from tts_tpu_torch.train.optim import gradual_training_schedule
    sched = [[0, 7, 64], [10, 5, 64], [50, 3, 32], [130, 2, 32]]
    for step in range(0, 160, 3):
        assert gradual_training_schedule(step, sched, replicas) == j_sched(
            step, sched, replicas), step


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    from tts_tpu.audio import AudioProcessor as JAudioProcessor
    from tts_tpu.data import TTSDataset as JTTSDataset
    from tts_tpu.data import load_meta_data as j_load_meta_data
    from tts_tpu_torch.audio import AudioProcessor
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.data import TTSDataset, load_meta_data
    tmp = tmp_path_factory.mktemp("shards")
    corpus = make_ljspeech_fixture(str(tmp / "lj"), n_items=11)
    c = load_config(os.path.join(ROOT, "configs", "glow_tts_ljspeech.json"))
    sets = [{"name": "ljspeech", "path": corpus,
             "meta_file_train": "metadata.csv"}]
    kw = dict(outputs_per_step=2, text_cleaner=c["text_cleaner"],
              use_phonemes=False)
    items, _ = load_meta_data(sets)
    j_items, _ = j_load_meta_data(sets)
    return (TTSDataset(AudioProcessor(**c["audio"]), items, **kw),
            JTTSDataset(JAudioProcessor(**c["audio"]), j_items, **kw))


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_tts_dataset_shards_match_tts_tpu(datasets, shards):
    """Each shard's batches hold tts_tpu's items in tts_tpu's order."""
    ds, jds = datasets
    for r in range(shards):
        got = [b["item_idxs"] for b in ds.batches(2, num_shards=shards,
                                                  shard_id=r)]
        want = [b["item_idxs"] for b in jds.batches(2, num_shards=shards,
                                                    shard_id=r)]
        assert got == want and got, (r, got, want)


def test_glow_part_of_a_batch_is_tts_tpus_device_rows(datasets):
    """The Glow trainer's part r of a global batch: the rows that
    tts_tpu's shard_batch gives device r of the collated batch."""
    ds, jds = datasets
    want = [b["item_idxs"] for b in jds.batches(4)]
    for part in range(2):
        rows = [ds.part_of_batch(sel, part, 2)
                for sel in ds.batch_indices(4)]
        got = [b["item_idxs"] for b in ds.batches(4, part=part, parts=2)]
        assert len(got) == len(want) == 2
        for b in range(len(want)):
            assert got[b] == [ds.items[i][1] for i in rows[b]] == \
                want[b][2 * part:2 * part + 2]
    with pytest.raises(ValueError):
        next(iter(ds.batches(4, part=0, parts=3)))


@pytest.mark.parametrize("shards", [1, 2])
def test_gan_dataset_shards_match_tts_tpu(shards):
    from tts_tpu.data.gan_dataset import GANDataset as JGANDataset
    from tts_tpu_torch.data.gan_dataset import GANDataset

    def ids(cls):
        class Ids(cls):
            def __getitem__(self, i):
                return {"audio": np.array([[i]]), "mel": np.array([[i]])}
        ds = Ids.__new__(Ids)
        ds.items = list(range(9))
        ds.G_to_D_mappings = list(range(9))[::-1]
        return ds

    for r in range(shards):
        got = [{s: b[s]["audio"].ravel().tolist() for s in "GD"}
               for b in GANDataset.batches(ids(GANDataset), 2, seed=3,
                                           num_shards=shards, shard_id=r)]
        jds = ids(JGANDataset)
        jds.is_training, jds.return_segments = True, True
        want = [{s: b[s]["audio"].ravel().tolist() for s in "GD"}
                for b in jds.batches(2, seed=3, num_shards=shards,
                                     shard_id=r)]
        assert got == want and got, (r, got, want)


# ---------------------------------------------------------------------------
# the steps at a world of 2
# ---------------------------------------------------------------------------

def _assert_state_close(got, want, names=None):
    for name in names or want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_tacotron2_dp_step_matches_tts_tpu_and_the_single_step(run):
    """Losses, grad_norm, parameters and BatchNorm statistics after one
    eval-mode step, on both ranks."""
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    from tts_tpu_torch.train.optim import make_optimizer
    from tts_tpu_torch.train.trainer_tts import train_step
    want = run["want"]["taco"]
    single = Tacotron2(num_chars=N_CHARS, **TACO)
    single.load_state_dict(run["inputs"]["taco"]["state"])
    one = train_step(single.eval(), make_optimizer(single, **OPT),
                     run["inputs"]["taco"]["batch"], {"r": 2})
    for rank in run["ranks"]:
        got = rank["taco"]
        np.testing.assert_allclose(got["losses"]["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"]["loss"], one["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"]["grad_norm"],
                                   want["grad_norm"], rtol=1e-4)
        assert any(k.endswith("running_var") for k in want["state"])
        _assert_state_close(got["state"], want["state"])
        _assert_state_close(got["state"], single.state_dict())


def test_glow_dp_step_matches_tts_tpu(run):
    want = run["want"]["glow"]
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank["glow"]["losses"]["loss"],
                                   want["loss"], rtol=LOSS_RTOL)
        _assert_state_close(rank["glow"]["state"], want["state"])


def test_gan_dp_step_matches_tts_tpu(run):
    want = run["want"]["gan"]
    for rank in run["ranks"]:
        got = rank["gan"]
        assert set(got["losses"]) == set(want["losses"])
        for key, value in want["losses"].items():
            np.testing.assert_allclose(got["losses"][key], value,
                                       rtol=LOSS_RTOL, err_msg=key)
        for side in range(2):
            _assert_state_close(got["state"][side], want["state"][side])


@pytest.mark.parametrize("name", ["taco", "glow", "gan"])
def test_ranks_stay_bitwise_equal_in_train_mode(run, name):
    a, b = (r[name]["train_state"] for r in run["ranks"])
    for sa, sb in ([(a, b)] if name != "gan" else zip(a, b)):
        assert set(sa) == set(sb)
        moved = 0
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
        init = (run["inputs"][name]["state"] if name != "gan" else None)
        if init is not None:
            moved = sum(not torch.equal(sa[k], init[k]) for k in init)
            assert moved > len(init) // 2, moved


def test_batchnorm_statistics_are_the_ranks_mean(run):
    """After the first train-mode step, each BatchNorm's running statistics
    are the mean of what each rank's part, with its rank's dropout masks,
    gives alone (no SyncBatchNorm: each rank normalises by its own
    batch)."""
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    from tts_tpu_torch.parallel.data_parallel import (rank_seed,
                                                      running_stats)
    from tts_tpu_torch.train.trainer_tts import forward
    batch = run["inputs"]["taco"]["batch"]
    per = TACO_B // WORLD
    stats = []
    for r in range(WORLD):
        m = Tacotron2(num_chars=N_CHARS, **TACO)
        m.load_state_dict(run["inputs"]["taco"]["state"])
        m.set_generator(torch.Generator().manual_seed(rank_seed(SEED, r)))
        with torch.no_grad():
            forward(m.train(), {k: v[r * per:(r + 1) * per]
                                for k, v in batch.items()})
        stats.append(running_stats(m))
    got = run["ranks"][0]["taco"]["stats_after_first"]
    assert len(got) == len(stats[0]) > 0
    for i, g in enumerate(got):
        want = sum(s[i] for s in stats) / WORLD
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)
        assert not torch.allclose(stats[0][i], stats[1][i])


def test_a_batch_the_world_does_not_divide_is_refused(run):
    for rank in run["ranks"]:
        assert "does not split over 2 ranks" in rank["refused"]


def test_host_local_batches_gather_in_rank_order(run):
    """host_local_to_global: each rank's local rows, in rank order, on
    every rank (scalars kept); local_batch_slice: (per rank, offset)."""
    want = torch.cat([torch.full((2, 3), float(r)) for r in range(WORLD)])
    for r, rank in enumerate(run["ranks"]):
        assert torch.equal(rank["gathered"]["x"], want)
        assert int(rank["gathered"]["n"]) == 7
        assert rank["slice"] == (8 // WORLD, r * 8 // WORLD)
