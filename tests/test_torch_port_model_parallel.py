"""The port's data-parallel serving and channel-sharded generator against
tts_tpu's, on the CPU.

This file, run as a script, is one rank of a gloo world of 2 on the CPU (no
JAX there); the module fixture starts both ranks once and, while they run,
computes tts_tpu's side on 2 of conftest's 8 CPU devices. Each rank:

- serves ``tests/test_serving_dp.py``'s small Glow-TTS -> Multiband-MelGAN
  pipeline (noise 0, 24 frames; the duration head pinned to 6 frames a
  symbol, as ``test_torch_port_slice.py`` does, so no length hinges on a
  rounding flip) through ``make_dp_serving`` over a data dim of 2, with the
  port's kernel wrappers (their plain versions on the CPU), against
  ``tts_tpu.infer.serving_dp.make_dp_serving`` with tts_tpu's megakernel in
  interpret mode (as that test runs it): 1e-4 absolute, the slice test's
  tolerance across the packages; and against the port's own pipeline on
  the whole batch in one process, 1e-5;
- runs a MelGAN generator wide enough to shard (base 256, tts_tpu's
  ``TestModelParallelVocoder``) with its convolutions channel-sharded over
  a (data 1, model 2) mesh, against tts_tpu's
  ``make_sharded_generator_forward`` on the same mesh shape: atol 2e-5, as
  ``tests/test_distributed.py``; the sharded layers must be tts_tpu's,
  name for name through the weights bridge;
- refuses a batch the data dim does not divide.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
B, T_TEXT, T_MEL = 8, 16, 24
GLOW = dict(num_chars=32, hidden_channels_enc=32, hidden_channels_dec=32,
            filter_channels=64, filter_channels_dp=32, num_layers_enc=2,
            num_flow_blocks_dec=2, num_block_layers=2,
            rel_attn_window_size=2)
VOC = dict(base_channels=32, num_res_blocks=2, upsample_factors=(2, 2))
WIDE = dict(base_channels=256, num_res_blocks=1, upsample_factors=(4, 4))
WIDE_B, WIDE_FRAMES = 2, 8
SERVE_ATOL, SELF_ATOL, SHARD_ATOL = 1e-4, 1e-5, 2e-5


# ---------------------------------------------------------------------------
# one rank of the spawned world (runs without JAX)
# ---------------------------------------------------------------------------

def port_pipeline(inputs):
    """The port's synthesis function: ids -> Glow (noise 0) -> the
    vocoder's kernel path (plain versions for CPU tensors)."""
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
    from tts_tpu_torch.models.vocoder.multiband_melgan import \
        MultibandMelganGenerator
    from tts_tpu_torch.ops.cuda.fused_melgan import (
        megakernel_generator_apply, pack_generator_params)
    glow = GlowTTS(**GLOW)
    glow.load_state_dict(inputs["glow"])
    glow.eval()
    voc = MultibandMelganGenerator(**VOC)
    voc.load_state_dict(inputs["voc"])
    packed = pack_generator_params(voc, fold_weight_norm(voc.state_dict()),
                                   device="cpu")

    @torch.no_grad()
    def synthesize(text, text_len):
        out = glow.inference(text, text_len, noise_scale=0.0,
                             y_max_length=T_MEL)
        mel = out["model_outputs"].float().contiguous()
        return megakernel_generator_apply(voc, packed, mel)

    return synthesize


def worker(rank: int, world: int, url: str, workdir: str) -> None:
    torch.set_num_threads(1)
    from tts_tpu_torch.infer.serving_dp import make_dp_serving
    from tts_tpu_torch.models.vocoder.melgan import MelganGenerator
    from tts_tpu_torch.parallel import make_mesh
    from tts_tpu_torch.parallel.mesh import finalize, initialize_multihost
    from tts_tpu_torch.parallel.model_parallel import (
        channel_shardings, make_sharded_generator_forward, shard_params)

    initialize_multihost(url, world, rank, device="cpu", timeout_s=120)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    out = {}
    serve = make_dp_serving(port_pipeline(inputs), make_mesh())
    out["wav"] = serve(inputs["text"], inputs["text_len"])
    try:
        serve(inputs["text"][:3], inputs["text_len"][:3])
    except ValueError as e:
        out["refused"] = str(e)

    mesh = make_mesh((("data", 1), ("model", world)))
    gen = MelganGenerator(**WIDE)
    gen.load_state_dict(inputs["wide"])
    out["sharded"] = channel_shardings(gen, mesh)
    forward = make_sharded_generator_forward(shard_params(gen, mesh), mesh)
    out["wide_wav"] = forward(inputs["wide_mel"])
    out["local_weights"] = {
        name: tuple(gen.get_submodule(name).weight.shape)
        for name in out["sharded"]}
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
from jax.sharding import Mesh, PartitionSpec  # noqa: E402

from tests.torch_port_params import module_params  # noqa: E402
from tts_tpu_torch.compat.from_jax import (  # noqa: E402
    glow_tts_state_dict_from_jax, melgan_state_dict_from_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _marks_through_bridge(params, shardings, factors, blocks):
    """The port modules that hold tts_tpu's sharded kernels: a tree of ones
    at the sharded kernels and zeros at the others (ones elsewhere, so weight
    norm folds to non-zero) carried over by the bridge."""
    def mark(path, leaf, spec):
        is_kernel = path[-1].key == "kernel"
        sharded = spec.spec != PartitionSpec()
        return np.full(leaf.shape, 1.0 if sharded or not is_kernel else 0.0,
                       np.float32)
    marks = jax.tree_util.tree_map_with_path(mark, params, shardings)
    sd = melgan_state_dict_from_jax(marks, factors, blocks)
    return {k[:-len(".weight_v")] for k, v in sd.items()
            if k.endswith(".weight_v") and float(v.abs().max()) > 0}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from tts_tpu.infer.serving_dp import make_dp_serving as j_make_dp_serving
    from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
    from tts_tpu.models.vocoder.fold import fold_weight_norm
    from tts_tpu.models.vocoder.melgan import MelganGenerator as JMelgan
    from tts_tpu.models.vocoder.multiband_melgan import \
        MultibandMelganGenerator as JMultiband
    from tts_tpu.ops.pallas.fused_melgan import (megakernel_generator_apply,
                                                 pack_generator_params)
    from tts_tpu.parallel.model_parallel import (
        channel_shardings, make_sharded_generator_forward, shard_params)

    workdir = str(tmp_path_factory.mktemp("serving_world"))
    jglow = JGlowTTS(**GLOW, mas_impl="jnp")
    gparams = module_params(jglow, 0, jnp.zeros((1, 8), jnp.int32),
                            jnp.array([8], jnp.int32),
                            jnp.zeros((1, 12, 80)),
                            jnp.array([12], jnp.int32), train=False)
    proj = gparams["encoder"]["duration_predictor"]["proj"]
    proj["kernel"][:] = 0.0
    proj["bias"][:] = np.log(6.5)
    jvoc = JMultiband(**VOC)
    vparams = module_params(jvoc, 1, jnp.zeros((1, 8, 80)))
    jwide = JMelgan(**WIDE)
    wparams = module_params(jwide, 2, jnp.zeros((1, WIDE_FRAMES, 80)))
    rng = np.random.default_rng(3)
    text = rng.integers(1, GLOW["num_chars"], (B, T_TEXT)).astype(np.int32)
    wide_mel = rng.standard_normal((WIDE_B, WIDE_FRAMES, 80)
                                   ).astype(np.float32)
    inputs = {
        "glow": glow_tts_state_dict_from_jax(gparams),
        "voc": melgan_state_dict_from_jax(vparams, VOC["upsample_factors"],
                                          VOC["num_res_blocks"]),
        "wide": melgan_state_dict_from_jax(wparams,
                                           WIDE["upsample_factors"],
                                           WIDE["num_res_blocks"]),
        "text": torch.from_numpy(text).long(),
        "text_len": torch.full((B,), T_TEXT, dtype=torch.long),
        "wide_mel": torch.from_numpy(wide_mel.transpose(0, 2, 1).copy()),
    }
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    url = "file://" + os.path.join(workdir, "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD), url,
         workdir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
        plain = jvoc.clone(use_weight_norm=False)
        packed = pack_generator_params(plain, fold_weight_norm(vparams),
                                       fuse_pqmf=True)

        def synthesize(params, text, text_len):
            gp, packed = params
            out = jglow.apply({"params": gp}, text, text_len,
                              noise_scale=0.0, y_max_length=T_MEL,
                              rngs={"noise": jax.random.PRNGKey(1)},
                              method=JGlowTTS.inference)
            mel = out["model_outputs"].astype(jnp.float32)
            return megakernel_generator_apply(plain, packed, mel,
                                              interpret=True)

        want_wav = np.asarray(j_make_dp_serving(synthesize, mesh)(
            (gparams, packed), jnp.asarray(text),
            jnp.full((B,), T_TEXT, jnp.int32)))
        mesh2 = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(1, WORLD),
                     ("data", "model"))
        shardings = channel_shardings(wparams, mesh2)
        want_wide = np.asarray(make_sharded_generator_forward(jwide, mesh2)(
            shard_params(wparams, mesh2), jnp.asarray(wide_mel)))
        want_sharded = _marks_through_bridge(
            wparams, shardings, WIDE["upsample_factors"],
            WIDE["num_res_blocks"])
        single = port_pipeline(inputs)(inputs["text"], inputs["text_len"])
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
    return {"ranks": ranks, "want_wav": want_wav, "single": single,
            "want_wide": want_wide, "want_sharded": want_sharded}


def test_dp_serving_matches_tts_tpu_and_the_single_process(run):
    want = run["want_wav"]
    assert want.shape == (B, T_MEL * 4 * 4, 1)
    for rank in run["ranks"]:
        wav = rank["wav"].numpy()
        assert wav.shape == want.shape
        np.testing.assert_allclose(wav, want, rtol=0, atol=SERVE_ATOL)
        np.testing.assert_allclose(wav, run["single"].numpy(), rtol=0,
                                   atol=SELF_ATOL)
    assert float(np.abs(want).max()) > 1e-3


def test_dp_serving_refuses_a_batch_the_ranks_do_not_divide(run):
    for rank in run["ranks"]:
        assert "does not split over 2 ranks" in rank["refused"]


def test_sharded_layers_are_tts_tpus(run):
    """The same layers are sharded, name for name through the bridge, and
    each rank holds half of each one's output channels."""
    want = run["want_sharded"]
    assert want, "tts_tpu shards no layer at this width"
    for rank in run["ranks"]:
        assert set(rank["sharded"]) == want
        for name, dim in rank["sharded"].items():
            assert rank["local_weights"][name][dim] * WORLD >= 128, name


def test_channel_sharded_generator_matches_tts_tpu(run):
    want = run["want_wide"]
    for rank in run["ranks"]:
        got = rank["wide_wav"].numpy().transpose(0, 2, 1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=SHARD_ATOL)
