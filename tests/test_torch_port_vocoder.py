"""MelGAN-family vocoder of the port against tts_tpu.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
these are held against tts_tpu's Pallas kernels in interpret mode at the
tiny shapes of tests/test_fused_vocoder.py and tests/test_fused_melgan.py,
reflect edges and the PQMF tail included. Tolerance: 3e-5 absolute (float32,
different summation order), tts_tpu's own for its kernels. The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.compat.torch_port import port_melgan
from tts_tpu.models.vocoder.fold import fold_weight_norm as j_fold
from tts_tpu.models.vocoder.melgan import MelganGenerator as JMelgan
from tts_tpu.models.vocoder.melgan import ResidualStack as JResidualStack
from tts_tpu.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator as JMultiband
from tts_tpu.models.vocoder.serving import fused_inference as j_fused_inference
from tts_tpu.ops.pallas.fused_melgan import \
    megakernel_generator_apply as j_mega_apply
from tts_tpu.ops.pallas.fused_melgan import megakernel_inference as j_mega
from tts_tpu.ops.pallas.fused_melgan import pack_generator_params as j_pack
from tts_tpu.ops.pallas.fused_resstack import (fused_residual_stack as j_stack,
                                               stack_params_from_tree)
from tts_tpu_torch.compat.from_jax import melgan_state_dict_from_jax
from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
from tts_tpu_torch.models.vocoder.melgan import (MelganGenerator,
                                                 UpsampleConvTranspose1d)
from tts_tpu_torch.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator
from tts_tpu_torch.models.vocoder.serving import fused_inference, pack_stacks
from tts_tpu_torch.ops.cuda import fused_melgan as M
from tts_tpu_torch.ops.cuda import fused_resstack as R

from tests.torch_port_params import module_params

torch.set_num_threads(1)

ATOL = 3e-5


def _np_tree(node):
    return {k: _np_tree(v) if hasattr(v, "items") else np.array(v, np.float32)
            for k, v in node.items()}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _mel(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(jgen, params, factors, num_res_blocks, tgen_cls, **kw):
    """The port's folded generator and state dict for tts_tpu ``params``."""
    sd = fold_weight_norm(melgan_state_dict_from_jax(params, factors,
                                                     num_res_blocks))
    gen = tgen_cls(upsample_factors=factors, num_res_blocks=num_res_blocks,
                   use_weight_norm=False, **kw)
    gen.load_state_dict(sd, strict=True)
    return gen.eval(), sd


def _stack_operands(stack_params, n):
    """tts_tpu ResidualStack params (folded) -> the port's packed operands,
    through a Mozilla-named state dict."""
    sd = {}
    for j in range(n):
        for ours, theirs in ((f"block_{j}_conv1", f"blocks.{j}.2"),
                             (f"block_{j}_conv2", f"blocks.{j}.4"),
                             (f"block_{j}_shortcut", f"shortcuts.{j}")):
            node = stack_params[ours]
            node = node.get("conv", node)
            sd[f"s.{theirs}.weight"] = _t(np.transpose(node["kernel"],
                                                       (2, 1, 0)))
            sd[f"s.{theirs}.bias"] = _t(node["bias"])
    return R.pack_stack_params(sd, "s", n)


class TestResidualStackPlain:
    @pytest.mark.parametrize("channels,t", [(24, 160), (48, 96), (192, 40)])
    def test_matches_pallas_stack(self, channels, t):
        x = _mel(channels, (3, t, channels))
        stack = JResidualStack(channels, 3, use_weight_norm=False)
        params = module_params(stack, channels, jnp.asarray(x))
        want = j_stack(jnp.asarray(x), *stack_params_from_tree(params, 3),
                       interpret=True)
        got = R.fused_residual_stack(_t(x), *_stack_operands(params, 3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_reflect_edges_match(self):
        x = _mel(7, (1, 32, 24))
        stack = JResidualStack(24, 3, use_weight_norm=False)
        params = module_params(stack, 7, jnp.asarray(x))
        want = np.asarray(j_stack(jnp.asarray(x),
                                  *stack_params_from_tree(params, 3),
                                  interpret=True))
        got = R.fused_residual_stack(_t(x), *_stack_operands(params, 3)).numpy()
        np.testing.assert_allclose(got[:, :10], want[:, :10], atol=ATOL)
        np.testing.assert_allclose(got[:, -10:], want[:, -10:], atol=ATOL)


@pytest.mark.parametrize("factor", [2, 3, 4, 8])
def test_upsample_matches_flax_conv_transpose(factor):
    """Both the module (torch ConvTranspose1d with the SAME padding) and the
    kernel's packed two-tap form reproduce lax.conv_transpose SAME."""
    rng = np.random.default_rng(factor)
    c_in, c_out, T = 6, 4, 13
    kernel = rng.standard_normal((2 * factor, c_in, c_out)).astype(np.float32)
    x = rng.standard_normal((1, T, c_in)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(kernel), strides=(factor,),
        padding="SAME", dimension_numbers=("NWC", "WIO", "NWC")))[0].T
    w_t = _t(np.transpose(kernel, (1, 2, 0))[:, :, ::-1])   # torch layout
    mod = UpsampleConvTranspose1d(c_in, c_out, factor)
    mod.load_state_dict({"weight": w_t, "bias": torch.zeros(c_out)})
    with torch.no_grad():
        got = mod(_t(x).transpose(1, 2))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the kernel's plain version runs leaky first: feed positive input
    xp = np.abs(x)
    want_p = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(xp), jnp.asarray(kernel), strides=(factor,),
        padding="SAME", dimension_numbers=("NWC", "WIO", "NWC")))[0].T
    up = M.pack_upsample_params(w_t, torch.zeros(c_out), factor)
    got_p = M.upsample_plain(_t(xp).transpose(1, 2), up)[0].numpy()
    np.testing.assert_allclose(got_p, want_p, atol=1e-5)


class TestGenerator:
    @pytest.mark.parametrize("factors,base", [((2, 2), 32), ((3, 2), 32)])
    def test_module_matches_flax(self, factors, base):
        """Weight-normed module: the flax tree carried over (weight norm
        folded on the way, see from_jax) gives the same waveform."""
        jg = JMultiband(upsample_factors=factors, base_channels=base,
                        num_res_blocks=3)
        mel = _mel(0, (2, 20, 80))
        params = module_params(jg, factors[0], jnp.asarray(mel))
        want = np.asarray(jg.apply({"params": params}, jnp.asarray(mel),
                                   method=JMultiband.inference))
        tg = MultibandMelganGenerator(base_channels=base,
                                      upsample_factors=factors,
                                      num_res_blocks=3)
        tg.load_state_dict(melgan_state_dict_from_jax(params, factors, 3),
                           strict=True)
        got = tg.inference(_t(mel).transpose(1, 2)).numpy()
        np.testing.assert_allclose(got.transpose(0, 2, 1), want, atol=ATOL)

    def test_weights_round_trip(self):
        """port_melgan(melgan_state_dict_from_jax(p)) == fold(p)."""
        factors = (2, 8)
        jg = JMultiband(upsample_factors=factors, base_channels=32,
                        num_res_blocks=2)
        params = module_params(jg, 3, jnp.zeros((1, 8, 80)))
        sd = {k: v.numpy() for k, v in
              melgan_state_dict_from_jax(params, factors, 2).items()}
        back = port_melgan(sd, factors, 2)
        want_leaves, want_def = jax.tree_util.tree_flatten(
            _np_tree(j_fold(params)))
        got_leaves, got_def = jax.tree_util.tree_flatten(_np_tree(back))
        assert got_def == want_def
        for w, g in zip(want_leaves, got_leaves):
            np.testing.assert_allclose(g, w, atol=1e-6)


def _jax_generator(jcls, factors, base, seed, **kw):
    jg = jcls(upsample_factors=factors, base_channels=base, **kw)
    mel = _mel(seed, (2, 24, 80))
    params = module_params(jg, seed, jnp.asarray(mel))
    folded = _np_tree(j_fold(params))
    return jg, params, folded, mel


class TestMegakernelPlain:
    @pytest.mark.parametrize("factors,base", [((2, 8), 32), ((2, 2), 32)])
    def test_generator_apply_matches_pallas(self, factors, base):
        jg, params, folded, mel = _jax_generator(JMultiband, factors, base,
                                                 len(factors))
        plain = jg.clone(use_weight_norm=False)
        want = j_mega_apply(plain, j_pack(plain, folded), jnp.asarray(mel),
                            interpret=True)
        tg, sd = _port(jg, params, factors, 3, MultibandMelganGenerator,
                       base_channels=base)
        w = M.pack_generator_params(tg, sd, device="cpu")
        w.syn = None                       # subbands, as tts_tpu's call
        got = M.megakernel_generator_apply(tg, w, _t(mel))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=1e-4)

    def test_fullband_single_channel(self):
        jg, params, folded, mel = _jax_generator(JMelgan, (8, 2), 64, 9)
        plain = jg.clone(use_weight_norm=False)
        want = j_mega_apply(plain, j_pack(plain, folded), jnp.asarray(mel),
                            interpret=True)
        tg, sd = _port(jg, params, (8, 2), 3, MelganGenerator,
                       base_channels=64)
        got = M.megakernel_generator_apply(
            tg, M.pack_generator_params(tg, sd, device="cpu"), _t(mel))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=1e-4)

    def test_inference_with_pqmf(self):
        """Inference padding + generator + the PQMF tail against tts_tpu's
        megakernel with the synthesis fused in."""
        factors = (2, 2, 2, 2)
        jg, params, folded, mel = _jax_generator(JMultiband, factors, 64, 1)
        plain = jg.clone(use_weight_norm=False)
        want = j_mega(plain, j_pack(plain, folded, fuse_pqmf=True),
                      jnp.asarray(mel), interpret=True)
        tg, sd = _port(jg, params, factors, 3, MultibandMelganGenerator,
                       base_channels=64)
        got = M.megakernel_inference(
            tg, M.pack_generator_params(tg, sd, device="cpu"), _t(mel))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=1e-4)

    def test_per_stack_path_matches_pallas(self):
        factors = (2, 2)
        jg, params, folded, mel = _jax_generator(JMultiband, factors, 32, 4)
        plain = jg.clone(use_weight_norm=False)
        want = j_fused_inference(plain, folded, jnp.asarray(mel),
                                 interpret=True)
        tg, _ = _port(jg, params, factors, 3, MultibandMelganGenerator,
                      base_channels=32)
        got = fused_inference(tg, pack_stacks(tg), _t(mel))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=1e-4)


def test_megakernel_supported():
    assert M.megakernel_supported(MultibandMelganGenerator(
        base_channels=384, upsample_factors=(2, 8, 2, 2), num_res_blocks=4))
    assert not M.megakernel_supported(MultibandMelganGenerator(
        base_channels=64, upsample_factors=(3, 2), num_res_blocks=2))
