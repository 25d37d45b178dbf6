"""The port's grouped strided conv gradients (ops/grouped_conv.py) against
tts_tpu, on the CPU.

The plain weight and input gradients (the tap loops that the CUDA kernels
are held against on the card) against tts_tpu's Pallas kernels in
interpret mode and against torch's own conv autograd, at the
discriminator's down_0..2 geometries shrunk in batch and length (as
tests/test_grouped_conv_grad.py shrinks them), a layer with 4 inputs per
group (down_3's kind) and a kernel of 21 taps. Layouts: the port is NCW,
tts_tpu NWC with (k, in / groups, out) kernels. Inputs come from numpy
seeds. Tolerances:

- dW: 1e-4 of the largest |dW| of the reference (sums of B x L_out
  products in another order);
- dx: 1e-5 absolute (sums of about k / stride x 4 products of unit-scale
  values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tts_tpu.ops.pallas.grouped_conv_grad import (grouped_conv_dgrad as
                                                  j_dgrad)
from tts_tpu.ops.pallas.grouped_conv_grad import (grouped_conv_wgrad as
                                                  j_wgrad)
from tts_tpu_torch.models.vocoder.melgan import (GroupedStridedConv,
                                                 MelganDiscriminator)
from tts_tpu_torch.ops import grouped_conv as GC

torch.set_num_threads(1)

# (B, L, cin, cout, k, stride, groups)
GEOMS = [
    (2, 256, 16, 64, 41, 4, 16),      # down_0
    (2, 128, 64, 256, 41, 4, 64),     # down_1
    (2, 64, 256, 1024, 41, 4, 256),   # down_2
    (2, 64, 64, 64, 41, 4, 16),       # m = 4 (down_3's kind)
    (3, 128, 16, 64, 21, 4, 16),      # k = 21, odd batch
]
IDS = ["down0", "down1", "down2", "m4", "k21"]


def _inputs(geom, seed):
    B, L, cin, cout, k, s, g = geom
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cin, L)).astype(np.float32)
    w = (0.1 * rng.standard_normal((cout, cin // g, k))).astype(np.float32)
    Lout = (L + 2 * ((k - 1) // 2) - k) // s + 1
    dy = rng.standard_normal((B, cout, Lout)).astype(np.float32)
    return x, w, dy


def _torch_grads(x, w, dy, s, g):
    """dx, dW of torch's conv autograd for <conv(x, w), dy>."""
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = F.conv1d(xt, wt, None, s, (w.shape[-1] - 1) // 2, 1, g)
    (y * torch.from_numpy(dy)).sum().backward()
    return xt.grad.numpy(), wt.grad.numpy()


def _close_dw(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def _close_dx(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_plain_wgrad_matches_pallas_and_autograd(geom):
    B, L, cin, cout, k, s, g = geom
    x, w, dy = _inputs(geom, 0)
    got = GC.grouped_conv_wgrad_torch(torch.from_numpy(x),
                                      torch.from_numpy(dy), k, s, g).numpy()
    want = j_wgrad(jnp.asarray(x.transpose(0, 2, 1)),
                   jnp.asarray(dy.transpose(0, 2, 1)), k, s, g, block_b=2,
                   interpret=True)
    _close_dw(got, np.asarray(want).transpose(2, 1, 0))
    _close_dw(got, _torch_grads(x, w, dy, s, g)[1])


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_plain_dgrad_matches_pallas_and_autograd(geom):
    B, L, cin, cout, k, s, g = geom
    x, w, dy = _inputs(geom, 1)
    got = GC.grouped_conv_dgrad_torch(torch.from_numpy(dy),
                                      torch.from_numpy(w), L, s, g).numpy()
    _close_dx(got, _torch_grads(x, w, dy, s, g)[0])
    if cin // g == 1:
        # the Pallas dgrad in interpret mode takes ~26 s at m = 4 here; the
        # port's kernels take m = 1 only, so m = 4 is held to autograd
        want = j_dgrad(jnp.asarray(dy.transpose(0, 2, 1)),
                       jnp.asarray(w.transpose(2, 1, 0)), L, s, g,
                       block_b=2, interpret=True)
        _close_dx(got, np.asarray(want).transpose(0, 2, 1))


def test_function_grads_and_skips(monkeypatch):
    """grouped_conv's forward is the library conv; its backward gives
    autograd's gradients and computes only those asked for."""
    B, L, cin, cout, k, s, g = GEOMS[0]
    x, w, dy = _inputs(GEOMS[0], 2)
    want_dx, want_dw = _torch_grads(x, w, dy, s, g)
    calls = []
    for name in ("grouped_conv_wgrad", "grouped_conv_dgrad"):
        fn = getattr(GC, name)
        monkeypatch.setattr(GC, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = GC.grouped_conv(xt, wt, s, g)
    assert torch.equal(y, F.conv1d(xt, wt, None, s, (k - 1) // 2, 1, g))
    (y * torch.from_numpy(dy)).sum().backward()
    _close_dx(xt.grad.numpy(), want_dx)
    _close_dw(wt.grad.numpy(), want_dw)
    assert sorted(calls) == ["grouped_conv_dgrad", "grouped_conv_wgrad"]

    calls.clear()               # frozen weight: no weight gradient
    xt.grad = None
    (GC.grouped_conv(xt, torch.from_numpy(w), s, g)
     * torch.from_numpy(dy)).sum().backward()
    _close_dx(xt.grad.numpy(), want_dx)
    assert calls == ["grouped_conv_dgrad"]

    calls.clear()               # input without gradient: no input gradient
    (GC.grouped_conv(torch.from_numpy(x), wt, s, g)
     * torch.from_numpy(dy)).sum().backward()
    assert calls == ["grouped_conv_wgrad"]


def test_bfloat16_operands_take_float32_grads():
    """bf16 x / dy are upcast for the gradient and the results cast back
    (dx to dy's dtype, dW to x's), as tts_tpu's wrappers do."""
    B, L, cin, cout, k, s, g = GEOMS[0]
    x, w, dy = _inputs(GEOMS[0], 3)
    xb = torch.from_numpy(x).bfloat16()
    dyb = torch.from_numpy(dy).bfloat16()
    dw = GC.grouped_conv_wgrad(xb, dyb, k, s, g)
    assert dw.dtype == torch.bfloat16
    want = GC.grouped_conv_wgrad_torch(xb.float(), dyb.float(), k, s, g)
    assert torch.equal(dw, want.bfloat16())
    dx = GC.grouped_conv_dgrad(dyb, torch.from_numpy(w).bfloat16(), L, s, g)
    assert dx.dtype == torch.bfloat16


@pytest.mark.parametrize("cin,cout,groups,stride,length,expect", [
    (16, 64, 16, 4, 16384, True),     # down_0, scale 0
    (64, 256, 64, 4, 4096, True),     # down_1
    (256, 1024, 256, 4, 1024, True),  # down_2
    (16, 64, 16, 4, 4096, True),      # down_0, scale 2
    (1024, 1024, 256, 4, 256, False),  # down_3: 4 inputs per group
    (16, 64, 16, 4, 16383, False),    # (L + k - 1) % 4 != 0
    (16, 64, 16, 2, 16384, False),    # stride 2
])
def test_selection_rule(cin, cout, groups, stride, length, expect):
    conv = GroupedStridedConv(cin, cout, 4 * 10 + 1, stride, groups)
    assert conv.uses_kernel_grads(length) is expect


def test_discriminator_layers_take_the_rule():
    """At the full width of one discriminator: down_0..2 take the kernel
    gradients at every length that is a multiple of 4, down_3 never."""
    disc = MelganDiscriminator()
    lengths = [16384, 4096, 1024, 256]
    taken = [getattr(disc, f"down_{i}").uses_kernel_grads(lengths[i])
             for i in range(4)]
    assert taken == [True, True, True, False]
