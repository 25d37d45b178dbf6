"""The algebra of the STFT-magnitude kernel (ops/cuda/stft_mag.cu), on the
CPU, before the card runs it.

The kernel windows each frame and folds it by the real DFT's symmetry
(e[j] = xw[j] + xw[K - j], o[j] = xw[j] - xw[K - j] for 0 < j < G; e[0] =
xw[0]; G = K / 2 for even K, K / 2 + 1 for odd) and multiplies e and o with
the half-banks C and S of ``half_banks`` for the bins f < G; for even K it
adds the middle sample's (-1)^f xw[K/2] and sums the Nyquist bin in float32.
Where K is a multiple of 64 it first takes one radix-2 step: the even and
the odd samples each through that fold at size K / 2 (G = K / 4), then
X[f] = U[f] + W^f V[f], X[K/2 - f] = conj(U[f] - W^f V[f]) and
X[K/4] = U[K/4] - i V[K/4]. Every product operand v is split into TF32
parts, hi = v and lo = v - hi each truncated to 10 mantissa bits (3xTF32).
Here the same steps run in plain torch on the same numbers, at all six
resolutions of the GAN losses (odd n_fft 683 and 171 on the fold alone, the
other four on the radix-2 path), on numpy-seeded signals:

- the algebra with the half-banks equals ``stft_magnitude_torch`` and
  tts_tpu's Pallas ``stft_magnitude`` in interpret mode within 1e-5 of the
  largest magnitude (float32 sums of up to 1024 products in another order);
- the 3xTF32 emulation (the same truncation by a bit mask on the float32
  view; products of TF32 values exact in float32, float32 sums) stays within
  1e-4, the kernel's tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.losses.vocoder_losses import (DEFAULT_RESOLUTIONS,
                                           SUBBAND_RESOLUTIONS)
from tts_tpu.ops.pallas import stft_kernel as J
from tts_tpu_torch.ops.stft import (BANK_TILE, dft_banks, fold_size, frames,
                                    half_banks, radix2, stft_magnitude_torch)

CASES = ([(res, 2500) for res in DEFAULT_RESOLUTIONS]
         + [(res, 700) for res in SUBBAND_RESOLUTIONS])
IDS = [f"nfft{r[0]}" for r, _ in CASES]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fold(z: torch.Tensor, G: int):
    """(N, D) -> e, o (N, G): z[j] +- z[D - j], z[0] alone."""
    D = z.shape[1]
    j = torch.arange(G)
    a, b = z[:, j], z[:, (D - j) % D]
    first = j == 0
    return (torch.where(first, a, a + b),
            torch.where(first, torch.zeros_like(a), a - b))


def _alternate(n: int) -> torch.Tensor:
    return 1.0 - 2.0 * (torch.arange(n) % 2)


def _magnitudes(fr, window, C, S, product):
    """The kernel's algebra, its products through ``product``."""
    K = fr.shape[1]
    xw = fr * window
    if radix2(K):
        Q = K // 4
        sign = _alternate(Q)
        u, v = xw[:, 0::2], xw[:, 1::2]
        (eu, ou), (ev, ov) = _fold(u, Q), _fold(v, Q)
        ur = product(eu, C) + sign * u[:, Q:Q + 1]
        vr = product(ev, C) + sign * v[:, Q:Q + 1]
        ui, vi = product(ou, S), product(ov, S)
        theta = 2.0 * np.pi * np.arange(Q) / K
        cs = torch.from_numpy(np.cos(theta).astype(np.float32))
        sn = torch.from_numpy(np.sin(theta).astype(np.float32))
        tr, ti = cs * vr + sn * vi, cs * vi - sn * vr
        mag = torch.empty(fr.shape[0], K // 2 + 1)
        mag[:, :Q] = torch.sqrt((ur + tr) ** 2 + (ui + ti) ** 2 + 1e-12)
        mag[:, K // 2 - Q + 1:] = torch.sqrt(
            (ur - tr) ** 2 + (ui - ti) ** 2 + 1e-12).flip(1)
        uq = (eu * sign).sum(1) + (-1.0) ** Q * u[:, Q]
        vq = (ev * sign).sum(1) + (-1.0) ** Q * v[:, Q]
        mag[:, Q] = torch.sqrt(uq * uq + vq * vq + 1e-12)
        return mag
    G = fold_size(K)
    e, o = _fold(xw, G)
    re, im = product(e, C), product(o, S)
    if K % 2 == 0:
        sign = _alternate(G)
        mid = xw[:, K // 2]
        re = re + sign * mid[:, None]
        nyq = (e * sign).sum(1) + (-1.0) ** (K // 2) * mid
        re = torch.cat([re, nyq[:, None]], 1)
        im = torch.cat([im, torch.zeros_like(nyq)[:, None]], 1)
    return torch.sqrt(re * re + im * im + 1e-12)


def _truncate(a: np.ndarray) -> np.ndarray:
    """float32 -> TF32 by truncation: the low 13 mantissa bits cleared, as
    the kernel's split_tf32 masks them."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split(t: torch.Tensor):
    hi = torch.from_numpy(_truncate(t.numpy()))
    return hi, torch.from_numpy(_truncate((t - hi).numpy()))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def test_tf32_split_by_truncation():
    """hi and lo keep 10 mantissa bits each; what they drop is under 2^-20
    of the value."""
    x = np.array([1.0, 1 + 2.0 ** -11, -(1 + 3 * 2.0 ** -11), 0.0],
                 np.float32)
    np.testing.assert_array_equal(
        _truncate(x), np.array([1.0, 1.0, -(1 + 2.0 ** -10), 0.0],
                               np.float32))
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    hi, lo = _split(v)
    for part in (hi, lo):
        assert (part.numpy().view(np.uint32) & 0x1FFF == 0).all()
    assert float((v - hi).abs().max()) <= 2.0 ** -10 * float(v.abs().max())
    assert float((v - hi - lo).abs().max()) <= \
        2.0 ** -20 * float(v.abs().max())


@pytest.mark.parametrize("res", [r for r, _ in CASES], ids=IDS)
def test_half_banks_layout(res):
    n_fft, _, win = res
    window, banks = half_banks(n_fft, win, CPU)
    G = fold_size(n_fft)
    P = banks.shape[-1]
    assert banks.shape == (2, P, P) and P % BANK_TILE == 0 and G <= P
    assert not banks[:, G:].any() and not banks[:, :, G:].any()
    np.testing.assert_array_equal(window.numpy(),
                                  J._dft_banks(n_fft, win)[0][:, 0])
    assert not banks[1, 0].any() and not banks[1, :, 0].any()   # sin 0 = 0
    np.testing.assert_array_equal(banks[0, 0, :G], np.ones(G, np.float32))


@pytest.mark.parametrize("res,T", CASES, ids=IDS)
def test_fold_and_3xtf32_match_plain_and_pallas(res, T):
    n_fft, hop, win = res
    y = np.random.default_rng(n_fft).standard_normal((2, T)).astype(
        np.float32)
    fr = frames(torch.from_numpy(y), n_fft, hop).reshape(-1, n_fft)
    plain = stft_magnitude_torch(fr, *dft_banks(n_fft, win, CPU))
    pallas = np.asarray(J.stft_magnitude(jnp.asarray(y), n_fft, hop, win,
                                         interpret=True)).reshape(plain.shape)
    window, banks = half_banks(n_fft, win, CPU)
    G = fold_size(n_fft)
    C, S = banks[0, :G, :G], banks[1, :G, :G]

    folded = _magnitudes(fr, window, C, S, torch.matmul)
    _close(folded, plain, 1e-5)
    _close(folded, pallas, 1e-5)

    def tf32x3(a, b):
        (ah, al), (bh, bl) = _split(a), _split(b)
        return al @ bh + ah @ bl + ah @ bh
    emulated = _magnitudes(fr, window, C, S, tf32x3)
    _close(emulated, plain, 1e-4)
    _close(emulated, pallas, 1e-4)
