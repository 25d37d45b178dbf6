"""The port's STFT magnitude (ops/stft.py) against tts_tpu, on the CPU.

On the CPU the forward runs the plain version (frames @ window-folded DFT
banks, then the magnitude); tts_tpu's side is its Pallas kernel in
interpret mode and the jnp.fft path of ``dsp.stft``. All six resolutions of
the GAN losses, the odd n_fft 683 and 171 among them. Signals are numpy
seeded. Tolerances:

- framing and banks: exact (the same indexing and the same float64 -> float32
  construction);
- magnitudes: 1e-4 of the largest reference magnitude (float32 sums of up to
  2048 products in another order; the FFT path rounds differently again);
- gradients: 1e-4 of the largest reference gradient (two more products of
  the same depth in the backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.audio import dsp
from tts_tpu.losses.vocoder_losses import (DEFAULT_RESOLUTIONS,
                                           SUBBAND_RESOLUTIONS)
from tts_tpu.ops.pallas import stft_kernel as J
from tts_tpu_torch.ops.stft import (dft_banks, frames, stft_magnitude,
                                    stft_magnitude_torch)

torch.set_num_threads(1)

TOL = 1e-4
# full-band resolutions on 2,500 samples (reflect padding needs more than
# n_fft / 2), subband ones on 700 (a subband of 2,800 samples)
CASES = ([(res, 2500) for res in DEFAULT_RESOLUTIONS]
         + [(res, 700) for res in SUBBAND_RESOLUTIONS])
IDS = [f"nfft{r[0]}" for r, _ in CASES]


def _signal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("res,T", CASES, ids=IDS)
def test_framing_and_banks_equal_tts_tpu(res, T):
    n_fft, hop, win = res
    y = _signal(0, (2, T))
    np.testing.assert_array_equal(
        frames(torch.from_numpy(y), n_fft, hop).numpy(),
        np.asarray(J._frames(jnp.asarray(y), n_fft, hop)))
    wr, wi = dft_banks(n_fft, win, torch.device("cpu"))
    jwr, jwi = J._dft_banks(n_fft, win)
    np.testing.assert_array_equal(wr.numpy(), jwr)
    np.testing.assert_array_equal(wi.numpy(), jwi)


@pytest.mark.parametrize("res,T", CASES, ids=IDS)
def test_magnitude_matches_pallas_and_fft(res, T):
    n_fft, hop, win = res
    y = _signal(1, (2, T))
    got = stft_magnitude(torch.from_numpy(y), n_fft, hop, win).numpy()
    _close(got, J.stft_magnitude(jnp.asarray(y), n_fft, hop, win,
                                 interpret=True))
    _close(got, jnp.abs(dsp.stft(jnp.asarray(y), n_fft, hop, win)))


def test_plain_version_is_the_functions_forward():
    """stft_magnitude on the CPU is the plain version on the framed rows."""
    y = torch.from_numpy(_signal(2, (3, 900)))
    fr = frames(y, 171, 10).reshape(-1, 171)
    want = stft_magnitude_torch(fr, *dft_banks(171, 60, torch.device("cpu")))
    got = stft_magnitude(y, 171, 10, 60)
    assert torch.equal(got.reshape(-1, got.shape[-1]), want)


@pytest.mark.parametrize("res,T", [((1024, 120, 600), 2500),
                                   ((683, 60, 300), 700)],
                         ids=["nfft1024", "nfft683"])
def test_gradient_matches_jax_grad(res, T):
    """The Function's analytic backward against jax.grad through tts_tpu's
    custom VJP, for a weighted sum of the magnitudes."""
    n_fft, hop, win = res
    y = _signal(3, (2, T))
    n_frames = 1 + (T + 2 * (n_fft // 2) - n_fft) // hop
    w = _signal(4, (2, n_frames, n_fft // 2 + 1))

    def j_loss(yy):
        return (J.stft_magnitude(yy, n_fft, hop, win, interpret=True)
                * w).sum()

    want = jax.grad(j_loss)(jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_()
    (stft_magnitude(yt, n_fft, hop, win) * torch.from_numpy(w)).sum() \
        .backward()
    _close(yt.grad.numpy(), want)
