"""GAN vocoder losses: multi-scale STFT, adversarial, feature matching
(≙ tts_tpu/losses/vocoder_losses.py).

Waveforms are (B, 1, T) or (B, T); subband signals (B, N, T / N). Every
|STFT| goes through ``ops/stft.py::stft_magnitude``: the hand-written
kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tts_tpu_torch.ops.stft import stft_magnitude

Tensor = torch.Tensor


def stft_loss(y_hat: Tensor, y: Tensor, n_fft: int, hop_length: int,
              win_length: int) -> Tuple[Tensor, Tensor]:
    """(spectral convergence, log-magnitude L1) at one resolution; both
    magnitudes clipped at 1e-7."""
    mag_hat = stft_magnitude(y_hat, n_fft, hop_length,
                             win_length).clamp_min(1e-7)
    mag = stft_magnitude(y, n_fft, hop_length, win_length).clamp_min(1e-7)
    sc = (torch.linalg.vector_norm(mag - mag_hat)
          / torch.linalg.vector_norm(mag).clamp_min(1e-7))
    log_mag = (torch.log(mag) - torch.log(mag_hat)).abs().mean()
    return sc, log_mag


DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
SUBBAND_RESOLUTIONS = ((384, 30, 150), (683, 60, 300), (171, 10, 60))


def multiscale_stft_loss(y_hat: Tensor, y: Tensor,
                         resolutions: Sequence[Tuple[int, int, int]]
                         = DEFAULT_RESOLUTIONS) -> Tuple[Tensor, Tensor]:
    """SC and log-magnitude losses averaged over the resolutions
    ((n_fft, hop, win) each)."""
    sc_total, mag_total = 0.0, 0.0
    for n_fft, hop, win in resolutions:
        sc, mag = stft_loss(y_hat, y, n_fft, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n


def multiscale_subband_stft_loss(y_hat_sub: Tensor, y_sub: Tensor
                                 ) -> Tuple[Tensor, Tensor]:
    """Multi-scale STFT over PQMF subbands (B, N, T) as B * N signals."""
    B, N, T = y_sub.shape
    return multiscale_stft_loss(y_hat_sub.reshape(B * N, T),
                                y_sub.reshape(B * N, T), SUBBAND_RESOLUTIONS)


# -- adversarial ------------------------------------------------------------

def mse_g_loss(scores_fake: List[Tensor]) -> Tensor:
    loss = 0.0
    for s in scores_fake:
        loss = loss + ((s - 1.0) ** 2).mean()
    return loss / len(scores_fake)


def hinge_g_loss(scores_fake: List[Tensor]) -> Tensor:
    loss = 0.0
    for s in scores_fake:
        loss = loss - s.mean()
    return loss / len(scores_fake)


def mse_d_loss(scores_fake: List[Tensor], scores_real: List[Tensor]
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """(total, real part, fake part)."""
    loss_real, loss_fake = 0.0, 0.0
    for sr, sf in zip(scores_real, scores_fake):
        loss_real = loss_real + ((sr - 1.0) ** 2).mean()
        loss_fake = loss_fake + (sf ** 2).mean()
    n = len(scores_real)
    return (loss_real + loss_fake) / n, loss_real / n, loss_fake / n


def hinge_d_loss(scores_fake: List[Tensor], scores_real: List[Tensor]
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    loss_real, loss_fake = 0.0, 0.0
    for sr, sf in zip(scores_real, scores_fake):
        loss_real = loss_real + torch.relu(1.0 - sr).mean()
        loss_fake = loss_fake + torch.relu(1.0 + sf).mean()
    n = len(scores_real)
    return (loss_real + loss_fake) / n, loss_real / n, loss_fake / n


def feature_matching_loss(feats_fake: List[List[Tensor]],
                          feats_real: List[List[Tensor]]) -> Tensor:
    """Mean over layers of each layer's L1 between fake and real
    features."""
    loss = 0.0
    count = 0
    for ff, fr in zip(feats_fake, feats_real):
        for a, b in zip(ff, fr):
            loss = loss + (a - b).abs().mean()
            count += 1
    return loss / max(count, 1)


# -- composites -------------------------------------------------------------

def generator_loss(
    y_hat: Tensor,
    y: Tensor,
    *,
    scores_fake: Optional[List[Tensor]] = None,
    feats_fake: Optional[List[List[Tensor]]] = None,
    feats_real: Optional[List[List[Tensor]]] = None,
    y_hat_sub: Optional[Tensor] = None,
    y_sub: Optional[Tensor] = None,
    use_stft_loss: bool = True,
    use_subband_stft_loss: bool = False,
    use_mse_gan_loss: bool = True,
    use_hinge_gan_loss: bool = False,
    use_feat_match_loss: bool = False,
    stft_loss_weight: float = 0.5,
    subband_stft_loss_weight: float = 0.5,
    mse_G_loss_weight: float = 2.5,
    hinge_G_loss_weight: float = 2.5,
    feat_match_loss_weight: float = 10.0,
) -> Dict[str, Tensor]:
    """Composite generator loss under tts_tpu's keys; ``G_loss`` is the
    weighted total."""
    out: Dict[str, Tensor] = {}
    total = 0.0
    if use_stft_loss:
        sc, mag = multiscale_stft_loss(y_hat[:, 0] if y_hat.dim() == 3
                                       else y_hat,
                                       y[:, 0] if y.dim() == 3 else y)
        out["G_stft_loss_sc"] = sc
        out["G_stft_loss_mag"] = mag
        total = total + stft_loss_weight * (sc + mag)
    if use_subband_stft_loss and y_hat_sub is not None:
        sc, mag = multiscale_subband_stft_loss(y_hat_sub, y_sub)
        out["G_subband_stft_loss_sc"] = sc
        out["G_subband_stft_loss_mag"] = mag
        total = total + subband_stft_loss_weight * (sc + mag)
    if scores_fake is not None:
        if use_mse_gan_loss:
            adv = mse_g_loss(scores_fake)
            out["G_mse_fake_loss"] = adv
            total = total + mse_G_loss_weight * adv
        if use_hinge_gan_loss:
            adv = hinge_g_loss(scores_fake)
            out["G_hinge_fake_loss"] = adv
            total = total + hinge_G_loss_weight * adv
        if use_feat_match_loss and feats_fake is not None:
            fm = feature_matching_loss(feats_fake, feats_real)
            out["G_feat_match_loss"] = fm
            total = total + feat_match_loss_weight * fm
    out["G_loss"] = total
    return out


def discriminator_loss(scores_fake: List[Tensor], scores_real: List[Tensor],
                       *, use_mse_gan_loss: bool = True,
                       use_hinge_gan_loss: bool = False
                       ) -> Dict[str, Tensor]:
    """Composite discriminator loss under tts_tpu's keys; ``D_loss`` is the
    total."""
    out: Dict[str, Tensor] = {}
    total = 0.0
    if use_mse_gan_loss:
        loss, lr, lf = mse_d_loss(scores_fake, scores_real)
        out["D_mse_gan_loss"] = loss
        out["D_mse_gan_real_loss"] = lr
        out["D_mse_gan_fake_loss"] = lf
        total = total + loss
    if use_hinge_gan_loss:
        loss, lr, lf = hinge_d_loss(scores_fake, scores_real)
        out["D_hinge_gan_loss"] = loss
        out["D_hinge_gan_real_loss"] = lr
        out["D_hinge_gan_fake_loss"] = lf
        total = total + loss
    out["D_loss"] = total
    return out
