"""Alignment, spectrogram and waveform figures (≙ tts_tpu/utils/visual.py:
``plot_alignment``, ``plot_spectrogram``, ``plot_results``).

matplotlib is imported when a figure is drawn, not with this module: a
machine without it still trains and serves, and the trainers log no
figures there (``figures_available``)."""

from __future__ import annotations

import numpy as np


def figures_available() -> bool:
    """True where matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_alignment(alignment, info=None, fig_size=(16, 10), title=None):
    """An alignment (T_dec, T_in), or the first of a batch, as an image
    with the decoder steps across."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=fig_size)
    align = np.asarray(alignment)
    if align.ndim == 3:
        align = align[0]
    im = ax.imshow(align.T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep"
    if info is not None:
        xlabel += "\n\n" + info
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Encoder timestep")
    if title is not None:
        ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_spectrogram(spectrogram, ap=None, fig_size=(16, 10)):
    """A spectrogram (T, bins), or the first of a batch; denormalized
    through ``ap`` where one is given."""
    plt = _pyplot()
    spec = np.asarray(spectrogram)
    if spec.ndim == 3:
        spec = spec[0]
    if ap is not None:
        spec = ap.denormalize(spec)
    fig = plt.figure(figsize=fig_size)
    plt.imshow(spec.T, aspect="auto", origin="lower")
    plt.colorbar()
    plt.tight_layout()
    return fig


def plot_results(y_hat, y, ap=None, name_prefix=""):
    """Generated against real audio for GAN training: the two waveforms,
    and with ``ap`` their mel spectrograms and the difference. Returns
    {name: figure}."""
    plt = _pyplot()
    y_hat = np.asarray(y_hat).reshape(-1)
    y = np.asarray(y).reshape(-1)
    figures = {}
    fig_wave = plt.figure(figsize=(12, 4))
    plt.plot(y, alpha=0.6, label="real")
    plt.plot(y_hat, alpha=0.6, label="generated")
    plt.legend()
    plt.tight_layout()
    figures[name_prefix + "waveform"] = fig_wave
    if ap is not None:
        spec_fake = ap.melspectrogram(y_hat)
        spec_real = ap.melspectrogram(y)
        for key, spec in (("spectrogram/fake", spec_fake),
                          ("spectrogram/real", spec_real),
                          ("spectrogram/diff", np.abs(spec_fake - spec_real))):
            fig = plt.figure(figsize=(10, 4))
            plt.imshow(spec.T, aspect="auto", origin="lower")
            plt.colorbar()
            plt.tight_layout()
            figures[name_prefix + key] = fig
    return figures
