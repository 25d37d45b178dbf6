"""Speaker-embedding scatter plots (≙ tts_tpu/utils/embeddings_visual.py):
UMAP where the library is installed, else PCA."""

from __future__ import annotations

import numpy as np


def project_embeddings(embeddings: np.ndarray) -> np.ndarray:
    """(N, D) -> (N, 2) by UMAP if installed, else by PCA (the centred
    embeddings on their first two right singular vectors)."""
    embeddings = np.asarray(embeddings)
    try:
        import umap
    except ImportError:
        centered = embeddings - embeddings.mean(axis=0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        return centered @ vt[:2].T
    return umap.UMAP().fit_transform(embeddings)


def plot_embeddings(embeddings: np.ndarray, num_utter_per_speaker: int):
    """A scatter of the projected embeddings, coloured by speaker (each
    speaker's ``num_utter_per_speaker`` utterances in a row); returns the
    figure (matplotlib imported here)."""
    from tts_tpu_torch.utils.visual import _pyplot
    plt = _pyplot()
    proj = project_embeddings(embeddings)
    n_speakers = len(embeddings) // num_utter_per_speaker
    labels = np.repeat(np.arange(n_speakers), num_utter_per_speaker)
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(proj[:, 0], proj[:, 1], c=labels[: len(proj)],
                    cmap="tab20", s=18)
    ax.set_title("Speaker embeddings")
    fig.colorbar(sc, ax=ax)
    fig.tight_layout()
    return fig
