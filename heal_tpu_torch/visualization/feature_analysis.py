"""Feature-space analysis: CKA, MMD, pairwise distances, t-SNE embedding.

The port's copy of heal_tpu/visualization/feature_analysis.py (numpy;
scikit-learn and matplotlib imported where they are used), capability
parity with reference visualization/tsne/{cka.py, mmd.py,
pairwise_distance.py}: quantify how similar two modalities' BEV feature
spaces are (HEAL stage-2 alignment quality) and embed per-agent features
for a 2D scatter. The t-SNE embedding uses scikit-learn and, where it is
not installed, a PCA projection.

Typical use: take (N, C) feature vectors of two modalities' aligner
outputs at matching BEV cells to the host (channels-last rows,
``x.float().cpu().numpy()``), then ``linear_cka(f_m1, f_m2)``: 1.0 means
the aligner mapped m2 onto m1's feature space, 0 means unrelated.
"""
from __future__ import annotations

import numpy as np


def _center_gram(k: np.ndarray) -> np.ndarray:
    n = k.shape[0]
    h = np.eye(n) - np.ones((n, n)) / n
    return h @ k @ h


def _rbf_gram(x: np.ndarray, sigma: float | None = None) -> np.ndarray:
    gx = x @ x.T
    sq = np.diag(gx)[:, None] + np.diag(gx)[None, :] - 2 * gx
    if sigma is None:
        nz = sq[sq > 0]
        sigma = np.sqrt(np.median(nz)) if nz.size else 1.0
    return np.exp(-0.5 * sq / (sigma * sigma))


def linear_cka(x: np.ndarray, y: np.ndarray) -> float:
    """Linear centered-kernel alignment between (N, Cx) and (N, Cy)."""
    kx = _center_gram(x @ x.T)
    ky = _center_gram(y @ y.T)
    hsic = float((kx * ky).sum())
    v1 = float((kx * kx).sum())
    v2 = float((ky * ky).sum())
    return hsic / (np.sqrt(v1 * v2) + 1e-12)


def kernel_cka(x, y, sigma: float | None = None) -> float:
    """RBF-kernel CKA."""
    kx = _center_gram(_rbf_gram(x, sigma))
    ky = _center_gram(_rbf_gram(y, sigma))
    hsic = float((kx * ky).sum())
    v1 = float((kx * kx).sum())
    v2 = float((ky * ky).sum())
    return hsic / (np.sqrt(v1 * v2) + 1e-12)


def mmd_linear(x: np.ndarray, y: np.ndarray) -> float:
    """Linear-kernel maximum mean discrepancy (mean-embedding form)."""
    delta = x.mean(0) - y.mean(0)
    return float(delta @ delta)


def mmd_rbf(x: np.ndarray, y: np.ndarray, gamma: float = 1.0) -> float:
    """RBF-kernel MMD^2 between sample sets (Nx, C) and (Ny, C)."""

    def k(a, b):
        sq = (
            (a * a).sum(1)[:, None]
            + (b * b).sum(1)[None, :]
            - 2 * a @ b.T
        )
        return np.exp(-gamma * sq)

    return float(k(x, x).mean() + k(y, y).mean() - 2 * k(x, y).mean())


def pairwise_l2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(Nx, Ny) euclidean distance matrix."""
    sq = (
        (x * x).sum(1)[:, None]
        + (y * y).sum(1)[None, :]
        - 2 * x @ y.T
    )
    return np.sqrt(np.maximum(sq, 0.0))


def tsne_embed(features: np.ndarray, perplexity: float = 30.0, seed: int = 0):
    """Embed (N, C) features to (N, 2). sklearn TSNE when available,
    where scikit-learn is not installed the top-2 PCA projection."""
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        x = features - features.mean(0)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        return x @ vt[:2].T
    n = features.shape[0]
    return TSNE(
        n_components=2,
        perplexity=min(perplexity, max(2.0, (n - 1) / 3.0)),
        random_state=seed,
        init="pca",
    ).fit_transform(features)


def scatter_by_label(embedding, labels, save_path: str, title: str = ""):
    """Save a 2D scatter colored by integer/str label per row."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(6, 5))
    for lab in np.unique(labels):
        sel = labels == lab
        ax.scatter(
            embedding[sel, 0], embedding[sel, 1], s=6, label=str(lab)
        )
    ax.legend(markerscale=2, fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
