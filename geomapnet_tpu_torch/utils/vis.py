"""Visualization helpers: batch grids, stereo pairs, t-SNE of features.

Copies of :mod:`geomapnet_tpu.utils.vis` (upstream common/vis_utils.py:
``show_batch``, ``show_stereo_batch``, ``vis_tsne``), which cannot be
imported without jax; tests/test_torch_import_isolation.py pins them to
the originals. matplotlib is imported only when a figure is drawn (the
card's machine has none; :func:`make_grid` and the numpy t-SNE need only
numpy). Rendering is headless-safe (Agg when there is no display); pass
``path`` to save instead of showing.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["make_grid", "show_batch", "show_stereo_batch", "vis_tsne"]


def _plt():
    import matplotlib

    if "DISPLAY" not in os.environ:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              normalize: bool = True) -> np.ndarray:
    """Tile (N, H, W, C) images into one (H', W', C) grid image."""
    images = np.asarray(images, dtype=np.float32)
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / (hi - lo + 1e-12)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.ones(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        np.float32,
    )
    for i in range(n):
        r, cl = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + cl * (w + padding)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def show_batch(images: np.ndarray, path: str | None = None) -> None:
    """Display/save a batch grid (reference vis_utils.show_batch)."""
    plt = _plt()
    plt.figure()
    plt.imshow(make_grid(images))
    plt.axis("off")
    if path:
        plt.savefig(path, bbox_inches="tight")
        plt.close()
    else:
        plt.show()


def show_stereo_batch(left: np.ndarray, right: np.ndarray,
                      path: str | None = None) -> None:
    """Display/save left|right batches side by side."""
    plt = _plt()
    lg = make_grid(left, nrow=1)
    rg = make_grid(right, nrow=1)
    h = min(lg.shape[0], rg.shape[0])
    both = np.concatenate([lg[:h], rg[:h]], axis=1)
    plt.figure()
    plt.imshow(both)
    plt.axis("off")
    if path:
        plt.savefig(path, bbox_inches="tight")
        plt.close()
    else:
        plt.show()


def vis_tsne(features: np.ndarray, images: np.ndarray | None = None,
             path: str | None = None, perplexity: float = 30.0) -> np.ndarray:
    """2-D t-SNE embedding of feature vectors, optionally with thumbnails.

    Returns the (N, 2) embedding. Uses scikit-learn when available, else a
    compact numpy t-SNE fallback.
    """
    features = np.asarray(features, dtype=np.float64)
    try:
        from sklearn.manifold import TSNE

        emb = TSNE(n_components=2, perplexity=min(perplexity,
                                                  max(2, len(features) - 1)),
                   init="pca").fit_transform(features)
    except ImportError:
        emb = _tsne_np(features, perplexity=min(perplexity,
                                                max(2.0, len(features) / 4)))

    plt = _plt()
    plt.figure(figsize=(8, 8))
    if images is not None:
        from matplotlib.offsetbox import AnnotationBbox, OffsetImage

        ax = plt.gca()
        lo, hi = images.min(), images.max()
        for (x, y), im in zip(emb, images):
            thumb = (im - lo) / (hi - lo + 1e-12)
            ab = AnnotationBbox(OffsetImage(thumb, zoom=0.3), (x, y),
                                frameon=False)
            ax.add_artist(ab)
        ax.set_xlim(emb[:, 0].min(), emb[:, 0].max())
        ax.set_ylim(emb[:, 1].min(), emb[:, 1].max())
    else:
        plt.scatter(emb[:, 0], emb[:, 1], s=8)
    if path:
        plt.savefig(path, bbox_inches="tight")
        plt.close()
    else:
        plt.show()
    return emb


def _tsne_np(X: np.ndarray, perplexity: float = 30.0, n_iter: int = 300,
             lr: float = 100.0, seed: int = 0) -> np.ndarray:
    """Minimal Barnes-free t-SNE (exact pairwise) for small N."""
    rng = np.random.RandomState(seed)
    n = len(X)
    D = np.sum((X[:, None] - X[None]) ** 2, axis=-1)

    # binary-search per-point bandwidths for the target perplexity
    P = np.zeros((n, n))
    target = np.log(perplexity)
    for i in range(n):
        lo, hi = 1e-20, 1e20
        beta = 1.0
        d = np.delete(D[i], i)
        for _ in range(40):
            p = np.exp(-d * beta)
            s = p.sum() + 1e-12
            H = np.log(s) + beta * np.sum(d * p) / s
            if H > target:
                lo = beta
                beta = beta * 2 if hi == 1e20 else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == 1e-20 else (beta + lo) / 2
        p = np.exp(-np.delete(D[i], i) * beta)
        P[i, np.arange(n) != i] = p / (p.sum() + 1e-12)
    P = (P + P.T) / (2 * n)
    P = np.maximum(P, 1e-12)

    Y = rng.randn(n, 2) * 1e-4
    gains = np.ones_like(Y)
    dY = np.zeros_like(Y)
    for it in range(n_iter):
        num = 1.0 / (1.0 + np.sum((Y[:, None] - Y[None]) ** 2, axis=-1))
        np.fill_diagonal(num, 0)
        Q = np.maximum(num / num.sum(), 1e-12)
        PQ = (P - Q) * num
        grad = 4 * (np.diag(PQ.sum(1)) - PQ) @ Y
        gains = np.where(np.sign(grad) != np.sign(dY), gains + 0.2,
                         gains * 0.8).clip(0.01)
        dY = 0.8 * dY - lr * gains * grad
        Y = Y + dY
        Y = Y - Y.mean(0)
    return Y
