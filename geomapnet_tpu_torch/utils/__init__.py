"""Shared utilities: logging, meters, structured metrics, plots."""

from .logger import AverageMeter, MetricsWriter, Tee
from .vis import make_grid, show_batch, show_stereo_batch, vis_tsne

__all__ = ["AverageMeter", "MetricsWriter", "Tee", "make_grid", "show_batch",
           "show_stereo_batch", "vis_tsne"]
