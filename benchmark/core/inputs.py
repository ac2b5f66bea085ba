"""Inputs made from the run's seed: weights, frames and poses.

Weights are drawn on the card by one ``torch.Generator`` in two large calls
(normals and uniforms for every tensor of every checkpoint at once), then
cut into tensors: He-scaled kernels, BatchNorm scales and variances in
[0.5, 1.5], small biases and means; for inference the BatchNorm running
statistics are then settled on the scene's frames
(:func:`settle_batch_norm`), and so is the translation head
(:func:`settle_translation_head`). The log-quaternion head is drawn at a
tenth of He scale, so that the rotations stay under about 90 degrees, as a
trained model's do; at full scale they wrap. 7Scenes-like frames are
windows panning along a smooth random colour panorama, under an exposure and
white balance that swing along the trajectory, with per-frame sensor noise,
made on the card. RobotCar-like mosaics are GBRG Bayer windows of a smooth random
panorama, each frame a view at its own offset, made once on the host (the
trainer uploads its cache from host frames).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..reference.mapnet import normalize_rgb, param_specs, trunk

# the output heads' kernels, as a share of He scale
HEAD_SCALE = {"fc_wpqr.weight": 0.1}

__all__ = ["seeds", "seeded_states", "settle_batch_norm",
           "settle_translation_head", "panorama_frames", "trajectory_poses",
           "MosaicScene", "Frames"]


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds from the run's seed."""
    ss = np.random.SeedSequence(int(seed))
    return [int(x) for x in ss.generate_state(n, np.uint64) >> np.uint64(1)]


def seeded_states(seed: int, count: int, device, stage_sizes, feat_dim
                  ) -> list[dict]:
    """``count`` PoseNet state dicts (float32, on ``device``)."""
    specs = param_specs(stage_sizes, feat_dim)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = [s for s in specs if s[2] in ("conv", "bn_bias", "bn_mean",
                                           "fc_weight", "fc_bias")]
    uniform = [s for s in specs if s[2] in ("bn_weight", "bn_var")]
    nn_ = sum(math.prod(s[1]) for s in normal)
    nu = sum(math.prod(s[1]) for s in uniform)
    zn = torch.randn(count, nn_, generator=gen, device=device)
    zu = torch.rand(count, nu, generator=gen, device=device)
    states = []
    for c in range(count):
        st, on, ou = {}, 0, 0
        for name, shape, kind in specs:
            n = math.prod(shape)
            if kind == "bn_count":
                st[name] = torch.zeros((), dtype=torch.int64, device=device)
            elif kind in ("bn_weight", "bn_var"):
                st[name] = (zu[c, ou:ou + n] + 0.5).view(shape)
                ou += n
            else:
                z = zn[c, on:on + n].view(shape)
                on += n
                if kind in ("conv", "fc_weight"):
                    st[name] = z * (HEAD_SCALE.get(name, 1.0) * math.sqrt(
                        2.0 / math.prod(shape[1:])))
                else:
                    st[name] = z * 0.1
        states.append(st)
    return states


def settle_batch_norm(states: list, frames: torch.Tensor, n: int,
                      stage_sizes, pixel_stats) -> None:
    """Set every BatchNorm's running statistics of each state to the batch
    statistics of ``n`` frames spread evenly over ``frames`` ((N, H, W, 3)
    uint8), as a trained model's match its activations; without it the
    random trunk's features grow to hundreds and its poses with them."""
    idx = torch.linspace(0, len(frames) - 1, n, device=frames.device)
    x = normalize_rgb(frames.index_select(0, idx.round().long()),
                      list(pixel_stats[0]), list(np.sqrt(pixel_stats[1])))
    with torch.no_grad():
        for st in states:
            trunk(st, x, stage_sizes, train=True, momentum=1.0)


def settle_translation_head(states: list, frames: torch.Tensor, n: int,
                            stage_sizes, pixel_stats) -> None:
    """Point each state's translation head at what varies across the scene,
    as a trained head reads its features: its rows become the three leading
    principal directions of the ``fc_feat`` output over ``n`` frames spread
    evenly over ``frames``, all divided by the first one's spread, and its
    bias takes off their mean. Without it a random head reads mostly the
    frame-free part of the features, and a translation that ignored the
    frame would pass for right. Call after :func:`settle_batch_norm`."""
    idx = torch.linspace(0, len(frames) - 1, n, device=frames.device)
    x = normalize_rgb(frames.index_select(0, idx.round().long()),
                      list(pixel_stats[0]), list(np.sqrt(pixel_stats[1])))
    with torch.no_grad():
        for st in states:
            f = trunk(st, x, stage_sizes)
            h = torch.relu(F.linear(f, st["fc_feat.weight"],
                                    st["fc_feat.bias"])).double()
            mu = h.mean(0)
            _, sv, vh = torch.linalg.svd(h - mu, full_matrices=False)
            w = vh[:3] * (math.sqrt(n) / sv[0].clamp_min(1e-12))
            st["fc_xyz.weight"] = w.float()
            st["fc_xyz.bias"] = (st["fc_xyz.bias"].double() - w @ mu).float()


def panorama_frames(seed: int, sequences: int, per_sequence: int, h: int,
                    w: int, device, chunk: int = 250) -> torch.Tensor:
    """(sequences * per_sequence, h, w, 3) uint8 frames on ``device``:
    sequence ``s`` pans one pixel a frame along its own panorama (a random
    colour field at 1/16 resolution, bilinearly upsampled), under a contrast
    that swings between 0.5 and 1.5 with a period of 29 frames and a colour
    cast of up to +-20 per channel with a period of 37 (the exposure and
    white balance of a moving camera; short periods, so that the first
    batches, on which an int8 model is calibrated, span their whole range
    as a scene's first frames span a real camera's), plus uniform noise of
    +-8 per pixel."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((sequences * per_sequence, h, w, 3), dtype=torch.uint8,
                      device=device)
    width = w + per_sequence
    cols = torch.arange(w, device=device)
    for s in range(sequences):
        low = torch.rand((1, 3, h // 16 + 2, width // 16 + 2), generator=gen,
                         device=device) * 255.0
        pano = F.interpolate(low, size=(h, width), mode="bilinear",
                             align_corners=False)[0].permute(1, 2, 0)
        phase = torch.rand(4, generator=gen, device=device) * (2 * math.pi)
        for j in range(0, per_sequence, chunk):
            k = min(chunk, per_sequence - j)
            t = torch.arange(j, j + k, device=device, dtype=torch.float32)
            gain = 1.0 + 0.5 * torch.sin(t * (2 * math.pi / 29) + phase[0])
            cast = 20.0 * torch.sin(t[:, None] * (2 * math.pi / 37)
                                    + phase[1:])
            idx = t.long()[:, None] + cols
            win = pano[:, idx].permute(1, 0, 2, 3)          # (k, h, w, 3)
            win = ((win - 128.0) * gain[:, None, None, None] + 128.0
                   + cast[:, None, None, :])
            noise = torch.randint(-8, 9, win.shape, generator=gen,
                                  device=device, dtype=torch.int16)
            out[s * per_sequence + j:s * per_sequence + j + k] = (
                win.round().clamp(-128, 383).to(torch.int16) + noise).clamp(
                    0, 255).to(torch.uint8)
    return out


def trajectory_poses(seed: int, n: int, sequences: int = 1) -> np.ndarray:
    """(n, 6) float32 [xyz, log q] targets along smooth random camera
    paths, one loop a sequence."""
    rng = np.random.default_rng(seed)
    per = n // sequences
    out = []
    for s in range(sequences):
        a = np.linspace(0, 2 * np.pi, per, endpoint=False) + rng.uniform(
            0, 2 * np.pi)
        r = rng.uniform(0.5, 2.0, 3)
        t = np.stack([r[0] * np.cos(a), r[1] * np.sin(a),
                      0.2 * r[2] * np.sin(3 * a)], axis=1)
        logq = np.stack([0.05 * np.sin(2 * a), 0.05 * np.cos(a), a / 2 % np.pi
                         - np.pi / 2], axis=1) * 0.5
        out.append(np.concatenate([t, logq], axis=1))
    poses = np.concatenate(out)
    if len(poses) < n:
        poses = np.concatenate([poses, poses[:n - len(poses)]])
    return poses.astype(np.float32)


class Frames:
    """A frame dataset over given poses: ``get_image`` reads ``images``
    (host frames, or None where the frames live only on the card)."""

    def __init__(self, poses: np.ndarray, images=None):
        self.poses = poses
        self.gt_idx = np.arange(len(poses))
        self.images = images

    def __len__(self):
        return len(self.poses)

    def get_image(self, i):
        return None if self.images is None else self.images[int(i)]

    def get_images(self, idx, num_workers: int = 1):
        return [self.get_image(i) for i in idx]


class MosaicScene:
    """``sequences * per_sequence`` GBRG mosaics of ``h x w``, as host
    views: frame ``j`` of sequence ``s`` is the window of that sequence's
    mosaic panorama at an even offset that pans two pixels right a frame
    and sways vertically."""

    def __init__(self, seed: int, sequences: int, per_sequence: int,
                 h: int, w: int, sway: int = 64):
        rng = np.random.default_rng(seed)
        self.per, self.h, self.w = per_sequence, h, w
        self.panos = []
        for _ in range(sequences):
            ph, pw = h + 2 * sway, w + 2 * per_sequence
            low = torch.from_numpy(rng.uniform(
                0, 255, (1, 3, ph // 16 + 2, pw // 16 + 2)).astype(
                    np.float32))
            rgb = F.interpolate(low, size=(ph, pw), mode="bilinear",
                                align_corners=False)[0].numpy()
            mosaic = np.empty((ph, pw), np.uint8)
            # GBRG: G B on even rows, R G on odd rows
            mosaic[0::2, 0::2] = rgb[1, 0::2, 0::2]
            mosaic[0::2, 1::2] = rgb[2, 0::2, 1::2]
            mosaic[1::2, 0::2] = rgb[0, 1::2, 0::2]
            mosaic[1::2, 1::2] = rgb[1, 1::2, 1::2]
            self.panos.append(mosaic)
        j = np.arange(per_sequence)
        self.dy = 2 * np.round(sway / 4 * (1 + np.sin(j / 37.0))).astype(
            np.int64)
        self.dx = 2 * j

    def __len__(self):
        return len(self.panos) * self.per

    def __getitem__(self, i) -> np.ndarray:
        s, j = divmod(int(i), self.per)
        y, x = int(self.dy[j]), int(self.dx[j])
        return self.panos[s][y:y + self.h, x:x + self.w]
