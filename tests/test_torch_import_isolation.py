"""The port imports without jax, and its numpy copies equal the originals.

``geomapnet_tpu``'s host code is numpy, but its package imports pull in jax,
so the port carries copies; each copy is held here to the original on the
same inputs, exactly.
"""

import ast
import dataclasses
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import geomapnet_tpu_torch
from geomapnet_tpu.cli.config import parse_ini as jax_parse_ini
from geomapnet_tpu.data import MF as JaxMF
from geomapnet_tpu.data import Loader as JaxLoader
from geomapnet_tpu.data import vo_np as jax_vo
from geomapnet_tpu.data.robotcar import RobotCar as JaxRobotCar
from geomapnet_tpu.data.robotcar_sdk import (
    interpolate_ins_poses as jax_interpolate_ins,
)
from geomapnet_tpu.data.robotcar_sdk import (
    interpolate_vo_poses as jax_interpolate_vo,
)
from geomapnet_tpu.data import transforms as jax_transforms
from geomapnet_tpu.data.cache import CachedScene as JaxCachedScene
from geomapnet_tpu.data.synthetic import SyntheticScene as JaxSyntheticScene
from geomapnet_tpu.data.transforms import Normalize as JaxNormalize
from geomapnet_tpu.data.transforms import std_from_stats as jax_std_from_stats
from geomapnet_tpu.data.tuples import TupleSampler as JaxTupleSampler
from geomapnet_tpu.geometry import metrics as jax_metrics
from geomapnet_tpu.geometry import process as jax_process
from geomapnet_tpu.geometry import rotations as jax_rot
from geomapnet_tpu_torch.cli.config import parse_ini
from geomapnet_tpu_torch.data import transforms, vo_np
from geomapnet_tpu_torch.data.cache import CachedScene
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.loader import Loader
from geomapnet_tpu_torch.data.robotcar import RobotCar
from geomapnet_tpu_torch.data.robotcar_sdk import (
    interpolate_ins_poses,
    interpolate_vo_poses,
)
from geomapnet_tpu_torch.data.synthetic import SyntheticScene
from geomapnet_tpu_torch.data.transforms import Normalize, std_from_stats
from geomapnet_tpu_torch.data.tuples import TupleSampler
from geomapnet_tpu_torch.geometry import metrics, process
from geomapnet_tpu_torch.geometry import rotations as rot
from test_torch_eval import SEQ, write_bayer_scene
from test_torch_eval_pgo import write_stereo_vo

REPO = Path(__file__).resolve().parent.parent
PKG = Path(geomapnet_tpu_torch.__file__).parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax")


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="geomapnet_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter with jax, flax, optax and orbax made unimportable
    imports every module of the port."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [k for k, v in sys.modules.items()\n"
        f"          if v is not None and k.split('.')[0] in {BLOCKED!r}]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_new_modules_are_covered():
    """The torch geometry, PGO and training modules are among those imported
    with the JAX stack blocked (above) and scanned for imports (below)."""
    mods = set(_port_modules())
    for m in ("geometry.quaternion", "geometry.se3", "geometry.vo", "pgo",
              "pgo.pose_graph", "losses.criterion", "models.torch_import",
              "train.optim", "train.state", "train.checkpoint", "train.loop",
              "utils.logger", "cli.train", "data.robotcar_sdk",
              "data.composite", "native", "native.build", "serving",
              "ops.library", "geometry.align", "cli.tools", "parallel",
              "parallel.mesh", "parallel.multihost", "parallel.tensor",
              "parallel.pipeline", "dryrun"):
        assert f"geomapnet_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("module", ("parallel.tensor", "parallel.pipeline",
                                    "dryrun"))
def test_grid_modules_import_neither_jax_nor_the_jax_package(module):
    """Tensor parallelism, the pipeline and the dry run import in a fresh
    interpreter where the JAX stack and ``geomapnet_tpu`` are unimportable,
    load neither, and name neither in an import statement."""
    blocked = BLOCKED + ("geomapnet_tpu",)
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"importlib.import_module('geomapnet_tpu_torch.{module}')\n"
        "loaded = [k for k, v in sys.modules.items()\n"
        f"          if v is not None and k.split('.')[0] in {blocked!r}]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    path = PKG / (module.replace(".", "/") + ".py")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in blocked, f"{path}: {n}"


def test_no_module_names_jax():
    """No import statement anywhere in the port names a JAX-stack package."""
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BLOCKED, f"{path}: {n}"


def _rotations(n=16, seed=0):
    rng = np.random.RandomState(seed)
    eul = rng.uniform(-np.pi, np.pi, (n, 3))
    return np.stack([jax_rot.euler2mat(*e) for e in eul]), eul


@pytest.mark.parametrize("fn,args", [
    ("mat2quat", lambda R, q, v, e: (R[0],)),
    ("mat2quat_batch", lambda R, q, v, e: (R,)),
    ("quat2mat", lambda R, q, v, e: (q,)),
    ("euler2mat", lambda R, q, v, e: tuple(e[0])),
    ("mat2euler", lambda R, q, v, e: (R[1],)),
    ("qmult_np", lambda R, q, v, e: (q, q[::-1])),
    ("qinv_np", lambda R, q, v, e: (q,)),
    ("qexp_np", lambda R, q, v, e: (v,)),
    ("qlog_np", lambda R, q, v, e: (q,)),
    ("rotate_vector_np", lambda R, q, v, e: (v, q)),
])
def test_rotations_copy(fn, args):
    R, eul = _rotations()
    q = jax_rot.mat2quat_batch(R)
    v = np.random.RandomState(1).randn(len(R), 3)
    a = args(R, q, v, eul)
    np.testing.assert_array_equal(getattr(rot, fn)(*a),
                                  getattr(jax_rot, fn)(*a))


def test_process_and_metrics_copies():
    R, _ = _rotations(seed=2)
    rng = np.random.RandomState(3)
    poses = np.concatenate([R, rng.randn(len(R), 3, 1)], axis=2)
    poses = poses.reshape(-1, 12)
    align = (R[0], rng.randn(3), 1.7)
    args = (poses, rng.randn(3), rng.uniform(0.5, 2, 3)) + align
    p = process.process_poses(*args)
    np.testing.assert_array_equal(p, jax_process.process_poses(*args))
    q = rot.qexp_np(p[:, 3:])
    np.testing.assert_array_equal(
        metrics.translation_error(p[:, :3], p[::-1, :3]),
        jax_metrics.translation_error(p[:, :3], p[::-1, :3]))
    np.testing.assert_array_equal(
        metrics.quaternion_angular_error(q, q[::-1]),
        jax_metrics.quaternion_angular_error(q, q[::-1]))
    for fn in ("vos_simple_np", "vos_logq_np", "vos_logq_fc_np"):
        np.testing.assert_array_equal(getattr(vo_np, fn)(p[:5]),
                                      getattr(jax_vo, fn)(p[:5]))


@pytest.mark.parametrize("kw", [dict(steps=3, skip=2),
                                dict(steps=5, skip=3, no_duplicates=True),
                                dict(steps=3, skip=4, variable_skip=True)])
def test_tuple_sampler_copy(kw):
    a = TupleSampler(dataset_len=20, **kw)
    b = JaxTupleSampler(dataset_len=20, **kw)
    assert len(a) == len(b)
    np.testing.assert_array_equal(a.index_matrix(np.random.RandomState(0)),
                                  b.index_matrix(np.random.RandomState(0)))


class _Frames:
    """In-memory frame dataset: frame i is an image filled with i."""

    def __init__(self, n=13, bad=()):
        self.poses = np.random.RandomState(4).randn(n, 6).astype(np.float32)
        self.gt_idx = np.arange(n)
        self.bad = set(bad)

    def __len__(self):
        return len(self.poses)

    def get_image(self, i):
        return None if i in self.bad else np.full((2, 3), i, np.uint8)

    def __getitem__(self, i):
        return self.get_image(i), self.poses[i]


@pytest.mark.parametrize("kw", [dict(steps=3, skip=2),
                                dict(steps=3, skip=3, variable_skip=True,
                                     deterministic_indices=True),
                                dict(steps=2, skip=1, include_vos=True)])
def test_mf_and_loader_copies(kw):
    """MF tuples and padded eval batches (a corrupt frame included) equal the
    originals batch for batch."""
    frames = _Frames(bad=(5,))
    ours = Loader(MF(frames, **kw), 4, drop_last=False, num_workers=2)
    theirs = JaxLoader(JaxMF(frames, **kw), 4, drop_last=False,
                       num_workers=2)
    assert len(ours) == len(theirs)
    for (ia, pa, na), (ib, pb, nb) in zip(ours, theirs, strict=True):
        assert na == nb
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("gps", [False, True])
def test_mfonline_and_only_poses_copies(gps):
    """MapNet++'s composite: items (a corrupt unlabeled frame included),
    ``get_indices`` rows, ``_poses_for`` blocks and ``frame_sources`` equal
    the originals, with VO targets and in ``gps_mode``; so do
    ``OnlyPoses``' (real, ground-truth) pairs."""
    from geomapnet_tpu.data import MFOnline as JaxMFOnline
    from geomapnet_tpu.data import OnlyPoses as JaxOnlyPoses
    from geomapnet_tpu_torch.data import MFOnline, OnlyPoses

    train, unlab, gt = _Frames(9), _Frames(13, bad=(6,)), _Frames(13)
    unlab.gt_idx = np.arange(13)[::-1].copy()

    def build(mf, online, vo):
        kw = dict(steps=3, skip=2)
        return online(mf(train, **kw), mf(
            unlab, include_vos=not gps, real=not gps, no_duplicates=True,
            gt_dataset=None if gps else gt, vo_func=vo.vos_logq_np, **kw),
            gps_mode=gps)

    ours, theirs = build(MF, MFOnline, vo_np), build(JaxMF, JaxMFOnline,
                                                      jax_vo)
    assert len(ours) == len(theirs)
    assert ours.frame_sources == theirs.frame_sources == (train, unlab)
    for i in range(len(ours)):
        idx = ours.get_indices(i)
        np.testing.assert_array_equal(idx, theirs.get_indices(i))
        np.testing.assert_array_equal(ours._poses_for(idx),
                                      theirs._poses_for(idx))
        (a, p), (b, q) = ours[i], theirs[i]
        assert (a is None) == (b is None) and (p is None) == (q is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(p, q)
    assert any(ours[i][0] is None for i in range(len(ours)))
    pairs, jpairs = OnlyPoses(unlab, gt), JaxOnlyPoses(unlab, gt)
    assert len(pairs) == len(jpairs) == 13
    for i in (0, 5, 12):
        for x, y in zip(pairs[i], jpairs[i], strict=True):
            np.testing.assert_array_equal(x, y)


def test_robotcar_sdk_image_copies(tmp_path):
    """``demosaic_gbrg``, ``CameraModel`` (intrinsics, LUT, undistortion)
    and ``load_stereo_image`` (a mosaic, an RGB image, an unreadable file;
    with and without a model) equal the originals."""
    from PIL import Image

    from geomapnet_tpu.data import robotcar_sdk as jsdk
    from geomapnet_tpu_torch.data import robotcar_sdk as sdk

    rs = np.random.RandomState(2)
    for shape in ((8, 12), (7, 9)):
        raw = rs.randint(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(sdk.demosaic_gbrg(raw),
                                      jsdk.demosaic_gbrg(raw))
    h, w = 8, 12
    d = tmp_path / "models"
    d.mkdir()
    np.savetxt(d / "stereo_narrow_left.txt", [[400.0, 401.0, 6.0, 4.0]])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    np.stack([(xx + 0.6 * np.sin(yy)).ravel(),
              (yy + 0.4 * np.cos(xx) - 0.5).ravel()]).tofile(
        d / "stereo_narrow_left_distortion_lut.bin")
    ours = sdk.CameraModel(d, "stereo/centre")
    theirs = jsdk.CameraModel(d, "stereo/centre")
    assert (ours.focal_length, ours.principal_point) == (
        theirs.focal_length, theirs.principal_point)
    np.testing.assert_array_equal(ours.lut, theirs.lut)
    for sub in ("stereo/left", "stereo/right", "mono_rear"):
        assert sdk.CameraModel._model_name(sub) == \
            jsdk.CameraModel._model_name(sub)
    img = rs.uniform(0, 255, (h, w, 3)).astype(np.float32)
    np.testing.assert_array_equal(ours.undistort(img), theirs.undistort(img))
    Image.fromarray(rs.randint(0, 256, (h, w), dtype=np.uint8)).save(
        tmp_path / "mosaic.png")
    Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
        tmp_path / "rgb.png")
    for name in ("mosaic.png", "rgb.png"):
        for a, b in ((None, None), (ours, theirs)):
            np.testing.assert_array_equal(
                sdk.load_stereo_image(tmp_path / name, a),
                jsdk.load_stereo_image(tmp_path / name, b))
    assert sdk.load_stereo_image(tmp_path / "missing.png") is None


@pytest.mark.parametrize("bad", [(), (0, 4)])
def test_device_cache_copies(bad):
    """``frame_sources``, ``_ConcatFrames`` (a composite's sources in one
    index space) and a recorder's finalize over corrupt frames equal the
    originals."""
    from geomapnet_tpu.data import device_cache as jdc
    from geomapnet_tpu_torch.data import device_cache as dc

    a, b = _Frames(5, bad=bad), _Frames(7)
    comp = type("Composite", (), {"frame_sources": (a, b)})()
    for ds in (comp, MF(a), a):
        assert dc.frame_sources(ds) == jdc.frame_sources(ds)
    ours, theirs = dc._ConcatFrames([a, b]), jdc._ConcatFrames([a, b])
    assert len(ours) == len(theirs) == 12
    idx = [11, 0, 5, 4, 6]
    for x, y in zip(ours.get_images(idx), theirs.get_images(idx)):
        assert (x is None and y is None) or np.array_equal(x, y)
    assert np.array_equal(ours.get_image(9), theirs.get_image(9))
    if not bad:
        rec, jrec = dc.FrameRecorder(a).install(), \
            jdc.FrameRecorder(a).install()
        a.get_image(3)
        np.testing.assert_array_equal(rec.finalize(num_workers=1),
                                      jrec.finalize(num_workers=1))


def test_loader_stops_its_thread_on_early_exit():
    """A consumer that stops after two batches stops the prefetch thread:
    it fetches at most the batches in flight and is gone at ``close()``."""
    import threading
    import time

    fetched = []

    class Slow(_Frames):
        def __getitem__(self, i):
            fetched.append(i)
            time.sleep(0.005)
            return super().__getitem__(i)

    before = threading.active_count()
    batches = iter(Loader(Slow(n=200), 4, drop_last=False))
    for _, _batch in zip(range(2), batches):
        pass
    batches.close()
    assert threading.active_count() == before
    n = len(fetched)
    time.sleep(0.1)
    assert len(fetched) == n <= 4 * 5   # 2 taken, 2 queued, 1 in hand


def test_loader_shuffled_drop_last_copy():
    frames = _Frames()
    ours = list(Loader(frames, 3, shuffle=True, seed=11))
    theirs = list(JaxLoader(frames, 3, shuffle=True, seed=11))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_process_sharding_copy(drop_last):
    """The process-sharded branch: every process's batches, pads and
    length equal the original's on a ragged, shuffled dataset."""
    frames = _Frames(n=11)
    for p in range(3):
        kw = dict(shuffle=True, seed=4, drop_last=drop_last,
                  process_index=p, process_count=3)
        ours, theirs = list(Loader(frames, 2, **kw)), \
            list(JaxLoader(frames, 2, **kw))
        assert len(ours) == len(theirs) == len(Loader(frames, 2, **kw))
        for a, b in zip(ours, theirs, strict=True):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_transforms_copies():
    stats = np.array([[0.45, 0.45, 0.46], [0.078, 0.077, 0.072]])
    for x, y in zip(std_from_stats(stats), jax_std_from_stats(stats)):
        np.testing.assert_array_equal(x, y)
    img = np.random.RandomState(5).rand(4, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(Normalize(*stats)(img),
                                  JaxNormalize(*stats)(img))


def _photo(h=480, w=640, seed=6):
    """A 7Scenes-sized PIL colour image: smooth shapes plus noise."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(xx / 37.0)[..., None] * np.cos(
        yy / 23.0)[..., None] * rng.uniform(0.3, 1.0, 3)
    return Image.fromarray(np.clip(base + rng.randn(h, w, 3) * 9, 0,
                                   255).astype(np.uint8))


@pytest.mark.parametrize("kw", [
    dict(resize=256, keep_uint8=True),
    dict(resize=256, normalize=(0.45, 0.28)),
    dict(resize=None),
    dict(resize=128, keep_uint8=True, color_jitter_strength=0.7),
    dict(resize=128, color_jitter_strength=0.3, normalize=(0.4, 0.3)),
], ids=["uint8", "host_normalized", "raw", "jitter_uint8", "jitter_norm"])
def test_image_transform_copy(kw):
    """A 480x640 frame through both ImageTransforms: PIL's bilinear
    shortest-side resize (to 256x341) and the rint to uint8 bit for bit,
    the jitter draws from equal seeds."""
    img = _photo()
    outs = []
    for mod in (transforms, jax_transforms):
        t_kw = dict(kw)
        if "normalize" in t_kw:
            t_kw["normalize"] = mod.Normalize(*t_kw["normalize"])
        outs.append(mod.ImageTransform(rng=np.random.RandomState(9),
                                       **t_kw)(img))
    ours, theirs = outs
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    if kw.get("resize") == 256:
        assert ours.shape == (256, 341, 3)


def test_transforms_functions_copies():
    img = _photo(60, 90)
    for size in (30, 60, 200):
        np.testing.assert_array_equal(
            np.asarray(transforms.resize_shorter_side(img, size)),
            np.asarray(jax_transforms.resize_shorter_side(img, size)))
    arr = np.asarray(img, np.float64)
    for seed in range(4):
        np.testing.assert_array_equal(
            transforms.color_jitter(arr, np.random.RandomState(seed), 0.5,
                                    0.5, 0.5, 0.5),
            jax_transforms.color_jitter(arr, np.random.RandomState(seed),
                                        0.5, 0.5, 0.5, 0.5))
    u8 = np.asarray(img)
    gray = u8[..., 0].astype(np.float32)
    for x in (u8, gray):   # already-decoded arrays
        for keep in (True, False):
            np.testing.assert_array_equal(
                transforms.ImageTransform(keep_uint8=keep)(x),
                jax_transforms.ImageTransform(keep_uint8=keep)(x))


@pytest.mark.parametrize("kw", [dict(train=True), dict(train=False),
                                dict(train=False, real=True),
                                dict(train=True, height=16, width=20,
                                     n_frames=9, seed=3)])
def test_synthetic_scene_copy(kw):
    ours, theirs = SyntheticScene(**kw), JaxSyntheticScene(**kw)
    assert len(ours) == len(theirs)
    np.testing.assert_array_equal(ours.poses, theirs.poses)
    np.testing.assert_array_equal(ours.gt_idx, theirs.gt_idx)
    for i in (0, len(ours) // 2, len(ours) - 1):
        np.testing.assert_array_equal(ours[i][0], theirs[i][0])
    assert SyntheticScene(skip_images=True).get_image(0) is None


def test_cached_scene_copy_in_memory():
    """Over an in-memory scene with a corrupt frame: same frames, counters
    and budget cut-off; corrupt frames are never cached; entries frozen."""
    a = CachedScene(_Frames(bad=(2,)), max_bytes=4 * 6)
    b = JaxCachedScene(_Frames(bad=(2,)), max_bytes=4 * 6)
    for idx in ([0, 1, 2], [2, 3, 3, 4], [5, 0, 6]):
        for x, y in zip(a.get_images(idx), b.get_images(idx), strict=True):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    assert (a.hits, a.misses, a.cached_frames, a.cached_bytes) == (
        b.hits, b.misses, b.cached_frames, b.cached_bytes) == (1, 9, 4, 24)
    assert not a.get_image(0).flags.writeable
    assert len(a) == 13
    np.testing.assert_array_equal(a[7][1], b[7][1])


def test_ins_interpolation_and_robotcar_poses(tmp_path):
    raw, assets = write_bayer_scene(tmp_path, n=7, h=8, w=12)
    ins = raw / "loop" / "2014-06-26-08-53-56" / "gps" / "ins.csv"
    stamps = [1000, 1500, 2600, 7000]
    np.testing.assert_array_equal(
        np.asarray(interpolate_ins_poses(ins, stamps, 1200)),
        np.asarray(jax_interpolate_ins(ins, stamps, 1200)))
    for train in (True, False):  # the train split writes pose_stats.txt
        ours = RobotCar("loop", str(raw), train=train,
                        asset_dir=str(assets / "RobotCar"), raw_bayer=True,
                        raw_size=(8, 12))
        theirs = JaxRobotCar("loop", str(raw), train=train,
                             asset_dir=str(assets / "RobotCar"),
                             raw_bayer=True, raw_size=(8, 12))
        np.testing.assert_array_equal(ours.poses, theirs.poses)
        np.testing.assert_array_equal(ours.get_image(3), theirs.get_image(3))
        assert [str(p) for p in ours.imgs] == [str(p) for p in theirs.imgs]


@pytest.mark.parametrize("vo_lib", ["stereo", "gps"])
def test_vo_interpolation_and_real_robotcar_poses(tmp_path, vo_lib):
    """``interpolate_vo_poses`` equals JAX's, and so do RobotCar's "real"
    poses (integrated stereo VO, or GPS, aligned by the sequence's pickle)
    and a pose-only dataset's poses."""
    import pickle

    raw, assets = write_bayer_scene(tmp_path, n=9, h=8, w=12)
    write_stereo_vo(raw, assets, n=9)
    seq = raw / "loop" / SEQ
    vo = seq / "vo" / "vo.csv"
    stamps = [1000, 1500, 2600, 7000, 9000]
    np.testing.assert_array_equal(
        np.asarray(interpolate_vo_poses(vo, stamps, 1200)),
        np.asarray(jax_interpolate_vo(vo, stamps, 1200)))
    # GPS: every other INS row, in the same schema
    ins = (seq / "gps" / "ins.csv").read_text().splitlines()
    (seq / "gps" / "gps_ins.csv").write_text("\n".join(ins[:1]
                                                        + ins[1::2]))
    with open(assets / "RobotCar" / "loop" / SEQ / "gps_vo_stats.pkl",
              "wb") as f:
        pickle.dump({"R": jax_rot.euler2mat(0.1, 0, 0.3),
                     "t": np.array([1.0, 2, 3]), "s": 1.2}, f)
    rc = str(assets / "RobotCar")
    RobotCar("loop", str(raw), train=True, asset_dir=rc, raw_size=(8, 12))
    for kw in (dict(real=True, vo_lib=vo_lib), dict(skip_images=True)):
        ours = RobotCar("loop", str(raw), train=False, asset_dir=rc,
                        raw_size=(8, 12), **kw)
        theirs = JaxRobotCar("loop", str(raw), train=False, asset_dir=rc,
                             raw_bayer=True, raw_size=(8, 12), **kw)
        np.testing.assert_array_equal(ours.poses, theirs.poses)
        np.testing.assert_array_equal(ours.gt_idx, theirs.gt_idx)
        if "skip_images" in kw:
            assert ours.get_image(0) is None is theirs.get_image(0)
            assert ours.get_images([0, 1]) == [None, None]


def test_robotcar_wrong_size_frame_is_corrupt(tmp_path):
    raw, assets = write_bayer_scene(tmp_path, n=3, h=8, w=12)
    ds = RobotCar("loop", str(raw), train=True,
                  asset_dir=str(assets / "RobotCar"), raw_bayer=True,
                  raw_size=(8, 14))
    assert ds.get_image(0) is None
    assert ds.get_images([0, 1], num_workers=2) == [None, None]


@pytest.mark.parametrize("ini", sorted((REPO / "configs").glob("*.ini")),
                         ids=lambda p: p.name)
def test_parse_ini_copy(ini):
    assert dataclasses.asdict(parse_ini(ini)) == dataclasses.asdict(
        jax_parse_ini(ini))


@pytest.mark.parametrize("fn", ["_bn_affine", "_fold_conv_bn",
                                "_fold_conv_bn_float", "_stem_kernel_s2d",
                                "_walk_and_sites"])
def test_quant_tree_copies(fn):
    """The numpy tree preparation of models/quant.py: each copied helper
    equals the original on the same inputs, exactly."""
    import geomapnet_tpu.models.quant as jq
    from geomapnet_tpu_torch.models import quant as pq

    rng = np.random.RandomState(7)
    bn = {"scale": rng.uniform(0.5, 1.5, 8), "bias": rng.randn(8)}
    stats = {"mean": rng.randn(8), "var": rng.uniform(0.5, 1.5, 8)}
    kernel = rng.randn(7, 7, 3, 8)
    if fn == "_bn_affine":
        outs = [m._bn_affine(bn, stats) for m in (pq, jq)]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    elif fn == "_stem_kernel_s2d":
        q = rng.randint(-127, 128, (7, 7, 3, 8)).astype(np.int8)
        np.testing.assert_array_equal(pq._stem_kernel_s2d(q),
                                      jq._stem_kernel_s2d(q))
    elif fn == "_walk_and_sites":
        # a 2-stage trunk with a projection block: same block walk, same
        # site order, stage sizes and fusability
        blk = {f"{c}": {"kernel": kernel} for c in ("conv1", "conv2",
                                                    "downsample_conv")}
        blk.update({b: dict(bn) for b in ("bn1", "bn2", "downsample_bn")})
        blk_s = {b: dict(stats) for b in ("bn1", "bn2", "downsample_bn")}
        trunk_p = {"conv1": {"kernel": kernel}, "bn1": bn,
                   "layer1_0": blk, "layer2_0": blk, "layer2_1": blk}
        trunk_s = {"bn1": stats, "layer1_0": blk_s, "layer2_0": blk_s,
                   "layer2_1": blk_s}
        heads = {k: {"kernel": rng.randn(8, 3), "bias": rng.randn(3)}
                 for k in ("fc_feat", "fc_xyz", "fc_wpqr")}
        variables = {"params": {"feature_extractor": trunk_p, **heads},
                     "batch_stats": {"feature_extractor": trunk_s}}
        trees = [m._prepare_tree(variables, (1, 2), m._fold_conv_bn, True)
                 for m in (pq, jq)]
        for m, t in zip((pq, jq), trees):
            assert m._stage_sizes(t["trunk"]) == (1, 2)
        sites = [[s["m"] for s in m._iter_sites(t)]
                 for m, t in zip((pq, jq), trees)]
        assert len(sites[0]) == len(sites[1]) == 1 + 3 * 3
        for a, b in zip(*sites):
            np.testing.assert_array_equal(a, b)
        assert pq._is_fusable(trees[0]) is jq._is_fusable(trees[1]) is False
        for site in pq._iter_sites(trees[0]):
            site["x_scale"] = np.float32(0.1)
        assert pq._is_fusable(trees[0])
    else:
        outs = [getattr(m, fn)(kernel, bn, stats) for m in (pq, jq)]
        assert outs[0].keys() == outs[1].keys()
        for k in outs[0]:
            np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_package_import_loads_no_submodule():
    code = ("import sys, geomapnet_tpu_torch\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('geomapnet_tpu_torch.')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.stdout.strip() == "[]", proc.stderr


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def _torchvision_trunk(seed=8):
    from geomapnet_tpu.models.torchvision_layout import resnet34_state_shapes

    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) if s else np.int64(3)
            for k, s in resnet34_state_shapes(include_fc=True).items()}


@pytest.mark.parametrize("source", ["posenet", "mapnet", "module.mapnet",
                                    "torchvision", "resnet50"])
def test_torch_import_convert_copy(source):
    """``convert_state_dict`` maps every key and value as the original: an
    upstream PoseNet state dict, the same under MapNet's ``mapnet.`` and a
    DataParallel ``module.mapnet.`` prefix, a torchvision ResNet-34 trunk
    (its ImageNet ``fc`` dropped) and a ResNet-50 one."""
    import geomapnet_tpu.models.torch_import as jti
    from geomapnet_tpu.models import torchvision_layout as tl
    from geomapnet_tpu_torch.models import torch_import as pti

    if source == "torchvision":
        sd = _torchvision_trunk()
    elif source == "resnet50":
        sd = tl.synthetic_resnet50_state_dict(torch_tensors=False)
    else:
        sd = tl.synthetic_posenet_state_dict(feat_dim=16,
                                             torch_tensors=False)
        if source != "posenet":
            sd = {f"{source}.{k}": v for k, v in sd.items()}
    _tree_equal(pti.convert_state_dict(sd), jti.convert_state_dict(sd))
    if source == "posenet":
        bad = dict(sd, **{"extra.weight": np.zeros(2, np.float32)})
        for mod in (pti, jti):
            with pytest.raises(KeyError, match="unmapped torch key"):
                mod.convert_state_dict(bad, strict=True)


def test_torch_import_checkpoint_npz_and_merge_copies(tmp_path):
    """``load_torch_checkpoint`` of an upstream ``.pth.tar``, the npz round
    trip across the two packages, and ``merge_variables`` (a partial
    import, a shape mismatch, an unknown key) as the originals."""
    import torch

    import geomapnet_tpu.models.torch_import as jti
    from geomapnet_tpu.models import torchvision_layout as tl
    from geomapnet_tpu_torch.models import torch_import as pti

    sd = tl.synthetic_posenet_state_dict(feat_dim=16)
    path = tmp_path / "epoch_010.pth.tar"
    torch.save({"epoch": 10, "model_state_dict": {
        f"mapnet.{k}": v for k, v in sd.items()}}, path)
    ours, theirs = (m.load_torch_checkpoint(str(path)) for m in (pti, jti))
    _tree_equal(ours, theirs)

    pti.save_npz(str(tmp_path / "a.npz"), ours)
    jti.save_npz(str(tmp_path / "b.npz"), theirs)
    _tree_equal(jti.load_npz(str(tmp_path / "a.npz")),
                pti.load_npz(str(tmp_path / "b.npz")))

    trunk_only = {c: {"feature_extractor": t["feature_extractor"]}
                  for c, t in ours.items()}
    base = jti.convert_state_dict(
        tl.synthetic_posenet_state_dict(feat_dim=16, torch_tensors=False))

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}

    base = zeros(base)
    _tree_equal(pti.merge_variables(base, trunk_only),
                jti.merge_variables(base, trunk_only))
    wrong = {"params": {"fc_xyz": {"bias": np.zeros(5, np.float32)}}}
    unknown = {"params": {"fc_extra": {"bias": np.zeros(3, np.float32)}}}
    for mod in (pti, jti):
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.merge_variables(base, wrong)
        with pytest.raises(KeyError, match="not in model"):
            mod.merge_variables(base, unknown)


@pytest.mark.parametrize("args", [
    ("7Scenes", "heads", "mapnet", "configs/mapnet.ini", True, True, ""),
    ("RobotCar", "loop", "posenet", "/x/posenet.ini", True, False, "_a"),
    ("synth", "synth", "mapnet", "tiny.ini", False, False, ""),
])
def test_experiment_name_copy(args):
    from geomapnet_tpu.cli.builders import experiment_name as jax_name
    from geomapnet_tpu_torch.cli.builders import experiment_name

    assert experiment_name(*args) == jax_name(*args)


def test_logger_copies(tmp_path, capsys):
    """``MetricsWriter`` writes the same records as the original (its
    wall-clock stamp aside), ``AverageMeter`` keeps the same running
    values, ``Tee`` mirrors stdout to its file as the original does."""
    from geomapnet_tpu.utils import logger as jl
    from geomapnet_tpu_torch.utils import logger as pl

    records = [dict(kind="train", step=1, loss=0.25, lr=1e-4, sax=0.0),
               dict(kind="val", epoch=0, step=4, loss=1.5),
               dict(kind="train", step=5, t=7.0)]
    for name, mod in (("port", pl), ("jax", jl)):
        w = mod.MetricsWriter(tmp_path / name / "metrics.jsonl")
        for r in records:
            w.write(**r)
        w.close()
        assert not mod.MetricsWriter(tmp_path / "off.jsonl",
                                     enabled=False).enabled
    lines = [[json.loads(x) for x in open(tmp_path / n / "metrics.jsonl")]
             for n in ("port", "jax")]
    for a, b in zip(*lines, strict=True):
        assert a.keys() == b.keys()
        assert {k: v for k, v in a.items() if k != "t"} == \
            {k: v for k, v in b.items() if k != "t"}
    assert lines[0][2]["t"] == lines[1][2]["t"] == 7.0

    meters = [mod.AverageMeter() for mod in (pl, jl)]
    for v, n in ((1.0, 1), (3.5, 2), (0.25, 4)):
        for m in meters:
            m.update(v, n)
        assert vars(meters[0]) == vars(meters[1])

    for name, mod in (("port", pl), ("jax", jl)):
        tee = mod.Tee(tmp_path / f"{name}.txt").install()
        try:
            print(f"line {name}")
        finally:
            tee.uninstall()
            tee.close()
        assert (tmp_path / f"{name}.txt").read_text() == f"line {name}\n"
    assert capsys.readouterr().out == "line port\nline jax\n"


def test_native_source_is_a_copy():
    """The port compiles a byte-for-byte copy of the JAX package's decoder
    source."""
    assert (PKG / "native" / "imageio.cc").read_bytes() == \
        (REPO / "geomapnet_tpu" / "native" / "imageio.cc").read_bytes()


def test_port_never_loads_the_jax_library():
    """A process that decodes through the port maps the port's own build
    of the library, never ``geomapnet_tpu/native/libgeomapnet_io.so``."""
    code = (
        "import numpy as np\n"
        "from geomapnet_tpu_torch import native\n"
        "assert native.available(), native.build_error()\n"
        "out, ok = native.decode_batch(['missing.png'], 4, 4)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libgeomapnet_io' not in maps\n"
        "assert str(native.lib_path()) in maps\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    for path in PKG.rglob("*.py"):
        assert "libgeomapnet_io" not in path.read_text(), path


def _align_inputs(seed=5, n=12):
    rng = np.random.RandomState(seed)
    R = np.stack([jax_rot.euler2mat(*e)
                  for e in rng.uniform(-np.pi, np.pi, (n, 3))])
    x1 = rng.randn(3, n)
    Rg = jax_rot.euler2mat(0.3, -0.2, 1.1)
    x2 = 1.7 * Rg @ (x1 - rng.randn(3, 1)) + 0.01 * rng.randn(3, n)
    R2 = np.einsum("ij,njk->nik", Rg, R)
    return x1, x2, R, R2


@pytest.mark.parametrize("fn,args", [
    ("align_pts", lambda x1, x2, R1, R2: (x1, x2)),
    ("align_3d_pts", lambda x1, x2, R1, R2: (x1, x2)),
    ("align_2d_pts", lambda x1, x2, R1, R2: (x1[:2], x2[:2])),
    ("align_3d_pts_noscale", lambda x1, x2, R1, R2: (x1, x2)),
    ("align_2d_pts_noscale", lambda x1, x2, R1, R2: (x1[:2], x2[:2])),
    ("align_camera_poses", lambda x1, x2, R1, R2: (x1, x2, R1, R2)),
    ("align_camera_poses", lambda x1, x2, R1, R2: (x1, x2, R1, R2, True)),
])
def test_align_copy(fn, args):
    """``geometry/align.py`` is a copy of the JAX package's: the same
    similarity transforms on the same trajectories, exactly."""
    from geomapnet_tpu.geometry import align as jax_align
    from geomapnet_tpu_torch.geometry import align

    a = args(*_align_inputs())
    got, want = getattr(align, fn)(*a), getattr(jax_align, fn)(*a)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
