"""The port's native decoder (geomapnet_tpu_torch.native) against the JAX
package's (geomapnet_tpu.native), and the datasets and CLI on it.

The port builds its own library from its copy of ``imageio.cc`` (g++ at
first use, into ``geomapnet_tpu_torch/_build/``); the JAX package loads its
own ``.so``. On the same seeded PNG and JPEG files the two must give the
same bytes: ``decode_image`` and ``decode_batch`` at the source size and
downscaled, ``decode_batch_gray`` and ``decode_batch_gray16``, the failure
flags on missing, corrupt and mis-sized files, the pread reader
(``GM_DISABLE_URING=1``, in a fresh process) and a batch that refills the
io_uring ring. Then ``SevenScenes(use_native=True)`` in modes 0, 1 and 2 and
``RobotCar`` (processed RGB with ``use_native``, raw mosaics through
``decode_batch_gray``) array for array against JAX's; an explicit
``use_native`` without a library raises with the compiler's message; and a
``--native_loader`` eval through ``cli.eval.main`` agrees with JAX's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from geomapnet_tpu import native as jax_native
from geomapnet_tpu.cli import eval as jax_eval_module
from geomapnet_tpu.data.robotcar import RobotCar as JaxRobotCar
from geomapnet_tpu.data.sevenscenes import SevenScenes as JaxSevenScenes
from geomapnet_tpu.data.transforms import ImageTransform as JaxImageTransform
from geomapnet_tpu_torch import native
from geomapnet_tpu_torch.cli import eval as port_eval
from geomapnet_tpu_torch.data.robotcar import RobotCar
from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
from geomapnet_tpu_torch.data.transforms import ImageTransform
from test_torch_eval import _make_verify_fixture, seeded_npz, write_bayer_scene
from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not jax_native.available(),
    reason="the JAX package's native library is not built")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded RGB PNGs, a grayscale PNG, an RGBA PNG, JPEGs, 8-bit and
    16-bit single-channel PNGs."""
    d = tmp_path_factory.mktemp("img")
    rng = np.random.RandomState(0)
    out = {"rgb": [], "jpg": [], "gray": [], "gray16": []}
    for i in range(4):
        p = d / f"rgb_{i}.png"
        Image.fromarray(rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
                        ).save(p)
        out["rgb"].append(p)
        p = d / f"img_{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
                        ).save(p, quality=90)
        out["jpg"].append(p)
        p = d / f"gray_{i}.png"
        Image.fromarray(rng.randint(0, 256, (24, 32)).astype(np.uint8),
                        mode="L").save(p)
        out["gray"].append(p)
        p = d / f"depth_{i}.png"
        Image.fromarray(rng.randint(0, 65536, (20, 30)).astype(np.uint16)
                        ).save(p)
        out["gray16"].append(p)
    p = d / "rgba.png"
    Image.fromarray(rng.randint(0, 256, (48, 64, 4)).astype(np.uint8),
                    mode="RGBA").save(p)
    out["rgba"] = p
    return out


def test_port_builds_its_own_library():
    assert native.available() and native.build_error() is None
    path = native.lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "geomapnet_tpu_torch"
    assert native.io_backend() == jax_native.io_backend()
    assert native.io_backend() in ("io_uring", "pread")


@pytest.mark.parametrize("kind", ["rgb", "jpg"])
@pytest.mark.parametrize("size", ["identity", "down", "down_odd", "up"])
def test_decode_image_and_batch_equal_jax(files, kind, size):
    src = np.asarray(Image.open(files[kind][0]))
    h, w = src.shape[:2]
    hw = {"identity": (h, w), "down": (h // 2, w // 2),
          "down_odd": (h // 3 + 1, w // 5 + 1), "up": (h + 7, w + 3)}[size]
    got = native.decode_image(files[kind][0], *hw)
    want = jax_native.decode_image(files[kind][0], *hw)
    assert got.shape == (*hw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if size == "identity" and kind == "rgb":
        np.testing.assert_array_equal(got, src)
    for threads in (1, 3):
        got_b, ok = native.decode_batch(files[kind], *hw, n_threads=threads)
        want_b, want_ok = jax_native.decode_batch(files[kind], *hw,
                                                  n_threads=threads)
        assert ok.all() and want_ok.all()
        np.testing.assert_array_equal(got_b, want_b)
        np.testing.assert_array_equal(got_b[0], got)


def test_gray_and_rgba_promoted_as_jax(files):
    for path, hw in ((files["gray"][0], (24, 32)), (files["rgba"], (48, 64)),
                     (files["gray"][1], (12, 16))):
        np.testing.assert_array_equal(native.decode_image(path, *hw),
                                      jax_native.decode_image(path, *hw))


def test_decode_batch_gray_and_gray16_equal_jax(files, tmp_path):
    got, ok = native.decode_batch_gray(files["gray"], 24, 32, n_threads=2)
    want, want_ok = jax_native.decode_batch_gray(files["gray"], 24, 32,
                                                 n_threads=2)
    assert got.dtype == np.uint8 and ok.all() and want_ok.all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], np.asarray(
        Image.open(files["gray"][2])))
    got16, ok16 = native.decode_batch_gray16(files["gray16"], 20, 30,
                                             n_threads=2)
    want16, _ = jax_native.decode_batch_gray16(files["gray16"], 20, 30,
                                               n_threads=2)
    assert got16.dtype == np.uint16 and ok16.all()
    np.testing.assert_array_equal(got16, want16)
    np.testing.assert_array_equal(got16[1], np.asarray(
        Image.open(files["gray16"][1])))
    # a mosaic of another size, an 8-bit file as depth: flagged failed
    paths = [files["gray"][0], files["gray16"][0]]
    for fn in (native.decode_batch_gray, jax_native.decode_batch_gray):
        assert fn(paths, 24, 32)[1].tolist() == [True, False]
    for fn in (native.decode_batch_gray16, jax_native.decode_batch_gray16):
        assert fn([files["gray"][0], files["gray16"][0]], 20, 30)[1].tolist() \
            == [False, True]


def test_failure_flags_and_corrupt_inputs(files, tmp_path):
    """Missing, random, truncated and mislabeled files are flagged failed
    by both libraries, and the good file beside them decodes the same."""
    rng = np.random.RandomState(1)
    (tmp_path / "noise.png").write_bytes(rng.bytes(4096))
    (tmp_path / "trunc.png").write_bytes(files["rgb"][0].read_bytes()[:40])
    (tmp_path / "fake.jpg").write_bytes(rng.bytes(512))
    paths = [tmp_path / "missing.png", tmp_path / "noise.png",
             tmp_path / "trunc.png", tmp_path / "fake.jpg", files["rgb"][0]]
    got, ok = native.decode_batch(paths, 48, 64, n_threads=2)
    want, want_ok = jax_native.decode_batch(paths, 48, 64, n_threads=2)
    assert ok.tolist() == want_ok.tolist() == [False] * 4 + [True]
    np.testing.assert_array_equal(got[4], want[4])
    assert native.decode_image(tmp_path / "noise.png", 8, 8) is None
    assert jax_native.decode_image(tmp_path / "noise.png", 8, 8) is None


def test_pread_reader_decodes_identically(files, tmp_path):
    """``GM_DISABLE_URING=1`` (read once per process, so in a fresh one):
    the port's library reports pread and decodes JAX's bytes."""
    paths = [str(p) for p in files["rgb"] + files["jpg"]]
    want, _ = jax_native.decode_batch(paths, 20, 28, n_threads=2)
    np.save(tmp_path / "want.npy", want)
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from geomapnet_tpu_torch import native\n"
        "assert native.io_backend() == 'pread', native.io_backend()\n"
        f"got, ok = native.decode_batch({paths!r}, 20, 28, n_threads=2)\n"
        "assert ok.all()\n"
        f"assert np.array_equal(got, np.load({str(tmp_path / 'want.npy')!r}))\n"
        "print('pread ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, GM_DISABLE_URING="1"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "pread ok" in proc.stdout


def test_large_batch_refills_the_ring(tmp_path):
    """300 files against a 64-deep ring: order and content as JAX's."""
    paths = []
    for i in range(300):
        p = tmp_path / f"f{i:04d}.png"
        Image.fromarray(np.full((4, 6, 3), i % 251, np.uint8)).save(p)
        paths.append(p)
    got, ok = native.decode_batch(paths, 4, 6, n_threads=3)
    want, _ = jax_native.decode_batch(paths, 4, 6, n_threads=3)
    assert ok.all()
    np.testing.assert_array_equal(got, want)
    assert [int(got[i, 0, 0, 0]) for i in (0, 250, 251, 299)] == \
        [0, 250, 0, 48]


# ------------------------------------------------------------- the datasets


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The 7Scenes verify fixture: two 6-frame sequences of 48x64 colour
    and 16-bit depth PNGs; the train split written once (pose_stats)."""
    root = _make_verify_fixture().build(tmp_path_factory.mktemp("7s"),
                                        n_frames=6)
    SevenScenes("heads", str(root / "deepslam" / "7Scenes"), train=True,
                asset_dir=str(root / "assets" / "7Scenes"))
    return root


def _seven(scene, cls, **kw):
    return cls("heads", str(scene / "deepslam" / "7Scenes"),
               asset_dir=str(scene / "assets" / "7Scenes"), **kw)


def _assert_frames_equal(a, b):
    if isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_frames_equal(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,transform", [
    (0, None), (1, None), (2, None), (0, "uint8")])
def test_sevenscenes_native_modes_equal_jax(scene, mode, transform):
    """Colour decoded and resized to ``native_size`` (or the 256x341
    default), depth at its own resolution, in one batch call each; the
    uint8 host transform passes the decoded colour frames through."""
    kw = dict(train=False, mode=mode, use_native=True)
    if mode == 2:
        kw["native_size"] = (24, 32)
    if transform:
        ours = _seven(scene, SevenScenes, transform=ImageTransform(
            resize=256, keep_uint8=True), **kw)
        theirs = _seven(scene, JaxSevenScenes, transform=JaxImageTransform(
            resize=256, keep_uint8=True), **kw)
    else:
        ours, theirs = _seven(scene, SevenScenes, **kw), \
            _seven(scene, JaxSevenScenes, **kw)
    idx = [4, 0, 5, 2]
    got, want = ours.get_images(idx, num_workers=2), \
        theirs.get_images(idx, num_workers=2)
    for a, b in zip(got, want):
        _assert_frames_equal(a, b)
    _assert_frames_equal(ours.get_image(3), theirs.get_image(3))
    _assert_frames_equal(ours.get_image(4), got[0])
    if mode == 1:
        pil = _seven(scene, SevenScenes, train=False, mode=1)
        _assert_frames_equal(got[1], pil.get_image(0))
    if mode == 0 and transform is None:
        assert got[0].shape == (256, 341, 3)


def test_sevenscenes_pil_depth_modes_equal_jax(scene):
    """Without the decoder, depth (mode 1) and both (mode 2) through PIL."""
    for mode in (1, 2):
        ours = _seven(scene, SevenScenes, train=False, mode=mode)
        theirs = _seven(scene, JaxSevenScenes, train=False, mode=mode)
        assert ours.d_imgs == theirs.d_imgs
        for i in (0, 5):
            _assert_frames_equal(ours.get_image(i), theirs.get_image(i))
        _assert_frames_equal(ours.get_images([1, 2])[1],
                             theirs.get_images([1, 2])[1])


def _write_rgb_robotcar(tmp_path):
    """A RobotCar sequence whose frames are processed RGB PNGs."""
    raw, assets = write_bayer_scene(tmp_path, n=5, h=24, w=32)
    rng = np.random.RandomState(2)
    for p in sorted((raw / "loop").glob("*/stereo/centre/*.png")):
        Image.fromarray(rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
                        ).save(p)
    return raw, assets


def test_robotcar_native_rgb_equals_jax(tmp_path):
    raw, assets = _write_rgb_robotcar(tmp_path)
    kw = dict(train=True, asset_dir=str(assets / "RobotCar"),
              use_native=True, native_size=(12, 16))
    ours = RobotCar("loop", str(raw), **kw)
    theirs = JaxRobotCar("loop", str(raw), **kw)
    np.testing.assert_array_equal(ours.poses, theirs.poses)
    got, want = ours.get_images([3, 1, 4]), theirs.get_images([3, 1, 4])
    for a, b in zip(got, want):
        _assert_frames_equal(a, b)
    _assert_frames_equal(ours.get_image(2), theirs.get_image(2))
    _assert_frames_equal(ours.get_image(3), got[0])
    assert got[0].shape == (12, 16, 3)


def test_robotcar_mosaics_decode_natively_as_jax(tmp_path, monkeypatch):
    """Raw mosaics go through ``decode_batch_gray`` whenever the library
    is there, as in JAX; a lossless PNG gives PIL's pixels, and a mosaic of
    another size is corrupt either way."""
    raw, assets = write_bayer_scene(tmp_path, n=5, h=8, w=12)
    kw = dict(train=True, asset_dir=str(assets / "RobotCar"),
              raw_bayer=True, raw_size=(8, 12))
    ours = RobotCar("loop", str(raw), **kw)
    theirs = JaxRobotCar("loop", str(raw), **kw)
    calls = []
    orig = native.decode_batch_gray
    monkeypatch.setattr(native, "decode_batch_gray",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got, want = ours.get_images([4, 0, 2], num_workers=2), \
        theirs.get_images([4, 0, 2], num_workers=2)
    assert calls == [1]
    for a, b in zip(got, want):
        _assert_frames_equal(a, b)
    _assert_frames_equal(ours.get_image(1), theirs.get_image(1))
    monkeypatch.setattr(native, "available", lambda: False)
    pil = ours.get_images([4, 0, 2], num_workers=2)
    for a, b in zip(pil, got):
        _assert_frames_equal(a, b)
    wrong = RobotCar("loop", str(raw), train=True,
                     asset_dir=str(assets / "RobotCar"), raw_bayer=True,
                     raw_size=(8, 10))
    monkeypatch.undo()
    assert wrong.get_images([0, 1]) == [None, None]


@pytest.fixture
def no_library(monkeypatch, capsys):
    """The port's decoder as on a host without the libpng headers."""
    from geomapnet_tpu_torch.native import build as native_build

    message = "imageio.cc:23:10: fatal error: png.h: No such file or directory"

    def fail(verbose=False):
        raise native_build.BuildError(message)

    monkeypatch.setattr(native_build, "build", fail)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    yield message


def test_missing_library_is_never_silent(no_library, tmp_path, capsys):
    """Without a library: the compiler's message goes to stderr once and is
    kept; an explicit ``use_native`` raises with it (the JAX contract: no
    PIL in its place); mosaics fall back to PIL, as JAX's do."""
    assert not native.available() and not native.available()
    err = capsys.readouterr().err
    assert err.count("png.h: No such file") == 1
    assert native.build_error() == no_library
    assert native.io_backend() is None
    for fn, args in ((native.decode_image, ("x.png", 4, 4)),
                     (native.decode_batch, (["x.png"], 4, 4)),
                     (native.decode_batch_gray, (["x.png"], 4, 4)),
                     (native.decode_batch_gray16, (["x.png"], 4, 4))):
        with pytest.raises(RuntimeError, match="png.h"):
            fn(*args)
    raw, assets = _write_rgb_robotcar(tmp_path)
    with pytest.raises(RuntimeError, match="png.h"):
        RobotCar("loop", str(raw), True, asset_dir=str(assets / "RobotCar"),
                 use_native=True)
    mosaics = RobotCar("loop", str(raw), True,
                       asset_dir=str(assets / "RobotCar"), raw_bayer=True,
                       raw_size=(24, 32))
    assert mosaics.get_images([0]) == [None]   # RGB files: not mosaics
    scene = _make_verify_fixture().build(tmp_path / "7s", n_frames=2)
    with pytest.raises(RuntimeError, match="png.h"):
        _seven(scene, SevenScenes, train=True, use_native=True)
    poses = _seven(scene, SevenScenes, train=True, use_native=True,
                   skip_images=True)
    assert poses.get_images([0, 1]) == [None, None]


def test_cli_native_loader_fails_without_the_library(no_library, scene,
                                                     tmp_path):
    npz = tmp_path / "w.npz"
    seeded_npz(npz, "posenet", _config(), "resnet18")
    with pytest.raises(RuntimeError, match="png.h"):
        port_eval.main(_argv(scene, npz, "posenet") + ["--device", "cpu",
                                                       "--native_loader"])


def _config():
    from geomapnet_tpu.cli.config import ExperimentConfig

    return ExperimentConfig()


def _argv(scene, npz, model):
    return ["--dataset", "7Scenes", "--scene", "heads", "--model", model,
            "--trunk", "resnet18", "--weights", str(npz),
            "--config_file", str(scene / "tiny.ini"), "--batch_size", "4",
            "--val", "--data_path", str(scene / "deepslam"),
            "--asset_root", str(scene / "assets")]


@pytest.mark.parametrize("extra", [[], ["--device_cache"]],
                         ids=["loader", "device_cache"])
def test_cli_native_loader_matches_jax(scene, tmp_path, extra):
    """``--native_loader`` through both CLIs on the fixture's test split
    (frames decoded and resized to 256x341 natively, MapNet ResNet-18):
    the same targets, poses within 1e-4; the loader and the device cache
    upload give the port the same poses."""
    npz = tmp_path / "w.npz"
    seeded_npz(npz, "mapnet", _config(), "resnet18")
    argv = _argv(scene, npz, "mapnet") + ["--native_loader"] + extra
    got = port_eval.main(argv + ["--device", "cpu"])
    assert got["pred_poses"].shape == (6, 7)
    jax_eval_module._SCAN_CACHE.clear()   # fault R1: no stale program
    want = jax_eval_module.main(argv)
    np.testing.assert_array_equal(got["targ_poses"], want["targ_poses"])
    assert np.abs(got["pred_poses"]).max() > 0.1
    np.testing.assert_allclose(got["pred_poses"], want["pred_poses"],
                               rtol=1e-4, atol=1e-4)
    pil = port_eval.main(_argv(scene, npz, "mapnet") + ["--device", "cpu"]
                         + extra)
    assert not np.array_equal(pil["pred_poses"], got["pred_poses"])
