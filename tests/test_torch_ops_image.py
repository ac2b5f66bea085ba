"""The port's image ops against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages. The Pallas
demosaic kernel runs in interpret mode here (its default off the TPU), and
the port's CPU path is the kernel's plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.ops.image import make_device_pipeline as jax_pipeline
from geomapnet_tpu.ops.image import resize_bilinear_matmul as jax_resize
from geomapnet_tpu.ops.pallas_image import demosaic_half_normalize as jax_dhn
from geomapnet_tpu_torch.ops import cuda_image
from geomapnet_tpu_torch.ops.image import (
    demosaic_half,
    make_device_pipeline,
    normalize,
    resize_bilinear_matmul,
    resize_shorter_side_shape,
)

MEAN = (0.45, 0.45, 0.46)
STD = tuple(float(s) for s in np.sqrt([0.078, 0.077, 0.072]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _mosaic(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def _bf16_ulps(a: torch.Tensor, b: np.ndarray) -> int:
    """Largest distance in bf16 ulps (ordered bit patterns) between a torch
    bf16 tensor and a JAX bf16 array."""
    ia = a.view(torch.int16).numpy().astype(np.int32)
    ib = np.asarray(b).view(np.int16).astype(np.int32)
    # map sign-magnitude bit patterns onto a monotone integer line
    ia = np.where(ia < 0, -32768 - ia, ia)
    ib = np.where(ib < 0, -32768 - ib, ib)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("shape", [(2, 16, 256), (3, 32, 48)])
@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demosaic_reference_matches_pallas(shape, planar, dtype):
    """Plain version of the CUDA kernel == the Pallas kernel (interpret
    mode): within 1e-6 in f32 (XLA may turn the division by a constant std
    into a multiply by its reciprocal, a 1-ulp difference) and within 1 bf16
    ulp in bf16 (the same 1-ulp f32 difference can flip one rounding)."""
    raw = _mosaic(shape)
    want = np.asarray(jax_dhn(jnp.asarray(raw), MEAN, STD,
                              dtype=getattr(jnp, dtype), planar=planar))
    got = cuda_image.demosaic_half_normalize(
        torch.from_numpy(raw), MEAN, STD, dtype=getattr(torch, dtype),
        planar=planar)
    assert tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        assert _bf16_ulps(got, want) <= 1


def test_wrapper_uses_plain_version_on_cpu_without_counting():
    raw = torch.from_numpy(_mosaic((2, 8, 12)))
    before = cuda_image.launches
    out = cuda_image.demosaic_half_normalize(raw, MEAN, STD, torch.float32,
                                             planar=True)
    ref = cuda_image.demosaic_half_normalize_reference(
        raw, MEAN, STD, torch.float32, planar=True)
    assert torch.equal(out, ref)
    assert cuda_image.launches == before


@pytest.mark.parametrize("bad", [
    dict(raw=np.zeros((2, 7, 12), np.uint8)),        # odd height
    dict(raw=np.zeros((2, 8, 12), np.float32)),      # not uint8
    dict(raw=np.zeros((8, 12), np.uint8)),           # no batch axis
    dict(dtype=torch.float16),                       # unsupported output
])
def test_wrapper_rejects_bad_input(bad):
    raw = torch.from_numpy(bad.get("raw", np.zeros((2, 8, 12), np.uint8)))
    with pytest.raises(ValueError):
        cuda_image.demosaic_half_normalize(
            raw, MEAN, STD, dtype=bad.get("dtype", torch.float32))


def test_demosaic_half_and_normalize_compose_to_the_kernel():
    """The unfused plain ops give the fused kernel's values."""
    raw = torch.from_numpy(_mosaic((2, 16, 24), seed=3))
    fused = cuda_image.demosaic_half_normalize(raw, MEAN, STD, torch.float32)
    unfused = normalize(demosaic_half(raw), MEAN, STD)
    assert torch.equal(fused, unfused)


@pytest.mark.parametrize("in_hw,out_hw", [((16, 24), (8, 11)),
                                          ((480, 640), (256, 341)),
                                          ((10, 10), (7, 13))])
def test_resize_matches_jax(in_hw, out_hw):
    img = np.random.RandomState(1).randn(2, 3, *in_hw).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(img), *out_hw))
    got = resize_bilinear_matmul(torch.from_numpy(img), *out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_shorter_side_shape():
    assert resize_shorter_side_shape(960, 1280, 256) == (256, 341)
    assert resize_shorter_side_shape(32, 48, 8) == (8, 12)
    assert resize_shorter_side_shape(48, 32, 8) == (12, 8)


def _jax_tpu_branch(raw, resize_to):
    """The TPU branch of the JAX bayer pipeline, composed by hand: on the CPU
    ``make_device_pipeline`` takes the XLA composition instead."""
    img = jax_dhn(jnp.asarray(raw), MEAN, STD, dtype=jnp.float32, planar=True)
    img = jax_resize(img, *resize_to)
    return np.asarray(jnp.transpose(img, (0, 2, 3, 1)))


@pytest.mark.parametrize("shape,resize_to", [((4, 32, 48), (8, 12)),
                                             ((2, 3, 16, 24), (8, 11))])
def test_bayer_pipeline_matches_jax(shape, resize_to):
    """Against the TPU branch within 1e-5 (the kernel's 1e-6, carried through
    the resize's float32 sums); against JAX's CPU branch within 1e-4, which
    normalizes after the resize instead of before, so its sums round
    differently."""
    raw = _mosaic(shape, seed=2)
    pipe = make_device_pipeline(MEAN, STD, resize_to=resize_to, bayer=True,
                                dtype=torch.float32)
    got = pipe(torch.from_numpy(raw)).numpy()
    assert got.shape == shape[:-2] + resize_to + (3,)
    flat = raw.reshape((-1,) + shape[-2:])
    tpu = _jax_tpu_branch(flat, resize_to).reshape(got.shape)
    np.testing.assert_allclose(got, tpu, rtol=0, atol=1e-5)
    cpu = np.asarray(jax_pipeline(MEAN, STD, resize_to=resize_to, bayer=True,
                                  dtype=jnp.float32)(jnp.asarray(raw)))
    np.testing.assert_allclose(got, cpu, rtol=0, atol=1e-4)


def test_bayer_pipeline_bf16_output():
    raw = _mosaic((2, 32, 48), seed=4)
    pipe32 = make_device_pipeline(MEAN, STD, resize_to=(8, 12), bayer=True,
                                  dtype=torch.float32)
    pipe16 = make_device_pipeline(MEAN, STD, resize_to=(8, 12), bayer=True)
    out16 = pipe16(torch.from_numpy(raw))
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, pipe32(torch.from_numpy(raw)).to(torch.bfloat16))


@pytest.mark.parametrize("kwargs", [
    dict(bayer=True, resize_to=(8, 12), undistort_maps=object()),
    dict(bayer=False, resize_to=(8, 12), undistort_maps=object()),
    dict(bayer=True, resize_to=None),
])
def test_unported_pipeline_branches_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_device_pipeline(MEAN, STD, **kwargs)


def test_upsampling_resize_raises():
    pipe = make_device_pipeline(MEAN, STD, resize_to=(20, 30), bayer=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe(torch.zeros((1, 32, 48), dtype=torch.uint8))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    """On a card: the CUDA kernel bit for bit against its plain version."""
    raw = torch.from_numpy(_mosaic((3, 64, 104), seed=5)).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        for planar in (True, False):
            before = cuda_image.launches
            got = cuda_image.demosaic_half_normalize(raw, MEAN, STD, dtype,
                                                     planar)
            torch.cuda.synchronize()
            assert cuda_image.launches == before + 1
            want = cuda_image.demosaic_half_normalize_reference(
                raw, MEAN, STD, dtype, planar)
            assert torch.equal(got, want)
