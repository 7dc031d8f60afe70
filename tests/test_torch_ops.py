"""Parity of the port's ops (mega_nerf_tpu_torch.ops) with the JAX package.

Inputs come from a seeded numpy Generator and go through both functions in
float32 on the CPU; outputs agree to atol 1e-5 (float32 rounding of
differently ordered sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu import ops as jops
from mega_nerf_tpu.data.image_metadata import ImageMetadata as JMeta
from mega_nerf_tpu.data.memory_dataset import generate_image_rays as j_image_rays
from mega_nerf_tpu_torch import ops as tops
from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata as TMeta

ATOL = 1e-5


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)


def _pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return np.concatenate([q, rng.normal(size=(3, 1)) * 0.3], 1).astype(np.float32)


@pytest.mark.parametrize("center_pixels", [True, False])
def test_ray_directions(center_pixels):
    args = (7, 5, 6.3, 5.9, 3.4, 2.6, center_pixels)
    _close(tops.get_ray_directions(*args), jops.get_ray_directions(*args))


@pytest.mark.parametrize("altitude", [None, [-0.4, 0.5]])
def test_get_rays(altitude):
    rng = np.random.default_rng(0)
    dirs = jops.get_ray_directions(9, 6, 7.0, 7.0, 4.5, 3.0, True)
    c2w = _pose(rng)
    want = jops.get_rays(dirs, jnp.asarray(c2w), 0.1, 5.0, altitude)
    got = tops.get_rays(torch.from_numpy(np.array(dirs)), torch.from_numpy(c2w),
                        0.1, 5.0, altitude)
    _close(got, want)


def test_generate_image_rays(tmp_path):
    rng = np.random.default_rng(1)
    c2w = _pose(rng)
    intr = np.array([11.0, 10.0, 6.0, 4.5], np.float32)
    args = (tmp_path / "x.png", c2w, 12, 9, intr, 0, None, True)
    want = j_image_rays(JMeta(*args), 0.2, 4.0, [-0.5, 0.3], True)
    got = tops.generate_image_rays(TMeta(*args), 0.2, 4.0, [-0.5, 0.3], True)
    assert got.shape == (12 * 9, 8)
    _close(got, want)


def _rays(rng, n):
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_intersect_sphere():
    rng = np.random.default_rng(2)
    o, d = _rays(rng, 64)
    c = np.array([0.1, -0.2, 0.05], np.float32)
    r = np.array([1.3, 0.9, 1.1], np.float32)
    want = jops.intersect_sphere(o, d, c, r)
    got = tops.intersect_sphere(*map(torch.from_numpy, (o, d, c, r)))
    _close(got, want)


def test_depth2pts_outside():
    rng = np.random.default_rng(3)
    o, d = _rays(rng, 32)
    depth = np.sort(rng.uniform(0, 1, size=(32, 10)).astype(np.float32), -1)
    c = np.array([0.1, -0.2, 0.05], np.float32)
    r = np.array([1.3, 0.9, 1.1], np.float32)
    pts_j, real_j = jops.depth2pts_outside(o[:, None], d[:, None], depth, c, r)
    pts_t, real_t = tops.depth2pts_outside(
        torch.from_numpy(o[:, None]), torch.from_numpy(d[:, None]),
        *map(torch.from_numpy, (depth, c, r)),
    )
    _close(pts_t, pts_j)
    _close(real_t, real_j, atol=1e-4, rtol=1e-5)  # 1/depth reaches ~1e3


@pytest.mark.parametrize("grouped", [False, True])
def test_sample_pdf_deterministic(grouped):
    """The port's searchsorted lookup vs both JAX bracketing forms (dense
    masked reduces and the two-level grouped search)."""
    rng = np.random.default_rng(4)
    n, s = 16, 80
    z = np.sort(rng.uniform(0.5, 3.0, size=(n, s)).astype(np.float32), -1)
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    weights = rng.exponential(size=(n, s - 2)).astype(np.float32)
    weights[::3, 10:40] = 0.0  # empty spans: flat cdf stretches
    want = jops.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 48,
                           det=True, key=None, grouped=grouped)
    got = tops.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 48)
    _close(got, want, atol=1e-5, rtol=1e-6)
    assert bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.parametrize("flip", [False, True])
def test_composite_weights(flip):
    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(0.1, 4.0, size=(8, 20)).astype(np.float32), -1)
    if flip:
        z = z[:, ::-1].copy()
    sig = rng.exponential(2.0, size=(8, 20)).astype(np.float32)
    last = np.where(rng.uniform(size=(8, 1)) > 0.5, 1e10, 0.7).astype(np.float32)
    want = jops.composite_weights(sig, z, last, flip=flip)
    got = tops.composite_weights(*map(torch.from_numpy, (sig, z, last)), flip=flip)
    _close(got.weights, want.weights)
    _close(got.bg_lambda, want.bg_lambda)


@pytest.mark.parametrize("flip", [False, True])
def test_composite_weights_merge(flip):
    """Sort-then-composite merge vs the JAX sort-free merge, with ties
    between the lists (B composites after a tied A sample)."""
    rng = np.random.default_rng(6)
    n, sa, sb = 8, 24, 12
    za = np.sort(rng.uniform(0.1, 4.0, size=(n, sa)).astype(np.float32), -1)
    zb = np.sort(np.concatenate(
        [rng.uniform(0.1, 4.0, size=(n, sb - 3)), za[:, [2, 9, 17]]], -1
    ).astype(np.float32), -1)
    if flip:
        za, zb = za[:, ::-1].copy(), zb[:, ::-1].copy()
    sa_ = rng.exponential(2.0, size=(n, sa)).astype(np.float32)
    sb_ = rng.exponential(2.0, size=(n, sb)).astype(np.float32)
    last = np.where(rng.uniform(size=(n, 1)) > 0.5, 1e10, 0.4).astype(np.float32)
    want = jops.composite_weights_merge(za, sa_, zb, sb_, last, flip=flip)
    got = tops.composite_weights_merge(
        *map(torch.from_numpy, (za, sa_, zb, sb_, last)), flip=flip)
    _close(got.weights, want.weights)
    _close(got.bg_lambda, want.bg_lambda)


def test_psnr_ssim():
    rng = np.random.default_rng(7)
    a = rng.uniform(size=(20, 14, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, size=a.shape), 0, 1).astype(np.float32)
    _close(tops.psnr(torch.from_numpy(a), torch.from_numpy(b)),
           jops.psnr(jnp.asarray(a), jnp.asarray(b)), atol=1e-4)
    _close(tops.ssim(torch.from_numpy(a), torch.from_numpy(b), 1.0),
           jops.ssim(jnp.asarray(a), jnp.asarray(b), 1.0))
