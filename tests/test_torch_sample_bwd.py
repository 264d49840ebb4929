"""Port sampler backward (K4) and the image-gradient route vs ``hocon.render``.

On the CPU, K4's wrapper runs its plain version and the reference runs
``sample_pallas._sample_bwd`` in interpret mode, which keeps the image in
f32 as the port does. Coordinates are random (in and far outside the
image), exact pixel centres, integer after the half-pixel shift (the hat
kinks, where the Pallas kernel takes the right-hand slope) and on the
clamp borders (gradient 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hocon.render.warp as W
from hocon.render.sample_pallas import _pad_queries, _sample_bwd
import hocon_torch.render.sample_cuda as TSC
import hocon_torch.render.warp as TW

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them (with
# a pool per core in each of 4 workers, a warp train step ran ~70x slower).
torch.set_num_threads(1)


def _image_and_coords(seed=0, b=2, h=20, w=24, c=3, hq=16, wq=20):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    coords = np.stack(
        [rng.uniform(-3, w + 3, (b, hq, wq)), rng.uniform(-3, h + 3, (b, hq, wq))], -1
    ).astype(np.float32)
    # Clamp borders and beyond, pixel centres, integer points of the hat
    # (x - 0.5 and y - 0.5 integers), one axis integer only.
    coords[0, 0, :6] = [[0.5, 0.5], [w - 0.5, h - 0.5], [-50.0, 7.0], [1e4, -1e4],
                        [5.5, 7.5], [w - 1.5, h - 1.5]]
    coords[-1, 1, :4] = [[3.0, 4.0], [5.5, 2.25], [w - 0.5, 3.5], [10.75, h - 0.5]]
    return img, coords


def _pallas_dcoords(img, coords, g):
    """``_sample_bwd`` on the reference's padded channel-major layout."""
    b, h, w, c = img.shape
    _, hq, wq, _ = coords.shape
    img_t = jnp.asarray(img).transpose(0, 3, 2, 1).reshape(b, c * w, h)
    xy, hp, wp = _pad_queries(jnp.moveaxis(jnp.asarray(coords), -1, 1))
    gp = jnp.pad(jnp.moveaxis(jnp.asarray(g), -1, 1), ((0, 0), (0, 0), (0, hp - hq), (0, wp - wq)))
    _, dxy = _sample_bwd((h, w, c), (img_t, xy), gp)
    return np.moveaxis(np.asarray(dxy)[:, :, :hq, :wq], 1, -1)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_bwd_plain_matches_pallas_kernel(seed):
    img, coords = _image_and_coords(seed)
    g = np.random.default_rng(seed + 10).standard_normal(coords.shape[:3] + (3,)).astype(np.float32)
    want = _pallas_dcoords(img, coords, g)
    got = TSC.sample_bwd(torch.from_numpy(img), torch.from_numpy(coords), torch.from_numpy(g))
    assert got.shape == want.shape == coords.shape
    # Sums of three lerped texel differences in [-1, 1] times unit
    # cotangents, in another order: measured 4.8e-7, held at 2e-6 (the
    # reference's bar is 1e-4).
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    # A coordinate on or past a clamp border gets exactly 0, as in the
    # reference; the other axis of the same point does not.
    got = got.numpy()
    for (bi, yi, xi), axes in (((0, 0, 0), [0, 1]), ((0, 0, 1), [0, 1]), ((0, 0, 2), [0]),
                               ((0, 0, 3), [0, 1]), ((-1, 1, 2), [0]), ((-1, 1, 3), [1])):
        assert np.all(got[bi, yi, xi, axes] == 0.0) and np.all(want[bi, yi, xi, axes] == 0.0)
    assert got[0, 0, 2, 1] != 0.0 and got[-1, 1, 2, 1] != 0.0
    assert TSC.sample_bwd.launches == 0  # CPU tensors never launch the kernel


def test_bilinear_sample_coord_grads_match_gather():
    """Autograd through ``BilinearSample`` (K3 + K4) vs ``jax.grad`` of the
    reference's gather sampler at non-integer coordinates (the gather gives
    half the slope at the kinks), image detached."""
    img, coords = _image_and_coords(2)
    coords = coords + np.float32(0.013)  # off the kinks
    mask = np.random.default_rng(3).uniform(0, 1, coords.shape[:3] + (1,)).astype(np.float32)

    def loss(cc):
        return jnp.sum((W.bilinear_sample(jnp.asarray(img), cc) * mask) ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(coords)))
    cc = torch.from_numpy(coords).requires_grad_(True)
    img_t = torch.from_numpy(img).requires_grad_(True)
    out = TW.bilinear_sample(img_t, cc)
    torch.sum((out * torch.from_numpy(mask)) ** 2).backward()
    assert img_t.grad is None  # the image is data
    # Measured 3.6e-7, held at 1e-6.
    np.testing.assert_allclose(cc.grad.numpy(), want, atol=1e-6)


def test_image_grad_matches_gather():
    """``image_grad=True`` differentiates the image too, as the reference's
    gather does off the TPU."""
    img, coords = _image_and_coords(4, b=1)
    coords = coords + np.float32(0.013)
    w = np.random.default_rng(5).standard_normal(coords.shape[:3] + (3,)).astype(np.float32)

    def loss(im, cc):
        return jnp.sum(W.bilinear_sample(im, cc, image_grad=True) * w)

    want_img, want_xy = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(coords))
    img_t = torch.from_numpy(img).requires_grad_(True)
    cc = torch.from_numpy(coords).requires_grad_(True)
    torch.sum(TW.bilinear_sample(img_t, cc, image_grad=True) * torch.from_numpy(w)).backward()
    # Scatter-added lerp weights times unit cotangents: measured 4.8e-7
    # (image) and 0 (coordinates), held at 2e-6.
    np.testing.assert_allclose(img_t.grad.numpy(), np.asarray(want_img), atol=2e-6)
    np.testing.assert_allclose(cc.grad.numpy(), np.asarray(want_xy), atol=2e-6)
    assert TSC.sample_fwd.launches == 0 and TSC.sample_bwd.launches == 0
