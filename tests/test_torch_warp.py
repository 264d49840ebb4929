"""Port sampler (K3), SSIM and photometric loss vs ``hocon.render``.

K3's wrapper runs its plain version on CPU tensors. The reference runs its
gather sampler and its Pallas sampler in interpret mode, which on the CPU
keeps the image in f32 as the port does. All three compute the same
lerps of the same texels, so they agree to f32 rounding of values in
[0, 1] (atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hocon.geometry.mano as M
import hocon.render.raster as R
import hocon.render.raster_pallas as RP
from hocon.render.ssim import ssim as ref_ssim
from hocon.render.ssim import ssim_loss as ref_ssim_loss
import hocon.render.warp as W
import hocon_torch.render.sample_cuda as TSC
from hocon_torch.render.ssim import ssim, ssim_loss
import hocon_torch.render.warp as TW
from hocon.geometry.project import persp_project
from hocon.render.sample_pallas import bilinear_sample_pallas
from hocon_torch.geometry.mano import synthetic_mano_model

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
    coords[0, 0, :4] = [[0.5, 0.5], [w - 0.5, h - 0.5], [-50.0, 7.0], [1e4, -1e4]]
    coords[-1, 1, :3] = [[3.0, 4.0], [5.5, 2.5], [w - 1.0, h - 1.0]]  # integer / centres
    return img, coords


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_fwd_matches_gather_and_pallas(seed):
    img, coords = _image_and_coords(seed)
    got = TSC.sample_fwd(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    ref_g = np.asarray(W.bilinear_sample_gather(jnp.asarray(img), jnp.asarray(coords)))
    ref_p = np.asarray(bilinear_sample_pallas(jnp.asarray(img), jnp.asarray(coords)))
    assert got.shape == ref_g.shape == (2, 16, 20, 3)
    np.testing.assert_allclose(got, ref_g, atol=1e-5)
    np.testing.assert_allclose(got, ref_p, atol=1e-5)
    assert TSC.sample_fwd.launches == 0  # CPU tensors never launch the kernel


def test_bilinear_sample_detaches_image():
    img, coords = _image_and_coords(2, b=1)
    img_t = torch.from_numpy(img).requires_grad_(True)
    out = TW.bilinear_sample(img_t, torch.from_numpy(coords))
    assert not out.requires_grad
    np.testing.assert_allclose(
        out.numpy(), np.asarray(W.bilinear_sample(jnp.asarray(img), jnp.asarray(coords))),
        atol=1e-5,
    )


def test_ssim_and_photometric_loss_match():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (2, 24, 28, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 24, 28)).astype(np.float32)
    ta, tb, tm = map(torch.from_numpy, (a, b, mask))
    ja, jb, jm = map(jnp.asarray, (a, b, mask))
    # SSIM in [-1, 1] from f32 window moments with cancelling variance
    # terms: 1e-5 absolute.
    np.testing.assert_allclose(ssim(ta, tb).numpy(), np.asarray(ref_ssim(ja, jb)), atol=1e-5)
    np.testing.assert_allclose(float(ssim_loss(ta, tb)), float(ref_ssim_loss(ja, jb)), atol=1e-6)
    np.testing.assert_allclose(
        float(ssim_loss(ta, tb, mask=tm)), float(ref_ssim_loss(ja, jb, mask=jm)), atol=1e-6
    )
    loss, terms = TW.photometric_loss(ta.requires_grad_(True), tb, tm.requires_grad_(True))
    loss_ref, terms_ref = W.photometric_loss(ja, jb, jm)
    assert set(terms) == set(terms_ref)
    for k in terms_ref:
        np.testing.assert_allclose(float(terms[k].detach()), float(terms_ref[k]), atol=1e-6, err_msg=k)
    loss.backward()
    assert ta.grad is not None and tm.grad is None  # the mask only weights


def test_render_warp_matches(mano_model):
    """The warp entry on the synthetic hand: tgt and ref poses differ, the
    ref image is sampled at the rendered ref-frame coordinates."""
    rng = np.random.default_rng(4)
    poses = (rng.standard_normal((2, 2, 15)) * 0.3).astype(np.float32)
    verts = []
    for p, rot in zip(poses, ([0.0, 0.0, 0.0], [0.05, 0.02, -0.03])):
        v, _ = M.mano_forward(mano_model, jnp.asarray(p), jnp.zeros((2, 10)),
                              jnp.asarray([rot, rot]), scale_mm=False)
        verts.append(np.array(v) + np.float32([0.0, 0.0, 0.6]))
    k = np.tile(np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32), (2, 1, 1))
    ref_img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    faces = np.array(mano_model.faces)
    args = (verts[0], verts[1], faces, k, k, ref_img)
    ref = W.render_warp(*map(jnp.asarray, args), image_size=(64, 64), backend="pallas")
    got = TW.render_warp(*map(torch.from_numpy, args), image_size=(64, 64))
    assert got.warped.shape == (2, 64, 64, 3)
    # Silhouette and mask: the reference's own mesh bars (sil 1e-4
    # everywhere; the mask, sil * vis, 1e-3 where covered).
    np.testing.assert_allclose(got.raster.sil.numpy(), np.asarray(ref.raster.sil), atol=1e-4)
    covered = np.asarray(ref.raster.sil) > 1e-3
    np.testing.assert_allclose(got.mask.numpy()[covered], np.asarray(ref.mask)[covered], atol=1e-3)
    # The warped image is the reference sampler at the port's coordinates.
    np.testing.assert_allclose(
        got.warped.numpy(),
        np.asarray(W.bilinear_sample_gather(jnp.asarray(ref_img), jnp.asarray(got.raster.attr.numpy()))),
        atol=1e-5,
    )
    # The coordinates: rim slivers get f32 plane rows that differ with the
    # evaluation order (test_torch_raster), so the reference's eager build
    # of the same render already differs from its jitted one; the port must
    # stay within twice that spread (+ the 2e-4 bar) on covered pixels.
    tgt_pix = persp_project(jnp.asarray(verts[0]), jnp.asarray(k))
    ref_pix = persp_project(jnp.asarray(verts[1]), jnp.asarray(k))
    fs, bb = RP.sort_faces_by_y(tgt_pix, jnp.asarray(faces), backface_cull=True)
    planes = R.face_planes(tgt_pix, R.normalize_depth(jnp.asarray(verts[0][..., 2])), fs,
                           ref_pix, backface_cull=True)
    eager = RP.rasterize_planes_pallas(planes, bb, image_size=(64, 64), presorted=True)
    jit_c = np.asarray(ref.raster.attr)[covered]
    spread = np.abs(np.asarray(eager.attr)[covered] - jit_c).max()
    err = np.abs(got.raster.attr.numpy()[covered] - jit_c).max()
    assert err <= 2e-4 + 2.0 * spread, (err, spread)


def test_port_mano_model_matches_reference_for_warp(mano_model):
    # The warp test above feeds reference verts; the port's own MANO model
    # must give the same faces for the same connectivity.
    assert np.array_equal(synthetic_mano_model(0, device="cpu").faces.numpy(),
                          np.asarray(mano_model.faces))
