"""Port rasterizer vs ``hocon.render``: scheduling, packing, kernel K1.

On the CPU, K1's wrapper runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode (``backend="pallas"``) and its
unculled XLA backend (``backend="xla"``). Bars are those of
``tests/test_raster_pallas.py``: silhouette atol 2e-5, attr / depth / vis
atol 2e-4, with rtol 1e-4 on attributes whose magnitude reaches tens of
pixels (the softmax sums run in another order: ~1e-5 relative in f32).

Random scenes draw three distinct vertices per face. A face with exactly
two equal vertices has a zero determinant, which eager f32 arithmetic
keeps at exactly 0 (the face is culled), while the reference's jitted CPU
path contracts it into a fused multiply-add residue of ~1e-5 and keeps the
face with a garbage plane; such faces are a reference artefact, not mesh
data (real meshes and padded (0, 0, 0) object faces are unaffected).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hocon.geometry.mano as M
from hocon.geometry.project import persp_project
from hocon.render import raster as R
from hocon.render import raster_pallas as RP
from hocon_torch.render import raster as TR
from hocon_torch.render import raster_cuda as TRC

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them (with
# a pool per core in each of 4 workers, a warp train step ran ~70x slower).
torch.set_num_threads(1)

SIL_ATOL, ATOL, ATTR_RTOL = 2e-5, 2e-4, 1e-4


def _scene(seed=0, b=2, v=24, f=40, spread=28.0):
    rng = np.random.default_rng(seed)
    verts_pix = rng.uniform(2, spread, (b, v, 2)).astype(np.float32)
    verts_z = rng.uniform(0.3, 1.0, (b, v)).astype(np.float32)
    faces = np.stack([rng.choice(v, 3, replace=False) for _ in range(f)]).astype(np.int32)
    attrs = rng.standard_normal((b, v, 2)).astype(np.float32)
    return verts_pix, verts_z, faces, attrs


def _mano_scene(mano_model, b=2):
    verts, _ = M.mano_forward(
        mano_model, jnp.zeros((b, 15)), jnp.zeros((b, 10)),
        jnp.asarray([[0.0, 0.0, 0.0], [0.2, -0.1, 0.3]][:b]), scale_mm=False,
    )
    verts = verts + jnp.asarray([0.0, 0.0, 0.6])
    k = jnp.asarray([[[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1.0]]] * b)
    vp = np.array(persp_project(verts, k))
    return vp, np.array(verts[..., 2]), np.array(mano_model.faces), vp * 0.01


def _render_ref(backend, vp, vz, f, a, hw, sigma, gamma, cull=False):
    return R.soft_rasterize(
        jnp.asarray(vp), jnp.asarray(vz), jnp.asarray(f),
        None if a is None else jnp.asarray(a), image_size=hw, sigma=sigma,
        gamma=gamma, backend=backend, backface_cull=cull,
    )


def _render_port(vp, vz, f, a, hw, sigma, gamma, cull=False):
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    return TR.soft_rasterize(
        t(vp), t(vz), t(f), t(a), image_size=hw, sigma=sigma, gamma=gamma,
        backface_cull=cull,
    )


def _assert_close(got, ref, mask=None, sil_atol=SIL_ATOL, atol=ATOL):
    pick = (lambda x: x) if mask is None else (lambda x: x[mask])
    np.testing.assert_allclose(pick(got.sil.numpy()), pick(np.asarray(ref.sil)), atol=sil_atol)
    np.testing.assert_allclose(
        pick(got.attr.numpy()), pick(np.asarray(ref.attr)), atol=atol, rtol=ATTR_RTOL
    )
    np.testing.assert_allclose(pick(got.depth.numpy()), pick(np.asarray(ref.depth)), atol=atol)
    np.testing.assert_allclose(pick(got.vis.numpy()), pick(np.asarray(ref.vis)), atol=atol)


def _assert_close_to_xla(got, ref_p, ref_x, sil_atol=SIL_ATOL, atol=ATOL):
    """Port vs the unculled XLA backend, where the silhouette is non-trivial.

    On empty pixels the depth softmax is decided by faces beyond the
    3.5-sigma cutoff that the kernel drops, so only covered pixels count (as
    in the reference's own kernel-vs-XLA tests). There, the port may differ
    from XLA by the bar plus what the reference's own kernel differs by.
    """
    mask = np.asarray(ref_x.sil) > 1e-3
    for name, bar, rtol in (("sil", sil_atol, 0.0), ("attr", atol, ATTR_RTOL),
                            ("depth", atol, 0.0), ("vis", atol, 0.0)):
        g = getattr(got, name).numpy()[mask]
        p = np.asarray(getattr(ref_p, name))[mask]
        x = np.asarray(getattr(ref_x, name))[mask]
        excess = np.abs(g - x) - (bar + rtol * np.abs(x) + np.abs(p - x))
        assert excess.max(initial=0.0) <= 0.0, (name, excess.max())


@pytest.mark.parametrize("cull", [False, True], ids=["all", "backface_cull"])
def test_sort_and_chunk_ranges_bit_equal(mano_model, cull):
    for vp, _, f, _ in (_scene(0), _mano_scene(mano_model)):
        fs_ref, bb_ref = RP.sort_faces_by_y(jnp.asarray(vp), jnp.asarray(f), backface_cull=cull)
        fs, bb = TRC.sort_faces_by_y(torch.from_numpy(vp), torch.from_numpy(f), backface_cull=cull)
        np.testing.assert_array_equal(fs.numpy(), np.asarray(fs_ref))
        np.testing.assert_array_equal(bb.numpy(), np.asarray(bb_ref))
    # Tied y-centres must keep their input order (stable sort).
    vp = np.tile(np.array([[[0, 0], [4, 0], [0, 4], [4, 4]]], np.float32), (1, 1, 1))
    f = np.array([[0, 1, 2], [1, 3, 2], [0, 1, 2], [1, 3, 2]] * 5, np.int32)
    fs_ref, _ = RP.sort_faces_by_y(jnp.asarray(vp), jnp.asarray(f))
    fs, _ = TRC.sort_faces_by_y(torch.from_numpy(vp), torch.from_numpy(f))
    np.testing.assert_array_equal(fs.numpy(), np.asarray(fs_ref))

    bounds = np.random.default_rng(1).uniform(-20, 90, (3, 7, 4)).astype(np.float32)
    bounds[..., 1] = bounds[..., 0] + np.abs(bounds[..., 1]) / 4
    bounds[0, 2] = [np.inf, -np.inf, np.inf, -np.inf]  # an all-culled chunk
    bounds[1] = [500.0, 600.0, 0.0, 1.0]  # nothing on screen: (0, 0)
    kr = TRC.chunk_ranges(torch.from_numpy(bounds), 64)
    assert kr.dtype == torch.int32
    np.testing.assert_array_equal(kr.numpy(), np.asarray(RP._chunk_ranges(jnp.asarray(bounds), 64)))


def test_pack_sorted_planes_matches(mano_model):
    vp, vz, f, a = _mano_scene(mano_model)
    sigma = 1.0
    zb_ref = R.normalize_depth(jnp.asarray(vz))
    zb = TR.normalize_depth(torch.from_numpy(vz))
    faces_ref, bb_ref = RP.sort_faces_by_y(jnp.asarray(vp), jnp.asarray(f), backface_cull=True)
    faces, bb = TRC.sort_faces_by_y(torch.from_numpy(vp), torch.from_numpy(f), backface_cull=True)
    planes_ref = R.face_planes(jnp.asarray(vp), zb_ref, faces_ref, jnp.asarray(a), backface_cull=True)
    planes = TR.face_planes(torch.from_numpy(vp), zb, faces, torch.from_numpy(a), backface_cull=True)
    np.testing.assert_array_equal(planes.valid.numpy(), np.asarray(planes_ref.valid))
    # Rows are O(1-100) (pixel offsets, edge lengths): f32 ulp level, on
    # faces that are not slivers (|2 x area| >= 0.05 x longest edge^2). A
    # sliver's rows come from a ~1/det cancellation that f32 gets wrong in
    # both frameworks (one such face is ~100x off the float64 value in
    # each), so slivers are held to the rendered outputs, not row by row.
    fv = np.asarray(R.gather_faces(jnp.asarray(vp), faces_ref))
    edge2 = ((fv - np.roll(fv, 1, axis=-2)) ** 2).sum(-1).max(-1)
    well = np.abs(np.asarray(R.face_det2d(jnp.asarray(fv)))) >= 0.05 * edge2
    assert well.mean() > 0.8
    np.testing.assert_allclose(planes.rows.numpy()[well], np.asarray(planes_ref.rows)[well],
                               atol=1e-4, rtol=1e-5)
    c_ref, b_ref = RP.pack_sorted_planes(planes_ref, bb_ref, sigma, presorted=True)
    c, b = TRC.pack_sorted_planes(planes, bb, sigma)
    assert c.shape == c_ref.shape and b.shape == b_ref.shape
    f = well.shape[1]
    np.testing.assert_allclose(c.numpy()[:, :f][well], np.asarray(c_ref)[:, :f][well],
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(c.numpy()[:, f:], np.asarray(c_ref)[:, f:])  # inert pad
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))  # same f32 min/max


@pytest.mark.parametrize("gamma", [1.0 / 40.0, 1.0 / 100.0], ids=["fixed_m", "streaming"])
def test_raster_fwd_plain_matches_pallas_kernel(mano_model, gamma):
    """K1's plain version at the kernel interface vs ``_forward_padded``:
    the same coeffs and bounds in, all four padded outputs (incl. mden)."""
    vp, vz, f, a = _mano_scene(mano_model)
    faces_ref, bb_ref = RP.sort_faces_by_y(jnp.asarray(vp), jnp.asarray(f), backface_cull=True)
    planes_ref = R.face_planes(jnp.asarray(vp), R.normalize_depth(jnp.asarray(vz)),
                               faces_ref, jnp.asarray(a), backface_cull=True)
    coeffs, bounds = RP.pack_sorted_planes(planes_ref, bb_ref, 1.0, presorted=True)
    hw = (56, 64)
    ref = RP._forward_padded(coeffs, bounds, hw, 1.0, gamma, 3, RP.default_config())
    bounds_t = torch.from_numpy(np.array(bounds))
    got = TRC.raster_fwd(torch.from_numpy(np.array(coeffs)), bounds_t,
                         TRC.chunk_ranges(bounds_t, 56), hw, 1.0, gamma)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    names = ("sil", "attr", "vis", "mden")
    for name, g, r in zip(names, got, ref):
        g, r = g.numpy(), np.asarray(r)
        if name == "mden":
            # m and log(den) carry zbar / gamma: the depth bar times 1/gamma
            # (m absolute; den relative, as den spans exp(-1/gamma)..O(10)).
            np.testing.assert_allclose(g[:, 0], r[:, 0], atol=ATOL / gamma, rtol=0, err_msg="m")
            np.testing.assert_allclose(g[:, 1], r[:, 1], rtol=ATOL / gamma, atol=0, err_msg="den")
        else:
            atol = SIL_ATOL if name == "sil" else ATOL
            np.testing.assert_allclose(g, r, atol=atol, rtol=ATTR_RTOL, err_msg=name)
    assert TRC.raster_fwd.launches == 0  # CPU tensors never launch the kernel


_CASES = {
    # name: (scene kwargs, offset added to verts_pix, image size, sigma, gamma)
    "fixed_m": (dict(b=1, v=9, f=8), None, (32, 32), 1.2, 1.0 / 40.0),
    "streaming": (dict(b=1, v=9, f=8), None, (32, 32), 1.2, 1.0 / 100.0),
    "random_scene": (dict(seed=0), None, (32, 32), 0.8, 0.05),
    "nonsquare_padded": (dict(seed=3, spread=40.0), None, (16, 48), 0.8, 0.05),
    "wide_lane_blocks": (dict(seed=4, b=1, v=12, f=10, spread=30.0), "spread_x", (16, 384), 0.8, 0.05),
    "offscreen_faces": (dict(seed=2), "push4", (32, 32), 0.8, 0.05),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_soft_rasterize_matches_reference(case):
    kw, offset, hw, sigma, gamma = _CASES[case]
    vp, vz, f, a = _scene(**kw)
    if offset == "spread_x":
        vp = vp + np.array([300.0, 0.0], np.float32) * np.linspace(0, 1, vp.shape[1], dtype=np.float32)[None, :, None]
    elif offset == "push4":
        vp[:, :4] += 500.0
    got = _render_port(vp, vz, f, a, hw, sigma, gamma)
    assert got.sil.shape == (vp.shape[0],) + hw and got.attr.shape == (vp.shape[0],) + hw + (2,)
    ref_p = _render_ref("pallas", vp, vz, f, a, hw, sigma, gamma)
    _assert_close(got, ref_p)
    _assert_close_to_xla(got, ref_p, _render_ref("xla", vp, vz, f, a, hw, sigma, gamma))


def test_soft_rasterize_mano_mesh_with_culling(mano_model):
    vp, vz, f, a = _mano_scene(mano_model)
    hw, sigma, gamma = (64, 64), 1.0, 1.0 / 40.0
    # The rim of a projected mesh has slivers whose plane rows f32 builds
    # differently in every evaluation order (see the packing test): the
    # reference's own eager and jitted builds of these planes render
    # covered pixels up to ~3e-2 apart. So the kernel path is held at the
    # tight bars on shared planes, and the whole entry point within the
    # reference's own build-to-build spread.
    fs, bb = RP.sort_faces_by_y(jnp.asarray(vp), jnp.asarray(f), backface_cull=True)
    planes = R.face_planes(jnp.asarray(vp), R.normalize_depth(jnp.asarray(vz)), fs,
                           jnp.asarray(a), backface_cull=True)
    ref_p = RP.rasterize_planes_pallas(planes, bb, image_size=hw, sigma=sigma,
                                       gamma=gamma, presorted=True)
    got = TRC.rasterize_planes(
        TR.FacePlanes(torch.from_numpy(np.array(planes.rows)),
                      torch.from_numpy(np.array(planes.valid))),
        torch.from_numpy(np.array(bb)), image_size=hw, sigma=sigma, gamma=gamma,
    )
    _assert_close(got, ref_p)
    ref_x = R.rasterize_planes_xla(planes, hw, sigma, gamma)
    _assert_close_to_xla(got, ref_p, ref_x)

    ref_jit = _render_ref("pallas", vp, vz, f, a, hw, sigma, gamma, cull=True)
    port = _render_port(vp, vz, f, a, hw, sigma, gamma, cull=True)
    # Silhouette: the reference's own mesh bar (test_pallas_mano_mesh).
    np.testing.assert_allclose(port.sil.numpy(), np.asarray(ref_jit.sil), atol=1e-4)
    covered = np.asarray(ref_jit.sil) > 1e-3
    for name in ("attr", "depth", "vis"):
        jit_v = np.asarray(getattr(ref_jit, name))[covered]
        spread = np.abs(np.asarray(getattr(ref_p, name))[covered] - jit_v).max()
        err = np.abs(getattr(port, name).numpy()[covered] - jit_v).max()
        assert err <= ATOL + 2.0 * spread, (name, err, spread)


def test_soft_rasterize_no_attrs_and_offscreen_mesh():
    vp, vz, f, _ = _scene(seed=1)
    got = _render_port(vp, vz, f, None, (32, 32), 1.0, 1.0 / 40.0)
    assert got.attr.shape == (2, 32, 32, 0)
    ref = _render_ref("pallas", vp, vz, f, None, (32, 32), 1.0, 1.0 / 40.0)
    np.testing.assert_allclose(got.sil.numpy(), np.asarray(ref.sil), atol=SIL_ATOL)
    # A mesh far below the image: pure background everywhere.
    got = _render_port(vp + np.float32([0.0, 5000.0]), vz, f, None, (32, 32), 0.8, 0.05)
    np.testing.assert_allclose(got.sil.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(got.vis.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(got.depth.numpy(), 1.0, atol=1e-5)


def test_soft_rasterize_rejects_unknown_backend():
    vp, vz, f, a = _scene()
    args = (torch.from_numpy(vp), torch.from_numpy(vz), torch.from_numpy(f))
    for backend in ("cuda", "tpu"):
        with pytest.raises(ValueError, match="backend"):
            TR.soft_rasterize(*args, backend=backend)
    # The reference's names: "pallas" is the kernel path, as "auto" is.
    auto = TR.soft_rasterize(*args, backend="auto")
    kernel = TR.soft_rasterize(*args, backend="pallas")
    for name in ("sil", "attr", "depth", "vis"):
        assert torch.equal(getattr(auto, name), getattr(kernel, name))
