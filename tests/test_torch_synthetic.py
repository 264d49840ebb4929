"""Port synthetic dataset, K1 at 3 colour channels and the data slice as a
whole vs ``hocon``.

The port renders its frames with its own MANO and soft rasterizer, on the
CPU through the unculled ``xla`` backend, as ``hocon`` does off the TPU.
Both packages' f32 plane rows of rim sliver faces come from a ~1/det
cancellation that every f32 evaluation order gets wrong differently
(ROADMAP queue 3), so a few rim pixels differ by more than one level; the
rest match within one level (the frames are truncated to uint8).
"""

import ast

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
import hocon.geometry.mano as M
from hocon.data.factory import get_dataset as ref_get_dataset
from hocon.data.pipeline import BatchLoader as RefBatchLoader
from hocon.data.synthetic import SyntheticHandDataset as RefSynthetic
from hocon.geometry.project import persp_project as ref_persp_project
from hocon.render import raster as R
from hocon.render import raster_pallas as RP
from hocon_torch.data import synthetic as TS
from hocon_torch.data.factory import get_dataset
from hocon_torch.data.pipeline import BatchLoader
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.hocnet import HOCNet
from hocon_torch.render import raster_cuda as TRC
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.train.steps import make_warp_train_step, warp_loss

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

SIL_ATOL, ATOL = 2e-5, 2e-4  # tests/test_raster_pallas.py
# Frames: within one level on this share of values at least; the largest
# difference measured at 64 px was 59 levels (rim slivers), bar 80.
WITHIN_ONE_LEVEL = 0.995
MAX_LEVELS = 80


def _assert_frames_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= WITHIN_ONE_LEVEL, (diff <= 1).mean()
    assert diff.max() <= MAX_LEVELS, diff.max()


@pytest.mark.parametrize("obj_faces", [0, 320], ids=["box", "sphere320"])
def test_synthetic_dataset_matches_reference(mano_model, monkeypatch, tmp_path, obj_faces):
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path))  # the oracle renders fresh
    kw = dict(n_videos=2, frames_per_video=4, image_size=64, seed=3, supervised_fraction=0.5,
              pair_spacing=2, obj_n_faces=obj_faces)
    ref = RefSynthetic(mano=mano_model, **kw)
    port = TS.SyntheticHandDataset(device="cpu", **kw)
    assert len(port) == len(ref) == 8
    np.testing.assert_allclose(port.verts, ref.verts, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.joints, ref.joints, atol=1e-5, rtol=0)
    for name in ("pose", "betas", "root", "trans", "camintr", "obj_verts_can", "obj_faces",
                 "supervised"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(port.obj_pose, ref.obj_pose, atol=1e-5, rtol=0)
    assert {q.value for q in port.available_queries()} == {q.value for q in ref.available_queries()}
    _assert_frames_close(port.images, ref.images)
    for seed in range(10):
        ref_rng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
        for i in range(len(port)):
            assert port.sample_pair(i, rng) == ref.sample_pair(i, ref_rng)
    got, want = port.get_sample(5), ref.get_sample(5)
    assert set(got) == set(want)
    for k in ("supervised", "seq_id", "frame_idx", "side"):
        assert got[k] == want[k]


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.SyntheticHandDataset(n_videos=1, frames_per_video=2, image_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_dataset("synthetic", "train", image_size=16, synth_videos=1, synth_frames=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main([])


def _packed(vp, vz, faces, colors):
    """K1's C = 3 interface, packed by ``hocon``: (coeffs, bounds) of every
    face, and of the faces that are not slivers (|2 x area| >= 0.05 x
    longest edge^2; the slivers made inert)."""
    fs, bb = RP.sort_faces_by_y(vp, faces)
    planes = R.face_planes(vp, R.normalize_depth(vz), fs, colors)
    fv = R.gather_faces(vp, fs)
    edge2 = jnp.max(jnp.sum((fv - jnp.roll(fv, 1, axis=-2)) ** 2, axis=-1), axis=-1)
    well = jnp.abs(R.face_det2d(fv)) >= 0.05 * edge2
    without = R.FacePlanes(rows=planes.rows, valid=planes.valid * well)
    return [RP.pack_sorted_planes(p, bb, TS.RENDER_SIGMA, presorted=True)
            for p in (planes, without)]


def _colour_scene(mano_model, b=2, res=64):
    """Two synthetic-dataset views: ``hocon``'s MANO hand + the box at the
    wrist, seeded poses, at ``res``."""
    rng = np.random.default_rng(1)
    trans = np.concatenate([rng.uniform(-0.03, 0.03, (b, 2)), rng.uniform(0.55, 0.7, (b, 1))], 1)
    verts, joints = M.mano_forward(
        mano_model, jnp.asarray(rng.standard_normal((b, 15)) * 0.3, jnp.float32),
        jnp.zeros((b, 10)), jnp.asarray(rng.standard_normal((b, 3)) * 0.3, jnp.float32),
        trans=jnp.asarray(trans, jnp.float32), scale_mm=False)
    obj = (TS._BOX_VERTS * TS.OBJ_SCALE)[None] + TS.object_poses(np.asarray(joints))[:, None, :3, 3]
    verts = jnp.asarray(np.concatenate([np.asarray(verts), obj], axis=1))
    faces = np.concatenate([np.asarray(mano_model.faces), TS._BOX_FACES + M.N_VERTS])
    vp = ref_persp_project(verts, jnp.asarray(TS.synthetic_camintr(res))[None])
    colors = jnp.asarray(np.tile(TS.vertex_colors(verts.shape[1])[None], (b, 1, 1)))
    return _packed(vp, verts[..., 2], jnp.asarray(faces), colors)


def _random_colour_scene(seed=0, b=2, v=24, f=40):
    """Random triangles (three distinct vertices each), colours in [0, 1]."""
    rng = np.random.default_rng(seed)
    vp = jnp.asarray(rng.uniform(2, 30, (b, v, 2)), jnp.float32)
    vz = jnp.asarray(rng.uniform(0.3, 1.0, (b, v)), jnp.float32)
    faces = jnp.asarray(np.stack([rng.choice(v, 3, replace=False) for _ in range(f)]), jnp.int32)
    return _packed(vp, vz, faces, jnp.asarray(rng.uniform(0, 1, (b, v, 3)), jnp.float32))


def _plain(coeffs, bounds, hw, gamma, dtype=torch.float32):
    c, b = torch.from_numpy(np.array(coeffs)).to(dtype), torch.from_numpy(np.array(bounds))
    return TRC.raster_fwd_plain(c, b, TRC.chunk_ranges(b, hw[0]), hw, TS.RENDER_SIGMA, gamma,
                                TRC.default_config())


@pytest.mark.parametrize("gamma", [1.0 / 40.0, 1.0 / 100.0], ids=["fixed_m", "streaming"])
@pytest.mark.parametrize("scene", ["random", "hand_box"])
def test_k1_plain_at_three_colours_matches_pallas_kernel(mano_model, scene, gamma):
    """K1's plain version at C = 3 (the synthetic render: vertex colours,
    sigma 0.7) vs ``hocon``'s ``_raster_kernel`` in interpret mode on the
    same packed coefficients, all four padded outputs: silhouette,
    visibility and m at the reference's bars everywhere. Colours and depth
    at the bars (rtol 1e-4 for colours extrapolated past 1, as in
    test_torch_raster) on every value that the slivers do not move, with
    float64 as the arbiter: a value is moved when the float64 renders with
    and without the slivers differ there by more than the bar (a few % of
    the values). Measured: the f32 renders differ beyond the bar at a few
    dozen values, every one of them moved."""
    if scene == "random":
        hw, ((coeffs, bounds), (coeffs_ws, bounds_ws)) = (32, 32), _random_colour_scene()
    else:
        hw, ((coeffs, bounds), (coeffs_ws, bounds_ws)) = (64, 64), _colour_scene(mano_model)
    assert coeffs.shape[-1] == 3 * (10 + 3)
    ref = RP._forward_padded(coeffs, bounds, hw, TS.RENDER_SIGMA, gamma, 4, RP.default_config())
    got = _plain(coeffs, bounds, hw, gamma)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    assert got[1].shape[1] == 4  # three colours, then depth
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=SIL_ATOL, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[3][:, 0].numpy(), np.asarray(ref[3])[:, 0], atol=ATOL / gamma)
    moved = np.abs(_plain(coeffs, bounds, hw, gamma, torch.float64)[1].numpy()
                   - _plain(coeffs_ws, bounds_ws, hw, gamma, torch.float64)[1].numpy()) > ATOL
    assert moved.mean() < 0.15
    attr, attr_ref = got[1].numpy(), np.asarray(ref[1])
    np.testing.assert_allclose(attr[~moved], attr_ref[~moved], atol=ATOL, rtol=1e-4)
    assert TRC.raster_fwd.launches == 0  # CPU tensors never launch the kernel


def test_kernel_wrappers_refuse_other_channel_counts():
    """K1 is built for 2 and 3 attribute channels, K2 for 2: the wrappers
    raise before any launch for other counts."""
    for n_user in (1, 4):
        coeffs = torch.zeros((1, 32, 3 * (10 + n_user)))
        with pytest.raises(ValueError, match="attribute channels"):
            TRC.raster_fwd_cuda(coeffs, torch.zeros((1, 1, 4)),
                                torch.zeros((1, 1, 2), dtype=torch.int32), (8, 8), 1.0,
                                1.0 / 40, TRC.default_config())
    coeffs = torch.zeros((1, 32, 39))
    img = torch.zeros((1, 8, 128))
    with pytest.raises(ValueError, match="attribute channels"):
        TRC.raster_bwd_cuda(coeffs, torch.zeros((1, 1, 4)), torch.zeros((1, 1, 2), dtype=torch.int32),
                            img, torch.zeros((1, 4, 8, 128)), img, torch.zeros((1, 2, 8, 128)),
                            img, torch.zeros((1, 4, 8, 128)), img, (8, 8), 1.0, 1.0 / 40,
                            TRC.default_config())
    assert TRC.K1_ATTRS == (2, 3) and TRC.K2_ATTRS == 2


def _compare_batches(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _compare_batches(g, w)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape)
        if k == "image":
            _assert_frames_close(g, w)
        elif k in ("obj_faces", "obj_verts_mask", "sup_mask", "obj_nverts", "_valid"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            # 1e-5 m, where the labels are in mm 1e-2 (the MANO verts agree to 1e-5 m).
            atol = 1e-2 if k in ("joints3d", "verts3d", "objverts3d", "objcorners3d") else 1e-5
            np.testing.assert_allclose(g, w, atol=atol, rtol=1e-5, err_msg=k)


def test_data_slice_matches_reference(mano_model, monkeypatch, tmp_path):
    """The slice as a whole: the port's ``get_dataset`` -> ``BatchLoader``
    gives ``hocon``'s batch within the bars above; the port's ``warp_loss``
    on either batch agrees to 1e-3 relative; one port warp train step on
    the port's batch is finite."""
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path))
    kw = dict(image_size=32, use_objects=True, train=True, pair_mode=True, fraction=0.5,
              synth_videos=2, synth_frames=4, seed=2, synth_obj_faces=80, uint8_images=True)
    ref_ds = ref_get_dataset("synthetic", "train", mano=mano_model, **kw)
    mano = synthetic_mano_model(0, device="cpu")
    ds = get_dataset("synthetic", "train", mano=mano, device="cpu", **kw)
    # The reference's fields, plus the port's decode device: get_dataset's.
    assert ds.cfg == type(ds.cfg)(**{f: getattr(ref_ds.cfg, f) for f in ("image_size",
                                     "bbox_scale", "center_idx", "max_obj_verts",
                                     "max_obj_faces", "pair_mode", "clip_len", "train",
                                     "uint8_images")}, augment=ds.cfg.augment,
                                  decode_device="cpu")
    batch = next(iter(BatchLoader(ds, 4, seed=0)))
    ref_batch = next(iter(RefBatchLoader(ref_ds, 4, seed=0)))
    _compare_batches(batch, ref_batch)

    model = HOCNet(with_object=True, seed=0, device="cpu")
    with torch.no_grad():
        total, terms = warp_loss(model, mano, batch, (32, 32), device="cpu")
        ref_total, ref_terms = warp_loss(model, mano, ref_batch, (32, 32), device="cpu")
    assert float(terms["mask_area"]) > 5
    for k, v in terms.items():
        np.testing.assert_allclose(float(v), float(ref_terms[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-3)

    optimizer = make_optimizer("adam", 1e-4)
    state = create_train_state(model, optimizer)
    step = make_warp_train_step(model, mano, optimizer, image_size=(32, 32), device="cpu")
    _, step_terms = step(state, batch)
    assert all(np.isfinite(float(v)) for v in step_terms.values())
    assert float(step_terms["grad_norm"]) > 0


def _bench_get_dataset_kwargs(obj_faces: int) -> dict:
    """The keyword arguments of ``bench.py``'s ``get_dataset`` call, read
    from its source and evaluated in its module namespace (``mano`` aside)."""
    import bench

    path = bench.__file__
    with open(path) as fh:
        tree = ast.parse(fh.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "get_dataset"]
    assert len(calls) == 1
    call = calls[0]
    env = {**vars(bench), "obj_faces": obj_faces}
    out = {"name": ast.literal_eval(call.args[0]), "split": ast.literal_eval(call.args[1])}
    for k in call.keywords:
        if k.arg != "mano":
            out[k.arg] = eval(compile(ast.Expression(k.value), path, "eval"), env)
    return out


@pytest.mark.parametrize("obj_faces", [1280, 0], ids=["sphere1280", "toy_box"])
def test_bench_torch_dataset_is_bench_py_dataset(obj_faces):
    assert bench_torch.dataset_kwargs(obj_faces) == _bench_get_dataset_kwargs(obj_faces)
    assert (bench_torch.BATCH_PAIRS, bench_torch.RES, bench_torch.TIMED_STEPS,
            bench_torch.WARMUP_STEPS) == (16, 256, 60, 3)
