"""The port's FPHAB / HO-3D parsers, decimation and ``check_dataset`` vs ``hocon``'s.

Both packages read the same fixture trees, written in the official layouts
(``tools/fixture_trees.py``, with the content ``tests/test_dataset_parsers.py``
gives its trees): FPHAB with 3 train sequences and 1 test sequence of
1920 x 1080 JPEG frames (its intrinsics are fixed), a dense binary PLY
object that the default budget decimates, and MANO fits; HO-3D with 2
sequences of 64 x 48 PNG frames (its ``camMat`` is the tree's own) and a
dense OBJ object. Held equal: lengths, supervision, every ``get_sample``
field and ``sample_pair`` under one ``rng`` sequence; the fit vertices
within 1e-5 m of ``hocon``'s jitted MANO; ``HandDataset`` items within the
bars of ``tests/test_torch_data.py``; ``decimate_mesh`` bit for bit;
``check_dataset``'s lines. The port's HO-3D vertex cache is keyed apart
from ``hocon``'s, and ``get_sample`` does no torch or device work.
"""

import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from hocon.data import augment as RA
from hocon.data import fphab as RF
from hocon.data import ho3d as RH
from hocon.data.check import check_dataset as ref_check_dataset
from hocon.data.factory import get_dataset as ref_get_dataset
from hocon.data.hand_dataset import HandDataset as RefHandDataset
from hocon.data.hand_dataset import HandDatasetConfig as RefConfig
from hocon.data.meshes import decimate_mesh as ref_decimate_mesh
from hocon_torch.data import augment as TA
from hocon_torch.data import fphab as TF
from hocon_torch.data import ho3d as TH
from hocon_torch.data.check import check_dataset
from hocon_torch.data.factory import get_dataset
from hocon_torch.data.hand_dataset import HandDataset, HandDatasetConfig
from hocon_torch.data.meshes import decimate_mesh
from hocon_torch.geometry.mano import synthetic_mano_model
from test_torch_data import IMAGE_ATOL, LABEL_ATOL
from tools import fixture_trees as FT

torch.set_num_threads(1)

FIT_ATOL = 1e-5  # meters: f32 MANO of the two frameworks
# HO-3D's object rotations: f32 Rodrigues of torch against jax, apart by
# an ulp (1.2e-7 measured); every other field is held bit for bit.
OBJ_POSE_ATOL = 1e-6
# Float crops of 1920 x 1080 frames: cv2.warpAffine rounds its source
# coordinates in f32, whose spacing near x = 1000-2000 px is 1.2e-4 px
# (7.6e-6 px within a 64 px frame, where test_torch_data's IMAGE_ATOL
# holds); measured 3.8e-5 on the FPHAB tree here. The frames themselves
# decode bit for bit as cv2's (test_frames_decode_as_cv2).
FULL_HD_IMAGE_ATOL = 1e-4
# (subject, action, seq): 3 train sequences, 1 test sequence. The one
# without MANO fits has no object, so --use_objects batches never mix
# frames with and without vertices (tree_stack refuses that in both packages).
FPHAB_SEQS = (("Subject_1", "open_milk", "1"), ("Subject_1", "charge_cell_phone", "1"),
              ("Subject_3", "put_salt", "2"), ("Subject_2", "open_milk", "1"))
FPHAB_FRAMES = 6
HO3D_SEQS = ("ABF10", "MC1")
HO3D_FRAMES = 4


def _frame(rng, h, w):
    """A smooth colour field with noise: image-like content."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 200.0 / w, yy * 200.0 / h, (xx + yy) * 100.0 / (w + h)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _jpeg(rgb, quality=90):
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def _png(rgb, level):
    ok, buf = cv2.imencode(".png", rgb[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def fphab_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fphab"))
    rng = np.random.default_rng(0)
    frames = [_jpeg(_frame(rng, 1080, 1920)) for _ in range(2)]
    for si, (subject, action, seq) in enumerate(FPHAB_SEQS):
        skel = rng.uniform(-100, 100, (FPHAB_FRAMES, 21, 3)).astype(np.float32)
        skel[..., 2] += 500
        poses = np.tile(np.eye(4, dtype=np.float32), (FPHAB_FRAMES, 1, 1))
        poses[:, :3, 3] = [[10.0 * i, 5.0, 400.0] for i in range(FPHAB_FRAMES)]
        fits = None
        if si != 1:  # one sequence without fits
            fits = {i: {"pose": rng.standard_normal(48).astype(np.float32) * 0.1,
                        "shape": rng.standard_normal(10).astype(np.float32) * 0.1,
                        "trans": np.array([0.0, 0.0, 0.5], np.float32)}
                    for i in range(FPHAB_FRAMES)}
        FT.write_fphab_sequence(root, subject, action, seq, skel,
                                [frames[i % 2] for i in range(FPHAB_FRAMES)], poses, fits)
    models = os.path.join(root, "Object_models")
    verts, faces = FT.sphere_mesh(1500, 30.0, seed=1)  # ~3000 faces, mm
    FT.write_ply(os.path.join(models, "milk_model", "milk_model.ply"), verts, faces, binary=True)
    verts, faces = FT.box_mesh(25.0)
    FT.write_ply(os.path.join(models, "salt_model", "salt_model.ply"), verts, faces)
    return root


def _write_ho3d(root, split_dir, seqs, joints_zero=False):
    """Train sequences hold a dense OBJ object and a box; the evaluation
    split's object has only ``points.xyz`` (no faces)."""
    rng = np.random.default_rng(1)
    cam = np.array([[60.0, 0.0, 32.0], [0.0, 60.0, 24.0], [0.0, 0.0, 1.0]], np.float32)
    objects = ("003_cracker_box", "006_mustard_bottle") if split_dir == "train" else (
        "021_bleach_cleanser",)
    for s, seq in enumerate(seqs):
        for i in range(HO3D_FRAMES):
            joints = rng.uniform(-0.05, 0.05, (21, 3)).astype(np.float32)
            joints[:, 2] -= 0.5  # OpenGL: in front of the camera is -z
            if joints_zero:
                joints[:] = 0.0
            meta = {
                "handJoints3D": joints if split_dir == "train" else joints[0],
                "handPose": rng.standard_normal(48).astype(np.float32) * 0.2,
                "handBeta": rng.standard_normal(10).astype(np.float32),
                "handTrans": np.array([0.0, 0.0, -0.5], np.float32),
                "objName": objects[s % len(objects)],
                "objRot": rng.standard_normal(3).astype(np.float32),
                "objTrans": np.array([0.0, 0.02, -0.55], np.float32),
                "camMat": cam,
            }
            FT.write_ho3d_frame(root, split_dir, seq, i, meta,
                                _png(_frame(rng, 48, 64), level=(3 * i) % 10))
    models = os.path.join(root, "models_root", "models")
    FT.write_obj(os.path.join(models, "003_cracker_box", "textured_simple.obj"),
                 *FT.sphere_mesh(800, 0.05, seed=2))
    FT.write_obj(os.path.join(models, "006_mustard_bottle", "textured_simple.obj"),
                 *FT.box_mesh(0.03))
    os.makedirs(os.path.join(models, "021_bleach_cleanser"), exist_ok=True)
    np.savetxt(os.path.join(models, "021_bleach_cleanser", "points.xyz"),
               rng.uniform(-0.05, 0.05, (20, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def ho3d_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ho3d"))
    _write_ho3d(root, "train", HO3D_SEQS)
    _write_ho3d(root, "evaluation", HO3D_SEQS[:1])
    return root


@pytest.fixture(scope="module")
def manos(mano_model):
    return mano_model, synthetic_mano_model(0, device="cpu")


def _assert_samples_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert g is None and w is None, k
        elif k == "verts3d_cam":
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, atol=FIT_ATOL, rtol=0)
        elif k == "obj_pose" and g.dtype == w.dtype:
            np.testing.assert_allclose(g, w, atol=OBJ_POSE_ATOL, rtol=0)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w and type(g) is type(w), k


def _assert_parsers_equal(port, ref):
    assert len(port) == len(ref) > 0
    np.testing.assert_array_equal(port.supervised, ref.supervised)
    assert {q.value for q in port.available_queries()} == {
        q.value for q in ref.available_queries()}
    for i in range(len(ref)):
        _assert_samples_equal(port.get_sample(i), ref.get_sample(i))
    rng_p, rng_r = np.random.default_rng(3), np.random.default_rng(3)
    pairs = [(port.sample_pair(i, rng_p), ref.sample_pair(i, rng_r)) for i in range(len(ref))]
    assert all(p == r for p, r in pairs), pairs


_FPHAB_CASES = {
    # name: (split, use_objects, with MANO, fraction)
    "train_objects_fits": ("train", True, True, 0.34),
    "train_hand_only": ("train", False, False, 1.0),
    "test_objects": ("test", True, True, 1.0),
}


@pytest.mark.parametrize("case", list(_FPHAB_CASES))
def test_fphab_matches_reference(case, fphab_root, manos):
    split, objects, with_mano, fraction = _FPHAB_CASES[case]
    kw = dict(split=split, fraction=fraction, use_objects=objects,
              decimate_objects_to=1000 if objects else None)
    ref = RF.FPHAB(fphab_root, mano=manos[0] if with_mano else None, **kw)
    port = TF.FPHAB(fphab_root, mano=manos[1] if with_mano else None, **kw)
    _assert_parsers_equal(port, ref)
    if objects:  # the dense PLY decimated to the budget, bit for bit
        assert 0 < len(port.objects["milk"][1]) <= 1000 < 2 * 1500 - 4
    if with_mano and split == "train":
        assert (port._fit_row >= 0).sum() == 2 * FPHAB_FRAMES


_HO3D_CASES = {
    # name: (split, use_objects, with MANO, fraction)
    "train_objects_fits": ("train", True, True, 0.5),
    "train_hand_only": ("train", False, False, 1.0),
    "evaluation_root_only": ("test", True, True, 1.0),
}


@pytest.mark.parametrize("case", list(_HO3D_CASES))
def test_ho3d_matches_reference(case, ho3d_root, manos, tmp_path, monkeypatch):
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path / "ref_cache"))
    split, objects, with_mano, fraction = _HO3D_CASES[case]
    kw = dict(split=split, fraction=fraction, use_objects=objects,
              decimate_objects_to=300 if objects else None)
    ref = RH.HO3D(ho3d_root, mano=manos[0] if with_mano else None, **kw)
    port = TH.HO3D(ho3d_root, mano=manos[1] if with_mano else None,
                   cache_dir=str(tmp_path / "port_cache"), **kw)
    _assert_parsers_equal(port, ref)


def test_fit_cache_is_keyed_apart_reused_and_reopened(ho3d_root, manos, tmp_path, monkeypatch):
    """The port's vertex cache never names ``hocon``'s file, is reused by a
    second construction, and an unpickled copy reopens it."""
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path / "cache"))
    ref = RH.HO3D(ho3d_root, mano=manos[0])
    port = TH.HO3D(ho3d_root, mano=manos[1])  # the reference's default directory
    assert os.path.dirname(port._fit_path) == os.path.dirname(ref._fit_path)
    assert port._fit_path != ref._fit_path
    assert sorted(os.listdir(tmp_path / "cache")) == sorted(
        os.path.basename(p) for p in (ref._fit_path, port._fit_path))
    mtime = os.stat(port._fit_path).st_mtime_ns
    again = TH.HO3D(ho3d_root, mano=manos[1])
    assert os.stat(port._fit_path).st_mtime_ns == mtime
    copy = pickle.loads(pickle.dumps(again))
    assert again.__getstate__()["_fit_verts"] is None
    assert isinstance(copy._fit_verts, np.memmap)
    np.testing.assert_array_equal(copy.get_sample(1)["verts3d_cam"],
                                  port.get_sample(1)["verts3d_cam"])
    # Another MANO model, another file.
    other = TH.HO3D(ho3d_root, mano=synthetic_mano_model(1, device="cpu"))
    assert other._fit_path != port._fit_path


def test_get_sample_does_no_torch_or_device_work(ho3d_root, fphab_root, manos, tmp_path,
                                                 monkeypatch):
    """Fit vertices and object rotations are computed at construction:
    ``get_sample`` must not run MANO, make a tensor, touch CUDA or reread a
    meta pickle."""
    ho3d = TH.HO3D(ho3d_root, use_objects=True, mano=manos[1], cache_dir=str(tmp_path))
    fphab = TF.FPHAB(fphab_root, use_objects=True, mano=manos[1], decimate_objects_to=1000)

    def boom(*a, **k):
        raise AssertionError("torch or device work inside get_sample")

    import hocon_torch.geometry.mano as TM

    for mod, name in ((TM, "mano_forward"), (TF, "fit_vertices"), (TH, "fit_vertices"),
                      (torch, "from_numpy"), (torch, "as_tensor"), (torch, "tensor"),
                      (torch.cuda, "_lazy_init"), (torch.cuda, "is_available")):
        monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(TH, "pickle", None)  # any meta reread -> AttributeError
    for ds in (ho3d, fphab):
        for i in range(len(ds)):
            s = ds.get_sample(i)
        assert s["verts3d_cam"].shape == (778, 3) and s["obj_pose"][2, 3] > 0


def _assert_items_close(got: dict, want: dict, uint8: bool, image_atol: float):
    """test_torch_data's bars: labels 1e-5, uint8 crops within one level,
    float crops within ``image_atol``; the labels from MANO fits at FIT_ATOL
    and those from HO-3D's object rotations at OBJ_POSE_ATOL (in mm)."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_items_close(g, w, uint8, image_atol)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape)
        if k == "image" and uint8:
            diff = np.abs(g.astype(int) - w.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())
        elif k == "image":
            np.testing.assert_allclose(g, w, atol=image_atol, rtol=0, err_msg=k)
        elif k == "verts3d":  # root-centred mm
            np.testing.assert_allclose(g, w, atol=FIT_ATOL * 1000.0, rtol=0, err_msg=k)
        elif k in ("objverts3d", "objcorners3d"):
            np.testing.assert_allclose(g, w, atol=OBJ_POSE_ATOL * 1000.0, rtol=0, err_msg=k)
        elif k in ("obj_faces", "obj_verts_mask", "sup_mask", "obj_nverts", "sample_idx"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=LABEL_ATOL, rtol=LABEL_ATOL, err_msg=k)


def test_frames_decode_as_cv2(fphab_root, ho3d_root):
    """Every frame of both trees: read_image on the CPU gives cv2's bits."""
    from hocon_torch.data.images import read_image

    paths = [os.path.join(d, f) for top in (fphab_root, ho3d_root)
             for d, _, files in os.walk(top) for f in files if f.endswith((".jpeg", ".png"))]
    assert len(paths) == len(FPHAB_SEQS) * FPHAB_FRAMES + 3 * HO3D_FRAMES
    for p in paths:
        want = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(read_image(p, "cpu"), want, err_msg=p)


def _hand_datasets(pose_port, pose_ref, pair_mode, uint8, train):
    kw = dict(image_size=64, pair_mode=pair_mode, train=train, uint8_images=uint8,
              max_obj_verts=1000, max_obj_faces=1000)
    ref = RefHandDataset(pose_ref, RefConfig(augment=RA.AugmentConfig(enabled=train), **kw),
                         seed=5)
    port = HandDataset(pose_port, HandDatasetConfig(augment=TA.AugmentConfig(enabled=train),
                                                    decode_device="cpu", **kw), seed=5)
    return port, ref


_HD_CASES = {
    # name: (dataset, pair_mode, uint8_images, train)
    "fphab_pairs": ("fphab", True, False, True),
    "fphab_eval_uint8": ("fphab", False, True, False),
    "ho3d_pairs_uint8": ("ho3d", True, True, True),
    "ho3d_eval": ("ho3d", False, False, False),
}


@pytest.mark.parametrize("case", list(_HD_CASES))
def test_hand_dataset_items_match_reference(case, fphab_root, ho3d_root, manos, tmp_path,
                                            monkeypatch):
    """Frames read from disk (the port's decoders against cv2), cropped and
    jittered: images and labels within the bars of test_torch_data, the
    float crops of FPHAB's frames within FULL_HD_IMAGE_ATOL."""
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path))
    name, pair_mode, uint8, train = _HD_CASES[case]
    if name == "fphab":
        kw = dict(split="train", use_objects=True, fraction=0.5, decimate_objects_to=1000)
        pose_ref, pose_port = RF.FPHAB(fphab_root, mano=manos[0], **kw), TF.FPHAB(
            fphab_root, mano=manos[1], **kw)
        idx = (0, 7, 11)
    else:
        kw = dict(split="train", use_objects=True, decimate_objects_to=300)
        pose_ref, pose_port = RH.HO3D(ho3d_root, mano=manos[0], **kw), TH.HO3D(
            ho3d_root, mano=manos[1], **kw)
        idx = range(0, len(pose_ref), 2)
    port, ref = _hand_datasets(pose_port, pose_ref, pair_mode, uint8, train)
    atol = FULL_HD_IMAGE_ATOL if name == "fphab" else IMAGE_ATOL
    for i in idx:
        _assert_items_close(port[i], ref[i], uint8, atol)


_FACTORY_CASES = {
    # name: (dataset, split, use_objects)
    "fphab": ("fphab", "train", True),
    "fhbhands": ("fhbhands", "test", False),
    "ho3d": ("ho3d", "train", True),
    "ho3dv2": ("ho3dv2", "test", False),
}


@pytest.mark.parametrize("case", list(_FACTORY_CASES))
def test_get_dataset_builds_real_datasets_as_reference(case, fphab_root, ho3d_root, manos,
                                                      tmp_path, monkeypatch):
    """The aliases, the decimation default (the face cap) and the buffers
    sized to it; the port decodes on the device it is given."""
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path))
    name, split, objects = _FACTORY_CASES[case]
    root = fphab_root if name.startswith("f") else ho3d_root
    kw = dict(image_size=32, use_objects=objects, pair_mode=split == "train", train=False)
    ref = ref_get_dataset(name, split, root, mano=manos[0], **kw)
    port = get_dataset(name, split, root, mano=manos[1], device="cpu", **kw)
    assert type(port.pose_dataset).__name__ == type(ref.pose_dataset).__name__
    assert (port.cfg.max_obj_faces, port.cfg.max_obj_verts) == (
        ref.cfg.max_obj_faces, ref.cfg.max_obj_verts)
    assert port.cfg.decode_device == "cpu"
    _assert_parsers_equal(port.pose_dataset, ref.pose_dataset)
    atol = FULL_HD_IMAGE_ATOL if root == fphab_root else IMAGE_ATOL
    _assert_items_close(port[1], ref[1], False, atol)


def _strip_mesh():
    """``test_decimate_mesh_guarantees_budget_on_pathological_geometry``'s
    hair-thin strip: clustering jumps from over budget to empty."""
    n = 400
    x = np.linspace(0.0, 1.0, n)
    verts = np.stack([np.concatenate([x, x]),
                      np.concatenate([np.zeros(n), np.full(n, 1e-5)]),
                      np.zeros(2 * n)], axis=1).astype(np.float32)
    faces = [[i, i + 1, n + i] for i in range(n - 1)] + [
        [i + 1, n + i + 1, n + i] for i in range(n - 1)]
    return verts, np.asarray(faces, np.int64)


_DECIMATE_CASES = {
    # name: (mesh, target faces)
    "dense_sphere_1500": (lambda: FT.sphere_mesh(6000, seed=0), 1500),
    "dense_sphere_200": (lambda: FT.sphere_mesh(6000, seed=0), 200),
    "box_fits": (lambda: FT.box_mesh(), 100),
    "box_to_4": (lambda: FT.box_mesh(), 4),
    "strip_700": (_strip_mesh, 700),
    "strip_100": (_strip_mesh, 100),
    "strip_10": (_strip_mesh, 10),
}


@pytest.mark.parametrize("case", list(_DECIMATE_CASES))
def test_decimate_mesh_is_bit_equal(case):
    make, target = _DECIMATE_CASES[case]
    verts, faces = make()
    got, want = decimate_mesh(verts, faces, target), ref_decimate_mesh(verts, faces, target)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert len(got[1]) <= target


def test_check_dataset_prints_the_references_lines(fphab_root, ho3d_root, manos, tmp_path,
                                                   monkeypatch):
    """A clean FPHAB tree (0 anomalies) and an HO-3D tree whose joints are
    all zero (anomalies): the same lines and counts."""
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path / "ref"))
    cfg = dict(image_size=64, max_obj_verts=1000, max_obj_faces=1000)
    kw = dict(split="train", use_objects=True, fraction=0.5, decimate_objects_to=1000)
    ref = RefHandDataset(RF.FPHAB(fphab_root, mano=manos[0], **kw), RefConfig(**cfg))
    port = HandDataset(TF.FPHAB(fphab_root, mano=manos[1], **kw),
                       HandDatasetConfig(decode_device="cpu", **cfg))
    lines_ref, lines_port = [], []
    assert ref_check_dataset(ref, "train", out=lines_ref.append) == 0
    assert check_dataset(port, "train", out=lines_port.append) == 0
    assert lines_port == lines_ref and lines_ref[-1] == "[check_data:train] OK"
    assert len(lines_ref) == 2 + 2 + 1  # head, supervision, 2 object sequences, verdict

    zeros = str(tmp_path / "zeros")
    _write_ho3d(zeros, "train", HO3D_SEQS, joints_zero=True)
    kw = dict(split="train", use_objects=True, decimate_objects_to=300)
    ref = RefHandDataset(RH.HO3D(zeros, mano=manos[0], **kw), RefConfig(**cfg))
    port = HandDataset(TH.HO3D(zeros, mano=manos[1], cache_dir=str(tmp_path / "port"), **kw),
                       HandDatasetConfig(decode_device="cpu", **cfg))
    lines_ref, lines_port = [], []
    n_ref = ref_check_dataset(ref, "train", out=lines_ref.append)
    assert check_dataset(port, "train", out=lines_port.append) == n_ref >= 2
    assert lines_port == lines_ref
    assert any("all zeros" in ln for ln in lines_port)
