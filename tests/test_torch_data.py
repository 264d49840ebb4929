"""Port data pipeline vs ``hocon.data``: queries, pairing, augmentation,
cropping, ``HandDataset`` and ``BatchLoader``.

Every comparison feeds both packages the same seeded numpy inputs. The
``HandDataset`` cases wrap *the same* pose dataset (``hocon``'s
``SyntheticHandDataset`` at 32 px) in both packages' wrappers, which the
duck-typed pose-dataset protocol allows, so only the wrappers differ.

``warp_image`` is plain PyTorch in the port and ``cv2.warpAffine`` in the
reference: the port samples at exact float64 inverse-affine coordinates,
cv2 rounds them in float32, so the two drift apart as the coordinates grow
(~3e-6 at 64 px, ~2e-5 at 256 px on a random texture).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from hocon.data import augment as RA
from hocon.data import cropping as RC
from hocon.data import pairing as RPair
from hocon.data import pipeline as RPipe
from hocon.data import queries as RQ
from hocon.data.hand_dataset import HandDataset as RefHandDataset
from hocon.data.hand_dataset import HandDatasetConfig as RefConfig
from hocon.data.meshes import bbox_corners as ref_bbox_corners
from hocon.data.synthetic import SyntheticHandDataset as RefSynthetic
from hocon_torch.data import augment as TA
from hocon_torch.data import cropping as TC
from hocon_torch.data import pairing as TPair
from hocon_torch.data import pipeline as TPipe
from hocon_torch.data import queries as TQ
from hocon_torch.data.factory import get_dataset
from hocon_torch.data.hand_dataset import HandDataset, HandDatasetConfig
from hocon_torch.data.meshes import bbox_corners

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

IMAGE_ATOL = 2e-5  # float crops: the warp's coordinate rounding (module note)
LABEL_ATOL = 1e-5


def test_queries_have_the_reference_values():
    for ref_enum, enum in ((RQ.BaseQueries, TQ.BaseQueries), (RQ.TransQueries, TQ.TransQueries)):
        assert [(q.name, q.value) for q in enum] == [(q.name, q.value) for q in ref_enum]
    avail = {TQ.BaseQueries.IMAGE, TQ.BaseQueries.CAMINTR}
    assert TQ.one_query_in([TQ.BaseQueries.JOINTS2D, TQ.BaseQueries.IMAGE], avail)
    assert not TQ.one_query_in([TQ.BaseQueries.JOINTS2D], avail)


@pytest.mark.parametrize("fixed", [False, True], ids=["random_offset", "fixed_offset"])
def test_pair_target_draws_the_reference_indices(fixed):
    draws = 0
    for seed in range(40):
        count = 2 + seed % 9  # short sequences: every ref is near an edge
        spacing = 1 + seed % 5
        ref_rng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
        for ref in range(count):
            want = RPair.pair_target(ref, count, spacing, ref_rng, fixed=fixed)
            got = TPair.pair_target(ref, count, spacing, rng, fixed=fixed)
            assert got == want, (seed, ref, count, spacing)
            assert 0 <= got < count
            draws += 1
        assert ref_rng.random() == rng.random()  # the same calls were made
    assert draws >= 200


_AUG_CASES = {
    "default": TA.AugmentConfig(),
    "no_hue": TA.AugmentConfig(hue=0.0, brightness=0.5),
    "disabled": TA.AugmentConfig(enabled=False),
}


@pytest.mark.parametrize("case", list(_AUG_CASES))
def test_jitter_matches_reference_from_the_same_seed(case):
    cfg = _AUG_CASES[case]
    ref_cfg = RA.AugmentConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    image = np.random.default_rng(3).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    for seed in range(5):
        ref_rng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
        want = RA.sample_affine_jitter(ref_rng, ref_cfg, 40.0)
        got = TA.sample_affine_jitter(rng, cfg, 40.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        want_img = RA.color_jitter(ref_rng, image, ref_cfg)
        got_img = TA.color_jitter(rng, image, cfg)
        assert got_img.dtype == want_img.dtype
        np.testing.assert_allclose(got_img, want_img, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(TA.normalize_image(image), RA.normalize_image(image))
    np.testing.assert_array_equal(TA.IMAGENET_MEAN, RA.IMAGENET_MEAN)
    np.testing.assert_array_equal(TA.IMAGENET_STD, RA.IMAGENET_STD)


def test_crop_affine_and_intrinsics_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        pts = rng.uniform(-20, 300, (21, 2))
        center, side = TC.square_bbox_from_points(pts, 1.3)
        ref_center, ref_side = RC.square_bbox_from_points(pts, 1.3)
        np.testing.assert_allclose(center, ref_center, atol=1e-9, rtol=0)
        assert abs(side - ref_side) <= 1e-9
        rot, scale, jit = rng.uniform(-30, 30), rng.uniform(0.8, 1.2), rng.uniform(-9, 9, 2)
        aff = TC.build_crop_affine(center, side, 64, rot, scale, jit)
        ref_aff = RC.build_crop_affine(ref_center, ref_side, 64, rot, scale, jit)
        np.testing.assert_allclose(aff, ref_aff, atol=1e-9, rtol=0)
        k = np.array([[rng.uniform(80, 400), 0, 128], [0, rng.uniform(80, 400), 120], [0, 0, 1]])
        np.testing.assert_allclose(TC.transform_intrinsics(k, aff),
                                   RC.transform_intrinsics(k, ref_aff), atol=1e-9, rtol=0)
        np.testing.assert_allclose(TC.transform_points2d(pts, aff),
                                   RC.transform_points2d(pts, ref_aff), atol=1e-9, rtol=0)
    assert TC.square_bbox_from_points(np.zeros((3, 2)))[1] == 1.0  # degenerate: side 1
    verts = rng.standard_normal((50, 3)).astype(np.float32)
    np.testing.assert_array_equal(bbox_corners(verts), ref_bbox_corners(verts))


_WARP_CASES = {
    # name: (centre, side, out_res, rotation deg, scale, centre jitter)
    "rotated_scaled": ((30.0, 34.0), 40.0, 48, 20.0, 1.1, (5.0, -7.0)),
    "partly_outside": ((30.0, 34.0), 40.0, 48, -13.0, 0.8, (30.0, 20.0)),
    "mostly_outside": ((10.0, 60.0), 30.0, 32, 40.0, 0.5, (-40.0, -30.0)),
    "upsampled": ((32.0, 32.0), 20.0, 64, 75.0, 1.0, (0.0, 0.0)),
}


@pytest.mark.parametrize("case", list(_WARP_CASES))
def test_warp_image_matches_cv2(case):
    center, side, res, rot, scale, jit = _WARP_CASES[case]
    image = np.random.default_rng(1).uniform(0, 1, (64, 60, 3)).astype(np.float32)
    aff = RC.build_crop_affine(np.array(center), side, res, rot, scale, np.array(jit))
    want = RC.warp_image(image, aff, res)
    got = TC.warp_image(image, aff, res)
    assert got.shape == want.shape == (res, res, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # Pixels mapped outside the source are exactly the constant 0 border.
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.fixture(scope="module")
def pose_dataset(tmp_path_factory):
    """``hocon``'s synthetic pose dataset (2 videos x 4 frames at 32 px, box
    object, half the frames annotated), rendered fresh."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOCON_CACHE_DIR", str(tmp_path_factory.mktemp("synth_cache")))
        from hocon.geometry.mano import synthetic_mano_model

        return RefSynthetic(n_videos=2, frames_per_video=4, image_size=32, seed=0,
                            mano=synthetic_mano_model(0), supervised_fraction=0.5,
                            pair_spacing=3)


class _Recorder:
    """The pose dataset, recording which frames a wrapper asks for."""

    def __init__(self, ds):
        self.ds, self.frames, self.pairs = ds, [], []

    def __len__(self):
        return len(self.ds)

    def available_queries(self):
        return self.ds.available_queries()

    def get_sample(self, i):
        self.frames.append(int(i))
        return self.ds.get_sample(i)

    def sample_pair(self, i, rng):
        pair = self.ds.sample_pair(i, rng)
        self.pairs.append(pair)
        return pair


def _assert_sample_close(got: dict, want: dict, uint8: bool):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_sample_close(g, w, uint8)
            continue
        w = np.asarray(w)
        g = np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if k == "image" and uint8:
            # Float crops within IMAGE_ATOL round to the same level except
            # where one lies on a .5 boundary.
            diff = np.abs(g.astype(int) - w.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())
        elif k == "image":
            np.testing.assert_allclose(g, w, atol=IMAGE_ATOL, rtol=0, err_msg=k)
        elif k in ("obj_faces", "obj_verts_mask", "sup_mask", "obj_nverts", "sample_idx"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            # Labels in mm reach hundreds: 1e-5 relative as well.
            np.testing.assert_allclose(g, w, atol=LABEL_ATOL, rtol=LABEL_ATOL, err_msg=k)


_HD_CASES = {
    # name: (pair_mode, clip_len, uint8_images, with_object, train)
    "single_float": (False, 2, False, True, True),
    "single_uint8_eval": (False, 2, True, True, False),
    "pairs_float": (True, 2, False, True, True),
    "pairs_uint8": (True, 2, True, True, True),
    "clip3_no_object": (True, 3, True, False, True),
}


@pytest.mark.parametrize("case", list(_HD_CASES))
def test_hand_dataset_matches_reference(pose_dataset, case):
    pair_mode, clip_len, uint8, with_object, train = _HD_CASES[case]
    pose_dataset.with_object = with_object
    try:
        kw = dict(image_size=32, pair_mode=pair_mode, clip_len=clip_len, train=train,
                  uint8_images=uint8, max_obj_verts=10, max_obj_faces=16)
        ref_rec, rec = _Recorder(pose_dataset), _Recorder(pose_dataset)
        ref = RefHandDataset(ref_rec, RefConfig(augment=RA.AugmentConfig(enabled=train), **kw),
                             seed=5)
        port = HandDataset(rec, HandDatasetConfig(augment=TA.AugmentConfig(enabled=train), **kw),
                           seed=5)
        assert len(port) == len(ref) == 8
        for i in range(len(port)):
            _assert_sample_close(port[i], ref[i], uint8)
        assert rec.frames == ref_rec.frames and rec.pairs == ref_rec.pairs
    finally:
        pose_dataset.with_object = True


def test_hand_dataset_refuses_oversized_meshes_and_missing_queries(pose_dataset, tmp_path):
    cfg = HandDatasetConfig(image_size=32, max_obj_verts=4)
    with pytest.raises(ValueError, match="exceeds the configured buffers"):
        HandDataset(pose_dataset, cfg)[0]
    with pytest.raises(ValueError, match="cannot serve queries"):
        HandDataset(pose_dataset, cfg, required_queries=[TQ.BaseQueries.JOINTS3D, TQ.TransQueries.IMAGE])
    # The FPHAB and HO-3D parsers build (on an empty tree here; on fixture
    # trees against hocon's in test_torch_parsers), objects decimated to the
    # face cap by default.
    os.makedirs(tmp_path / "evaluation")
    fphab = get_dataset("fphab", "train", str(tmp_path), device="cpu")
    ho3d = get_dataset("ho3d", "test", str(tmp_path), use_objects=True, max_obj_faces=700,
                       device="cpu")
    assert type(fphab.pose_dataset).__name__ == "FPHAB" and len(fphab) == 0
    assert type(ho3d.pose_dataset).__name__ == "HO3D" and len(ho3d) == 0
    assert ho3d.pose_dataset.decimate_objects_to == 700 == ho3d.cfg.max_obj_verts
    assert fphab.cfg.decode_device == "cpu"
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("mnist", "train")


class _Ints:
    """A dataset of dict samples {'i': i, 'x': (2,) floats}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full(2, i, np.float32), "nested": {"y": np.int32(-i)}}


@pytest.mark.parametrize(
    "n,batch,shuffle,drop_last,shards",
    [(10, 4, True, True, 1), (10, 4, True, False, 1), (10, 4, False, False, 2),
     (3, 8, True, False, 4), (16, 16, True, False, 1), (33, 6, True, True, 3)],
)
def test_batch_loader_indices_match_reference(n, batch, shuffle, drop_last, shards):
    ds = _Ints(n)
    for shard in range(shards):
        kw = dict(shuffle=shuffle, seed=7, drop_last=drop_last, shard_index=shard,
                  shard_count=shards)
        ref, port = RPipe.BatchLoader(ds, batch, **kw), TPipe.BatchLoader(ds, batch, **kw)
        assert port.steps_per_epoch() == ref.steps_per_epoch()
        for epoch in range(3):
            for g, w in zip(port.epoch_indices(epoch), ref.epoch_indices(epoch)):
                np.testing.assert_array_equal(g, w)
        for g, w in zip(port.epoch(1), ref.epoch(1)):
            assert set(g) == set(w)
            for k in ("i", "x", "_valid"):
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g["nested"]["y"], w["nested"]["y"])
    with pytest.raises(ValueError, match="divide"):
        TPipe.BatchLoader(ds, 5, shard_count=2)
    probe = TPipe.probe_batch(ds, 4)
    want = RPipe.probe_batch(ds, 4)
    for k in ("i", "x", "_valid"):
        np.testing.assert_array_equal(probe[k], want[k])


def test_prefetched_epoch_equals_synchronous_one():
    ds = _Ints(23)
    sync = list(TPipe.BatchLoader(ds, 4, seed=3, drop_last=False).epoch(2))
    pre = list(TPipe.BatchLoader(ds, 4, seed=3, drop_last=False, prefetch=2).epoch(2))
    assert len(sync) == len(pre) == 6
    for a, b in zip(sync, pre):
        for k in ("i", "x", "_valid"):
            np.testing.assert_array_equal(a[k], b[k])


def test_break_mid_epoch_ends_the_prefetch_thread():
    before = set(threading.enumerate())
    loader = TPipe.BatchLoader(_Ints(64), 2, prefetch=2)
    it = loader.epoch(0)
    for k, batch in enumerate(it):
        if k == 1:
            break
    new = [t for t in threading.enumerate() if t not in before]
    assert len(new) == 1 and new[0].daemon
    del it, batch  # the consumer drops the generator: its finally closes the prefetcher
    new[0].join(timeout=5.0)
    assert not new[0].is_alive()

    class Failing(_Ints):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("bad sample")
            return super().__getitem__(i)

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="bad sample"):
        list(TPipe.BatchLoader(Failing(8), 2, shuffle=False, prefetch=1).epoch(0))
    assert time.perf_counter() - t0 < 5.0
