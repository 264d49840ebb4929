"""Port epoch loop, metric meters, writer, evaluators and file dumps vs
``hocon``.

Both packages get the same seeded numpy inputs: the same flag namespace,
term dicts, keypoints, vertices and a loader whose tail batch is padded
with ``_valid = 0`` rows. ``epoch_pass`` runs on stub step functions that
return the same terms and predictions (numpy for ``hocon``, tensors for the
port, which fetches them in its one transfer per 20 steps), so every
difference is the loop's own. Values agree to 1e-12 (measured: equal).
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from hocon.evaluation.codalab import dump_ho3d_codalab as ref_dump
from hocon.evaluation.zimeval import EvalUtil as RefEvalUtil
from hocon.evaluation.zimeval import VertexErrorMeter as RefVertexErrorMeter
from hocon.exp.args import save_args as ref_save_args
from hocon.train.loop import epoch_pass as ref_epoch_pass
from hocon.train.metrics import AverageMeters as RefAverageMeters
from hocon.train.metrics import MetricWriter as RefMetricWriter
import hocon_torch.train.loop as loop
from hocon_torch.evaluation.codalab import dump_ho3d_codalab
from hocon_torch.evaluation.zimeval import EvalUtil, VertexErrorMeter
from hocon_torch.exp.args import save_args
from hocon_torch.train.metrics import AverageMeters, MetricWriter, StepTimer

torch.set_num_threads(1)

TOL = 1e-12


def _terms(rng, n):
    """n term dicts of f32 scalars, one NaN among them (the meters skip it)."""
    out = [{k: np.float32(rng.uniform(0.1, 10.0)) for k in ("loss_total", "photo_total",
                                                            "grad_norm")}
           for _ in range(n)]
    out[min(3, n - 1)]["photo_total"] = np.float32(np.nan)
    return out


def test_save_args_writes_the_reference_files(tmp_path):
    ns = argparse.Namespace(exp_id="run", lr=5e-5, epochs=3, bf16=True, resume="",
                            raster_gamma=1.0 / 40.0, thresholds=(15.0, 30.0), path=tmp_path)
    ref_save_args(ns, str(tmp_path / "ref"))
    save_args(ns, str(tmp_path / "port"))
    for name in ("opt.txt", "opt.json"):
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    assert json.loads((tmp_path / "port" / "opt.json").read_text())["epochs"] == 3


def test_meters_and_writer_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    terms = _terms(rng, 7)
    ref_m, m = RefAverageMeters(), AverageMeters()
    ref_w, w = RefMetricWriter(str(tmp_path / "ref")), MetricWriter(str(tmp_path / "port"))
    for i, t in enumerate(terms):
        ref_m.update(t, n=i % 3 + 1)
        m.update(t, n=i % 3 + 1)
        ref_w.log_step(i + 1, t)
        w.log_step(i + 1, t)
    got, want = m.averages(), ref_m.averages()
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL * abs(want[k]), k
    for epoch, split in ((0, "train"), (0, "val"), (1, "train")):
        ref_w.log_epoch(epoch, split, want)
        w.log_epoch(epoch, split, got)
    ref_w.close()
    w.close()
    assert (tmp_path / "ref" / "epochs.json").read_text() == \
        (tmp_path / "port" / "epochs.json").read_text()

    def lines(d):
        recs = [json.loads(s) for s in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
        for r in recs:
            r.pop("time")
        return json.dumps(recs)

    assert lines("ref") == lines("port")
    # A writer reopened on the run directory appends to its history.
    w2 = MetricWriter(str(tmp_path / "port"))
    w2.log_epoch(2, "val", {"mpjpe_mm": 1.0})
    w2.close()
    assert len(json.loads((tmp_path / "port" / "epochs.json").read_text())) == 4


def test_step_timer_skips_the_warmup():
    t = StepTimer(warmup=2)
    assert np.isnan(t.rate())
    t.tick()
    assert t.rate() > 0  # shorter than the warm-up: the rate including it
    for _ in range(3):
        t.tick()
    assert t._steps == 4 and t._t0 is not None and t.rate() > 0


def test_evaluators_match_reference():
    rng = np.random.default_rng(1)
    gt = rng.normal(0, 40, (9, 21, 3))
    pred = gt + rng.normal(0, 15, gt.shape)
    vis = rng.uniform(size=(9, 21)) > 0.2
    ref_e, e = RefEvalUtil(), EvalUtil()
    ref_e.feed(gt[:5], pred[:5])
    e.feed(gt[:5], pred[:5])
    ref_e.feed(gt[5:], pred[5:], vis[5:])
    e.feed(gt[5:], pred[5:], vis[5:])
    for thresholds in ((0.0, 50.0, 20), (10.0, 30.0, 7)):
        got, want = e.get_measures(*thresholds), ref_e.get_measures(*thresholds)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=0)

    verts_gt = rng.normal(0, 50, (4, 30, 3))
    verts = verts_gt + rng.normal(0, 5, verts_gt.shape)
    mask = (rng.uniform(size=(4, 30)) > 0.3).astype(np.float32)
    for use_mask in (False, True):
        ref_v, v = RefVertexErrorMeter(), VertexErrorMeter()
        for a, b in ((0, 2), (2, 4)):
            ref_v.feed(verts_gt[a:b], verts[a:b], mask[a:b] if use_mask else None)
            v.feed(verts_gt[a:b], verts[a:b], mask[a:b] if use_mask else None)
        assert abs(v.mean - ref_v.mean) <= TOL * ref_v.mean


def test_codalab_dump_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    joints = rng.normal(0, 0.05, (3, 21, 3)) + [0, 0, 0.6]
    verts = rng.normal(0, 0.05, (3, 778, 3)) + [0, 0, 0.6]
    ref_zip = ref_dump(joints, verts, str(tmp_path / "ref"))
    zip_path = dump_ho3d_codalab(joints, verts, str(tmp_path / "port"))
    assert os.path.basename(zip_path) == os.path.basename(ref_zip) == "pred.zip"
    assert (tmp_path / "ref" / "pred.json").read_bytes() == \
        (tmp_path / "port" / "pred.json").read_bytes()


class _State:
    def __init__(self, step):
        self.step = step


class _Loader:
    """``BatchLoader``'s interface over fixed numpy batches."""

    train_only = False

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        return iter([dict(b) for b in self.batches])


def _eval_batches(rng, n_batches=3, b=4, pad=3):
    batches = []
    for i in range(n_batches):
        valid = np.ones(b, np.float32)
        if i == n_batches - 1:
            valid[b - pad:] = 0.0  # drop_last=False tail: wrap-around rows
        batches.append({
            "joints3d": rng.normal(0, 40, (b, 21, 3)).astype(np.float32),
            "objverts3d": rng.normal(0, 60, (b, 50, 3)).astype(np.float32),
            "obj_verts_mask": (rng.uniform(size=(b, 50)) > 0.2).astype(np.float32),
            "objcorners3d": rng.normal(0, 60, (b, 8, 3)).astype(np.float32),
            "image": rng.uniform(size=(b, 8, 8, 3)).astype(np.float32),
            "_valid": valid,
        })
    return batches


def _eval_preds(rng, batches):
    return [{
        "joints_c_mm": b["joints3d"] + rng.normal(0, 12, b["joints3d"].shape).astype(np.float32),
        "obj_verts_c_mm": b["objverts3d"] + rng.normal(0, 9, b["objverts3d"].shape)
        .astype(np.float32),
        "obj_corners_c_mm": b["objcorners3d"] + rng.normal(0, 9, b["objcorners3d"].shape)
        .astype(np.float32),
    } for b in batches]


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k != "steps_per_sec":
            assert abs(got[k] - want[k]) <= TOL * abs(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_epoch_pass_matches_reference(tmp_path, train):
    """45 train steps (three metric windows: 20, 20, 5) or 3 eval batches
    with a padded tail, with writers; ``max_steps`` cuts the eval pass."""
    rng = np.random.default_rng(3)
    batches = _eval_batches(rng, n_batches=45 if train else 3)
    terms = _terms(rng, len(batches))
    preds = _eval_preds(rng, batches)
    seen = {"ref": 0, "port": 0}

    def stub(who, as_tensor):
        def step(state, batch):
            i = seen[who]
            seen[who] += 1
            if as_tensor:
                assert isinstance(batch["joints3d"], torch.Tensor)
            wrap = torch.from_numpy if as_tensor else np.asarray
            if train:
                return _State(state.step + 1), {k: wrap(np.asarray(v)) for k, v in terms[i].items()}
            return {k: wrap(v) for k, v in preds[i].items()}
        return step

    ref_w, w = RefMetricWriter(str(tmp_path / "ref")), MetricWriter(str(tmp_path / "port"))
    shown = {"ref": [], "port": []}

    def vis(who):
        return lambda ep, i, batch, preds: shown[who].append(
            (ep, i, float(np.asarray(batch["joints3d"]).sum()), float(preds["joints_c_mm"].sum())))

    kw = dict(train=train, epoch=2, pck_thresholds=(20.0, 40.0), vis_freq=2)
    ref_state, want = ref_epoch_pass(_Loader(batches), _State(7), stub("ref", False),
                                     writer=ref_w, vis_fn=vis("ref"), **kw)
    state, got = loop.epoch_pass(_Loader(batches), _State(7), stub("port", True),
                                 device="cpu", writer=w, vis_fn=vis("port"), **kw)
    assert shown["port"] == shown["ref"] and len(shown["ref"]) == (0 if train else 2)
    ref_w.close()
    w.close()
    _assert_metrics_equal(got, want)
    assert state.step == ref_state.step == (7 + 45 if train else 7)
    def epochs(d):
        recs = json.loads((tmp_path / d / "epochs.json").read_text())
        for r in recs:
            r.pop("steps_per_sec")
        return recs

    assert epochs("ref") == epochs("port")
    steps = [json.loads(s)["step"] for s in (tmp_path / "port" / "metrics.jsonl").read_text()
             .splitlines()]
    assert steps == (list(range(8, 8 + 45)) if train else [])
    if not train:
        assert {"obj_verts_err_mm", "obj_corners_err_mm", "pck@20.0mm"} <= set(got)
        seen.update(ref=0, port=0)
        _, want2 = ref_epoch_pass(_Loader(batches), _State(7), stub("ref", False), train=False,
                                  max_steps=2)
        _, got2 = loop.epoch_pass(_Loader(batches), _State(7), stub("port", True), train=False,
                                  device="cpu", max_steps=2)
        _assert_metrics_equal(got2, want2)


def test_epoch_pass_fetches_train_terms_once_per_window(monkeypatch):
    fetched = []
    real = loop.fetch_terms
    monkeypatch.setattr(loop, "fetch_terms", lambda p: fetched.append(len(p)) or real(p))
    rng = np.random.default_rng(4)
    terms = _terms(rng, 45)
    it = iter(terms)

    def step(state, batch):
        return _State(state.step + 1), {k: torch.tensor(v) for k, v in next(it).items()}

    loop.epoch_pass(_Loader(_eval_batches(rng, 45)), _State(0), step, train=True, device="cpu")
    assert fetched == [20, 20, 5]


def test_epoch_pass_guards_and_device(monkeypatch):
    loader = _Loader([])
    loader.train_only = True
    with pytest.raises(ValueError, match="train-only"):
        loop.epoch_pass(loader, _State(0), None, train=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.epoch_pass(_Loader([]), _State(0), None, train=True)
