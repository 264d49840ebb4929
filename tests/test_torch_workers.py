"""DataLoader workers of the port (``WorkerEvalLoader``, ``WorkerEpochLoader``)
vs ``hocon``'s Grain loaders and the port's ``BatchLoader``.

Workers start from a forkserver, a fresh interpreter, so every dataset
here is the package's own (a worker imports its class). The eval loader with 2 workers gives
``BatchLoader``'s batches and ``_valid`` masks bit for bit, and so does
``hocon``'s ``GrainEvalLoader`` on the same dataset; the train loader gives
``BatchLoader(drop_last=True)``'s batches over two epochs and, per epoch,
the sample multiset of ``hocon``'s ``GrainEpochLoader`` (whose order comes
from Grain's sampler). A worker's exception reaches the parent, a worker
without CUDA for a JPEG dataset decoding on the card raises, datasets
pickle without their MANO tensors, and ``evaluate --workers 2`` gives
``--workers 0``'s metrics exactly.
"""

import io
import os
import pickle

import numpy as np
import pytest
import torch

from hocon_torch.cli import evaluate
from hocon_torch.data.factory import get_dataset
from hocon_torch.data.pipeline import (BatchLoader, WorkerEpochLoader, WorkerEvalLoader,
                                      stop_worker_server)
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.train.loop import epoch_pass
from test_torch_parsers import fphab_root, ho3d_root  # noqa: F401  (fixtures)

torch.set_num_threads(1)

RES = 32


@pytest.fixture(scope="module")
def synth():
    """8 synthetic frames (2 videos x 4) with an object, train-mode jitter:
    every sample carries ``sample_idx``."""
    return get_dataset("synthetic", "train", "", RES, use_objects=True, synth_videos=2,
                       synth_frames=4, device="cpu")


def _assert_batches_equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_eval_loader_matches_grain_and_batch_loader(synth):
    """Batch 3 over 8 samples: two full batches and a tail with one padding
    row, ``_valid`` included; worker_count 0 is BatchLoader itself."""
    from hocon.data.pipeline import GrainEvalLoader

    want = list(BatchLoader(synth, 3, shuffle=False, drop_last=False).epoch(0))
    assert [float(b["_valid"].sum()) for b in want] == [3.0, 3.0, 2.0]
    with WorkerEvalLoader(synth, 3, worker_count=2) as loader:
        assert loader.steps_per_epoch() == 3
        got = list(loader.epoch(0))
        again = list(loader.epoch(1))  # the same workers, a second pass
    _assert_batches_equal(got, want)
    _assert_batches_equal(again, want)
    _assert_batches_equal(list(WorkerEvalLoader(synth, 3).epoch(0)), want)
    grain = list(GrainEvalLoader(synth, 3, shuffle=False, drop_last=False,
                                 worker_count=2).epoch(0))
    _assert_batches_equal(grain, want)


def test_train_loader_matches_batch_loader_and_grain_multiset(synth):
    from hocon.data.pipeline import GrainEpochLoader

    ref = BatchLoader(synth, 4, shuffle=True, seed=3, drop_last=True)
    grain = GrainEpochLoader(synth, 4, shuffle=True, seed=3, worker_count=2)
    with WorkerEpochLoader(synth, 4, seed=3, worker_count=2) as loader:
        assert loader.train_only and loader.steps_per_epoch() == grain.steps_per_epoch() == 2
        for epoch in range(2):
            got = list(loader.epoch(epoch))
            _assert_batches_equal(got, list(ref.epoch(epoch)))
            ids = np.concatenate([b["sample_idx"] for b in got])
            grain_ids = np.concatenate([b["sample_idx"] for b in grain.epoch(epoch)])
            assert sorted(ids) == sorted(grain_ids) == list(range(len(synth)))
    assert [b["sample_idx"].tolist() for b in ref.epoch(0)] != [
        b["sample_idx"].tolist() for b in ref.epoch(1)]  # shuffled per epoch


def test_epoch_pass_refuses_the_train_loader_in_eval(synth):
    with pytest.raises(ValueError, match="train-only"):
        epoch_pass(WorkerEpochLoader(synth, 4, worker_count=2), state=None, step_fn=None,
                   train=False, device="cpu")


def test_worker_exception_reaches_the_parent(synth):
    """A sample that raises in a worker (an object mesh over the buffers)
    raises in the parent, with the worker's message."""
    loader = WorkerEvalLoader(synth, 4, worker_count=2)
    cap = synth.cfg.max_obj_faces
    synth.cfg.max_obj_faces = 4  # pickled into the workers when they start
    try:
        with loader, pytest.raises(ValueError, match="exceeds the configured buffers"):
            next(iter(loader.epoch(0)))
    finally:
        synth.cfg.max_obj_faces = cap


def _children(pid: int) -> list:
    """The pids whose parent is ``pid``, from ``/proc``."""
    found = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == pid:
            found.append(int(d))
    return found


def test_stop_worker_server_leaves_no_process(synth):
    """Closed loaders leave the forkserver no worker, and
    ``stop_worker_server`` ends the forkserver and the resource tracker;
    the next loader starts them again."""
    from multiprocessing import forkserver, resource_tracker

    want = list(BatchLoader(synth, 4, shuffle=False, drop_last=False).epoch(0))
    for _ in range(2):
        with WorkerEvalLoader(synth, 4, worker_count=2) as loader:
            _assert_batches_equal(list(loader.epoch(0)), want)
        server = forkserver._forkserver._forkserver_pid
        tracker = resource_tracker._resource_tracker._pid
        assert server is not None and tracker is not None
        assert _children(server) == []
        stop_worker_server()
        assert not os.path.exists(f"/proc/{server}") and not os.path.exists(f"/proc/{tracker}")
        assert forkserver._forkserver._forkserver_pid is None


def test_jpeg_worker_without_cuda_raises(fphab_root):
    """A dataset that decodes its JPEG frames on the card, in workers that
    cannot reach CUDA: the parent raises (no decode on the CPU instead)."""
    ds = get_dataset("fhbhands", "test", fphab_root, RES, mano=synthetic_mano_model(
        0, device="cpu"), device="cpu")
    ds.cfg.decode_device = torch.device("cuda")
    with WorkerEvalLoader(ds, 2, worker_count=2) as loader:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(iter(loader.epoch(0)))


def _pickled_tensors(obj) -> int:
    """How many torch tensors pickling ``obj`` writes."""
    found = []
    pickler = pickle.Pickler(io.BytesIO())
    pickler.persistent_id = lambda o: found.append(o) if isinstance(o, torch.Tensor) else None
    pickler.dump(obj)
    return len(found)


def test_datasets_pickle_without_mano_tensors(synth, fphab_root, ho3d_root, tmp_path,
                                              monkeypatch):
    """What a worker receives holds no torch tensor (so no CUDA tensor), and
    the unpickled copy serves the same samples, MANO fit vertices included."""
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path / "cache"))
    mano = synthetic_mano_model(0, device="cpu")
    datasets = [synth,
                get_dataset("fhbhands", "train", fphab_root, RES, mano=mano, device="cpu"),
                get_dataset("ho3dv2", "train", ho3d_root, RES, mano=mano, device="cpu")]
    for ds in datasets:
        assert _pickled_tensors(ds) == 0, type(ds.pose_dataset).__name__
        copy = pickle.loads(pickle.dumps(ds))
        assert copy.pose_dataset.mano is None
        fitted = [i for i in range(len(ds)) if ds.pose_dataset.get_sample(i).get(
            "verts3d_cam") is not None]
        assert fitted, type(ds.pose_dataset).__name__
        _assert_batches_equal([copy[fitted[0]]], [ds[fitted[0]]])


def test_evaluate_with_workers_gives_the_same_metrics(ho3d_root, tmp_path, monkeypatch):
    """``evaluate`` on the HO-3D tree (PNG frames read in the workers, the
    fit-vertex memmap reopened there): the metrics of --workers 2 are those
    of --workers 0, exactly (the rate of steps aside)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path / "cache"))
    argv = ["--dataset", "ho3dv2", "--data_root", ho3d_root, "--val_split", "train",
            "--image_size", str(RES), "--batch_size", "3", "--use_objects", "--no_bf16"]
    want = evaluate.main(argv, device="cpu")
    got = evaluate.main(argv + ["--workers", "2"], device="cpu")
    assert set(got) == set(want) and "obj_verts_err_mm" in got
    for k in set(want) - {"steps_per_sec"}:  # a host clock's reading
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert not os.path.exists(tmp_path / "checkpoints")
