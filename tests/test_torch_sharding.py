"""Data parallelism (``hocon_torch.train.sharding``) vs one process on the
global batch, and vs ``hocon``'s step.

Two ranks over gloo on the CPU (``torch.multiprocessing``, spawned, one
thread each) take each step on their shards of a global batch, a third
process takes it on the whole global batch with no mesh; all three start
from ``hocon``'s initial weights (``load_flax_variables``) and see batches
made by ``hocon``'s synthetic dataset at 64 px. Cases:

- ``warp``: 2 warp steps (hand + object), 2 ranks x 2 pairs against 1
  process x 4 pairs;
- ``sparse``: the same with every annotated frame on rank 0's shard (rank 1
  holds none), its first step's terms also held against ``hocon``'s warp
  step on the global batch, within ``tests/test_torch_train.py``'s bars;
- ``batchnorm``: ``freeze_batchnorm=False``, statistics over the global batch;
- ``supervised``: 2 supervised steps, the annotated frames on rank 0;
- the ``evaluate`` metrics and CodaLab dump, ``predict``'s file and a
  ``trainwarp`` run at 32 px, against the same calls in one process.

Each rank's forward is bit for bit that of its rows in one process's; what
differs is the order of the float32 sums: the ranks' shares of a sum over
the 16384 pixels of a warp batch are added after the fact. After step 1
the warp terms lie within 3.3e-5 relative of one process's and the summed
gradients within 2.2e-5 of the global norm (measured; bars 1e-4). Adam's
update is g / (|g| + eps) per entry, so entries whose gradient is near 0
and flips sign take a full step either way: after step 2 the parameters
differ by up to 11 % of their update over all tensors (bar 0.4), the
step-2 terms by up to 1.4 % (bar 5 %), gradients and moments by up to
5.0e-4 (bar 2e-3), running statistics by 3.4e-6 (bar 2e-5). The
supervised case sums over 4 rows and agrees within 9e-8 throughout (bars
1e-6); ``trainwarp``'s weights after 2 steps within 0.64 % of their update
(bar 3 %); ``evaluate`` and ``predict`` gave one process's bits (bar 5e-6).
The ranks agree bit for bit with each other.
"""

import datetime
import json
import math
import os
import pickle
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp

from hocon_torch.cli import evaluate as cli_evaluate
from hocon_torch.cli import predict as cli_predict
from hocon_torch.cli import trainwarp as cli_trainwarp
from hocon_torch.data.pipeline import tree_stack
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.hocnet import HOCNet
from hocon_torch.train import sharding
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.train.steps import make_train_step, make_warp_train_step, warp_loss

torch.set_num_threads(1)

RES = 64
CLI_RES = 32
WORLD = 2
LR = 1e-3
CASES = {
    # name: (step kind, frozen batch norm)
    "warp": ("warp", True),
    "sparse": ("warp", True),
    "batchnorm": ("warp", False),
    "supervised": ("supervised", True),
}
# Bars, relative (measured values in the module note).
BARS = {
    "warp": dict(terms1=1e-4, grads1=1e-4, terms2=5e-2, grads2=2e-3, exp_avg=2e-3,
                 exp_avg_sq=2e-3, params=0.4, buffers=2e-5),
    "supervised": dict(terms1=1e-6, grads1=1e-6, terms2=1e-6, grads2=1e-6, exp_avg=1e-6,
                       exp_avg_sq=1e-6, params=1e-6, buffers=1e-6),
}
EVAL_RTOL = 5e-6
CLI_PARAMS_RTOL = 0.03  # of the update
CLI_FLAGS = ["--dataset", "synthetic", "--image_size", str(CLI_RES), "--batch_size", "4",
             "--synth_videos", "2", "--synth_frames", "5", "--use_objects", "--no_bf16"]
TRAINWARP_FLAGS = CLI_FLAGS + ["--synth_frames", "4", "--epochs", "1", "--exp_id", "dp",
                               "--fraction", "0.5"]
TAGS = ("rank0", "rank1", "solo")


def _unsupervised(item):
    """A pair with neither frame annotated."""
    out = dict(item)
    for view in ("ref", "tgt"):
        out[view] = dict(item[view], sup_mask=np.zeros_like(item[view]["sup_mask"]))
    return out


def _make_data(mano):
    """Global batches of 4 from ``hocon``'s synthetic dataset, and the
    initial weights: ``hocon``'s ``create_train_state(PRNGKey(0))`` mapped
    onto the port's names."""
    import jax

    from hocon.data.factory import get_dataset
    from hocon.models.hocnet import HOCNet as RefHOCNet
    from hocon.train.state import create_train_state as ref_create
    from hocon.train.state import make_optimizer as ref_make_optimizer
    from hocon_torch.utils.flax_weights import load_flax_variables

    common = dict(image_size=RES, use_objects=True, train=True, mano=mano, fraction=0.5,
                  synth_videos=2, synth_frames=4, uint8_images=True)
    pairs = get_dataset("synthetic", "train", pair_mode=True, **common)
    frames = get_dataset("synthetic", "train", **common)
    p = [pairs[i] for i in range(8)]
    f = [frames[i] for i in range(8)]
    # Pairs 3 and 7 have both frames annotated; 0 and 1 lose their refs'
    # annotation, so rank 1's shard holds no annotated frame.
    sparse = tree_stack([p[3], p[7], _unsupervised(p[0]), _unsupervised(p[1])])
    batches = {
        "warp": [tree_stack(p[:4]), tree_stack(p[4:])],
        "sparse": [sparse, sparse],
        "batchnorm": [tree_stack(p[:4]), tree_stack(p[4:])],
        # sup_mask 1, 0, 1, 0, ...: the annotated frames first.
        "supervised": [tree_stack([f[0], f[2], f[1], f[3]]), tree_stack([f[4], f[6], f[5], f[7]])],
    }
    state = ref_create(RefHOCNet(with_object=True), mano, ref_make_optimizer("adam", LR),
                       batches["warp"][0]["ref"], jax.random.PRNGKey(0), with_object=True)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    port = HOCNet(with_object=True, device="cpu")
    load_flax_variables(port, variables)
    return batches, variables, {k: v.clone() for k, v in port.state_dict().items()}


def _shard(batch, rank, world):
    if isinstance(batch, dict):
        return {k: _shard(v, rank, world) for k, v in batch.items()}
    n = batch.shape[0] // world
    return batch[rank * n:(rank + 1) * n]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _steps(case, batches, init, mesh, rank, world):
    """Two steps of ``case`` from ``init``. Returns the terms of each step
    and flat vectors: the gradients of step 1, and after step 2 the
    gradients, Adam's moments, the parameters and the buffers."""
    kind, frozen = CASES[case]
    mano = synthetic_mano_model(0, device="cpu")
    model = HOCNet(with_object=True, freeze_batchnorm=frozen, device="cpu")
    model.load_state_dict(init)
    sharding.replicate(model, mesh)
    optimizer = make_optimizer("adam", LR)
    state = create_train_state(model, optimizer)
    if kind == "warp":
        step = make_warp_train_step(model, mano, optimizer, image_size=(RES, RES),
                                    device="cpu", mesh=mesh)
    else:
        step = make_train_step(model, mano, optimizer, device="cpu", mesh=mesh)
    params = list(model.parameters())
    out, vectors = {"terms": []}, {}
    for i, batch in enumerate(batches):
        local = _shard(batch, rank, world)
        if case == "sparse" and i == 0:
            # What per-rank normalisers (DDP's averaged per-rank means) give.
            with torch.no_grad():
                _, own = warp_loss(model, mano, local, (RES, RES), device="cpu", train=True)
            out["own_terms"] = {k: float(v) for k, v in own.items()}
        state, terms = step(state, local)
        out["terms"].append({k: float(v) for k, v in terms.items()})
        vectors[f"grads{i + 1}"] = _flat(p.grad for p in params)
    out["running_moved"] = [k for k, b in model.named_buffers() if not torch.equal(b, init[k])]
    adam = [state.optimizer.state[p] for p in params]
    vectors.update(exp_avg=_flat(s["exp_avg"] for s in adam),
                   exp_avg_sq=_flat(s["exp_avg_sq"] for s in adam),
                   params=_flat(params), buffers=_flat(model.buffers()))
    return out, vectors


def _clis(tmp, mesh, tag):
    """``evaluate`` (metrics, then the CodaLab dump), ``predict`` and a
    ``trainwarp`` run, in a run directory of their own; returns the
    results and trainwarp's final parameters, flat."""
    run_dir = os.path.join(tmp, f"cli_{tag}")
    os.makedirs(run_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        out = {"metrics": cli_evaluate.main(CLI_FLAGS, device="cpu", mesh=mesh)}
        out["codalab"] = cli_evaluate.main(CLI_FLAGS + ["--dump_codalab", "dump"],
                                           device="cpu", mesh=mesh)
        out["predict"] = cli_predict.main(CLI_FLAGS + ["--out", "preds"], device="cpu",
                                          mesh=mesh)
        state = cli_trainwarp.main(TRAINWARP_FLAGS, device="cpu", mesh=mesh)
        out["trainwarp_step"] = state.step
        out["run_files"] = sorted(os.listdir(os.path.join("checkpoints", "dp")))
    finally:
        os.chdir(cwd)
    return out, _flat(state.model.parameters())


def _trainwarp_init() -> torch.Tensor:
    """The parameters ``trainwarp`` starts from (``build_model``, seed 0)."""
    from hocon_torch.cli.train import build_model

    args = cli_trainwarp.build_parser().parse_args(TRAINWARP_FLAGS)
    return _flat(build_model(args, synthetic_mano_model(0, device="cpu"), torch.device("cpu"),
                             seed=args.seed).parameters())


def _errors(got, want, slices, scale=None, whole=False) -> tuple:
    """(the largest per-tensor error, the error over all tensors) of ``got``
    against ``want``: each tensor's error norm relative to ``scale``'s norm
    (``want``'s when None) over the same tensor, or over all with
    ``whole``."""
    scale = want if scale is None else scale
    d, s = (got - want).double(), scale.double()
    total, per = float(s.norm()), []
    for a, b in slices:
        num, den = float(d[a:b].norm()), total if whole else float(s[a:b].norm())
        if num:
            per.append(num / den if den else math.inf)
    return max(per, default=0.0), float(d.norm()) / total


def _compare(vectors, others, slices, p0) -> dict:
    """Rank 0's comparison of its vectors with rank 1's (bit for bit) and
    with one process's (``_errors``): the gradients relative to the global
    norm, Adam's moments and the buffers to their own norm, the parameters
    to their update from ``p0``."""
    want = others["solo"]
    return {
        "bitwise": {k: torch.equal(v, others["rank1"][k]) for k, v in vectors.items()},
        "grads1": _errors(vectors["grads1"], want["grads1"], slices, whole=True),
        "grads2": _errors(vectors["grads2"], want["grads2"], slices, whole=True)[1],
        "exp_avg": _errors(vectors["exp_avg"], want["exp_avg"], slices)[1],
        "exp_avg_sq": _errors(vectors["exp_avg_sq"], want["exp_avg_sq"], slices)[1],
        "params": _errors(vectors["params"], want["params"], slices, want["params"] - p0)[1],
        "buffers": _errors(vectors["buffers"], want["buffers"], [])[1],
    }


def _process(index, tmp):
    """Three processes in one gloo group: 0 and 1 are the ranks of a 2-rank
    mesh (a subgroup), 2 takes each step on the global batch with no mesh.
    1 and 2 send their flat vectors to 0, which compares them."""
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "data.pkl"), "rb") as fh:
        batches, init = pickle.load(fh)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=index,
                            world_size=len(TAGS), timeout=datetime.timedelta(seconds=300))
    try:
        dp_group = dist.new_group([0, 1])
        tag = TAGS[index]
        if index < WORLD:
            mesh, rank, world = sharding.Mesh(index, WORLD, torch.device("cpu"), dp_group), index, WORLD
        else:
            mesh, rank, world = None, 0, 1
        slices, offset = [], 0
        for t in HOCNet(with_object=True, device="cpu").parameters():
            slices.append((offset, offset + t.numel()))
            offset += t.numel()
        summary = {}
        p0 = _flat(init[k] for k, _ in HOCNet(with_object=True, device="cpu").named_parameters())
        for case in CASES:
            summary[case], vectors = _steps(case, batches[case], init, mesh, rank, world)
            summary[case]["compared"] = _exchange(index, vectors, slices, p0)
        summary["cli"], tw = _clis(tmp, mesh, tag)
        summary["cli"]["compared"] = _exchange(index, {"params": tw}, slices, _trainwarp_init())
    finally:
        dist.destroy_process_group()
    torch.save(summary, os.path.join(tmp, f"{tag}.pt"))


def _exchange(index, vectors, slices, p0):
    """Processes 1.. send ``vectors`` to process 0, which returns its
    comparison (None elsewhere)."""
    if index > 0:
        for k in sorted(vectors):
            dist.send(vectors[k], dst=0)
        return None
    others = {}
    for src, tag in enumerate(TAGS[1:], start=1):
        others[tag] = {}
        for k in sorted(vectors):
            buf = torch.empty_like(vectors[k])
            dist.recv(buf, src=src)
            others[tag][k] = buf
    if "grads1" not in vectors:  # trainwarp's parameters: rank 1 and one process
        return {"bitwise": torch.equal(vectors["params"], others["rank1"]["params"]),
                "params": _errors(vectors["params"], others["solo"]["params"], slices,
                                  others["solo"]["params"] - p0)[1]}
    return _compare(vectors, others, slices, p0)


def _ref_terms(mano, batch, variables):
    """``hocon``'s warp step on the global batch (Pallas raster in interpret
    mode): its terms."""
    import dataclasses

    import jax
    import optax

    from hocon.models.hocnet import HOCNet as RefHOCNet
    from hocon.train.state import create_train_state as ref_create
    from hocon.train.steps import make_warp_train_step as ref_make_warp_train_step

    net = RefHOCNet(with_object=True)
    tx = optax.adam(LR)
    state = ref_create(net, mano, tx, batch["ref"], jax.random.PRNGKey(0), with_object=True)
    state = dataclasses.replace(state, params=variables["params"],
                                batch_stats=variables["batch_stats"])
    step = ref_make_warp_train_step(net, mano, tx, image_size=(RES, RES), backend="pallas")
    _, terms = step(state, batch)
    return {k: float(v) for k, v in jax.device_get(terms).items()}


@pytest.fixture(scope="module")
def data(mano_model):
    return _make_data(mano_model)


@pytest.fixture(scope="module")
def runs(mano_model, data, tmp_path_factory):
    """The four processes' summaries by tag, ``hocon``'s terms of the
    sparse case's first step, and the tmp dir."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    batches, variables, init = data
    with open(os.path.join(tmp, "data.pkl"), "wb") as fh:
        pickle.dump((batches, init), fh)
    ctx = tmp_mp.start_processes(_process, args=(tmp,), nprocs=len(TAGS), join=False,
                                 start_method="spawn")
    try:
        ref = _ref_terms(mano_model, batches["sparse"][0], variables)
        while not ctx.join(timeout=300):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = {tag: torch.load(os.path.join(tmp, f"{tag}.pt"), weights_only=False) for tag in TAGS}
    return out, ref, tmp


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_agree_bit_for_bit(runs, case):
    """Every rank applies the same update from summed gradients: terms,
    gradients, Adam's moments, parameters and buffers equal bit for bit."""
    out, _, _ = runs
    assert out["rank0"][case]["terms"] == out["rank1"][case]["terms"]
    bits = out["rank0"][case]["compared"]["bitwise"]
    assert bits and all(bits.values()), bits


def _assert_terms(got, want, rtol, what):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-9, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_take_one_process_first_step(runs, case):
    """Step 1 from the same weights: the 2-rank terms and summed gradients
    (each tensor's error relative to the global norm) against one
    process's on the global batch."""
    out, _, _ = runs
    bars = BARS[CASES[case][0]]
    _assert_terms(out["rank0"][case]["terms"][0], out["solo"][case]["terms"][0],
                  bars["terms1"], "step 1")
    per_tensor, whole = out["rank0"][case]["compared"]["grads1"]
    assert per_tensor <= bars["grads1"] and whole <= bars["grads1"], (per_tensor, whole)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_follow_one_process(runs, case):
    """After step 2: its terms, its gradients, Adam's moments, the
    parameters (relative to their update) and the buffers against one
    process's, over all tensors."""
    out, _, _ = runs
    bars = BARS[CASES[case][0]]
    _assert_terms(out["rank0"][case]["terms"][1], out["solo"][case]["terms"][1],
                  bars["terms2"], "step 2")
    compared = out["rank0"][case]["compared"]
    for k in ("grads2", "exp_avg", "exp_avg_sq", "params", "buffers"):
        assert compared[k] <= bars[k], (k, compared[k])


def test_batchnorm_statistics_are_the_global_batch(runs):
    """Trainable batch norm: its running statistics moved and are one
    process's (``test_two_ranks_follow_one_process[batchnorm]`` holds the
    buffers), and they are the same on both ranks."""
    out, _, _ = runs
    assert out["rank0"]["batchnorm"]["compared"]["bitwise"]["buffers"]
    assert len(out["rank0"]["batchnorm"]["running_moved"]) == 40
    assert out["rank0"]["warp"]["running_moved"] == []  # frozen
    assert 0 < out["rank0"]["batchnorm"]["compared"]["buffers"] <= BARS["warp"]["buffers"]


_TRAIN_BAR = {"photo": 5e-4, "mask_area": 5e-4, "grad_norm": 1e-4}  # test_torch_train's


def _bar(term):
    return next((v for k, v in _TRAIN_BAR.items() if term.startswith(k)), 1e-5)


def test_sparse_shards_match_hocon_global_step(runs):
    """Every annotated frame on rank 0's shard: the 2-rank terms of the first
    step against ``hocon``'s warp step on the global batch, within
    ``tests/test_torch_train.py``'s bars."""
    out, ref, _ = runs
    terms = out["rank0"]["sparse"]["terms"][0]
    assert terms.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(terms[k], v, rtol=_bar(k), err_msg=k)


def test_per_rank_normalisers_miss_the_bar(runs):
    """The teeth of the test above: the mean of the ranks' own masked means
    (what DDP's gradient averaging computes) misses the bar on every
    supervised term by far, since rank 1 holds no annotated frame."""
    out, ref, _ = runs
    own0, own1 = out["rank0"]["sparse"]["own_terms"], out["rank1"]["sparse"]["own_terms"]
    own = {k: (own0[k] + own1[k]) / 2 for k in own0}
    assert own1["ref_loss_hand_joints3d"] == 0.0
    supervised = [k for k in ref if k.startswith("ref_loss_") and abs(ref[k]) > 0]
    assert len(supervised) >= 4
    for k in supervised:
        assert abs(own[k] - ref[k]) > 100 * _bar(k) * abs(ref[k]), k


def test_evaluate_gathers_the_global_batches(runs):
    """``evaluate`` on 2 ranks: the metrics are one process's on every rank;
    rank 0 alone writes the CodaLab dump, in the split's order."""
    out, _, tmp = runs
    want = out["solo"]["cli"]["metrics"]
    for tag in ("rank0", "rank1"):
        got = out[tag]["cli"]["metrics"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k != "steps_per_sec":
                np.testing.assert_allclose(got[k], v, rtol=EVAL_RTOL, err_msg=k)
    assert out["rank1"]["cli"]["codalab"] is None
    assert not os.path.exists(os.path.join(tmp, "cli_rank1", "dump"))

    def dump(tag):
        with zipfile.ZipFile(os.path.join(tmp, f"cli_{tag}", "dump", "pred.zip")) as z:
            return json.loads(z.read("pred.json"))

    got, want = dump("rank0"), dump("solo")
    assert len(got[0]) == len(want[0]) == 10  # every frame of the split once
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=EVAL_RTOL, atol=1e-7)


def test_predict_writes_the_global_order_once(runs):
    out, _, tmp = runs
    assert out["rank1"]["cli"]["predict"] is None
    assert not os.path.exists(os.path.join(tmp, "cli_rank1", "preds"))
    got = np.load(os.path.join(tmp, "cli_rank0", "preds", "predictions.npz"))
    want = np.load(os.path.join(tmp, "cli_solo", "preds", "predictions.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].shape[0] == 10, k
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, atol=1e-5, err_msg=k)


def test_trainwarp_ranks_train_as_one_process(runs):
    """``trainwarp`` on 2 ranks (2 steps of 4 pairs at 32 px): one
    process's weights within ``CLI_PARAMS_RTOL`` of their update, the same
    on both ranks; rank 0 alone wrote the run's checkpoints and metrics."""
    out, _, tmp = runs
    r0, r1, solo = (out[t]["cli"] for t in ("rank0", "rank1", "solo"))
    assert r0["trainwarp_step"] == solo["trainwarp_step"] == 2
    assert r0["compared"]["bitwise"]
    assert r0["compared"]["params"] <= CLI_PARAMS_RTOL, r0["compared"]["params"]
    assert r0["run_files"] == solo["run_files"]
    assert {"ckpt", "metrics.jsonl", "opt.txt"} <= set(r0["run_files"])
    assert r1["run_files"] == ["ckpt"]  # restore looked for snapshots; nothing written
    assert not os.listdir(os.path.join(tmp, "cli_rank1", "checkpoints", "dp", "ckpt"))


def test_one_rank_group_gives_single_process_bits(data, tmp_path):
    """Under ``torchrun`` with one process the collectives run over a single
    rank: a warp step gives the bits of the step with no mesh."""
    batches, _, init = data
    mesh = sharding.make_mesh("cpu", rank=0, world_size=1,
                              init_method=f"file://{tmp_path}/init")
    try:
        assert mesh.group is not None and mesh.world == 1
        # One step on rank 0's shard (2 pairs) of the sparse batch.
        with_group, got = _steps("sparse", batches["sparse"][:1], init, mesh, 0, WORLD)
    finally:
        sharding.teardown(mesh)
    alone, want = _steps("sparse", batches["sparse"][:1], init, None, 0, WORLD)
    assert with_group["terms"] == alone["terms"]
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_make_mesh_defaults(monkeypatch):
    """No ``RANK`` / ``WORLD_SIZE``: one process, no group, the device as
    given; CUDA by default, which raises without a card."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = sharding.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.is_main) == (0, 1, None, True)
    assert mesh.device == torch.device("cpu")
    x = torch.arange(4.0)
    assert sharding.global_sum(x, mesh) is x
    terms = {"a": x[0]}
    assert sharding.reduce_terms(terms, mesh) is terms
    assert sharding.gather_rows({"a": np.ones(2)}, mesh)["a"].shape == (2,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.make_mesh()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.make_mesh()
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="rank 2 of world size 2"):
        sharding.make_mesh("cpu")


def test_sharding_imports_no_jax_and_no_reference():
    """``hocon_torch.train.sharding`` and the CLIs that use it import the
    port only."""
    script = r"""
import sys
import hocon_torch.train.sharding, hocon_torch.cli.trainwarp, hocon_torch.cli.evaluate
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hocon"))
assert not bad, bad
print("OK")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", script], cwd=repo, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr[-3000:]
