"""Port CLIs (``hocon_torch.cli``) vs ``hocon.cli``.

The parsers take the reference's flags with its defaults, plus the port's
own ``--model`` (``PORT_ONLY``), whose default is the reference's one
model. The entry points
run end to end on the CPU at 32 px: ``trainwarp`` trains 2 steps with
eval and a snapshot, a second call auto-restores it and trains 2 more,
``evaluate --resume`` reproduces the trainer's last val MPJPE, ``predict``
covers its split exactly once through a padded tail batch, and ``train``
runs. On FPHAB and HO-3D trees (``test_torch_parsers``' fixtures):
``trainwarp`` and ``evaluate`` run, and ``--check_data`` exits 0 on a clean
tree and 1 on one with an anomaly. ``--workers 2``, a MANO pickle and
``--mano_side left`` run through ``trainwarp`` and ``evaluate``, and
``main`` without ``device`` needs CUDA. The weight-import and
visualisation flags are tested in ``test_torch_weight_import`` and
``test_torch_visualize``.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import hocon.cli.opts as ref_opts
from hocon_torch.cli import evaluate, opts, predict, train, trainwarp
from hocon_torch.geometry.mano import synthetic_mano_arrays
from test_torch_parsers import fphab_root, ho3d_root  # noqa: F401  (fixtures)
from tools.fixture_trees import write_mano_pkl

torch.set_num_threads(1)

CLIS = {"train": train, "trainwarp": trainwarp, "evaluate": evaluate, "predict": predict}
SMALL = ["--dataset", "synthetic", "--image_size", "32", "--synth_videos", "2",
         "--synth_frames", "4", "--no_bf16"]


# Flags of the port alone, with the defaults that mean what the reference
# does: HOCNet, its one model.
PORT_ONLY = {"model": "hocnet"}


def _shared(ns) -> dict:
    """The parsed flags that the reference has too; the port's own flags
    must hold their defaults."""
    got = vars(ns)
    assert {k: got.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return got


def _ref_parser(name):
    """The parser ``hocon.cli.<name>.main`` builds."""
    p = argparse.ArgumentParser(name)
    ref_opts.add_exp_opts(p)
    ref_opts.add_net_opts(p)
    ref_opts.add_data_opts(p)
    if name == "trainwarp":
        ref_opts.add_warp_opts(p)
    elif name == "evaluate":
        p.add_argument("--dump_codalab", default="")
    elif name == "predict":
        p.add_argument("--out", default="preds")
    return p


@pytest.mark.parametrize("name", list(CLIS))
def test_parsers_match_reference(name):
    port = CLIS[name].build_parser()
    assert _shared(port.parse_args([])) == vars(_ref_parser(name).parse_args([]))
    argv = ["--no_freeze_batchnorm", "--lr", "1e-3", "--use_objects", "--no_bf16"]
    assert _shared(port.parse_args(argv)) == vars(_ref_parser(name).parse_args(argv))


@pytest.fixture(scope="module")
def warp_run(tmp_path_factory):
    """Two ``trainwarp`` calls in one run directory (hand + object, batch 4,
    2 steps each with eval; the second with ``--profile``), then
    ``evaluate`` and ``predict`` on its snapshot."""
    cwd = os.getcwd()
    root = tmp_path_factory.mktemp("cli")
    os.chdir(root)
    try:
        argv = SMALL + ["--batch_size", "4", "--use_objects", "--fraction", "0.5",
                        "--epochs", "1", "--exp_id", "w"]
        first = trainwarp.main(argv, device="cpu")
        files = sorted(os.listdir("checkpoints/w"))
        first_steps = [json.loads(s)["step"] for s in open("checkpoints/w/metrics.jsonl")]
        second = trainwarp.main(argv + ["--profile"], device="cpu")
        ckpt = os.path.join(root, "checkpoints", "w", "ckpt")
        metrics = evaluate.main(SMALL + ["--batch_size", "4", "--use_objects", "--resume", ckpt],
                                device="cpu")
        out = predict.main(SMALL + ["--batch_size", "5", "--use_objects", "--resume", ckpt,
                                    "--out", "p"], device="cpu")
        return dict(root=root, first=first, second=second, files=files,
                    first_steps=first_steps, eval=metrics, preds=dict(np.load(out)))
    finally:
        os.chdir(cwd)


def test_trainwarp_trains_snapshots_and_auto_restores(warp_run):
    assert warp_run["first"].step == 2 and warp_run["second"].step == 4
    assert {"opt.txt", "opt.json", "metrics.jsonl", "epochs.json", "ckpt"} <= set(
        warp_run["files"])
    run = warp_run["root"] / "checkpoints" / "w"
    assert sorted(os.listdir(run / "ckpt")) == ["2", "4"]
    assert warp_run["first_steps"] == [1, 2]
    records = [json.loads(s) for s in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    for r in records:
        assert all(np.isfinite(v) for v in r.values()), r
        assert r["mask_area"] > 0 and "photo_total" in r
    epochs = json.loads((run / "epochs.json").read_text())
    assert [(e["epoch"], e["split"]) for e in epochs] == [(0, "train"), (0, "val")] * 2
    assert json.loads((run / "opt.json").read_text())["pair_mode"] is True
    assert os.path.exists(run / "trace" / "epoch0.json")


def test_evaluate_reproduces_the_trainers_last_val_mpjpe(warp_run):
    epochs = json.loads((warp_run["root"] / "checkpoints" / "w" / "epochs.json").read_text())
    last_val = [e for e in epochs if e["split"] == "val"][-1]
    got = warp_run["eval"]
    for k in ("mpjpe_mm", "auc", "obj_verts_err_mm"):
        np.testing.assert_allclose(got[k], last_val[k], rtol=1e-6, err_msg=k)


def test_predict_covers_the_split_exactly_once(warp_run):
    """8 frames at batch 5: a full batch, then 3 frames and 2 padding rows."""
    preds = warp_run["preds"]
    assert preds["joints_cam"].shape == (8, 21, 3)
    assert preds["joints2d"].shape == (8, 21, 2)
    assert {"verts_cam", "joints_c_mm", "obj_verts_c_mm"} <= set(preds)
    assert len({preds["joints_cam"][i].tobytes() for i in range(8)}) == 8


def test_train_cli_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    state = train.main(SMALL + ["--batch_size", "4", "--epochs", "1", "--exp_id", "s",
                                "--max_steps_per_epoch", "2", "--eval_freq", "2"], device="cpu")
    assert state.step == 2
    run = tmp_path / "checkpoints" / "s"
    assert os.path.exists(run / "opt.txt") and os.path.exists(run / "ckpt" / "2" / "state.pt")
    assert [json.loads(s)["step"] for s in (run / "metrics.jsonl").read_text().splitlines()] == [
        1, 2]


FPHAB = ["--dataset", "fhbhands", "--image_size", "32", "--use_objects", "--no_bf16"]


@pytest.fixture(scope="module")
def fphab_run(fphab_root, tmp_path_factory):
    """``trainwarp`` on the FPHAB tree (hand + decimated PLY object, 2 steps
    with eval), then ``evaluate`` of its snapshot."""
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("fphab_cli"))
    try:
        flags = FPHAB + ["--data_root", fphab_root, "--batch_size", "4"]
        state = trainwarp.main(flags + ["--fraction", "0.25", "--epochs", "1",
                                        "--max_steps_per_epoch", "2", "--exp_id", "f"],
                               device="cpu")
        ckpt = os.path.abspath("checkpoints/f/ckpt")
        metrics = evaluate.main(flags + ["--resume", ckpt], device="cpu")
        records = [json.loads(s) for s in open("checkpoints/f/metrics.jsonl")]
        return dict(state=state, metrics=metrics, records=records,
                    ckpt=sorted(os.listdir(ckpt)))
    finally:
        os.chdir(cwd)


def test_trainwarp_and_evaluate_run_on_fphab(fphab_run, fphab_root):
    assert fphab_run["state"].step == 2 and fphab_run["ckpt"] == ["2"]
    assert [r["step"] for r in fphab_run["records"]] == [1, 2]
    for r in fphab_run["records"]:
        assert all(np.isfinite(v) for v in r.values()), r
        assert r["mask_area"] > 0
    m = fphab_run["metrics"]
    assert np.isfinite(m["mpjpe_mm"]) and np.isfinite(m["obj_verts_err_mm"])


_CHECK_DATA = {
    # name: (cli, dataset flags, the splits checked)
    "trainwarp_fphab": ("trainwarp", ["--dataset", "fhbhands", "--use_objects"],
                        ["train", "test"]),
    "train_fphab_hand": ("train", ["--dataset", "fhbhands"], ["train", "test"]),
    "evaluate_fphab": ("evaluate", ["--dataset", "fhbhands", "--use_objects"], ["test"]),
    "evaluate_ho3d": ("evaluate", ["--dataset", "ho3dv2", "--val_split", "train",
                                   "--use_objects"], ["train"]),
}


@pytest.mark.parametrize("case", list(_CHECK_DATA))
def test_check_data_exits_zero_on_a_clean_tree(case, fphab_root, ho3d_root, tmp_path,
                                               monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOCON_CACHE_DIR", str(tmp_path / "cache"))
    name, flags, splits = _CHECK_DATA[case]
    root = ho3d_root if "ho3dv2" in flags else fphab_root
    with pytest.raises(SystemExit) as exit_info:
        CLIS[name].main(flags + ["--data_root", root, "--image_size", "32", "--check_data"],
                        device="cpu")
    assert exit_info.value.code == 0
    verdicts = [ln for ln in capsys.readouterr().out.splitlines() if ln.endswith(" OK")]
    assert verdicts == [f"[check_data:{s}] OK" for s in splits]


def test_check_data_exits_one_on_an_anomaly(fphab_root, tmp_path, monkeypatch, capsys):
    """A missing frame is reported, and the exit code says so."""
    import shutil

    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "tree")
    shutil.copytree(fphab_root, root)
    os.remove(os.path.join(root, "Video_files", "Subject_2", "open_milk", "1", "color",
                           "color_0000.jpeg"))
    with pytest.raises(SystemExit) as exit_info:
        evaluate.main(FPHAB + ["--data_root", root, "--check_data"], device="cpu")
    assert exit_info.value.code == 1
    out = capsys.readouterr().out
    assert "image missing" in out and "ANOMALIES" in out


# case: flags; the MANO model the CLI must load (None: the synthetic one)
_WORKERS_AND_MANO = {
    "workers": (["--workers", "2"], None),
    "mano_left": (["--mano_assets", "mano", "--mano_side", "left"], "left"),
    "mano_pkl": (["--mano_assets", "mano"], "right"),
}


@pytest.mark.parametrize("cli", ["trainwarp", "evaluate"])
@pytest.mark.parametrize("case", list(_WORKERS_AND_MANO))
def test_workers_and_mano_assets_run(case, cli, tmp_path, monkeypatch, capsys):
    """One train step (trainwarp, no eval) or one eval pass at 32 px with
    ``--workers 2`` (trainwarp's step then equals that of ``--workers 0``), or with
    the chumpy-style ``mano/MANO_RIGHT.pkl`` of seed-1 arrays, loaded for
    the right hand or mirrored for the left."""
    monkeypatch.chdir(tmp_path)
    arrays = synthetic_mano_arrays(1)
    write_mano_pkl(os.path.join("mano", "MANO_RIGHT.pkl"), arrays)
    loaded = []
    load = opts.load_mano_or_synthetic
    monkeypatch.setattr(opts, "load_mano_or_synthetic",
                        lambda *a, **k: loaded.append(load(*a, **k)) or loaded[-1])
    flags, side = _WORKERS_AND_MANO[case]
    argv = SMALL + ["--batch_size", "2", "--max_steps_per_epoch", "1", "--use_objects"]
    if cli == "trainwarp":
        argv += ["--epochs", "1", "--eval_freq", "2", "--fraction", "0.5", "--exp_id", "run"]
    result = CLIS[cli].main(argv + flags, device="cpu")
    assert ("MANO assets not found" in capsys.readouterr().out) == (side is None)
    if side is not None:
        mirror = np.array([-1.0 if side == "left" else 1.0, 1.0, 1.0], np.float32)
        assert loaded[0].side == side
        np.testing.assert_array_equal(loaded[0].v_template.numpy(),
                                      arrays["v_template"] * mirror)
    if cli == "evaluate":
        assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["obj_verts_err_mm"])
        return
    assert result.step == 1
    records = [json.loads(s) for s in open("checkpoints/run/metrics.jsonl")]
    assert len(records) == 1 and all(np.isfinite(v) for v in records[0].values())
    if case == "workers":
        trainwarp.main(argv + ["--exp_id", "in_process"], device="cpu")
        in_process = json.loads(open("checkpoints/in_process/metrics.jsonl").readline())
        assert {k: v for k, v in in_process.items() if k != "time"} == {
            k: v for k, v in records[0].items() if k != "time"}


@pytest.mark.parametrize("name", list(CLIS))
def test_main_without_device_needs_cuda(name, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIS[name].main(SMALL)
    assert not os.path.exists(tmp_path / "checkpoints")
