"""The seam of model families (``reference/families/``, ``harness/families/``):
a configuration that names ``hocnet`` reads as one that names no family; a
family that the test alone supplies runs through ``run.run``, is judged
correct, and fails the comparison with half of each batch; a family
without its two files fails before any device work."""

import math
import os
import sys
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import run
from conftest import shrink
from harness import cost
from reference.model import mano_forward, persp_project, rot6d_to_matrix, transform_points

LOAD = run.load_cell
SEED = 2**31 + 4242
TOY = {"family": "toy", "mano_ncomps": 15, "center_idx": 9, "z_init": 0.6,
       "with_object": True, "pool": 4, "hidden": 32}
HOCNET_FLOPS = {"hocnet_r18_256_obj1280.warp": 445288022016.0,
                "hocnet_r18_256_obj1280.sup": 222644011008.0,
                "hocnet_r18_128_box.warp": 111487647744.0}


class ToyModel(nn.Module):
    """Pooled pixels -> one hidden layer -> MANO's pose and shape, the
    translation and the object's 6D pose."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        self.ncomps, self.center_idx, self.z_init = m["mano_ncomps"], m["center_idx"], m["z_init"]
        self.pool = m["pool"]
        self.hidden = nn.Linear(3 * self.pool ** 2, m["hidden"])
        self.out = nn.Linear(m["hidden"], self.ncomps + 16 + (9 if m["with_object"] else 0))

    def forward(self, images, camintr, mano, obj_verts_can=None):
        mano = mano if isinstance(mano, dict) else vars(mano)  # the port's ManoModel
        x = F.adaptive_avg_pool2d(images.permute(0, 3, 1, 2), self.pool).flatten(1)
        y = self.out(F.relu(self.hidden(x)))
        n = self.ncomps
        pose_pca, root, betas = y[:, :n], y[:, n:n + 3], y[:, n + 3:n + 13]
        trans = y[:, n + 13:n + 16] + y.new_tensor([0.0, 0.0, self.z_init])
        verts, joints = mano_forward(mano, pose_pca, betas, root)
        verts_cam, joints_cam = verts + trans[:, None], joints + trans[:, None]
        center = joints_cam[:, self.center_idx:self.center_idx + 1]
        out = {"pose_pca": pose_pca, "betas": betas, "verts_cam": verts_cam,
               "verts_c_mm": (verts_cam - center) * 1000.0,
               "joints_c_mm": (joints_cam - center) * 1000.0,
               "joints2d": persp_project(joints_cam, camintr)}
        if obj_verts_can is not None and y.shape[1] > n + 16:
            rot = rot6d_to_matrix(y[:, n + 16:n + 22] + y.new_tensor([1.0, 0, 0, 0, 1.0, 0]))
            otrans = y[:, n + 22:n + 25] + y.new_tensor([0.0, 0.0, self.z_init])
            obj = transform_points(obj_verts_can, rot, otrans)
            out.update(obj_verts_cam=obj, obj_verts_c_mm=(obj - center) * 1000.0)
        return out


@torch.no_grad()
def toy_weights(cfg: dict, generator: torch.Generator, device) -> dict:
    """Kernels normal at 1 / sqrt(fan-in), the output layer's at 1e-3; zero
    biases; one draw."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in ToyModel(cfg).state_dict().items()}
    draws = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=generator,
                        device=device)
    sd, i = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        scale = 0.0 if k.endswith("bias") else 1e-3 if k.startswith("out.") else s[1] ** -0.5
        sd[k] = draws[i:i + n].reshape(s) * scale
        i += n
    return sd


def toy_flops(cfg: dict, images: int) -> float:
    m = cfg["model"]
    ins, hid = 3 * m["pool"] ** 2, m["hidden"]
    return images * 3 * 2.0 * (ins * hid + hid * (m["mano_ncomps"] + 25))


def _toy_modules(port: bool = True) -> dict:
    ref = types.ModuleType("reference.families.toy")
    ref.Model, ref.weights, ref.flops = ToyModel, toy_weights, toy_flops
    mods = {"reference.families.toy": ref}
    if port:
        prog = types.ModuleType("harness.families.toy")
        prog.port_model = lambda cfg, device: ToyModel(cfg).to(device)
        mods["harness.families.toy"] = prog
    return mods


def _run(monkeypatch, cell: str, model, trace=False, fault=None):
    """``run.run`` on the CPU at ``shrink``'s size, the configuration's
    ``model`` replaced by ``model(cfg["model"])``."""
    def load(name):
        cfg, per_layer = LOAD(name)
        cfg = shrink(cfg)
        cfg["model"] = model(cfg["model"])
        return cfg, per_layer

    monkeypatch.setattr(run, "load_cell", load)
    torch.set_num_threads(1)
    return run.run(cell, SEED, 0.5, trace, "cpu", fault=fault)


def _files() -> dict:
    out = {}
    for folder, dirs, names in os.walk(run.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in names:
            path = os.path.join(folder, name)
            out[path] = os.stat(path).st_mtime_ns
    return out


def test_hocnet_named_reads_as_unnamed(monkeypatch):
    cell = "hocnet_r18_128_box.warp"
    plain = _run(monkeypatch, cell, lambda m: m)
    named = _run(monkeypatch, cell, lambda m: {**m, "family": "hocnet"})
    assert plain["correct"] is True, plain["checks"]
    assert named["checks"] == plain["checks"]


@pytest.mark.parametrize("cell", sorted(HOCNET_FLOPS))
def test_hocnet_flops(cell):
    """The count behind ``step.mfu``, as the benchmark has always made it."""
    cfg = LOAD(cell)[0]
    assert cost.step_flops(cfg, cfg["traffic"]["step"]) == HOCNET_FLOPS[cell]


def test_a_family_of_new_files_runs(monkeypatch):
    """A family supplied as two modules alone: judged correct, its FLOPs
    behind ``step.mfu``, and no file of the benchmark written."""
    for name, mod in _toy_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    before = _files()
    out = _run(monkeypatch, "hocnet_r18_256_obj1280.warp", lambda m: dict(TOY), trace=True)
    assert out["correct"] is True, out["checks"]
    assert "step.mfu" in out["metrics"]
    assert "model.host_ms" not in out["metrics"]  # the toy opens no spans
    cfg = shrink(LOAD("hocnet_r18_256_obj1280.warp")[0])
    cfg["model"] = dict(TOY)
    assert cost.step_flops(cfg, "warp") == toy_flops(cfg, 2 * cfg["data"]["pairs_per_step"])
    assert _files() == before


def test_a_new_family_with_half_a_batch_is_not_correct(monkeypatch):
    for name, mod in _toy_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    out = _run(monkeypatch, "hocnet_r18_256_obj1280.warp", lambda m: dict(TOY),
               fault="half_batch")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("family", ["nope", "toy", "../toy"])
def test_an_unknown_family_fails_before_device_work(monkeypatch, family):
    """No module on either side, the port's side missing ("toy": the
    reference's alone), or a name that is no module's."""
    for name, mod in _toy_modules(port=False).items():
        monkeypatch.setitem(sys.modules, name, mod)
    from harness import scene

    def no_device_work(*args, **kw):
        raise AssertionError("device work before the family was found")

    monkeypatch.setattr(scene, "mano_arrays", no_device_work)
    with pytest.raises(ValueError, match=r"unknown model family") as err:
        _run(monkeypatch, "hocnet_r18_128_box.warp", lambda m: {**TOY, "family": family})
    msg = str(err.value)
    assert repr(family) in msg
    assert "benchmark/reference/families" in msg and "benchmark/harness/families" in msg
