"""MANO assets in the port (``load_mano_model``, ``mirror_mano_model``,
``cli.opts.load_mano_or_synthetic``) vs ``hocon.geometry.mano``.

The pickle is written as the official assets are (``tools/fixture_trees.
write_mano_pkl``): chumpy ``Ch`` objects whose stand-in class exists in
``sys.modules`` only while dumping, a ``scipy.sparse.csc`` joint regressor
and uint32 faces, from the synthetic arrays of seed 1 (not the stand-in
model's seed 0, so a fallback to the synthetic model would show). Both
loaders read it to the same f32 arrays for either side, the mirrors are
equal bit for bit, the mirror is an involution, the mirrored forward is
the x-flip of the right forward at ``tests/test_mano.py``'s bars, and the
CLI helper's four branches match the reference's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import hocon.cli.opts as ref_opts
import hocon.geometry.mano as RM
from hocon_torch.cli import opts
from hocon_torch.geometry.mano import (
    _ChStub,
    load_mano_model,
    mano_forward,
    mirror_mano_model,
    synthetic_mano_arrays,
)
from tools.fixture_trees import write_mano_pkl

torch.set_num_threads(1)

FIELDS = ("v_template", "shapedirs", "posedirs", "joint_regressor", "skin_weights",
          "hands_components", "hands_mean", "faces")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A directory with MANO_RIGHT.pkl only, and the arrays it holds."""
    root = tmp_path_factory.mktemp("mano")
    arrays = synthetic_mano_arrays(1)
    write_mano_pkl(str(root / "MANO_RIGHT.pkl"), arrays)
    assert "chumpy" not in sys.modules and "chumpy.ch" not in sys.modules
    return str(root), arrays


def _assert_models_equal(port, ref):
    """Same side, and every array the same bits (faces: int64 against the
    reference's int32, the same values)."""
    assert port.side == ref.side
    for name in FIELDS:
        got, want = getattr(port, name).cpu().numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        if name == "faces":
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
        else:
            assert got.dtype == want.dtype == np.float32, name
            assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("side", ["right", "left"])
def test_load_matches_reference(assets, side):
    root, arrays = assets
    path = os.path.join(root, "MANO_RIGHT.pkl")
    port = load_mano_model(path, side=side, device="cpu")
    _assert_models_equal(port, RM.load_mano_model(path, side=side))
    flip = np.array([-1.0 if side == "left" else 1.0, 1.0, 1.0], np.float32)
    np.testing.assert_array_equal(port.shapedirs.numpy(), arrays["shapedirs"] * flip[:, None])
    np.testing.assert_array_equal(port.v_template.numpy(), arrays["v_template"])


def test_stub_refuses_an_object_without_payload():
    stub = _ChStub()
    stub.__setstate__({"size": 3})
    with pytest.raises(ValueError, match="no array payload"):
        np.asarray(stub)


def test_mirror_matches_reference(assets):
    path = os.path.join(assets[0], "MANO_RIGHT.pkl")
    left = mirror_mano_model(load_mano_model(path, device="cpu"))
    _assert_models_equal(left, RM.mirror_mano_model(RM.load_mano_model(path)))
    assert left.side == "left" and left.faces.is_contiguous()


def test_mirror_is_involution(assets):
    right = load_mano_model(os.path.join(assets[0], "MANO_RIGHT.pkl"), device="cpu")
    back = mirror_mano_model(mirror_mano_model(right))
    assert back.side == "right"
    for name in FIELDS:
        assert torch.equal(getattr(back, name), getattr(right, name)), name


def test_left_hand_is_mirrored_right(assets):
    """``tests/test_mano.py``'s oracle on the port: the mirrored model with
    mirrored inputs gives the x-flip of the right forward (rtol 1e-4, atol
    1e-3 mm), on the axis-angle and the PCA paths."""
    right = load_mano_model(os.path.join(assets[0], "MANO_RIGHT.pkl"), device="cpu")
    left = mirror_mano_model(right)
    rng = np.random.default_rng(11)
    b = 3
    pose, betas, rot, trans = (
        torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))
        for shape, s in (((b, 45), 0.3), ((b, 10), 0.5), ((b, 3), 0.8), ((b, 3), 0.1)))
    mirror_xyz = torch.tensor([-1.0, 1.0, 1.0])
    aa_flip = torch.tensor([1.0, -1.0, -1.0])
    v_r, j_r = mano_forward(right, pose, betas, rot, trans=trans, use_pca=False)
    v_l, j_l = mano_forward(left, (pose.reshape(b, 15, 3) * aa_flip).reshape(b, 45), betas,
                            rot * aa_flip, trans=trans * mirror_xyz, use_pca=False)
    np.testing.assert_allclose(v_l, v_r * mirror_xyz, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(j_l, j_r * mirror_xyz, rtol=1e-4, atol=1e-3)
    v_rp, _ = mano_forward(right, pose[:, :15], betas, rot, use_pca=True)
    v_lp, _ = mano_forward(left, pose[:, :15], betas, rot * aa_flip, use_pca=True)
    np.testing.assert_allclose(v_lp, v_rp * mirror_xyz, rtol=1e-4, atol=1e-3)


# case: (which pickles the assets directory holds, side)
_BRANCHES = {
    "right_pkl": (("MANO_RIGHT.pkl",), "right"),
    "left_pkl": (("MANO_RIGHT.pkl", "MANO_LEFT.pkl"), "left"),
    "left_mirrors_right_pkl": (("MANO_RIGHT.pkl",), "left"),
    "right_synthetic": ((), "right"),
    "left_synthetic_mirrored": ((), "left"),
}


@pytest.mark.parametrize("case", list(_BRANCHES))
def test_load_mano_or_synthetic_matches_reference(case, assets, tmp_path, capsys):
    files, side = _BRANCHES[case]
    for name in files:
        os.link(os.path.join(assets[0], "MANO_RIGHT.pkl"), tmp_path / name)
    port = opts.load_mano_or_synthetic(str(tmp_path), side, device="cpu")
    port_out = capsys.readouterr().out
    ref = ref_opts.load_mano_or_synthetic(str(tmp_path), side)
    assert port_out == capsys.readouterr().out
    assert ("not found" in port_out) == (not files)
    _assert_models_equal(port, ref)
    assert port.side == side
