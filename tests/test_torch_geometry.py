"""Port geometry vs ``hocon.geometry``: the same numpy inputs through both.

Tolerances are f32 rounding: the two frameworks order sums differently,
so values agree to a few ulp of their magnitude, not bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hocon.geometry.mano as M
from hocon.geometry import project as P
from hocon.geometry import rot as R
from hocon_torch.geometry import mano as TM
from hocon_torch.geometry import project as TP
from hocon_torch.geometry import rot as TR

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them (with
# a pool per core in each of 4 workers, a warp train step ran ~70x slower).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_mano():
    return TM.synthetic_mano_model(0, device="cpu")


def _axisang(rng, n):
    aa = rng.standard_normal((n, 3)).astype(np.float32)
    aa[0] = 0.0  # exact zero: the Taylor branch
    aa[1] = [1e-5, -2e-5, 0.0]  # small angle
    aa[2] = [np.pi - 1e-3, 0.0, 0.0]  # near pi: the symmetric branch
    return aa


def test_synthetic_mano_arrays_are_equal(mano_model, port_mano):
    # Same seeded numpy + scipy calls: every array must be identical.
    for name in ("v_template", "shapedirs", "posedirs", "joint_regressor",
                 "skin_weights", "hands_components", "hands_mean", "faces"):
        ref = np.asarray(getattr(mano_model, name))
        got = getattr(port_mano, name).numpy()
        assert got.shape == ref.shape, name
        assert np.array_equal(got, ref), name


def test_rotations_match():
    rng = np.random.default_rng(0)
    aa = _axisang(rng, 16)
    rot_ref = np.array(R.rodrigues(jnp.asarray(aa)))
    rot = TR.rodrigues(torch.from_numpy(aa)).numpy()
    # Entries are O(1): a few f32 ulp.
    np.testing.assert_allclose(rot, rot_ref, atol=2e-6)

    x6 = rng.standard_normal((8, 6)).astype(np.float32)
    np.testing.assert_allclose(
        TR.rot6d_to_matrix(torch.from_numpy(x6)).numpy(),
        np.asarray(R.rot6d_to_matrix(jnp.asarray(x6))), atol=2e-6,
    )
    # The log map is ill-conditioned near pi (angle from a ~1e-7 skew), so
    # the near-pi row gets 1e-4; elsewhere 2e-6 as above.
    back_ref = np.asarray(R.matrix_to_rodrigues(jnp.asarray(rot_ref)))
    back = TR.matrix_to_rodrigues(torch.from_numpy(rot_ref)).numpy()
    np.testing.assert_allclose(back[3:], back_ref[3:], atol=2e-6)
    np.testing.assert_allclose(back[:3], back_ref[:3], atol=1e-4)

    t = rng.standard_normal((5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TR.with_zeros_4x4(torch.from_numpy(rot_ref[:5]), torch.from_numpy(t)).numpy(),
        np.asarray(R.with_zeros_4x4(jnp.asarray(rot_ref[:5]), jnp.asarray(t))),
    )


def test_projection_matches():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.1, 0.1, (3, 50, 3)).astype(np.float32)
    pts[..., 2] += 0.6
    k = np.tile(np.array([[200.0, 0, 32], [0, 210.0, 30], [0, 0, 1]], np.float32), (3, 1, 1))
    # Pixels up to ~100: 1e-4 is ~10 ulp there.
    np.testing.assert_allclose(
        TP.persp_project(torch.from_numpy(pts), torch.from_numpy(k)).numpy(),
        np.asarray(P.persp_project(jnp.asarray(pts), jnp.asarray(k))), atol=1e-4,
    )
    rot = np.array(R.rodrigues(jnp.asarray(rng.standard_normal((3, 3)).astype(np.float32))))
    t = rng.standard_normal((3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TP.transform_points(*map(torch.from_numpy, (pts, rot, t))).numpy(),
        np.asarray(P.transform_points(*map(jnp.asarray, (pts, rot, t)))), atol=2e-6,
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(scale_mm=False),
        dict(center_idx=9),
        dict(with_trans=True),
        dict(use_pca=False, flat_hand_mean=True, scale_mm=False),
    ],
    ids=["meters", "centered_mm", "trans_mm", "full_pose"],
)
def test_mano_forward_matches(mano_model, port_mano, kwargs):
    kwargs = dict(kwargs)
    rng = np.random.default_rng(2)
    b = 4
    ncomps = 45 if kwargs.get("use_pca") is False else 15
    pose = (rng.standard_normal((b, ncomps)) * 0.5).astype(np.float32)
    betas = (rng.standard_normal((b, 10)) * 0.5).astype(np.float32)
    root = (rng.standard_normal((b, 3)) * 0.5).astype(np.float32)
    args = [pose, betas, root]
    if kwargs.pop("with_trans", False):
        args.append(rng.uniform(-0.1, 0.1, (b, 3)).astype(np.float32))
    v_ref, j_ref = M.mano_forward(mano_model, *map(jnp.asarray, args), **kwargs)
    v, j = TM.mano_forward(port_mano, *map(torch.from_numpy, args), **kwargs)
    # mm outputs are O(100): 1e-3 mm is ~10 ulp; meter outputs scale by 1e-3.
    atol = 1e-3 if kwargs.get("scale_mm", True) else 1e-6
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=atol)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), atol=atol)


def test_pca_to_full_pose_matches(mano_model, port_mano):
    pose = np.random.default_rng(3).standard_normal((3, 10)).astype(np.float32)
    np.testing.assert_allclose(
        TM.pca_to_full_pose(port_mano, torch.from_numpy(pose)).numpy(),
        np.asarray(M.pca_to_full_pose(mano_model, jnp.asarray(pose))), atol=2e-6,
    )


def test_mano_trans_and_center_exclusive(port_mano):
    z = torch.zeros((1, 15))
    with pytest.raises(ValueError, match="mutually exclusive"):
        TM.mano_forward(port_mano, z, torch.zeros((1, 10)), torch.zeros((1, 3)),
                        trans=torch.zeros((1, 3)), center_idx=9)
