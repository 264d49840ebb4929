"""Port visualisation (``hocon_torch.visualize``) vs ``hocon.visualize``.

``save_warp_panels`` of both packages runs on the same weights (carried by
``load_flax_variables``), the same 64 px synthetic pair batch and flags;
each package's ``sample_vis`` is replaced, as a module attribute, by one
that records what it was asked to draw. The reference renders through its
Pallas kernel in interpret mode, the port through K1's plain version, both
culled. Rim slivers move both packages' coordinates by up to ~1 px on
a few pixels (ROADMAP queue 3), so the mask and the warped image are held
to twice the port's own spread under a once-rounded float64 build of its
plane rows (measured in the test); the target is bit for bit and the
joints at f32 rounding. Then ``sample_vis`` writes PNGs, and ``train --vis_freq 1`` /
``trainwarp --vis_freq 1`` write their images on the CPU.
"""

import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch

import hocon.visualize.warpvis as ref_warpvis
from hocon.data.factory import get_dataset
from hocon.data.pipeline import probe_batch
from hocon.models.hocnet import HOCNet as RefHOCNet
from hocon.train.state import create_train_state as ref_train_state
import hocon_torch.visualize.warpvis as warpvis
from hocon_torch.cli import train, trainwarp
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.hocnet import HOCNet
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.utils.flax_weights import load_flax_variables
from hocon_torch.visualize import samplevis
from hocon_torch.visualize.samplevis import sample_vis

torch.set_num_threads(1)

RES = 64
MASK_ATOL = 2e-5  # the reference's silhouette parity bar
FAR = 0.05  # a warped value this far off counts as a moved sample
SMALL = ["--dataset", "synthetic", "--image_size", "32", "--synth_videos", "2",
         "--synth_frames", "4", "--batch_size", "4", "--no_bf16", "--epochs", "1",
         "--vis_freq", "1"]

_CASES = {  # name: (with_object, uint8 crops, consist_gt_refs, gamma)
    "object_uint8": (True, True, True, 1.0 / 40.0),
    "hand_float_predicted_refs": (False, False, False, 1.0 / 100.0),
}


def _capture(monkeypatch, module, calls):
    def record(batch, preds, save_path, max_rows=4, warp=None):
        calls.append(dict(batch=batch, preds=preds, warp=warp, max_rows=max_rows,
                          save_path=save_path))
        return save_path
    monkeypatch.setattr(module, "sample_vis", record)


@pytest.mark.parametrize("case", list(_CASES))
def test_warp_panels_match_reference(mano_model, monkeypatch, case, spreads=None):
    """``spreads`` (a dict; not a fixture) receives the measured spreads."""
    with_object, uint8, gt_refs, gamma = _CASES[case]
    ds = get_dataset("synthetic", "train", image_size=RES, use_objects=with_object, train=True,
                     mano=mano_model, pair_mode=True, fraction=0.5, synth_videos=1,
                     synth_frames=4, uint8_images=uint8)
    batch = probe_batch(ds, 2)  # 2 pairs
    net = RefHOCNet(with_object=with_object)
    state = ref_train_state(net, mano_model, optax.sgd(0.0), batch["ref"],
                            jax.random.PRNGKey(0), with_object=with_object)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    port = HOCNet(with_object=with_object, device="cpu")
    load_flax_variables(port, variables)
    port_state = create_train_state(port, make_optimizer())

    flags = dict(image_size=(RES, RES), consist_gt_refs=gt_refs, sigma=1.0, gamma=gamma,
                 backface_cull=True, max_rows=4)
    ref_calls, calls = [], []
    _capture(monkeypatch, ref_warpvis, ref_calls)
    _capture(monkeypatch, warpvis, calls)
    rendered, render_warp = {}, warpvis.render_warp

    def spy(*args, **kwargs):
        rendered.update(args=args, kwargs=kwargs)
        return render_warp(*args, **kwargs)
    monkeypatch.setattr(warpvis, "render_warp", spy)
    ref_warpvis.save_warp_panels(net, mano_model, state, batch, "ref.png", backend="pallas",
                                 **flags)
    port_mano = synthetic_mano_model(0, device="cpu")
    got = warpvis.save_warp_panels(port, port_mano, port_state, batch, "port.png",
                                   backend="auto", device="cpu", **flags)
    assert got == "port.png"
    (want,), (have,) = ref_calls, calls
    assert have["max_rows"] == want["max_rows"] == 4
    assert sorted(have["batch"]) == sorted(want["batch"]) == ["image", "joints2d"]
    np.testing.assert_array_equal(have["batch"]["image"], want["batch"]["image"])
    assert have["batch"]["image"].dtype == (np.uint8 if uint8 else np.float32)
    np.testing.assert_array_equal(have["batch"]["joints2d"], want["batch"]["joints2d"])
    np.testing.assert_allclose(have["preds"]["joints2d"], want["preds"]["joints2d"],
                               rtol=1e-5, atol=1e-4)
    for key in ("mask", "warped", "target"):
        assert have["warp"][key].shape == np.asarray(want["warp"][key]).shape, key
    assert have["warp"]["mask"].shape == (2, RES, RES)
    assert have["warp"]["mask"].sum() > 10  # the mesh covers pixels
    np.testing.assert_array_equal(have["warp"]["target"], want["warp"]["target"])

    # Rim slivers: a face seen nearly edge-on gets plane rows from a ~1/det
    # cancellation that f32 rounds differently in every order of operations
    # (ROADMAP queue 3), so two f32 builds of the rows (the reference's
    # jitted one, the port's eager one) move the coordinates the warped
    # image is sampled at by up to ~1 px on a few pixels, and the mask by a
    # few 1e-5. The yardstick is the port's own spread: the same render with
    # the rows built in float64 and rounded once. Measured at 64 px: the
    # warped image lies from the reference at mean 3.5e-4 / 4.7e-4 and 99th
    # percentile 6.0e-3 / 7.4e-3, from the port's float64-row render at
    # 4.2e-4 / 6.5e-4 and 7.7e-3 / 9.0e-3 (cases in order); the mask at
    # most 2.8e-5 / 2.1e-5 from the reference, 3.5e-5 / 2.1e-5 from itself.
    # The values off by more than ``FAR`` (moved samples) are 0.045 % / 0.21 %
    # of the warped image from the reference, 0.081 % / 0.36 % from the
    # float64-row render, so a fault confined to a thin band (one border
    # row is 1.6 % of a 64 px image) cannot hide above the 99th percentile
    # (``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_visualize.py``).
    # The port is held to twice its own spread, the mask to twice the
    # larger of that and the silhouette bar.
    args, kw = rendered["args"], rendered["kwargs"]
    (mask32, warped32), (mask64, warped64) = (_render(args, kw, dt)
                                              for dt in (torch.float32, torch.float64))
    np.testing.assert_array_equal(mask32, have["warp"]["mask"])  # the panel's own render
    np.testing.assert_array_equal(warped32, have["warp"]["warped"])
    m_ref = np.abs(have["warp"]["mask"] - want["warp"]["mask"]).max()
    m_self = np.abs(mask64 - mask32).max()
    assert m_ref <= 2 * max(MASK_ATOL, m_self), (m_ref, m_self)
    d_ref = np.abs(have["warp"]["warped"] - want["warp"]["warped"])
    d_self = np.abs(warped64 - warped32)
    q_ref, q_self = np.quantile(d_ref, 0.99), np.quantile(d_self, 0.99)
    if spreads is not None:
        spreads[case] = {"mask from the reference": m_ref, "mask from float64 rows": m_self,
                         "warped from the reference: mean, 99th percentile, max":
                             (d_ref.mean(), q_ref, d_ref.max()),
                         "warped from float64 rows: mean, 99th percentile, max":
                             (d_self.mean(), q_self, d_self.max()),
                         f"share of warped values off by more than {FAR}, from the reference "
                         "and from float64 rows": ((d_ref > FAR).mean(), (d_self > FAR).mean())}
    assert d_self.mean() > 0  # the yardstick is not empty
    assert d_ref.mean() <= 2 * d_self.mean(), (d_ref.mean(), d_self.mean())
    assert q_ref <= 2 * q_self, (q_ref, q_self)
    far_ref, far_self = (d_ref > FAR).mean(), (d_self > FAR).mean()
    assert far_ref <= 2 * far_self, (far_ref, far_self)


def _render(args, kw, dtype):
    """``render_warp``'s mask and warped image from the port's inputs, with
    the plane rows built in ``dtype``."""
    verts_tgt, verts_ref, faces, k_tgt, k_ref, ref_img = args
    out = warpvis.render_warp(verts_tgt.to(dtype), verts_ref.to(dtype), faces, k_tgt.to(dtype),
                              k_ref.to(dtype), ref_img, **kw)
    return out.mask.float().numpy(), out.warped.float().numpy()


def test_warp_panels_cut_the_batch_before_the_forward(monkeypatch):
    """Only ``max_rows`` pairs reach the model, as in the reference."""
    mano = synthetic_mano_model(0, device="cpu")
    ds = get_dataset("synthetic", "train", image_size=32, use_objects=False, train=True,
                     pair_mode=True, synth_videos=2, synth_frames=4)
    batch = probe_batch(ds, 5)
    port = HOCNet(with_object=False, device="cpu")
    seen = []
    port.register_forward_hook(lambda m, args, out: seen.append(args[0].shape[0]))
    batch_np, preds, warp = warpvis.warp_panels(
        port, mano, create_train_state(port, make_optimizer()), batch, (32, 32), max_rows=3,
        device="cpu")
    assert seen == [3, 3]
    assert batch_np["image"].shape[0] == preds["joints2d"].shape[0] == warp["mask"].shape[0] == 3
    with pytest.raises(ValueError, match="another model"):
        warpvis.warp_panels(port, mano, create_train_state(HOCNet(with_object=False,
                                                                  device="cpu"),
                                                           make_optimizer()),
                            batch, (32, 32), device="cpu")


def _png(path) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("case", ["uint8_no_joints", "float_with_warp"])
def test_sample_vis_writes_a_png(tmp_path, case):
    rng = np.random.default_rng(0)
    if case == "uint8_no_joints":
        batch = {"image": rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)}
        preds, warp = {}, None
    else:
        batch = {"image": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
                 "joints2d": rng.uniform(0, 32, (2, 21, 2)).astype(np.float32)}
        preds = {"joints2d": rng.uniform(0, 32, (2, 21, 2)).astype(np.float32)}
        warp = {"mask": rng.uniform(0, 1, (2, 32, 32)), "warped": rng.uniform(0, 1, (2, 32, 32, 3)),
                "target": rng.uniform(0, 1, (2, 32, 32, 3))}
    path = str(tmp_path / "sub" / "grid.png")
    assert sample_vis(batch, preds, path, warp=warp) == path
    assert _png(path) and os.path.getsize(path) > 1024


def test_unnormalize_and_no_matplotlib(monkeypatch, tmp_path):
    """uint8 crops are / 255, normalized ones un-normalized and clipped, as
    in the reference; without matplotlib ``sample_vis`` returns None."""
    from hocon.visualize.samplevis import _unnormalize as ref_unnormalize

    rng = np.random.default_rng(1)
    for img in (rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
                (3 * rng.standard_normal((4, 4, 3))).astype(np.float32)):
        got = samplevis._unnormalize(img)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref_unnormalize(img))
    assert samplevis._BONES == __import__("hocon.visualize.samplevis",
                                          fromlist=["_BONES"])._BONES
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert sample_vis({"image": np.zeros((1, 8, 8, 3), np.uint8)}, {},
                      str(tmp_path / "x.png")) is None
    assert not os.path.exists(tmp_path / "x.png")


@pytest.mark.parametrize("cli", ["train", "trainwarp"])
def test_cli_vis_freq_writes_images(cli, tmp_path, monkeypatch, capsys):
    """``--vis_freq 1`` on the CPU: ``train`` draws each of the eval pass's
    two batches (``ep0_b{i}.png``), ``trainwarp`` the warp panels after the
    train pass (``warp_ep0.png``)."""
    monkeypatch.chdir(tmp_path)
    main = {"train": train.main, "trainwarp": trainwarp.main}[cli]
    main(SMALL + ["--exp_id", "v"], device="cpu")
    images = tmp_path / "checkpoints" / "v" / "images"
    want = {"train": ["ep0_b0.png", "ep0_b1.png"], "trainwarp": ["warp_ep0.png"]}[cli]
    assert sorted(os.listdir(images)) == want
    assert _png(images / want[0]) and os.path.getsize(images / want[0]) > 1024


if __name__ == "__main__":  # prints the spreads quoted in the parity test
    from hocon.geometry.mano import synthetic_mano_model as ref_mano

    found = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in _CASES:
            test_warp_panels_match_reference(ref_mano(seed=0), mp, name, spreads=found)
    for name, values in found.items():
        for what, v in values.items():
            print(f"{name}: {what} {np.round(np.asarray(v, np.float64), 8).tolist()}")
