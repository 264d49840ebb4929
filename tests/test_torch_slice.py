"""The port's slice as a whole vs ``hocon``: the warp-loss forward pass.

One JAX ``make_warp_train_step`` step with ``optax.sgd(0.0)`` on a batch
of 64 px synthetic pairs from ``hocon``'s own dataset returns its loss
terms computed before the update; the port's ``warp_loss`` gets the same
weights through the Flax bridge and the same batch.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from hocon.data.factory import get_dataset
from hocon.data.meshes import orient_faces_outward as ref_orient
from hocon.data.pipeline import BatchLoader
from hocon.data.synthetic import SyntheticHandDataset
from hocon.data.synthetic import uv_sphere as ref_uv_sphere
from hocon.models.hocnet import HOCNet
from hocon.train.state import create_train_state
from hocon.train.steps import make_warp_train_step
import hocon_torch.device
import hocon_torch.render.raster_cuda as TRC
import hocon_torch.render.sample_cuda as TSC
from hocon_torch.data.meshes import orient_faces_outward
from hocon_torch.data.synthetic import OBJ_SCALE, synthetic_camintr, uv_sphere
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.hocnet import HOCNet as PortHOCNet
from hocon_torch.train.steps import warp_loss
from hocon_torch.utils import cuda_build
from hocon_torch.utils.flax_weights import load_flax_variables

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them (with
# a pool per core in each of 4 workers, a warp train step ran ~70x slower).
torch.set_num_threads(1)

_CASES = {
    # name: (with_object, clip_len, photo_downscale)
    "pairs_with_object": (True, 2, 1),
    "clip3_downscale2": (False, 3, 2),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_warp_loss_terms_match_reference_step(mano_model, case):
    with_object, clip_len, downscale = _CASES[case]
    ds = get_dataset(
        "synthetic", "train", image_size=64, use_objects=with_object, train=True,
        mano=mano_model, pair_mode=True, clip_len=clip_len, fraction=0.5,
        synth_videos=2, synth_frames=4, uint8_images=True,
    )
    batch = next(iter(BatchLoader(ds, batch_size=2, seed=0)))
    net = HOCNet(with_object=with_object)
    opt = optax.sgd(0.0)
    state = create_train_state(net, mano_model, opt, batch["ref"],
                               jax.random.PRNGKey(0), with_object=with_object)
    # The step donates its state: take the weights first.
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    step = make_warp_train_step(net, mano_model, opt, image_size=(64, 64),
                                backend="xla", photo_downscale=downscale)
    _, terms_ref = step(state, batch)
    terms_ref = jax.device_get(terms_ref)

    port = PortHOCNet(with_object=with_object, device="cpu")
    load_flax_variables(port, variables)
    TRC.raster_fwd.launches = TSC.sample_fwd.launches = 0
    with torch.no_grad():
        total, terms = warp_loss(port, synthetic_mano_model(0, device="cpu"), batch,
                                 (64, 64), photo_downscale=downscale, device="cpu")
    assert set(terms_ref) - set(terms) == {"grad_norm"}  # added by the update
    assert float(terms["mask_area"]) > 10  # the renderer produced a mask
    for k, v in terms.items():
        # Supervised terms: f32 sums of squared mm errors, 1e-5 relative.
        # Photometric terms and the mask area: the culled kernel vs the
        # unculled XLA backend, plus the rim-sliver spread of the plane
        # rows (test_torch_raster): 5e-4 relative measured ~7e-5.
        rtol = 5e-4 if k.startswith("photo") or k == "mask_area" else 1e-5
        np.testing.assert_allclose(float(v), float(terms_ref[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(float(total), float(terms_ref["loss_total"]), rtol=1e-5)
    # CPU tensors run the plain versions: the kernels were never launched.
    assert TRC.raster_fwd.launches == 0 and TSC.sample_fwd.launches == 0


def test_object_mesh_and_camera_match_reference():
    for n in (12, 80, 1280):
        v_ref, f_ref = ref_uv_sphere(n)
        v, f = uv_sphere(n)
        np.testing.assert_array_equal(v, v_ref)
        np.testing.assert_array_equal(f, f_ref)
    assert len(uv_sphere(1280)[1]) == 1300
    rng = np.random.default_rng(0)
    v, f = ref_uv_sphere(200)
    flipped = f.copy()
    sel = rng.uniform(size=len(f)) < 0.3
    flipped[sel] = flipped[sel][:, ::-1]
    np.testing.assert_array_equal(orient_faces_outward(v, flipped), ref_orient(v, flipped))
    assert OBJ_SCALE == SyntheticHandDataset(
        n_videos=1, frames_per_video=1, image_size=16, with_object=False
    ).obj_scale
    f = 64 * 1.6
    np.testing.assert_array_equal(
        synthetic_camintr(64),
        np.array([[f, 0, 32], [0, f, 32], [0, 0, 1]], np.float32),
    )


def test_port_imports_no_jax_and_no_reference():
    """Every port module imports without JAX, Flax, optax or ``hocon``."""
    script = r"""
import importlib, pkgutil, sys
import hocon_torch
names = [m.name for m in pkgutil.walk_packages(hocon_torch.__path__, "hocon_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hocon"))
assert not bad, bad
print("IMPORTED", len(names))
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", script], cwd=repo, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split("IMPORTED")[1]) >= 20


def test_repro_tool_imports_no_jax_and_no_reference():
    """``tools/repro_torch_consistency.py`` imports the port only."""
    script = r"""
import sys
import tools.repro_torch_consistency
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hocon"))
assert not bad, bad
assert "hocon_torch.train.steps" in sys.modules
print("IMPORTED")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", script], cwd=repo, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTED" in r.stdout


def test_plain_kernel_tool_imports_no_jax_and_no_reference():
    """``tools/repro_plain_kernels.py`` imports the port only."""
    script = r"""
import sys
import tools.repro_plain_kernels
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hocon"))
assert not bad, bad
assert "tools.repro_torch_consistency" in sys.modules
print("IMPORTED")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", script], cwd=repo, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTED" in r.stdout


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hocon_torch.device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_mano_model(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortHOCNet()
    with pytest.raises(RuntimeError, match="CUDA"):
        warp_loss(None, None, {}, (64, 64))
    assert hocon_torch.device.resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    for name in cuda_build.KERNELS:
        assert (cuda_build.SRC_DIR / f"{name}.cu").exists()
        path = cuda_build.lib_path(name)
        assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"
        assert path.name.startswith(name + "-")
    # The build writes under a directory of its own and, without a CUDA
    # toolkit, says so instead of falling back.
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()
