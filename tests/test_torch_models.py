"""Port models vs ``hocon.models`` through the Flax weight bridge.

The Flax variables are initialised by ``hocon``, then perturbed with
seeded numpy noise (batch-norm scales, biases and running statistics, and
larger output layers) so that every branch of the network carries signal;
the same numbers go to both frameworks, in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hocon.models.backbone import resnet50
from hocon.models.hocnet import HOCNet
from hocon.models.losses import total_supervised_loss
from hocon.train.state import TrainState
from hocon.train.steps import make_eval_step
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.backbone import resnet50 as port_resnet50
from hocon_torch.models.hocnet import HOCNet as PortHOCNet
from hocon_torch.models.losses import total_supervised_loss as port_supervised
from hocon_torch.train.steps import eval_step
from hocon_torch.utils.flax_weights import flax_to_state_dict, load_flax_variables

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them (with
# a pool per core in each of 4 workers, a warp train step ran ~70x slower).
torch.set_num_threads(1)

RES, B, VO = 64, 2, 30


def _perturb(variables, seed=0):
    """Seeded noise on a Flax variables tree (numpy in, numpy out)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias":
                v = rng.normal(0.0, 0.1, v.shape)
            elif k == "mean":
                v = rng.normal(0.0, 0.1, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "kernel" and v.ndim == 2 and v.std() < 1e-2:
                v = rng.normal(0.0, 0.02, v.shape)  # near-zero output layers
            out[k] = v.astype(np.float32)
        return out

    return walk(variables)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
    camintr = np.tile(
        np.array([[100.0, 0, RES / 2], [0, 100.0, RES / 2], [0, 0, 1]], np.float32),
        (B, 1, 1),
    )
    obj = rng.uniform(-0.05, 0.05, (B, VO, 3)).astype(np.float32)
    return images, camintr, obj


@pytest.fixture(scope="module")
def nets(mano_model):
    images, camintr, obj = _inputs()
    net = HOCNet(with_object=True)
    variables = net.init(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(camintr),
        mano_model, jnp.asarray(obj),
    )
    variables = _perturb(jax.device_get(variables))
    port = PortHOCNet(with_object=True, device="cpu")
    load_flax_variables(port, variables)
    return net, variables, port, synthetic_mano_model(0, device="cpu")


# f32 through a ResNet-18 and the MANO layer: convolutions sum thousands of
# products in another order, so outputs agree to ~1e-5 relative; absolute
# bars scale with each output's units (mm ~ 100, px ~ 100, m ~ 0.1).
_ATOL = {"_mm": 2e-2, "2d": 2e-2, "default": 2e-4}


def _atol(key):
    for suffix, tol in _ATOL.items():
        if key.endswith(suffix):
            return tol
    return _ATOL["default"]


def test_bridge_covers_every_port_weight(nets):
    _, variables, port, _ = nets
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    # Conv kernels HWIO -> OIHW, dense (in, out) -> (out, in).
    k = variables["params"]["trunk"]["conv_init"]["kernel"]
    np.testing.assert_array_equal(sd["trunk.conv_init.weight"], k.transpose(3, 2, 0, 1))
    d = variables["params"]["mano_head"]["pose_mlp"]["Dense_2"]["kernel"]
    np.testing.assert_array_equal(sd["mano_head.pose_mlp.layers.2.weight"], d.T)
    np.testing.assert_array_equal(
        sd["trunk.blocks.2.norm_proj.running_var"],
        variables["batch_stats"]["trunk"]["BasicBlock_2"]["norm_proj"]["var"],
    )


def test_hocnet_outputs_match(nets, mano_model):
    net, variables, port, port_mano = nets
    images, camintr, obj = _inputs(1)
    ref = net.apply(
        variables, jnp.asarray(images), jnp.asarray(camintr), mano_model,
        jnp.asarray(obj),
    )
    with torch.no_grad():
        out = port(*map(torch.from_numpy, (images, camintr)), port_mano,
                   torch.from_numpy(obj))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(
            out[k].numpy(), np.asarray(ref[k]), atol=_atol(k), rtol=1e-4, err_msg=k
        )


def test_eval_step_matches(nets, mano_model):
    net, variables, port, port_mano = nets
    images, camintr, obj = _inputs(2)
    batch = {
        "image": images, "camintr": camintr, "obj_verts_can": obj,
        "obj_corners_can": obj[:, :8].copy(),
    }
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=(),
                       step=jnp.zeros((), jnp.int32))
    ref = jax.device_get(make_eval_step(net, mano_model)(
        state, jax.tree_util.tree_map(jnp.asarray, batch)))
    preds = eval_step(port, port_mano, batch, device="cpu")
    assert set(preds) == set(ref)
    for k in ref:
        np.testing.assert_allclose(
            preds[k].numpy(), ref[k], atol=_atol(k), rtol=1e-4, err_msg=k
        )


def test_resnet50_trunk_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    trunk = resnet50()
    variables = _perturb(jax.device_get(
        trunk.init(jax.random.PRNGKey(1), jnp.asarray(x))))
    ref = np.asarray(trunk.apply(variables, jnp.asarray(x)))
    port = port_resnet50()
    load_flax_variables(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 2048)
    # Pooled features are O(1); 53 layers of reordered f32 sums.
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_bf16_trunk_autocast_keeps_f32_outputs(nets):
    _, variables, _, port_mano = nets
    port16 = PortHOCNet(with_object=False, dtype=torch.bfloat16, device="cpu")
    sd = {k: v for k, v in flax_to_state_dict(variables).items()
          if not k.startswith("obj_head")}
    port16.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    port32 = PortHOCNet(with_object=False, device="cpu")
    port32.load_state_dict(port16.state_dict())
    images, camintr, _ = _inputs(4)
    with torch.no_grad():
        f16 = port16.trunk(torch.from_numpy(images))
        f32 = port32.trunk(torch.from_numpy(images))
        out = port16(torch.from_numpy(images), torch.from_numpy(camintr), port_mano)
    assert f16.dtype == torch.float32 and out["verts_cam"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    # bf16 keeps 8 mantissa bits: pooled features agree to ~2% of scale.
    scale = f32.abs().max().item()
    assert (f16 - f32).abs().max().item() < 5e-2 * scale


def test_supervised_losses_match():
    rng = np.random.default_rng(5)
    pred = {
        "verts_c_mm": rng.normal(0, 50, (3, 778, 3)),
        "joints_c_mm": rng.normal(0, 50, (3, 21, 3)),
        "joints2d": rng.uniform(0, 64, (3, 21, 2)),
        "betas": rng.normal(0, 1, (3, 10)),
        "pose_pca": rng.normal(0, 1, (3, 15)),
        "obj_verts_c_mm": rng.normal(0, 50, (3, VO, 3)),
    }
    gt = {k: rng.normal(0, 50, pred[k].shape) for k in
          ("verts_c_mm", "joints_c_mm", "joints2d", "obj_verts_c_mm")}
    gt["obj_verts_mask"] = (np.arange(VO) < 20).astype(np.float64)[None].repeat(3, 0)
    mask = np.array([1.0, 0.0, 1.0])
    f32 = lambda t: {k: v.astype(np.float32) for k, v in t.items()}
    pred, gt, mask = f32(pred), f32(gt), mask.astype(np.float32)
    lam = dict(lambda_obj_verts2d=0.0)
    tot_ref, terms_ref = total_supervised_loss(
        jax.tree_util.tree_map(jnp.asarray, pred),
        jax.tree_util.tree_map(jnp.asarray, gt), jnp.asarray(mask), obj_lambdas=lam,
    )
    tot, terms = port_supervised(
        {k: torch.from_numpy(v) for k, v in pred.items()},
        {k: torch.from_numpy(v) for k, v in gt.items()}, torch.from_numpy(mask),
        obj_lambdas=lam,
    )
    assert set(terms) == set(terms_ref)
    for k in terms_ref:
        # Sums of ~1e4 squared errors of O(1e3): 1e-5 relative.
        np.testing.assert_allclose(float(terms[k]), float(terms_ref[k]), rtol=1e-5, err_msg=k)
