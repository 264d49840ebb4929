"""Port trainable batch norm (``freeze_batchnorm=False``) vs Flax.

``hocon``'s trunk normalises with the batch's statistics in a train step
when ``freeze_batchnorm`` is False and updates its running ones as Flax's
``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` does: running = 0.9 running +
0.1 batch, the biased variance E[x^2] - E[x]^2 clipped at 0, reductions in
f32. The port's ``BatchNorm2d`` is held to a Flax layer directly, then a
whole supervised step is held to ``hocon``'s from bridged weights and the
same running statistics (seeded away from (0, 1), so the momentum shows).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from hocon.data.factory import get_dataset
from hocon.data.pipeline import BatchLoader
from hocon.models.hocnet import HOCNet
from hocon.train.state import create_train_state as ref_create_train_state
from hocon.train.steps import make_eval_step as ref_make_eval_step
from hocon.train.steps import make_train_step as ref_make_train_step
from hocon_torch.data.factory import get_dataset as port_get_dataset
from hocon_torch.data.pipeline import BatchLoader as PortBatchLoader
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.backbone import BN_EPS, BatchNorm2d
from hocon_torch.models.hocnet import HOCNet as PortHOCNet
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.train.steps import (
    _device_images,
    eval_step,
    make_train_step,
    make_warp_train_step,
    warp_loss,
)
from hocon_torch.utils.flax_weights import flax_to_state_dict, load_flax_variables

torch.set_num_threads(1)

RES = 64
STATS_RTOL = 1e-5


def _layer_inputs(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(0.3, 1.7, (4, 2, 2, 8))).astype(np.float32)  # NHWC, 16 values per channel
    params = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "bias": rng.normal(0, 0.5, 8).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.5, 8).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    return x, params, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_layer_matches_flax(dtype):
    """One layer in training mode: output, gradients and updated running
    statistics against Flax's; in bf16 the statistics are still reduced in
    f32 (measured: equal to 1.2e-7 relative), the output is bf16."""
    x, params, stats = _layer_inputs(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def f(p, xin):
        y, new = flax_bn.apply({"params": p, "batch_stats": stats}, xin,
                               mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g), (y, new["batch_stats"])

    (_, (y_ref, new_stats)), (gp_ref, gx_ref) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x, jdt))

    bn = BatchNorm2d(8, frozen=False)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    assert y.dtype == tdt and bn.running_mean.dtype == torch.float32
    (y.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_stats["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_stats["var"]), rtol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx_ref),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp_ref["scale"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp_ref["bias"]), rtol=1e-6)
    else:  # one bf16 rounding of the output apart
        np.testing.assert_allclose(y.detach().float().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(y_ref.astype(jnp.float32)), rtol=1e-2, atol=1e-2)
    # Eval mode runs on the running statistics and leaves them alone.
    bn.eval()
    before = bn.running_var.clone()
    y_eval = bn(xt.detach())
    assert torch.equal(bn.running_var, before)
    want = F.batch_norm(xt.detach().float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=False, eps=BN_EPS)
    torch.testing.assert_close(y_eval.float(), want, rtol=1e-2 if dtype == "bfloat16" else 0,
                               atol=1e-2 if dtype == "bfloat16" else 0)


def test_frozen_default_keeps_running_statistics_and_state_dict_keys():
    model = PortHOCNet(with_object=False, device="cpu")
    assert model.freeze_batchnorm
    sd = model.state_dict()
    assert not [k for k in sd if "num_batches_tracked" in k]
    assert set(PortHOCNet(with_object=False, freeze_batchnorm=False, device="cpu")
               .state_dict()) == set(sd)
    img = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32, 3))
                           .astype(np.float32))
    model.train()
    f_train = model.trunk(img)
    model.eval()
    f_eval = model.trunk(img)
    assert torch.equal(f_train, f_eval)
    assert torch.equal(model.trunk.bn_init.running_var, torch.ones(64))


@pytest.fixture(scope="module")
def reference_step(mano_model):
    """One ``hocon`` supervised step (hand + object, 4 frames, 64 px, f32,
    trainable batch norm) with an optax transformation that keeps the
    gradients; the eval step on the new statistics after it."""
    ds = get_dataset("synthetic", "train", image_size=RES, use_objects=True, train=True,
                     mano=mano_model, synth_videos=2, synth_frames=4)
    batch = next(iter(BatchLoader(ds, batch_size=4, seed=0)))
    net = HOCNet(with_object=True, freeze_batchnorm=False)

    def capture():
        return optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))

    tx = capture()
    state = ref_create_train_state(net, mano_model, tx, batch, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    flat, tree = jax.tree_util.tree_flatten_with_path(jax.device_get(state.batch_stats))
    seeded = [(rng.uniform(0.5, 2.0, v.shape) if "var" in jax.tree_util.keystr(p)
               else rng.normal(0, 0.3, v.shape)).astype(np.float32) for p, v in flat]
    state.batch_stats = jax.tree_util.tree_unflatten(tree, [jnp.asarray(v) for v in seeded])
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    new_state, terms = ref_make_train_step(net, mano_model, tx)(state, batch)
    preds = jax.device_get(ref_make_eval_step(net, mano_model)(new_state, batch))
    return dict(
        batch=batch, variables=variables, terms=jax.device_get(terms),
        grads=flax_to_state_dict({"params": jax.device_get(new_state.opt_state)}),
        stats=flax_to_state_dict({"batch_stats": jax.device_get(new_state.batch_stats)}),
        preds=preds,
    )


def _port_step(ref):
    mano = synthetic_mano_model(0, device="cpu")
    port = PortHOCNet(with_object=True, freeze_batchnorm=False, device="cpu")
    load_flax_variables(port, ref["variables"])
    opt = make_optimizer("sgd", 0.0, momentum=0.0)
    state = create_train_state(port, opt)
    port.eval()  # the step must put the model in training mode itself
    state, terms = make_train_step(port, mano, opt, device="cpu")(state, ref["batch"])
    assert port.training
    return port, mano, terms


def _check_stats(port, ref):
    """Running means and variances against JAX's new ``batch_stats``, each
    to rtol 1e-5 plus an atol of 1e-5 of the tensor's largest value (a mean
    near 0 is a difference of two close numbers). Returns the largest
    difference in units of that atol."""
    sd = port.state_dict()
    worst = 0.0
    for k, want in ref["stats"].items():
        got = sd[k].numpy()
        atol = STATS_RTOL * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=STATS_RTOL, atol=atol, err_msg=k)
        worst = max(worst, float(np.abs(got - want).max()) / atol)
    return worst


def test_trainable_batchnorm_step_matches_reference(reference_step):
    """Terms to rtol 1e-5; per-tensor gradients at the supervised step's
    bars, cosine 1 - 1e-6 and relative L2 5e-4 (measured: 1 - 4.0e-11 and
    9.1e-6); the 40 updated running statistics to rtol 1e-5 plus 1e-5 of
    each tensor's largest value (measured: at most 0.36 of that atol);
    then ``eval_step`` on them against ``make_eval_step`` at the same bars
    (measured: at most 6.7e-7 of each output's largest value).

    Tried: ``F.batch_norm(training=True, momentum=0.1)``, which updates
    ``running_var`` with the unbiased variance, fails the statistics check
    (``test_unbiased_running_variance_fails_the_check``)."""
    ref = reference_step
    port, mano, terms = _port_step(ref)
    assert set(terms) == set(ref["terms"])
    for k, want in ref["terms"].items():
        rtol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(terms[k]), float(want), rtol=rtol, err_msg=k)
    global_norm = float(ref["terms"]["grad_norm"])
    worst_cos, worst_rel = 1.0, 0.0
    for k, p in port.named_parameters():
        g, w = p.grad.double().numpy(), ref["grads"][k].astype(np.float64)
        nw = np.linalg.norm(w)
        if nw == 0.0:
            assert np.linalg.norm(g) <= 1e-7 * global_norm, k
            continue
        cos = float((g * w).sum() / (np.linalg.norm(g) * nw))
        rel = float(np.linalg.norm(g - w) / nw)
        assert cos > 1 - 1e-6 and rel < 5e-4, (k, cos, rel)
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
    print(f"gradients: lowest cosine 1 - {1 - worst_cos:.3g}, largest relative L2 {worst_rel:.3g}")
    worst = _check_stats(port, ref)
    print(f"running statistics: largest difference {worst:.3g} x (1e-5 of the tensor's max)")
    before = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}

    preds = eval_step(port, mano, ref["batch"], device="cpu")
    assert port.training  # eval_step restores the mode it found
    assert all(torch.equal(port.state_dict()[k], v) for k, v in before.items())
    for k, want in ref["preds"].items():
        err = np.abs(preds[k].numpy() - want).max() / np.abs(want).max()
        print(f"eval {k}: max |diff| / max |value| {err:.3g}")
        np.testing.assert_allclose(preds[k].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_unbiased_running_variance_fails_the_check(reference_step, monkeypatch):
    """The trap: ``F.batch_norm(training=True)`` normalises as Flax does but
    moves ``running_var`` by the unbiased variance (16/15 of the biased one
    over the 2 x 2 x 4 values per channel of the last stage)."""

    def torch_update(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=self.training and not self.frozen, momentum=0.1,
                            eps=BN_EPS)

    monkeypatch.setattr(BatchNorm2d, "forward", torch_update)
    port, _, _ = _port_step(reference_step)
    with pytest.raises(AssertionError, match="running_var"):
        _check_stats(port, reference_step)


def test_warp_step_takes_statistics_from_the_joint_batch():
    """The warp step normalises its one trunk pass over [ref; tgt] with
    that joint batch's statistics (``hocon``'s ``_apply_model`` on the
    concatenated images): the first layer's running mean moves by 0.1 of
    the joint batch's channel means. ``warp_loss`` alone runs in eval mode
    and leaves the statistics alone."""
    mano = synthetic_mano_model(0, device="cpu")
    ds = port_get_dataset("synthetic", "train", image_size=32, use_objects=False, train=True,
                          mano=mano, pair_mode=True, fraction=0.5, synth_videos=2,
                          synth_frames=4, device="cpu")
    batch = next(iter(PortBatchLoader(ds, batch_size=2, seed=0)))
    model = PortHOCNet(with_object=False, freeze_batchnorm=False, seed=0, device="cpu")
    bn = model.trunk.bn_init
    with torch.no_grad():
        warp_loss(model, mano, batch, (32, 32), device="cpu")
    assert torch.equal(bn.running_mean, torch.zeros(64)) and model.training
    images = torch.cat([_device_images(torch.from_numpy(batch[k]["image"]))
                        for k in ("ref", "tgt")])
    with torch.no_grad():
        want = 0.1 * model.trunk.conv_init(images.permute(0, 3, 1, 2)).mean(dim=(0, 2, 3))
    opt = make_optimizer("sgd", 0.0, momentum=0.0)
    step = make_warp_train_step(model, mano, opt, image_size=(32, 32), device="cpu")
    step(create_train_state(model, opt), batch)
    torch.testing.assert_close(bn.running_mean, want, rtol=1e-5, atol=1e-7)
