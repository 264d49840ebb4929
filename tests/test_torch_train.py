"""Port train steps and optimizer vs ``hocon.train``.

The optimizer is held to optax update by update. A step's gradients are
held to JAX's exact gradients: ``make_warp_train_step`` / ``make_train_step``
get an optax transformation that applies no update and keeps the gradients
as its state, so ``state.opt_state`` after one step is the gradient tree,
mapped onto the port's parameter names by the Flax bridge. The port gets
the same weights and batch (64 px synthetic frames from ``hocon``'s own
dataset) and an SGD step at learning rate 0, which leaves ``.grad`` set.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hocon.data.factory import get_dataset
from hocon.data.pipeline import BatchLoader
from hocon.models.hocnet import HOCNet
from hocon.train.state import create_train_state as ref_create_train_state
from hocon.train.state import make_optimizer as ref_make_optimizer
from hocon.train.steps import make_train_step as ref_make_train_step
from hocon.train.steps import make_warp_train_step as ref_make_warp_train_step
import hocon_torch.render.raster_cuda as TRC
import hocon_torch.render.sample_cuda as TSC
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.hocnet import HOCNet as PortHOCNet
from hocon_torch.train.state import (
    TrainState,
    apply_gradients,
    create_train_state,
    make_optimizer,
)
from hocon_torch.train.steps import make_train_step, make_warp_train_step
from hocon_torch.utils.flax_weights import flax_to_state_dict, load_flax_variables

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them (with
# a pool per core in each of 4 workers, a warp train step ran ~70x slower).
torch.set_num_threads(1)

RES = 64
GRAD_NORM_RTOL = 1e-4  # measured 2.8e-5 (warp step) and below (supervised)

_OPT_CASES = {
    f"{name}-{'decay' if decay else 'const'}-{'clip' if clip else 'noclip'}": (name, decay, clip)
    for name, decay, clip in itertools.product(("adam", "adamw", "sgd"), (False, True),
                                               (False, True))
}


@pytest.mark.parametrize("case", list(_OPT_CASES))
def test_make_optimizer_matches_optax(case):
    """Three updates from the same parameters and gradient sequence; the
    decay halves the rate from the third update on, and clipping at 1.0
    scales the first and third gradients (norms ~3 and ~2) but not the
    second (~0.5)."""
    name, decay, clip = _OPT_CASES[case]
    kw = dict(name=name, lr=0.1, momentum=0.9, weight_decay=0.05 if name == "adamw" else 0.0,
              lr_decay_step=2 if decay else 0, lr_decay_gamma=0.5, grad_clip=1.0 if clip else 0.0)
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,)}
    # Away from 0, so that a relative bar means something for every entry.
    params = {k: (rng.uniform(0.5, 1.5, s) * rng.choice([-1, 1], s)).astype(np.float32)
              for k, s in shapes.items()}
    grads = []
    for norm in (3.0, 0.5, 2.0):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        grads.append({k: (v * (norm / total)).astype(np.float32) for k, v in g.items()})

    tx = ref_make_optimizer(**kw)
    ref_params = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(ref_params)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    state = create_train_state(module, make_optimizer(**kw))
    for t, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state,
                                       ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = apply_gradients(state)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for k, p in module.items():
            # f32 on both sides with optax's bias corrections: measured
            # <= 3.5e-7 relative for adam / adamw (torch's fused kernel
            # rounds the update in another order) and 7.7e-8 for sgd; held
            # at 1e-6.
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref_params[k]),
                                       rtol=1e-6, err_msg=f"{k} after update {t + 1}")
    assert state.step == 3


def _capture_grads():
    """An optax transformation that applies nothing and keeps the gradients."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _warp_batch(mano_model, with_object=True, clip_len=2, batch_size=2):
    ds = get_dataset(
        "synthetic", "train", image_size=RES, use_objects=with_object, train=True,
        mano=mano_model, pair_mode=True, clip_len=clip_len, fraction=0.5,
        synth_videos=2, synth_frames=4, uint8_images=True,
    )
    return next(iter(BatchLoader(ds, batch_size=batch_size, seed=0)))


def _port_and_ref_grads(mano_model, net, ref_step, port_step_fn, init_batch, batch,
                        with_object):
    tx = _capture_grads()
    state = ref_create_train_state(net, mano_model, tx, init_batch, jax.random.PRNGKey(0),
                                   with_object=with_object)
    # The step donates its state: take the weights first.
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    new_state, terms_ref = ref_step(tx)(state, batch)
    ref_grads = flax_to_state_dict({"params": jax.device_get(new_state.opt_state)})
    terms_ref = jax.device_get(terms_ref)

    port = PortHOCNet(with_object=with_object, device="cpu")
    load_flax_variables(port, variables)
    opt = make_optimizer("sgd", 0.0, momentum=0.0)
    pstate = create_train_state(port, opt)
    pstate, terms = port_step_fn(port, opt)(pstate, batch)
    assert set(ref_grads) == {k for k, _ in port.named_parameters()}
    return port, ref_grads, terms, terms_ref


def _assert_grads_close(port, ref_grads, global_norm, bars, report):
    """Per-tensor cosine and relative L2 error of the port's gradients.

    ``bars`` maps a least share of the global gradient norm to the
    (cosine, relative L2) bars of tensors whose gradient carries at least
    that share; a tensor takes the tightest bar it qualifies for."""
    worst = {}
    for k, p in port.named_parameters():
        g, w = p.grad.double().numpy(), ref_grads[k].astype(np.float64)
        nw = np.linalg.norm(w)
        if nw == 0.0:
            assert np.linalg.norm(g) == 0.0, k
            continue
        cos = float((g * w).sum() / (np.linalg.norm(g) * nw))
        rel = float(np.linalg.norm(g - w) / nw)
        worst[k] = (cos, rel, nw / global_norm)
        cos_bar, rel_bar = bars[max(s for s in bars if nw >= s * global_norm)]
        assert cos > cos_bar and rel < rel_bar, (k, cos, rel, nw / global_norm)
    lo_cos = min(worst.items(), key=lambda kv: kv[1][0])
    hi_rel = max(worst.items(), key=lambda kv: kv[1][1])
    print(f"{report}: {len(worst)} tensors; lowest cosine {lo_cos}; largest relative L2 {hi_rel}")


def test_warp_step_gradients_match_reference(mano_model):
    """One warp step (hand + object, 2 pairs, 64 px) from the bridged
    weights: per-parameter gradients and ``grad_norm`` vs JAX.

    The reference runs ``backend="pallas"``, in interpret mode here: the
    same culled raster function and its hand-written backward as the
    port's K1 / K2 path. Rim sliver faces get plane rows that round
    differently in the port's eager f32 build and the reference's jitted one
    (``test_torch_raster``): the rendered coordinates differ by up to
    ~1.5 px there, and on the random-texture frames the sampled image's
    gradient changes within a pixel. That reaches every parameter through
    the photometric term, but shows only in gradients that are a small sum
    of it: the shape head's (at most 1e-3 of the global norm) lies 4.4 %
    (relative L2, measured; cosine 0.99907) from the reference's. Every
    tensor carrying at least 2e-3 of the global norm is within 8.7e-4
    relative L2 and 1 - 4e-7 cosine (measured), held at 2e-3 and 1 - 1e-5;
    the rest at 6 % and 0.998. ``grad_norm`` agrees to 2.8e-5 (measured).
    """
    batch = _warp_batch(mano_model)
    net = HOCNet(with_object=True)
    TRC.raster_fwd.launches = TRC.raster_bwd.launches = 0
    TSC.sample_fwd.launches = TSC.sample_bwd.launches = 0
    port, ref_grads, terms, terms_ref = _port_and_ref_grads(
        mano_model, net,
        lambda tx: ref_make_warp_train_step(net, mano_model, tx, image_size=(RES, RES),
                                            backend="pallas"),
        lambda model, opt: make_warp_train_step(
            model, synthetic_mano_model(0, device="cpu"), opt, image_size=(RES, RES),
            device="cpu"),
        batch["ref"], batch, with_object=True,
    )
    assert set(terms) == set(terms_ref)
    for k in terms_ref:
        # The forward's bars (test_torch_slice); grad_norm's own.
        if k == "grad_norm":
            rtol = GRAD_NORM_RTOL
        else:
            rtol = 5e-4 if k.startswith("photo") or k == "mask_area" else 1e-5
        np.testing.assert_allclose(float(terms[k]), float(terms_ref[k]), rtol=rtol, err_msg=k)
    _assert_grads_close(port, ref_grads, float(terms_ref["grad_norm"]),
                        {0.0: (0.998, 0.06), 2e-3: (1 - 1e-5, 2e-3)}, "warp step")
    # CPU tensors run the plain versions: no kernel was launched.
    assert TRC.raster_fwd.launches == TRC.raster_bwd.launches == 0
    assert TSC.sample_fwd.launches == TSC.sample_bwd.launches == 0


def test_train_step_gradients_match_reference(mano_model):
    """One supervised step (hand + object, 4 frames, 64 px): per-parameter
    gradients and ``grad_norm`` vs JAX; measured per-tensor cosine >= 1 -
    1e-12 and relative L2 <= 1.1e-6, held at 1 - 1e-6 and 5e-4."""
    ds = get_dataset("synthetic", "train", image_size=RES, use_objects=True, train=True,
                     mano=mano_model, synth_videos=2, synth_frames=4)
    batch = next(iter(BatchLoader(ds, batch_size=4, seed=0)))
    net = HOCNet(with_object=True)
    port, ref_grads, terms, terms_ref = _port_and_ref_grads(
        mano_model, net,
        lambda tx: ref_make_train_step(net, mano_model, tx),
        lambda model, opt: make_train_step(model, synthetic_mano_model(0, device="cpu"), opt,
                                           device="cpu"),
        batch, batch, with_object=True,
    )
    assert set(terms) == set(terms_ref)
    for k in terms_ref:
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(terms[k]), float(terms_ref[k]), rtol=rtol, err_msg=k)
    _assert_grads_close(port, ref_grads, float(terms_ref["grad_norm"]),
                        {0.0: (1 - 1e-6, 5e-4)}, "supervised step")


def _port_warp_state(mano_model, with_object):
    model = PortHOCNet(with_object=with_object, seed=0, device="cpu")
    optimizer = make_optimizer("adam", 5e-4)
    return model, optimizer, create_train_state(model, optimizer)


def test_warp_step_runs_and_learns(mano_model):
    """The port of ``tests/test_train.py::test_warp_step_runs_and_learns``:
    8 steps at 64 px, batch 4, hand only; the loss falls, the mask lives."""
    batch = _warp_batch(mano_model, with_object=False, batch_size=4)
    model, optimizer, state = _port_warp_state(mano_model, with_object=False)
    step = make_warp_train_step(model, synthetic_mano_model(0, device="cpu"), optimizer,
                                image_size=(RES, RES), consist_gt_refs=True, device="cpu")
    losses = []
    for _ in range(8):
        state, terms = step(state, batch)
        losses.append(float(terms["loss_total"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert float(terms["mask_area"]) > 10  # the renderer produced a real mask
    assert float(terms["grad_norm"]) > 0 and state.step == 8
    assert isinstance(state, TrainState)


_VARIANTS = {
    # name: (clip_len, photo_downscale, least mask area)
    "clip3": (3, 1, 10.0),  # one annotated ref + 2 targets folded into the batch
    "photo_downscale2": (2, 2, 5.0),  # a 32 x 32 mask
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_warp_step_variants(mano_model, variant):
    """One step each of ``tests/test_train.py``'s k-frame clip and
    ``photo_downscale`` cases."""
    clip_len, downscale, min_area = _VARIANTS[variant]
    batch = _warp_batch(mano_model, with_object=False, clip_len=clip_len, batch_size=4)
    if clip_len == 3:
        assert batch["tgt"]["image"].shape == (4, 2, RES, RES, 3)
    model, optimizer, state = _port_warp_state(mano_model, with_object=False)
    step = make_warp_train_step(model, synthetic_mano_model(0, device="cpu"), optimizer,
                                image_size=(RES, RES), photo_downscale=downscale, device="cpu")
    state, terms = step(state, batch)
    assert all(np.isfinite(float(v)) for v in terms.values())
    assert float(terms["mask_area"]) > min_area
    assert float(terms["grad_norm"]) > 0


def test_train_state_must_hold_the_step_model(mano_model):
    model, optimizer, state = _port_warp_state(mano_model, with_object=False)
    other = PortHOCNet(with_object=False, seed=1, device="cpu")
    step = make_train_step(other, synthetic_mano_model(0, device="cpu"), optimizer, device="cpu")
    with pytest.raises(ValueError, match="another model"):
        step(state, {})
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb")


def test_train_steps_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_warp_train_step(None, None, make_optimizer(), image_size=(RES, RES))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(None, None, make_optimizer())
