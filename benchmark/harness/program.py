"""The system under test: the port's train step, built as a training run
builds it. With the port's side of each model family
(``harness/families/``), the only modules of the benchmark that import
``hocon_torch``.

The warp cells drive the step that ``make_warp_train_step`` returns, the
supervised cell the one from ``make_train_step``, both on
``create_train_state(model, make_optimizer("adam", lr))``, where the model
is the configuration's family's ``port_model``. The benchmark's weights and
MANO arrays are loaded into the port's own objects.

``fault`` plants one of the faults that the comparison must catch (the
tests and ``calibrate.py`` use it; a benchmark run never does):
``unchanged`` (the step returns its state as it was), ``half_batch`` (the
step sees the first half of each batch's rows, the means taken over them)
and ``altered`` (the supervised loss the step produces is scaled by 1.05).
"""

from __future__ import annotations

import contextlib

import torch

from harness import families

FAULTS = ("unchanged", "half_batch", "altered")


def build(cfg: dict, kind: str, mano: dict, weights: dict, device, log=None):
    """(state, step) of the port for this configuration and step kind;
    ``log`` gets the seconds of each part."""
    import time

    t0 = time.time()
    from hocon_torch.geometry.mano import ManoModel
    from hocon_torch.train.state import create_train_state, make_optimizer
    from hocon_torch.train.steps import make_train_step, make_warp_train_step

    tr = cfg["training"]
    lam = tr["lambdas"]
    hand = {"lambda_verts3d": lam["verts3d"], "lambda_joints3d": lam["joints3d"],
            "lambda_joints2d": lam["joints2d"], "lambda_shape": lam["shape"],
            "lambda_pose": lam["pose"]}
    obj = {"lambda_obj_verts3d": lam["obj_verts3d"]}
    t1 = time.time()
    model = families.load(cfg).port_model(cfg, device)
    t2 = time.time()
    model.load_state_dict(weights, strict=True)
    mano_model = ManoModel(**mano)
    spec = make_optimizer(tr["optimizer"], tr["lr"])
    state = create_train_state(model, spec)
    if log is not None:
        log(f"set-up: the program's imports {t1 - t0:.3f} s, the model {t2 - t1:.3f} s, "
            f"weights and train state {time.time() - t2:.3f} s")
    if kind == "warp":
        size = cfg["data"]["image_size"]
        step = make_warp_train_step(
            model, mano_model, spec, image_size=(size, size), hand_lambdas=hand,
            obj_lambdas=obj, lambda_consist=tr["lambda_consist"],
            consist_gt_refs=tr["consist_gt_refs"], sigma=tr["sigma"], gamma=tr["gamma"],
            backend="auto", backface_cull=tr["backface_cull"], device=device)
        return state, step
    sup = make_train_step(model, mano_model, spec, hand_lambdas=hand, obj_lambdas=obj,
                          device=device)
    return state, lambda st, batch: sup(st, batch["ref"])


def adam_first_moments(state) -> list[torch.Tensor]:
    """Each leaf's first moment, in ``model.parameters()`` order."""
    opt = state.optimizer
    return [opt.state[p]["exp_avg"] for p in state.model.parameters()]


def launch_counts() -> dict:
    """The K1-K4 wrappers' launch counters."""
    from hocon_torch.render import raster_cuda, sample_cuda

    return {"K1": raster_cuda.raster_fwd.launches, "K2": raster_cuda.raster_bwd.launches,
            "K3": sample_cuda.sample_fwd.launches, "K4": sample_cuda.sample_bwd.launches}


@contextlib.contextmanager
def k1_inputs(record: list):
    """Hold a reference to the arguments of every K1 launch in the block (no
    copy, no device work), for the needed-pairs count of the raster roofline."""
    from hocon_torch.render import raster_cuda

    orig = raster_cuda.raster_fwd_cuda

    def held(coeffs, bounds, krange, image_size, sigma, gamma, config, **kw):
        record.append((coeffs, bounds, krange, image_size, sigma, gamma))
        return orig(coeffs, bounds, krange, image_size, sigma, gamma, config, **kw)

    raster_cuda.raster_fwd_cuda = held
    try:
        yield
    finally:
        raster_cuda.raster_fwd_cuda = orig


@contextlib.contextmanager
def planted(fault: str | None, step):
    """``step`` with ``fault`` planted under it, undone on exit."""
    if fault is None:
        yield step
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}: expected one of {FAULTS}")
    from hocon_torch.train import steps

    if fault == "half_batch":
        def half(view):
            return {k: v[: v.shape[0] // 2] for k, v in view.items()}

        yield lambda st, batch: step(st, {k: half(v) for k, v in batch.items()})
        return
    name, orig = {"unchanged": ("_update", steps._update),
                  "altered": ("total_supervised_loss", steps.total_supervised_loss)}[fault]

    if fault == "unchanged":
        def patched(state, loss, terms, mesh=None):
            return state, {k: v.detach() for k, v in terms.items()}
    else:
        def patched(*args, **kw):
            total, terms = orig(*args, **kw)
            return total * 1.05, terms

    setattr(steps, name, patched)
    try:
        yield step
    finally:
        setattr(steps, name, orig)
