#!/usr/bin/env python3
"""The benchmark of ``hocon_torch``: one cell, one run, one card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell is ``benchmark/workloads/CELL.json``: a configuration
(``benchmark/configs/``), a step kind (``warp``: the photometric-consistency
train step; ``sup``: the supervised train step), the size of its batch
pool and the limits of its comparison. The run:

1. makes the MANO stand-in, the model's weights and a pool of frame-pair
   batches on the card from ``--seed`` (``harness/scene.py``);
2. builds the port's train state and step (``harness/program.py``), takes
   its first three steps on the pool's first batches (the checked steps),
   then warms up on the rest of the pool;
3. measures a closed loop for ``--seconds``: each step follows the last,
   on the pool's batches in turn (``harness/measure.py``);
4. with ``--trace 1``, traces a short stretch after the window and reduces
   it with the per-layer readers under ``benchmark/metrics/``;
5. frees the program, runs the plain-PyTorch reference
   (``benchmark/reference/``) on the same weights and batches and compares
   the checked steps with it (``harness/compare.py``).

A configuration names its model family in ``model.family`` (``hocnet``
without the key); the run finds the family by that name, as it finds a
per-layer reader, and fails with a ``ValueError`` before any device work
where either of its two files is missing. A family is:

- ``benchmark/reference/families/<family>.py``, which imports ``torch``,
  ``numpy`` and ``reference.*`` and nothing of the port or of JAX:
  ``Model(cfg)``, an ``nn.Module`` whose ``forward(images, camintr, mano,
  obj_verts_can=None)`` (NHWC ImageNet-normalised images, intrinsics, the
  MANO arrays as a dict, the object's canonical vertices or None) returns
  ``pose_pca`` (the pose vector that ``lambdas.pose`` regularises),
  ``betas``, ``verts_cam``, ``verts_c_mm``, ``joints_c_mm``, ``joints2d``
  and, with an object, ``obj_verts_cam`` and ``obj_verts_c_mm``, its
  parameters named as in the port's state dict; ``weights(cfg, generator,
  device)``, the seeded state dict, drawn from ``generator``;
  ``flops(cfg, images)``, the model's matrix FLOPs forward and backward
  for ``images`` images (``step.mfu`` divides by them);
- ``benchmark/harness/families/<family>.py``: ``port_model(cfg, device)``,
  the port's model built as a training run builds it, which the port's
  steps call as the reference's is called, with the port's ``ManoModel``
  in place of the dict, and which returns the same keys. For today's
  readers it opens the spans ``model.trunk``, ``model.heads`` and
  ``model.mano`` (``model.host_ms``).

The configuration's ``model.with_object`` says whether the batches carry
the object. The step kinds, the scene, the losses, the render reference,
Adam and the comparison are shared by every family. So a new architecture
joins as a configuration, a cell and a family: new files only.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``, the compared numbers with their limits, which
are also the last lines of standard error. Without a CUDA card the run
exits 2 and prints no result; if ``jax``, ``jaxlib``, ``flax``, ``optax``
or ``hocon`` is loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hocon")
CHECKED_STEPS = 3
TRACE_STEPS = 8
ADAM_B1 = 0.9


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_start() -> float:
    """The process's start on the epoch clock (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict]:
    """(configuration with the cell under ``traffic``, the cell's per-layer
    metric entries of BENCHMARK.json)."""
    cell = _json(os.path.join(HERE, "workloads", f"{name}.json"))
    cfg = _json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    cfg["traffic"] = cell
    spec = _json(os.path.join(ROOT, "BENCHMARK.json"))
    per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
    return cfg, per_layer


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def checked_steps(torch, program, state, step, pool) -> dict:
    """The program's first steps, read for the comparison: each step's loss,
    the first step's terms, each leaf's first-gradient norm from Adam's
    first moment after one step, each leaf's change after the last."""
    names = [k for k, _ in state.model.named_parameters()]
    leaves = [p for _, p in state.model.named_parameters()]
    start = [p.detach().to("cpu", copy=True) for p in leaves]
    losses, terms1, grads1 = [], None, None
    for t in range(CHECKED_STEPS):
        state, terms = step(state, pool[t])
        losses.append(terms["loss_total"].detach())
        if t == 0:
            terms1 = {k: float(v) for k, v in terms.items()}
            grads1 = [float(torch.linalg.vector_norm(m)) / (1.0 - ADAM_B1)
                      for m in program.adam_first_moments(state)]
    change = [float(torch.linalg.vector_norm(p.detach().cpu() - s)) for p, s in zip(leaves, start)]
    return {"losses": [float(x) for x in losses], "terms1": terms1,
            "grads1": dict(zip(names, grads1)), "change": dict(zip(names, change))}


def run(name: str, seed: int, seconds: float, trace: bool, device, fault=None,
        t_start: float | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object. ``device``
    other than CUDA runs the same code path on the plain kernel versions
    (the tests); ``fault`` plants one of ``harness.program.FAULTS``."""
    t_start = time.time() if t_start is None else t_start
    cfg, per_layer = load_cell(name)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from harness import compare, families, measure, program, scene, spans
    from reference import families as reference_families
    from reference import step as reference

    # A family without its two files fails here, before any device work.
    reference_families.load(cfg)
    families.load(cfg)
    torch.set_num_threads(1)
    # The configuration's precision: the trunk in bf16 autocast, the rest
    # float32 with TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    kind = cfg["traffic"]["step"]
    t_build = time.time()
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
        log(f"set-up: CUDA context {time.time() - t_build:.3f} s")
    mano = scene.mano_arrays(seed, dev)
    weights = scene.weights(cfg, seed, dev)
    pool = scene.batch_pool(cfg, mano, seed, dev)
    sync()
    t_inputs = time.time()
    state, step = program.build(cfg, kind, mano, weights, dev, log)
    del weights
    sync()
    t_program = time.time()
    with program.planted(fault, step) as step:
        prog = checked_steps(torch, program, state, step, pool)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        for i in range(CHECKED_STEPS, len(pool)):
            state, terms = step(state, pool[i])
        sync()
        t_ready = time.time()
        setup_s = t_ready - t_start
        log(f"set-up: process start to the cell's build {t_build - t_start:.3f} s")
        log(f"set-up: inputs and weights {t_inputs - t_build:.3f} s")
        log(f"set-up: the program's model, state and step {t_program - t_inputs:.3f} s")
        log(f"set-up: {CHECKED_STEPS} checked steps and {len(pool) - CHECKED_STEPS} warm-up "
            f"steps {t_ready - t_program:.3f} s")
        log(f"{name} seed {seed}: set-up {setup_s:.3f} s on {dev}")

        win = measure.window(state, step, pool, seconds, 0, log, on_card)
        step_ms = win["wall_s"] * 1e3 / win["steps"]
        p95 = statistics.quantiles(win["step_ms"], n=20)[-1] if len(win["step_ms"]) > 1 \
            else win["step_ms"][0]
        log(f"window: {win['steps']} steps, {step_ms:.3f} ms a step, p95 {p95:.3f} ms")
        last_loss = float(win["last_terms"]["loss_total"])
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

        metrics = {"step_ms": {"value": step_ms, "unit": "ms"},
                   "step_p95_ms": {"value": p95, "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        device_rec = {"platform": "gpu" if on_card else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                      "count": 1, "memory_peak_bytes": peak}
        breakdown = None
        if trace:
            held = []
            tr = measure.traced(state, step, pool, TRACE_STEPS, win["next"],
                                program.k1_inputs(held), on_card)
            summary = measure.summarize(tr["events"], TRACE_STEPS)
            summary.update(cfg=cfg, kind=kind, step_ms=step_ms, k1_inputs=held,
                           counters=tr["counters"], spans=spans.spans(tr["events"], TRACE_STEPS))
            log(f"trace: {TRACE_STEPS} steps in {tr['span_s']:.3f} s; K1-K4 launches in the "
                f"trace {summary['kernel_launches']}, by the wrappers' counters "
                f"{tr['counters']}"
                + ("" if summary["kernel_launches"] == tr["counters"] else " (MISMATCH)"))
            spans.report(summary["spans"], log)
            metrics = {}
            for m in per_layer:
                value = load_metric(m["name"]).read(summary)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_rec.update(busy_s=summary["busy_s"], window_s=tr["span_s"])
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
            del held, tr, summary
    del state, step, terms
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref = reference.run_steps(cfg, kind, mano, scene.weights(cfg, seed, dev),
                              pool[:CHECKED_STEPS], dev)
    nums, why = compare.numbers(prog, ref)
    limits = cfg["traffic"]["limits"]
    finite = math.isfinite(last_loss)
    correct = compare.judge(nums, limits) and finite
    for k, v in nums.items():
        if k not in limits:
            log(f"reading {k} {v!r} (not compared){f' (worst: {why[k]})' if k in why else ''}")
    for k, lim in limits.items():
        log(f"check {k} {nums[k]!r} limit {lim!r}{f' (worst: {why[k]})' if k in why else ''}")
    out = {"correct": bool(correct), "attempted": win["steps"],
           "failed": 0 if finite else win["steps"],
           "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": nums[k], "limit": lim} for k, lim in limits.items()}
    return out


def main(argv=None) -> int:
    t_start = process_start()
    log(f"set-up: interpreter start {time.time() - t_start:.3f} s")
    ap = argparse.ArgumentParser("benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = time.time()
    import torch

    log(f"set-up: import torch {time.time() - t0:.3f} s")
    spec = _json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start=t_start)
    found = forbidden_modules()
    if found:
        log(f"loaded once the window had closed: {', '.join(found)}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
