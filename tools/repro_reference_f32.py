#!/usr/bin/env python3
"""The reference's consistency-gain ablation, unmodified, in f32 on the CPU,
at the TPU record's regime: does ``hocon`` itself learn what the port
learns, or what the TPU learned?

The TPU record (``measurements/tpu_batch_r5c.log``, ``r5e``) is
``scripts/repro_synthetic_consistency.py`` at 128 px, batch 16, stages of
300 + 300 + 300 steps, 8 videos of 16 frames, 1 of 8 annotated
(``scripts/tpu_batch_r5c.sh``, ``r5e.sh``: ``--frames 16 --fraction
0.125``). This tool loads that script by path, overrides none of its
constants, and calls its ``main(seed, obj_faces=0, fraction=0.125,
frames=16)`` under ``JAX_PLATFORMS=cpu``. Off the TPU the script runs in
f32 with no edit: ``backend="auto"`` resolves to ``"xla"``, the warp
sampler is the f32 gather, and XLA's CPU dots compute f32 products at the
``DEFAULT`` precision (the trunk's bf16 convolutions are the model's own,
as on the TPU and in the port).

Each seed runs in a subprocess of its own, pinned to its share of the cores
(``os.sched_setaffinity`` before JAX starts, so XLA's thread pool is sized
to that share), with ``HOCON_CACHE_DIR`` pointed at a temporary directory
that is removed afterwards: the datasets are rendered again and nothing is
written into the repo or the user's cache. ``--parallel N`` runs N seeds at
a time from the queue, each on ``cores / N`` cores. The script's own
``[stage] step N loss=`` lines, a ``[progress]`` line every
``PROGRESS_EVERY`` calls of each step function (its loss and the mean
seconds a step), and each seed's JSON line as soon as it finishes go to the
log.

    nohup python -u tools/repro_reference_f32.py 0 1 2 3 --parallel 2 > LOG 2>&1 &
    python tools/repro_reference_f32.py --summary LOG [LOG ...]

``--summary`` reads the seeds that have finished and prints, per seed and as
the mean over them, the unannotated-frame MPJPE (mm) of the baseline, the
control, the warp stage and the gain for four runs: the TPU record, this f32
reference on the CPU, the port on the card
(``measurements/torch_repro_box_pr13.log``, else ``torch_repro_box_pr10.log``), and the port with
the TPU's bf16 rounding of G2 + G3 (``measurements/torch_tpu_rounding_pr12.log``).
It ends with ``verdict()``'s rule on the means over the seeds the reference
finished.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(HERE, "scripts", "repro_synthetic_consistency.py")
# The TPU record's regime: the script's constants as they stand, and the
# flags of scripts/tpu_batch_r5c.sh / r5e.sh at fraction 0.125.
RECORD_CONSTANTS = dict(RES=128, BATCH=16, STEPS_BASE=300, STEPS_WARP=300, VIDEOS=8)
RECORD_ARGS = dict(obj_faces=0, fraction=0.125, frames=16)
PROGRESS_EVERY = 20
MEASUREMENTS = os.path.join(HERE, "measurements")
PORT_LOGS = [os.path.join(MEASUREMENTS, "torch_repro_box_pr13.log"),
             os.path.join(MEASUREMENTS, "torch_repro_box_pr10.log")]
ROUNDED_LOG = os.path.join(MEASUREMENTS, "torch_tpu_rounding_pr12.log")
ROUNDED_GROUPS = ("G2", "G3")
FAITHFUL_MM, APART_MM = 1.0, 2.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_reference():
    """A fresh module of the reference script, loaded by path."""
    spec = importlib.util.spec_from_file_location("repro_synthetic_consistency", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_constants(mod) -> None:
    """Refuse to run if the script's regime is not the TPU record's."""
    found = {k: getattr(mod, k) for k in RECORD_CONSTANTS}
    if found != RECORD_CONSTANTS:
        raise RuntimeError(f"reference constants {found} differ from the TPU record's "
                           f"{RECORD_CONSTANTS}")


def _timed(step, kind: str):
    """``step`` that logs its loss and mean seconds every ``PROGRESS_EVERY``
    calls; it reads the loss on the host there and changes nothing else."""
    calls, t0 = 0, time.time()

    def run(state, batch):
        nonlocal calls, t0
        state, terms = step(state, batch)
        calls += 1
        if calls % PROGRESS_EVERY == 0:
            loss = float(terms["loss_total"])
            now = time.time()
            log(f"[progress] {kind} call {calls} loss={loss:.3f} "
                f"{(now - t0) / PROGRESS_EVERY:.2f} s/step")
            t0 = now
        return state, terms

    return run


def with_progress(mod) -> None:
    """Wraps the step functions of the script's engine in ``_timed``."""
    engine = mod._engine

    def timed_engine(*args, **kwargs):
        eng = engine(*args, **kwargs)
        if not eng.get("_timed"):
            eng["step_base"] = _timed(eng["step_base"], "supervised")
            eng["step_warp"] = _timed(eng["step_warp"], "warp")
            eng["_timed"] = True
        return eng

    mod._engine = timed_engine


def worker(seed: int, cores: list[int]) -> None:
    """One seed of the reference, in this process, on ``cores``."""
    os.sched_setaffinity(0, cores)
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, HERE)
    import jax

    jax.config.update("jax_platforms", "cpu")
    mod = load_reference()
    check_constants(mod)
    with_progress(mod)
    log(f"seed {seed}: jax {jax.__version__} on {jax.devices()}, cores {cores}, "
        f"HOCON_CACHE_DIR {os.environ.get('HOCON_CACHE_DIR')}")
    t0 = time.time()
    mod.main(seed, **RECORD_ARGS)
    log(f"seed {seed}: done in {time.time() - t0:.0f}s")


def cpu_model() -> str:
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
    for line in out.splitlines():
        if line.startswith("Model name:"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def worker_env(cache_dir: str) -> dict:
    """The subprocess's environment: the CPU platform and its own cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOCON_CACHE_DIR=cache_dir,
               PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (HERE, env.get("PYTHONPATH")) if p)
    return env


def split_cores(parallel: int) -> list[list[int]]:
    cores = sorted(os.sched_getaffinity(0))
    share = max(1, len(cores) // parallel)
    return [cores[i * share:(i + 1) * share] for i in range(parallel)]


def run_seed(seed: int, cores: list[int], out_lock: threading.Lock) -> int:
    """Runs one seed's subprocess; its stderr lines go to ours with the
    seed in front, its JSON line to our stdout as soon as it is printed."""
    cache_dir = tempfile.mkdtemp(prefix=f"hocon-ref-f32-seed{seed}-")
    cmd = [sys.executable, "-u", os.path.abspath(__file__), "--worker", str(seed),
           "--cores", ",".join(map(str, cores))]
    try:
        proc = subprocess.Popen(cmd, env=worker_env(cache_dir), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, cwd=HERE)
        for line in proc.stdout:
            with out_lock:
                if line.startswith("{"):
                    sys.stdout.write(line)
                    sys.stdout.flush()
                else:
                    log(f"[seed {seed}] {line.rstrip()}")
        return proc.wait()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run(seeds: list[int], parallel: int) -> int:
    shares = split_cores(parallel)
    log(f"CPU: {cpu_model()}, {len(os.sched_getaffinity(0))} cores; {parallel} seeds at a "
        f"time, pinned to {shares} (os.sched_setaffinity: XLA's CPU thread pool takes the "
        f"share's size)")
    log(f"reference {os.path.relpath(SCRIPT, HERE)}: constants {RECORD_CONSTANTS} as they "
        f"stand, main(seed, **{RECORD_ARGS})")
    todo: queue.Queue = queue.Queue()
    for s in seeds:
        todo.put(s)
    lock, rcs = threading.Lock(), {}

    def slot(cores):
        while True:
            try:
                seed = todo.get_nowait()
            except queue.Empty:
                return
            t0 = time.time()
            rcs[seed] = run_seed(seed, cores, lock)
            with lock:
                log(f"seed {seed}: exit {rcs[seed]} after {time.time() - t0:.0f}s on cores {cores}")

    threads = [threading.Thread(target=slot, args=(c,)) for c in shares]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return max(rcs.values(), default=0)


# ---- summary ----------------------------------------------------------------


def verdict(ref: tuple[float, float], port: tuple[float, float],
            tpu: tuple[float, float]) -> str:
    """The f32 reference's rule of PERF.md section 6 on the means (warp, gain) in mm
    of the f32 reference R, the port P and the TPU record T over the same
    seeds."""
    (rw, rg), (pw, pg), (_, tg) = ref, port, tpu
    near_port = abs(rw - pw) <= FAITHFUL_MM and abs(rg - pg) <= FAITHFUL_MM
    if near_port and abs(rg - tg) >= APART_MM:
        return "faithful"
    if abs(rg - tg) <= FAITHFUL_MM and (abs(rw - pw) >= APART_MM or abs(rg - pg) >= APART_MM):
        return "port fault"
    return "undecided"


VERDICT_TEXT = {
    "faithful": "the port is faithful to the JAX package; the excess over the TPU is the "
                "TPU's rounding",
    "port fault": "the f32 reference lands on the TPU: the port has a fault at this regime",
    "undecided": "undecided: add the next pair of seeds",
}


def summary(paths) -> list[str]:
    import numpy as np

    from tools.repro_tpu_rounding import FIGURES, TPU_LOGS, _records

    box = (0, 0.125, 16)
    ref = _records(paths, box)
    port_logs = [next(p for p in PORT_LOGS if os.path.exists(p))]
    # The port's lines: the repro tool's own, or the rounding tool's with no
    # group rounded (its counters read around every step).
    port = {**_records(port_logs, box), **_records(port_logs).get((), {})}
    tpu = _records(TPU_LOGS, box)
    rounded = _records([ROUNDED_LOG]).get(ROUNDED_GROUPS, {})
    runs = (("TPU record", tpu), ("f32 reference, CPU", ref),
            ("port, H100", port), ("port G2+G3 rounded, H100", rounded))
    fmt = lambda v: " / ".join(f"{x:6.2f}" for x in v)  # noqa: E731
    nan4 = [float("nan")] * 4

    def cells(recs, seed):
        if seed not in recs:
            return nan4
        r = recs[seed]["record"] if "record" in recs[seed] else recs[seed]
        return [float(r[FIGURES[k]]) for k in FIGURES]

    seeds = sorted(ref)
    lines = [f"f32 reference seeds finished: {seeds}; port logs "
             f"{[os.path.relpath(p, HERE) for p in port_logs]}",
             "unannotated MPJPE (mm): baseline / control / warp / gain"]
    table = np.asarray([[cells(recs, s) for _, recs in runs] for s in seeds] or
                       np.zeros((0, len(runs), 4)), np.float64)
    for i, seed in enumerate(seeds):
        lines.append(f"  seed {seed}:")
        for j, (name, _) in enumerate(runs):
            lines.append(f"    {name:26s} {fmt(table[i, j])}")
    if not seeds:
        lines.append("  no seed of the f32 reference has finished")
        return lines
    if port_logs[0] != PORT_LOGS[-1]:
        earlier = _records([PORT_LOGS[-1]], box)
        diffs = "; ".join(f"seed {s} {cells(port, s)[2] - cells(earlier, s)[2]:+.2f}, "
                          f"{cells(port, s)[3] - cells(earlier, s)[3]:+.2f}" for s in sorted(port))
        lines.append(f"  port minus {os.path.basename(PORT_LOGS[-1])} (warp, gain; mm): {diffs}")
    mean = table.mean(axis=0)
    lines.append(f"  mean over seeds {seeds}:")
    for j, (name, _) in enumerate(runs):
        lines.append(f"    {name:26s} {fmt(mean[j])}")
    t, r, p = ((float(mean[j, 2]), float(mean[j, 3])) for j in range(3))
    v = verdict(r, p, t)
    lines.append(f"  |R-P| warp {abs(r[0] - p[0]):.2f} gain {abs(r[1] - p[1]):.2f}; "
                 f"|R-T| gain {abs(r[1] - t[1]):.2f} (faithful: |R-P| <= {FAITHFUL_MM} both, "
                 f"|R-T| >= {APART_MM}; fault: |R-T| <= {FAITHFUL_MM}, |R-P| >= {APART_MM})")
    lines.append(f"  verdict: {VERDICT_TEXT[v]}")
    lines.append(json.dumps({"seeds": seeds, "ref_warp_mm": round(r[0], 4),
                             "ref_gain_mm": round(r[1], 4), "port_warp_mm": round(p[0], 4),
                             "port_gain_mm": round(p[1], 4), "tpu_warp_mm": round(t[0], 4),
                             "tpu_gain_mm": round(t[1], 4), "verdict": v}))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("repro_reference_f32")
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--parallel", type=int, default=2,
                    help="seeds run at a time, each on its share of the cores")
    ap.add_argument("--summary", nargs="+", metavar="LOG")
    ap.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--cores", help=argparse.SUPPRESS)
    cli = ap.parse_args(argv)
    if cli.summary:
        if HERE not in sys.path:
            sys.path.insert(0, HERE)
        for line in summary(cli.summary):
            print(line, flush=True)
        return 0
    if cli.worker is not None:
        worker(cli.worker, [int(c) for c in cli.cores.split(",")])
        return 0
    return run(cli.seeds or [0, 1], cli.parallel)


if __name__ == "__main__":
    sys.exit(main())
