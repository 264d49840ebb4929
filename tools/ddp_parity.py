#!/usr/bin/env python3
"""``trainwarp`` on N data-parallel ranks against one process: parity and
step rate.

Runs the same ``hocon_torch.cli.trainwarp`` command line twice, each in a
run directory of its own under ``--work``: once as one process with no
process group, once under ``python -m torch.distributed.run --standalone
--nproc_per_node N`` (one rank per card, NCCL; gloo with ``--device cpu``,
where the ranks share the host). Then it prints each run's wall time and
``steps_per_sec`` per epoch (``epochs.json``), and the last checkpoint's
weights of the N-rank run against the one-process run's: the error over
all tensors and the largest per tensor, relative to the one-process run's
update from the initial weights (``build_model``, ``--seed``), and whether
they are equal bit for bit.

    python3 tools/ddp_parity.py --nproc 4 [--device cpu] [--work DIR] -- \\
        --dataset synthetic --image_size 256 --batch_size 16 --use_objects ...

The flags after ``--`` are ``trainwarp``'s; ``--exp_id`` is set here. On
the card it prints the ``nvidia-smi`` name and power limit first. Prints
one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __package__ in (None, ""):
    sys.path.insert(0, HERE)

EXP = "ddp"


def _worker(argv, device) -> None:
    """One process of a run: ``trainwarp.main`` on ``device`` (None: the
    card), under the process group its environment names, if any."""
    from hocon_torch.cli import trainwarp

    trainwarp.main(argv, device=device)


def _run(cmd, cwd, env) -> tuple[float, str]:
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=3000)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} exited {r.returncode}:\n{r.stderr[-4000:]}")
    return seconds, r.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("ddp_parity")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default=None, help="cpu, or the card when not given")
    ap.add_argument("--work", default=os.path.join(HERE, "build", "hocon_torch", "ddp_parity"))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("flags", nargs=argparse.REMAINDER)
    cli = ap.parse_args(argv)
    flags = [f for f in cli.flags if f != "--"] + ["--exp_id", EXP]
    if cli.worker:
        _worker(flags, cli.device)
        return 0

    import torch

    from hocon_torch.cli.train import build_model
    from hocon_torch.cli.trainwarp import build_parser
    from hocon_torch.geometry.mano import synthetic_mano_model

    if cli.device is None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(smi, flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    me = [os.path.abspath(__file__), "--worker"]
    me += ["--device", cli.device] if cli.device else []
    runs = {"1 process": [sys.executable, *me, "--", *flags],
            f"{cli.nproc} ranks": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                   "--nproc_per_node", str(cli.nproc), *me, "--", *flags]}
    results = {}
    for i, (name, cmd) in enumerate(runs.items()):
        cwd = os.path.join(cli.work, f"run{i}")
        os.makedirs(cwd, exist_ok=True)
        seconds, out = _run(cmd, cwd, env)
        for line in out.splitlines():
            print(f"  {name} | {line}", flush=True)
        run_dir = os.path.join(cwd, "checkpoints", EXP)
        with open(os.path.join(run_dir, "epochs.json")) as fh:
            rates = [e["steps_per_sec"] for e in json.load(fh) if e["split"] == "train"]
        ckpt = os.path.join(run_dir, "ckpt")
        step = max(int(s) for s in os.listdir(ckpt) if s.isdigit())
        state = torch.load(os.path.join(ckpt, str(step), "state.pt"), map_location="cpu",
                           weights_only=False)
        results[name] = dict(seconds=seconds, rates=rates, step=step, model=state["model"])
        print(f"{name}: {seconds:.1f} s for the call, {step} steps, steps_per_sec per epoch "
              f"{[round(r, 3) for r in rates]}", flush=True)

    args = build_parser().parse_args(flags)
    model = build_model(args, synthetic_mano_model(0, device="cpu"), torch.device("cpu"),
                        seed=args.seed)
    init, params = model.state_dict(), [k for k, _ in model.named_parameters()]
    one, many = (results[n]["model"] for n in runs)
    diff = torch.cat([(many[k] - one[k]).double().reshape(-1) for k in params])
    update = torch.cat([(one[k] - init[k]).double().reshape(-1) for k in params])
    per = max(float((many[k] - one[k]).double().norm())
              / max(float((one[k] - init[k]).double().norm()), 1e-30) for k in params)
    equal = all(torch.equal(one[k], many[k]) for k in one)
    whole = float(diff.norm() / update.norm())
    print(f"weights after {results[f'{cli.nproc} ranks']['step']} steps, {cli.nproc} ranks against "
          f"1 process: {whole:.3g} of the update over all {len(params)} tensors, up to {per:.3g} "
          f"in one; bit for bit equal: {equal}", flush=True)
    print(json.dumps({"nproc": cli.nproc, "steps": results["1 process"]["step"],
                      "update_rel_all": whole, "update_rel_max": per, "bitwise": equal,
                      "steps_per_sec": {n: r["rates"] for n, r in results.items()},
                      "seconds": {n: r["seconds"] for n, r in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
