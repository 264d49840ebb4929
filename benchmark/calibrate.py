#!/usr/bin/env python3
"""Readings for the comparison's limits, on the card at the cell's sizes.

    python3 benchmark/calibrate.py --workload CELL --seeds N [N ...] [--who ...]

For each seed, in one process: the reference's first steps, then each of
``--who`` compared with it, one JSON line each:

- ``program``: the port as a run drives it (sound runs: the lower reading);
- ``control``: the reference itself with its float32 parts in TF32, the
  nearest precision below the configuration's (float32, TF32 off);
- ``half_batch``, ``altered``, ``unchanged``: the port with that fault
  planted (``harness/program.py``).

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run as bench  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--who", nargs="+", default=["program", "control", "half_batch"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg, _ = bench.load_cell(args.workload)
    if bench.ROOT not in sys.path:
        sys.path.insert(0, bench.ROOT)
    import torch

    from harness import compare, program, scene
    from reference import step as reference

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    kind = cfg["traffic"]["step"]
    n = bench.CHECKED_STEPS
    for seed in args.seeds:
        t0 = time.time()
        mano = scene.mano_arrays(seed, dev)
        pool = scene.batch_pool(cfg, mano, seed, dev)[:n]
        ref = reference.run_steps(cfg, kind, mano, scene.weights(cfg, seed, dev), pool, dev)
        for who in args.who:
            t1 = time.time()
            if who == "control":
                got = reference.run_steps(cfg, kind, mano, scene.weights(cfg, seed, dev), pool,
                                          dev, tf32=True)
            else:
                state, step = program.build(cfg, kind, mano, scene.weights(cfg, seed, dev), dev)
                fault = None if who == "program" else who
                with program.planted(fault, step) as planted:
                    got = bench.checked_steps(torch, program, state, planted, pool)
                del state, step
                gc.collect()
            nums, why = compare.numbers(got, ref)
            print(json.dumps({"workload": args.workload, "seed": seed, "who": who,
                              "numbers": nums, "worst": why,
                              "seconds": round(time.time() - t1, 2)}), flush=True)
        print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
