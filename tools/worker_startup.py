#!/usr/bin/env python3
"""How long the data-loader workers take to start, by start method.

    python3 tools/worker_startup.py [--workers N] [--frames 64] [--out DIR]   # one CUDA card

Writes ``chip_smoke.py``'s FPHAB tree (3 + 1 sequences of ``--frames``
1920 x 1080 nvJPEG frames), then, each in a fresh process as a CLI call
is, for the start method ``data/pipeline.py`` uses (``forkserver``) and
for ``spawn`` in its place, with the frames decoded on the card and (for
the forkserver) on the CPU: builds the FPHAB train set (pairs of 256^2
crops, the MANO model on the card) and times ``WorkerEpochLoader``'s first
batch of 16 pairs and the next N - 1 batches. Each worker records when it
had unpickled the dataset (its interpreter up, its imports done), when it
began its first sample and when it finished it, printed relative to the
loader's creation: workers that start one after another show as ready
times spaced apart. It times
``python -c "import torch"`` first. Each line ends with the card's
``nvidia-smi`` name and power limit. ``--workers`` defaults to
``chip_smoke.worker_count()``.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (start method, where the frames decode, whether this process assembles a
# batch first, as chip_smoke.py's workers phase does before its loader)
RUNS = (("forkserver", "cuda", False), ("spawn", "cuda", False), ("forkserver", "cpu", False),
        ("forkserver", "cuda", True), ("spawn", "cuda", False), ("forkserver", "cuda", False))


def process_age() -> float:
    """Seconds since this process was created (Linux: its start in clock
    ticks since boot, against the boot-time clock)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")


class TimedDataset:
    """``dataset`` that times each worker's start: every unpickled copy (one
    per worker) appends a line to ``log`` when its first sample is done:
    when it was unpickled (the worker's interpreter ready, its imports
    done), when the first sample began and when it ended, in seconds since
    the epoch, and how old the worker's process was when it was unpickled
    (a worker forked from a server that preloaded torch is ready at once;
    one that imports torch itself takes seconds)."""

    def __init__(self, dataset, log: str):
        self.dataset, self.log, self._ready = dataset, log, None

    def __setstate__(self, state):
        self.__dict__.update(state, _ready=time.time(), _age=process_age())

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        t0 = time.time()
        item = self.dataset[i]
        if self._ready is not None:
            with open(self.log, "a") as fh:
                fh.write(f"{os.getpid()} {self._ready} {t0} {time.time()} {self._age}\n")
            self._ready = None
        return item


def child(method: str, decode: str, warm: bool, tree: str, workers: int, smi: str) -> None:
    """One measurement, in this fresh process."""
    import torch

    import chip_smoke as CS
    from hocon_torch.data import pipeline
    from hocon_torch.data.factory import get_dataset
    from hocon_torch.geometry.mano import synthetic_mano_model

    if method == "spawn":
        pipeline._worker_context = lambda: multiprocessing.get_context("spawn")
    ds = get_dataset("fhbhands", "train", tree, CS.RES, fraction=0.25, use_objects=True,
                     pair_mode=True, mano=synthetic_mano_model(0, device="cuda"),
                     device="cuda")
    ds.cfg.decode_device = torch.device(decode)
    if warm:
        next(pipeline.BatchLoader(ds, CS.PAIRS, prefetch=0).epoch(0))
    log = os.path.join(os.path.dirname(tree), f"{method}-{decode}-{os.getpid()}.txt")
    t0 = time.time()
    with pipeline.WorkerEpochLoader(TimedDataset(ds, log), CS.PAIRS,
                                    worker_count=workers) as loader:
        batches = loader.epoch(0)
        next(batches)
        t1 = time.time()
        n_next = min(workers, loader.steps_per_epoch()) - 1
        for _ in range(n_next):
            next(batches)
        t2 = time.time()
    with open(log) as fh:
        rows = sorted([float(v) for v in line.split()[1:]] for line in fh)
    per_worker = "; ".join(f"{a - t0:.2f} / {b - t0:.2f} / {c - t0:.2f} (age {age:.2f})"
                           for a, b, c, age in rows)
    CS.log(f"worker_startup: {method}, {workers} workers decoding on {decode}: the first batch "
           f"of {CS.PAIRS} pairs {t1 - t0:.2f} s, the next {n_next} "
           f"{t2 - t1:.2f} s{' (a batch assembled in this process first)' if warm else ''}; per "
           f"worker, s after the loader's creation: ready / first sample begun / done (the "
           f"process's age when ready): {per_worker}; card {smi}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=0, help="0: chip_smoke.worker_count()")
    ap.add_argument("--frames", type=int, default=64, help="frames per FPHAB sequence")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "hocon_torch", "worker_startup"),
                    help="directory for the tree (removed at the end)")
    ap.add_argument("--child", nargs=5, metavar=("METHOD", "DECODE", "WARM", "TREE", "SMI"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as CS

    workers = args.workers or CS.worker_count()[1]
    if args.child:
        method, decode, warm, tree, smi = args.child
        child(method, decode, warm == "1", tree, workers, smi)
        return
    import torch

    from hocon_torch.geometry.mano import synthetic_mano_model

    if not torch.cuda.is_available():
        CS.fail("worker_startup runs on a CUDA card")
    smi = CS.phase_device(torch)
    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="startup-", dir=args.out)
    try:
        tree = os.path.join(work, "fphab")
        CS.write_fphab_tree(torch, "cuda", synthetic_mano_model(0, device="cuda"), tree,
                            args.frames)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import torch"], check=True)
        CS.log(f"worker_startup: python -c 'import torch' {time.perf_counter() - t0:.2f} s; "
               f"card {smi}")
        for method, decode, warm in RUNS:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--workers", str(workers),
                            "--child", method, decode, str(int(warm)), tree, smi], check=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
