"""The measured window and the traced stretch.

``window`` runs the closed loop: each step follows the last, on the pool's
batches in turn, for ``seconds`` of the host clock; a CUDA event recorded
at every step boundary times each step, read once the window has closed.

``traced`` runs a short stretch under ``torch.profiler`` after the window:
one traced warm-up step (the tracer loses its first events), then
``steps`` steps, each ended by a device synchronise so that its work falls
inside the stretch, in a single profiler cycle. Nothing of the harness
runs in the traced steps: no event records, no reads of the step's terms.
``summarize`` reduces the profile to what the per-layer readers take.
"""

from __future__ import annotations

import bisect
import time

import torch

CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize")
KERNELS = {"K1": "raster_fwd_kernel", "K2": "raster_bwd_kernel",
           "K3": "sample_fwd_kernel", "K4": "sample_bwd_kernel"}


def window(state, step, pool: list, seconds: float, start: int, log, on_card: bool) -> dict:
    """Steps for ``seconds``; returns the count, the wall time, each step's
    time (between CUDA events on the card, the host clock elsewhere), the
    last step's terms, and logs the host ms a step in each second."""
    n_marks = int(seconds * 400) + 2
    if on_card:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_marks)]
        torch.cuda.synchronize()
    else:
        marks = [0.0] * n_marks

    def mark(k):
        if on_card:
            marks[k].record()
        else:
            marks[k] = time.perf_counter()

    pace, n, i, terms = [], 0, start, None
    t0 = time.perf_counter()
    mark(0)
    sec, sec_n = t0, 0
    while True:
        state, terms = step(state, pool[i % len(pool)])
        i += 1
        n += 1
        if n < n_marks:
            mark(n)
        now = time.perf_counter()
        if now - sec >= 1.0:
            pace.append((now - sec) * 1e3 / (n - sec_n))
            sec, sec_n = now, n
        if now - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = min(n, n_marks - 1)
    if on_card:
        per_step = [marks[k].elapsed_time(marks[k + 1]) for k in range(timed)]
    else:
        per_step = [(marks[k + 1] - marks[k]) * 1e3 for k in range(timed)]
    log("window: host ms a step in each second: " + " ".join(f"{p:.1f}" for p in pace))
    return {"steps": n, "wall_s": wall, "step_ms": per_step, "next": i, "last_terms": terms}


def traced(state, step, pool: list, steps: int, start: int, record_k1, on_card: bool) -> dict:
    """Profile ``steps`` steps; returns the profiler's events, the traced
    stretch's host seconds and the K1-K4 counter deltas over it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from harness import program

    def sync():
        if on_card:
            torch.cuda.synchronize()

    got = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=steps, repeat=1),
                 on_trace_ready=lambda p: got.setdefault("events", p.events())) as prof:
        state, _ = step(state, pool[start % len(pool)])
        sync()
        prof.step()
        before = program.launch_counts()
        t0 = time.perf_counter()
        with record_k1:
            for k in range(1, steps + 1):
                state, _ = step(state, pool[(start + k) % len(pool)])
                sync()
                if k == steps:  # the last step closes the cycle and parses the trace
                    span = time.perf_counter() - t0
                prof.step()
        after = program.launch_counts()
    return {"events": got["events"], "span_s": span,
            "counters": {k: after[k] - before[k] for k in after}}


def _total_device_us(e) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def _is_device(e) -> bool:
    return e.device_type.name in ("CUDA", "PrivateUse1") and not getattr(
        e, "is_user_annotation", False) and "#" not in e.name


def summarize(events, steps: int, top: int = 10) -> dict:
    """Per-step launches, syncs, device busy ms and conv ms; kernel time by
    name; the longest idle gaps by the host op running in them."""
    dev = [e for e in events if _is_device(e)]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    by_name: dict[str, list] = {}
    for e in kernels:
        s = by_name.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += e.time_range.end - e.time_range.start
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    union = []
    for a, b in spans:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    busy = sum(b - a for a, b in union)
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type.name == "CPU" and not e.name.startswith("ProfilerStep"))
    starts = [c[0] for c in cpu]
    gaps: dict[str, float] = {}
    for (_, a), (b, _) in zip(union[:-1], union[1:]):
        mid = (a + b) / 2
        name = "host outside any op"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(last - 256, -1), -1):  # the innermost op open at mid
            if cpu[j][1] >= mid:
                name = cpu[j][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    conv_us = sum(_total_device_us(e) for e in events
                  if e.device_type.name == "CPU" and e.name in CONV_OPS)
    named = {k: [0, 0.0] for k in KERNELS}
    for name, (cnt, us) in by_name.items():
        for k, frag in KERNELS.items():
            if frag in name:
                named[k][0] += cnt
                named[k][1] += us
    return {
        "steps": steps,
        "launches": len(kernels) / steps,
        "syncs": sum(1 for e in events if e.name in SYNC_CALLS) / steps,
        "busy_ms": busy / 1e3 / steps,
        "busy_s": busy / 1e6,
        "conv_ms": conv_us / 1e3 / steps if conv_us > 0 else None,
        "kernel_launches": {k: v[0] for k, v in named.items()},
        "kernel_ms": {k: v[1] / 1e3 for k, v in named.items()},
        "device_ops": sorted(([n[:160], us / 1e6] for n, (_, us) in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n[:160], us / 1e6] for n, us in gaps.items()),
                            key=lambda x: -x[1])[:top],
    }
