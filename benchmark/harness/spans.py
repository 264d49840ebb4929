"""The port's spans in the traced stretch, reduced per span name.

``hocon_torch`` marks the layers of its step with ``record_function``
ranges while a profiler runs (``hocon_torch/utils/trace.py``): ``step.*``
around a whole step, and inside it ``step.inputs``, ``model.*``,
``loss.supervised``, ``render.*``, ``step.backward`` and ``optim.update``
(``data.*`` in the CLIs' epoch loop). Backward work has no span of its
own: each autograd node (``autograd::engine::evaluate_function: ...``) is
charged to the innermost span that holds the forward op with its sequence
number on its forward thread. ``spans`` gives, per span name and step:

- ``host_ms``: the ranges' host time, plus that of the backward nodes
  charged to the span;
- ``self_ms``: ``host_ms`` less the part its child spans cover;
- ``device_ms``, ``launches``: the device time and count of the kernels
  launched inside the span or its children, or from a backward node
  charged to one of them (a kernel is matched to its launch by
  correlation id);
- ``syncs``: ``cudaStreamSynchronize`` / ``cudaEventSynchronize`` calls in
  the same places;
- ``idle_ms``: the card's idle gaps charged to the span alone: a gap goes
  to the backward node open at its midpoint, through it to its span, and
  else to the innermost span open then; each gap to one span only;
- ``count`` (ranges a step) and ``parent`` (the enclosing span's name).

Work charged to no span is under ``NONE``. A program without spans gives
``NONE`` alone.

``run.run`` reduces the traced stretch into ``summary["spans"]`` and logs
one line per span (``report``); the per-layer readers take ``of(summary)``.
"""

from __future__ import annotations

import bisect

from harness.measure import SYNC_CALLS, _is_device

PREFIXES = ("step.", "model.", "loss.", "render.", "optim.", "data.")
NODE = "autograd::engine::evaluate_function: "
NONE = "(none)"
NEVER = float("-inf")  # a time no range holds


def _innermost(intervals: list, times: list) -> list:
    """For each time, the index of the innermost of ``intervals`` ((start,
    end, thread) tuples; nested within a thread) that holds it, or -1.
    Among threads, the one that started last."""
    out = [-1] * len(times)
    begun = [float("-inf")] * len(times)
    threads: dict = {}
    for i, iv in enumerate(intervals):
        threads.setdefault(iv[2], []).append(i)
    queries = sorted(range(len(times)), key=times.__getitem__)
    for idx in threads.values():
        idx.sort(key=lambda i: (intervals[i][0], -intervals[i][1]))
        stack, j = [], 0
        for q in queries:
            t = times[q]
            while j < len(idx) and intervals[idx[j]][0] <= t:
                while stack and intervals[stack[-1]][1] < intervals[idx[j]][1]:
                    stack.pop()
                stack.append(idx[j])
                j += 1
            while stack and intervals[stack[-1]][1] < t:
                stack.pop()
            if stack and intervals[stack[-1]][0] > begun[q]:
                out[q], begun[q] = stack[-1], intervals[stack[-1]][0]
    return out


def _parents(intervals: list) -> list:
    """Each interval's enclosing interval on its thread, or -1."""
    order = sorted(range(len(intervals)), key=lambda i: (intervals[i][0], -intervals[i][1]))
    parent, stacks = [-1] * len(intervals), {}
    for i in order:
        stack = stacks.setdefault(intervals[i][2], [])
        while stack and intervals[stack[-1]][1] < intervals[i][1]:
            stack.pop()
        if stack:
            parent[i] = stack[-1]
        stack.append(i)
    return parent


def spans(events, steps: int) -> dict:
    """Per span name, the figures of the module's docstring over ``steps``."""
    cpu = [e for e in events if e.device_type.name == "CPU"]
    marks = [e for e in cpu if e.name.startswith(PREFIXES)]
    iv = [(e.time_range.start, e.time_range.end, e.thread) for e in marks]
    parent = _parents(iv)

    # Backward nodes -> the span of their forward op.
    nodes = [e for e in cpu if e.name.startswith(NODE) and e.sequence_nr >= 0]
    fwd: dict = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(NODE):
            fwd.setdefault((e.thread, e.sequence_nr), []).append(e.time_range.start)
    for starts in fwd.values():
        starts.sort()
    origin = []  # the last forward op of the node's key to start before it
    for n in nodes:
        starts = fwd.get((n.fwd_thread, n.sequence_nr), [])
        k = bisect.bisect_left(starts, n.time_range.start) - 1
        origin.append(starts[k] if k >= 0 else NEVER)
    node_span = _innermost(iv, origin)
    node_iv = [(n.time_range.start, n.time_range.end, n.thread) for n in nodes]

    def charge(times: list) -> list:
        """The span each host time is charged to: through the backward node
        open then, else the innermost span open then; -1 for none."""
        in_node = _innermost(node_iv, times)
        in_span = _innermost(iv, times)
        return [node_span[n] if n >= 0 and node_span[n] >= 0 else s
                for n, s in zip(in_node, in_span)]

    n_marks = len(marks)
    host = [0.0] * (n_marks + 1)  # the last slot: NONE
    covered = [0.0] * (n_marks + 1)
    device = [0.0] * (n_marks + 1)
    idle = [0.0] * (n_marks + 1)
    launches = [0] * (n_marks + 1)
    syncs = [0] * (n_marks + 1)
    for i, (a, b, _) in enumerate(iv):
        host[i] += b - a
        if parent[i] >= 0:
            covered[parent[i]] += b - a
    for n, s in zip(node_iv, node_span):
        if s >= 0:
            host[s] += n[1] - n[0]

    def up(i):  # the span and its ancestors; NONE alone
        if i < 0:
            yield n_marks
            return
        while i >= 0:
            yield i
            i = parent[i]

    # Kernels, by the launch call that shares their correlation id.
    launch_at = {e.id: e.time_range.start for e in cpu
                 if e.name.startswith("cu") and "::" not in e.name}
    dev = [e for e in events if _is_device(e)]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    for e, s in zip(kernels, charge([launch_at.get(e.id, NEVER) for e in kernels])):
        for i in up(s):
            device[i] += e.time_range.end - e.time_range.start
            launches[i] += 1
    waits = [e.time_range.start for e in cpu if e.name in SYNC_CALLS]
    for s in charge(waits):
        for i in up(s):
            syncs[i] += 1

    # The card's idle gaps: between the intervals of the union of its work.
    union = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    gaps = [(a, b) for (_, a), (b, _) in zip(union[:-1], union[1:])]
    for (a, b), s in zip(gaps, charge([(a + b) / 2 for a, b in gaps])):
        idle[s if s >= 0 else n_marks] += b - a

    out: dict = {}
    rows = [(m.name, i) for i, m in enumerate(marks)] + [(NONE, n_marks)]
    for name, i in rows:
        r = out.setdefault(name, {"host_ms": 0.0, "self_ms": 0.0, "device_ms": 0.0,
                                  "idle_ms": 0.0, "launches": 0.0, "syncs": 0.0,
                                  "count": 0.0,
                                  "parent": marks[parent[i]].name
                                  if i < n_marks and parent[i] >= 0 else None})
        r["host_ms"] += host[i] / 1e3 / steps
        r["self_ms"] += (host[i] - covered[i]) / 1e3 / steps
        r["device_ms"] += device[i] / 1e3 / steps
        r["idle_ms"] += idle[i] / 1e3 / steps
        r["launches"] += launches[i] / steps
        r["syncs"] += syncs[i] / steps
        r["count"] += (i < n_marks) / steps
    return out


def cover(sp: dict) -> dict:
    """How far the spans hold the step: the ``step.*`` spans' self time over
    their host time, the share of the idle gaps charged to a span, and the
    ``step.*`` spans' device time over all kernel time."""
    steps = [r for name, r in sp.items() if name.startswith("step.") and r["parent"] is None]
    idle = sum(r["idle_ms"] for r in sp.values())
    kernel = sum(r["device_ms"] for r in sp.values() if r["parent"] is None)
    return {
        "step_self_share": sum(r["self_ms"] for r in steps) / sum(r["host_ms"] for r in steps)
        if steps else None,
        "idle_held_share": 1.0 - sp[NONE]["idle_ms"] / idle if idle > 0 else None,
        "step_device_share": sum(r["device_ms"] for r in steps) / kernel if kernel > 0 else None,
    }


def report(sp: dict, log) -> None:
    """One line per span to ``log``, then the cover figures."""
    for name, r in sp.items():
        log(f"span {name}: host {r['host_ms']:.3f} ms (self {r['self_ms']:.3f}), device "
            f"{r['device_ms']:.3f} ms, idle {r['idle_ms']:.3f} ms, launches "
            f"{r['launches']:.1f}, syncs {r['syncs']:.1f}, ranges {r['count']:.1f} a step"
            f"{'' if r['parent'] is None else ' in ' + r['parent']}")
    if sp:
        log("spans: " + ", ".join(f"{k} {'none' if v is None else f'{v:.4f}'}"
                                  for k, v in cover(sp).items()))


def of(summary: dict) -> dict:
    """The traced stretch's spans, which ``run.run`` reduces into
    ``summary["spans"]`` ({} when there is none)."""
    return summary.get("spans", {})
