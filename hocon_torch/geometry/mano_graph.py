"""MANO's forward and backward replayed from CUDA graphs, for HOCNet and
HaMeR.

``mano_forward`` launches about 130 small kernels forward and as many
backward (the kinematic chain goes one joint at a time) for 0.6 ms of work
on an H100, so the card waits on the host's launches (PERF.md section 5).
``graphed_mano_forward`` captures the function's own kernels once per
signature (``mano_signature``) into one CUDA graph for the forward and, when
the inputs need gradients, one for the backward, and replays them after:
each call is an input copy, one replay and an output copy, and its backward
likewise. ``graphed_mano_rotmat`` does the same for ``mano_forward_rotmat``
(MANO from the 16 joints' rotation matrices, HaMeR's entry), under
signatures of its own in the same cache.

A graph replays the kernels that eager mode launches, in the same order
(the backward is captured from autograd's own backward of the same
function), so the outputs and gradients are eager mode's bit for bit:

- the inputs are copied into buffers laid out as the caller's tensors
  (shape, strides, offset), so the capture takes eager mode's kernels for
  the strided slices of the pose head's output;
- each input buffer requires grad as its input does, so autograd saves
  what eager mode saves;
- a warm-up on the capture's stream makes the library handles and
  workspaces before the capture, as eager mode had them; the cuBLAS
  workspaces of that one stream per device (one for the host thread's
  handle, one for autograd's) are the graphs' main memory cost.

A CPU input runs ``mano_forward`` itself. Each call returns tensors of its
own, and so does each backward. A forward replay overwrites what the
previous replay of that graph saved for its backward, so the backward of a
call must run before the next call of the same signature: an older call's
backward raises.

``graphed_mano_forward.captures`` counts the signatures captured and
``graphed_mano_forward.replays`` the calls that replayed a forward graph,
of both entries.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from hocon_torch.geometry import mano as mano_mod
from hocon_torch.geometry.mano import ManoModel

WARMUP_CALLS = 3  # eager calls on the capture's stream before the capture


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream per device that every capture here runs on:
    cuBLAS keeps a workspace per (handle, stream), which the graphs hold, so
    a stream per signature would hold a workspace per signature."""
    return torch.cuda.Stream(device)


class ManoGraphs(dict):
    """One owner's graphs (a HOCNet's or a HaMeR's), keyed by the entry's
    name and ``mano_signature``.

    Each entry holds the ``ManoModel`` it captured, whose tensors the graphs
    read by address. Not part of any ``state_dict``; a deep copy of the owner
    gets an empty cache (a CUDA graph cannot be copied).
    """

    def __deepcopy__(self, memo) -> "ManoGraphs":
        return ManoGraphs()


def mano_signature(model: ManoModel, *inputs: torch.Tensor) -> tuple:
    """What a capture fixes: the device, the grad and autocast modes, the
    MANO model (by identity: the graphs read its tensors) and each input's
    shape, strides, offset, dtype and whether it needs a gradient."""
    dev = inputs[0].device
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    return (dev, grad, torch.is_inference_mode_enabled(),
            torch.is_autocast_enabled(dev.type), torch.get_autocast_dtype(dev.type), id(model),
            tuple((x.shape, x.stride(), x.storage_offset(), x.dtype, grad and x.requires_grad)
                  for x in inputs))


def _mirror(x: torch.Tensor, requires_grad: bool) -> torch.Tensor:
    """An empty tensor laid out as ``x``: its shape, strides and offset into
    a storage of its own."""
    extent = 1 + sum((n - 1) * s for n, s in zip(x.shape, x.stride())) if x.numel() else 0
    buf = torch.empty(x.storage_offset() + extent, dtype=x.dtype, device=x.device)
    return buf.as_strided(x.shape, x.stride(), x.storage_offset()).requires_grad_(requires_grad)


class _Graph:
    """One signature's forward graph, and its backward graph when an input
    needs a gradient, with their static buffers."""

    def __init__(self, body, model: ManoModel, inputs: tuple, grad: bool):
        dev = inputs[0].device
        self.body = body
        self.model = model
        self.generation = 0
        self.inputs = tuple(_mirror(x, grad and x.requires_grad) for x in inputs)
        self.wants = tuple(x for x in self.inputs if x.requires_grad)
        self.load(inputs)
        with torch.cuda.device(dev):
            stream = _capture_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_CALLS):
                    out = self._call()
                    if self.wants:
                        torch.autograd.grad(out, self.wants, [torch.ones_like(o) for o in out])
            torch.cuda.current_stream(dev).wait_stream(stream)
            self.fwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.fwd, stream=stream, capture_error_mode="thread_local"):
                out = self._call()
            self.bwd = None
            if self.wants:
                self.grad_out = tuple(torch.empty_like(o) for o in out)
                self.bwd = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.bwd, pool=self.fwd.pool(), stream=stream,
                                      capture_error_mode="thread_local"):
                    self.grad_in = torch.autograd.grad(out, self.wants, self.grad_out)
        self.out = tuple(o.detach() for o in out)

    def _call(self):
        return self.body(self.model, *self.inputs, scale_mm=False)

    @torch.no_grad()
    def load(self, inputs: tuple) -> None:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)

    def forward(self, inputs: tuple) -> tuple:
        self.load(inputs)
        self.fwd.replay()
        self.generation += 1
        graphed_mano_forward.replays += 1
        return tuple(o.clone() for o in self.out)

    def backward(self, generation: int, grads: tuple) -> tuple:
        if generation != self.generation:
            raise RuntimeError(
                "graphed_mano_forward: the backward of an older call of this signature; a "
                "later call's replay overwrote what it saved")
        for buf, g in zip(self.grad_out, grads):
            buf.copy_(g)
        self.bwd.replay()
        got = iter(g.clone() for g in self.grad_in)
        return tuple(next(got) if x.requires_grad else None for x in self.inputs)


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graph: _Graph, *inputs):
        ctx.graph = graph
        out = graph.forward(inputs)
        ctx.generation = graph.generation
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None,) + ctx.graph.backward(ctx.generation, grads)


def _graphed(graphs: ManoGraphs, body, model: ManoModel, inputs: tuple):
    """``body(model, *inputs, scale_mm=False)``: replayed from ``graphs`` on
    CUDA inputs (captured on the signature's first call), run as it is on
    CPU ones."""
    if not inputs[0].is_cuda:
        return body(model, *inputs, scale_mm=False)
    sig = mano_signature(model, *inputs)
    key = (body.__name__,) + sig
    graph = graphs.get(key)
    if graph is None:
        graph = graphs[key] = _Graph(body, model, inputs, grad=sig[1])
        graphed_mano_forward.captures += 1
    if graph.bwd is None:
        return graph.forward(inputs)
    return _Replay.apply(graph, *inputs)


def graphed_mano_forward(
    graphs: ManoGraphs,
    model: ManoModel,
    pose_pca: torch.Tensor,
    betas: torch.Tensor,
    global_rot: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``mano_forward(model, pose_pca, betas, global_rot, scale_mm=False)``:
    replayed from ``graphs`` on a CUDA input (captured on the signature's
    first call), run as it is on a CPU one."""
    return _graphed(graphs, mano_mod.mano_forward, model, (pose_pca, betas, global_rot))


def graphed_mano_rotmat(
    graphs: ManoGraphs,
    model: ManoModel,
    rots: torch.Tensor,
    betas: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``mano_forward_rotmat(model, rots, betas, scale_mm=False)``, as
    ``graphed_mano_forward`` runs ``mano_forward``."""
    return _graphed(graphs, mano_mod.mano_forward_rotmat, model, (rots, betas))


graphed_mano_forward.captures = 0
graphed_mano_forward.replays = 0
