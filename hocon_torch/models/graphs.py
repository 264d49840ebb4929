"""Functions replayed from CUDA graphs, forward and backward: MANO's
forward (HOCNet's and HaMeR's) and HOCNet's trunk and heads.

``mano_forward`` launches about 130 small kernels forward and as many
backward (the kinematic chain goes one joint at a time) for 0.6 ms of work
on an H100, and HOCNet's trunk and heads about 160, so the card waits on
the host's launches (PERF.md section 5). ``graphed_mano`` and
``graphed_model`` capture the function's own kernels once per signature
(``graph_signature``) into one CUDA graph for the forward and, when the
inputs or the parameters need gradients, one for the backward, and replay
them after: each call is an input copy, one replay and an output copy, and
its backward likewise. ``graphed_mano`` runs a MANO body (``mano_forward``
or ``mano_forward_rotmat``); ``graphed_model`` runs a function of a
module's parameters, whose gradients the backward graph gives too. An
owner (a HOCNet, a HaMeR) keeps its graphs in one ``Graphs`` cache, each
keyed by the name of the function graphed and its signature.

A graph replays the kernels that eager mode launches, in the same order
(the backward is captured from autograd's own backward of the same
function), so the outputs and gradients are eager mode's bit for bit:

- the inputs are copied into buffers laid out as the caller's tensors
  (shape, strides, offset), so the capture takes eager mode's kernels for
  the strided slices of the pose head's output; each call's outputs are
  copies laid out as the captured ones, views of one storage sharing one
  copy of it (the pose head's slices stay slices of one tensor);
- each input buffer requires grad as its input does, so autograd saves
  what eager mode saves;
- a warm-up on the capture's stream makes the library handles and
  workspaces before the capture, as eager mode had them; the cuBLAS
  workspaces of that one stream per device (one for the host thread's
  handle, one for autograd's) are the graphs' main memory cost. Tensors
  the call updates in place (batch norm's running statistics) are put back
  after the warm-ups, and the autocast cache is emptied before and after
  the capture, so the graph holds its own casts and no cached cast points
  into its memory;
- a parameter's gradient is laid out as the parameter, inside the graph,
  as ``AccumulateGrad`` lays out eager mode's, and is handed over as a
  detached alias of the graph's buffer, which ``AccumulateGrad`` takes as
  the ``.grad`` without a copy (``torch.cuda.make_graphed_callables`` does
  the same). A backward into a ``.grad`` that holds a value adds to it as
  eager mode does; where that ``.grad`` is the buffer itself, it is copied
  out first. The backward graph has a memory pool of its own, so no later
  forward replay writes over the buffers. An output the loss does not use
  takes a zero gradient, so a parameter that only it reaches gets zeros
  where eager mode leaves None (the train step's ``apply_gradients`` gives
  such a parameter zeros either way).

A CPU input runs the function itself. Each call returns tensors of its
own; the input gradients are copies, the parameter gradients the aliases
above, which the next backward of the signature overwrites (as eager mode's
next step replaces them). A forward replay overwrites what the previous
replay of that graph saved for its backward, so the backward of a call
must run before the next call of the same signature: an older call's
backward raises.

``graphed_mano.captures`` / ``.replays`` count the MANO signatures captured
and the calls that replayed one, of both bodies; ``graphed_model.captures``
/ ``.replays`` count ``graphed_model``'s.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd.function import once_differentiable

from hocon_torch.geometry.mano import ManoModel

WARMUP_CALLS = 3  # eager calls on the capture's stream before the capture


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream per device that every capture here runs on:
    cuBLAS keeps a workspace per (handle, stream), which the graphs hold, so
    a stream per signature would hold a workspace per signature."""
    return torch.cuda.Stream(device)


class Graphs(dict):
    """One owner's graphs (a HOCNet's or a HaMeR's), keyed by the name of
    the function graphed and its signature.

    Each entry holds what it captured (the ``ManoModel``, the module), whose
    tensors the graphs read by address. Not part of any ``state_dict``; a
    deep copy of the owner gets an empty cache (a CUDA graph cannot be
    copied).
    """

    def __deepcopy__(self, memo) -> "Graphs":
        return Graphs()


def graph_signature(owner, inputs: tuple, params: tuple = ()) -> tuple:
    """What a capture fixes: the device, the grad and autocast modes,
    cuDNN's and the matmuls' precision switches, the owner (by identity:
    the graphs read its tensors), each input's shape, strides, offset,
    dtype and whether it needs a gradient and, where the owner is a module,
    its training mode and each of its parameters ``params``' address,
    shape, dtype and whether it needs a gradient (a ``.to()`` or a replaced
    parameter captures anew)."""
    dev = inputs[0].device
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (*inputs, *params))
    sig = (dev, grad, torch.is_inference_mode_enabled(),
           torch.is_autocast_enabled(dev.type), torch.get_autocast_dtype(dev.type),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32, id(owner),
           tuple((x.shape, x.stride(), x.storage_offset(), x.dtype, grad and x.requires_grad)
                 for x in inputs))
    if isinstance(owner, torch.nn.Module):
        sig += (owner.training, tuple((p.data_ptr(), p.shape, p.dtype, grad and p.requires_grad)
                                      for p in params))
    return sig


def _name(fn) -> str:
    """The qualified name of the function graphed (of a partial's function)."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    return fn.__qualname__


def _extent(x: torch.Tensor) -> int:
    """Elements of ``x``'s storage from its start to ``x``'s last element."""
    if not x.numel():
        return x.storage_offset()
    return x.storage_offset() + 1 + sum((n - 1) * s for n, s in zip(x.shape, x.stride()))


def _mirror(x: torch.Tensor, requires_grad: bool) -> torch.Tensor:
    """An empty tensor laid out as ``x``: its shape, strides and offset into
    a storage of its own."""
    buf = torch.empty(_extent(x), dtype=x.dtype, device=x.device)
    return buf.as_strided(x.shape, x.stride(), x.storage_offset()).requires_grad_(requires_grad)


def _fresh(outs: tuple) -> tuple:
    """Copies of ``outs`` laid out as they are, one copy kernel a storage:
    a dense output alone on its storage is copied as ``clone`` copies it,
    the views of one storage become views of one copy of it."""
    def key(x):
        return x.untyped_storage().data_ptr(), x.dtype

    keys = [key(o) for o in outs]
    copies, fresh = {}, []
    for o, k in zip(outs, keys):
        if keys.count(k) == 1 and o.storage_offset() == 0 and _extent(o) == o.numel():
            fresh.append(torch.empty_strided(o.shape, o.stride(), dtype=o.dtype,
                                             device=o.device).copy_(o))
            continue
        if k not in copies:
            n = max(_extent(x) for x, kx in zip(outs, keys) if kx == k)
            copies[k] = o.as_strided((n,), (1,), 0).clone()
        fresh.append(copies[k].as_strided(o.shape, o.stride(), o.storage_offset()))
    return tuple(fresh)


def _as_accumulated(g: torch.Tensor | None, p: torch.Tensor) -> torch.Tensor | None:
    """``g`` laid out as ``AccumulateGrad`` lays out a new gradient of
    ``p``: as is when its strides are ``p``'s, else copied into ``p``'s."""
    if g is None or g.stride() == p.stride():
        return g
    return torch.empty_strided(p.shape, p.stride(), dtype=g.dtype, device=g.device).copy_(g)


@contextlib.contextmanager
def _standing_in(module, params: tuple, stand_ins: tuple):
    """``module``'s parameters ``params`` replaced by ``stand_ins`` for the
    block."""
    if module is None:
        yield
        return
    swap = {id(p): q for p, q in zip(params, stand_ins)}
    slots = [(m, name, p) for m in module.modules() for name, p in m._parameters.items()
             if id(p) in swap]
    for m, name, p in slots:
        m._parameters[name] = swap[id(p)]
    try:
        yield
    finally:
        for m, name, p in slots:
            m._parameters[name] = p


class _Graph:
    """One signature's forward graph, and its backward graph when an input
    or a parameter needs a gradient, with their static buffers."""

    def __init__(self, fn, inputs: tuple, grad: bool, counter, module=None):
        dev = inputs[0].device
        self.fn = fn
        self.counter = counter
        self.generation = 0
        self.inputs = tuple(_mirror(x, grad and x.requires_grad) for x in inputs)
        params = () if module is None else tuple(module.parameters())
        state = () if module is None else tuple(module.buffers())
        # The capture's parameters are stand-ins on the same storage: leaves
        # of their own, so no autograd node of a parameter kept alive from an
        # eager call (bound to the caller's stream) enters the capture.
        stand_ins = tuple(torch.nn.Parameter(p.detach(), requires_grad=p.requires_grad)
                          for p in params)
        # Each of the replay's arguments (inputs, then parameters): its index
        # in ``wants``, the leaves whose gradients the backward graph gives,
        # or None.
        wants, self.slots, self.params = [], [], []
        for x, arg in zip((*self.inputs, *stand_ins), (*self.inputs, *params)):
            self.slots.append(len(wants) if grad and x.requires_grad else None)
            if self.slots[-1] is not None:
                wants.append(x)
                if arg is not x:
                    self.params.append(arg)
        self.wants = tuple(wants)
        self.n_in = len(self.wants) - len(self.params)
        self.load(inputs)
        with torch.cuda.device(dev), _standing_in(module, params, stand_ins):
            stream = _capture_stream(dev)
            kept = [t.clone() for t in state]
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_CALLS):
                    out = self.fn(*self.inputs)
                    if self.wants:
                        diff = [o for o in out if o.requires_grad]
                        torch.autograd.grad(diff, self.wants, [torch.ones_like(o) for o in diff],
                                            allow_unused=True)
                with torch.no_grad():
                    for t, k in zip(state, kept):
                        t.copy_(k)
            torch.cuda.current_stream(dev).wait_stream(stream)
            del kept
            torch.clear_autocast_cache()
            self.fwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.fwd, stream=stream, capture_error_mode="thread_local"):
                out = self.fn(*self.inputs)
            torch.clear_autocast_cache()
            self.diff = tuple(i for i, o in enumerate(out) if o.requires_grad)
            self.bwd = None
            if self.wants:
                diff = [out[i] for i in self.diff]
                self.grad_out = tuple(torch.empty_like(o) for o in diff)
                self.bwd = torch.cuda.CUDAGraph()
                # A pool of its own: no forward replay writes where the
                # parameters' gradients are kept.
                with torch.cuda.graph(self.bwd, stream=stream, capture_error_mode="thread_local"):
                    grads = torch.autograd.grad(diff, self.wants, self.grad_out,
                                                allow_unused=True)
                    self.grad_in = grads[:self.n_in] + tuple(
                        _as_accumulated(g, p) for g, p in zip(grads[self.n_in:], self.params))
        self.out = tuple(o.detach() for o in out)

    @torch.no_grad()
    def load(self, inputs: tuple) -> None:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)

    def forward(self, inputs: tuple) -> tuple:
        self.load(inputs)
        self.fwd.replay()
        self.generation += 1
        self.counter.replays += 1
        return _fresh(self.out)

    def backward(self, generation: int, grads: tuple) -> tuple:
        if generation != self.generation:
            raise RuntimeError(
                f"{self.counter.__name__}: the backward of an older call of this signature; a "
                "later call's replay overwrote what it saved")
        for buf, i in zip(self.grad_out, self.diff):
            buf.copy_(grads[i])
        for p, g in zip(self.params, self.grad_in[self.n_in:]):
            if p.grad is not None and g is not None and (
                    p.grad.untyped_storage().data_ptr() == g.untyped_storage().data_ptr()):
                p.grad = p.grad.clone()  # the last backward's alias: keep its sum
        self.bwd.replay()
        got = [None if g is None else g.clone() if j < self.n_in else g.detach()
               for j, g in enumerate(self.grad_in)]
        return tuple(None if s is None else got[s] for s in self.slots)


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graph: _Graph, *args):
        ctx.graph = graph
        out = graph.forward(args[:len(graph.inputs)])
        ctx.mark_non_differentiable(*(o for i, o in enumerate(out) if i not in graph.diff))
        ctx.generation = graph.generation
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None,) + ctx.graph.backward(ctx.generation, grads)


def _graphed(graphs: Graphs, key: tuple, grad: bool, fn, inputs: tuple, counter,
             module=None, params: tuple = ()):
    """``fn(*inputs)`` replayed from ``graphs[key]``, captured on the key's
    first call (``grad``: whether the signature takes gradients; ``params``:
    ``module``'s parameters)."""
    graph = graphs.get(key)
    if graph is None:
        graph = graphs[key] = _Graph(fn, inputs, grad, counter, module)
        counter.captures += 1
    if graph.bwd is None:
        return graph.forward(inputs)
    return _Replay.apply(graph, *inputs, *params)


def graphed_mano(graphs: Graphs, body, mano: ManoModel,
                 *inputs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``body(mano, *inputs, scale_mm=False)``, where ``body`` is
    ``mano_forward`` (pose PCA, betas, root rotation) or
    ``mano_forward_rotmat`` (rotation matrices, betas): replayed from
    ``graphs`` on CUDA inputs (captured on the signature's first call), run
    as it is on CPU ones."""
    fn = functools.partial(body, mano, scale_mm=False)
    if not inputs[0].is_cuda:
        return fn(*inputs)
    sig = graph_signature(mano, inputs)
    return _graphed(graphs, (_name(fn),) + sig, sig[1], fn, inputs, graphed_mano)


def graphed_model(graphs: Graphs, module: torch.nn.Module, fn, inputs: tuple,
                  key: tuple = ()) -> tuple:
    """``fn(*inputs)``, a function of ``module``'s parameters and buffers
    that returns a tuple of tensors: replayed from ``graphs`` on CUDA inputs
    (captured on the signature's first call), run as it is on CPU ones.
    ``key`` adds what else the call depends on that no tensor and no switch
    shows (HOCNet's object head)."""
    if not inputs[0].is_cuda:
        return fn(*inputs)
    params = tuple(module.parameters())
    sig = graph_signature(module, inputs, params)
    return _graphed(graphs, (_name(fn), *key) + sig, sig[1], fn, inputs, graphed_model, module,
                    params)


graphed_mano.captures = 0
graphed_mano.replays = 0
graphed_model.captures = 0
graphed_model.replays = 0
