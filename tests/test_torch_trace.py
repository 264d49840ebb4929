"""The port's spans (``hocon_torch/utils/trace.py``): a shared no-op while no
profiler runs, and under ``torch.profiler`` the named ranges of the train
and eval steps, nested in the step's own range, with the step's numbers
unchanged."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hocon_torch.data.factory import get_dataset
from hocon_torch.data.pipeline import BatchLoader
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.hocnet import HOCNet
from hocon_torch.train.loop import epoch_pass
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.train.steps import make_eval_step, make_train_step, make_warp_train_step
from hocon_torch.utils import trace

torch.set_num_threads(1)

RES = 32
PREFIXES = ("step.", "model.", "loss.", "render.", "optim.", "data.")
MODEL = {"model.trunk", "model.heads", "model.mano"}
UPDATE = {"step.backward", "optim.update"}
RENDER = {"render.prep", "render.raster", "render.sample", "render.photo"}
# Per step kind: the spans it must emit.
EXPECTED = {
    "warp": {"step.warp", "step.inputs", "loss.supervised"} | MODEL | RENDER | UPDATE,
    "sup": {"step.sup", "step.inputs", "loss.supervised"} | MODEL | UPDATE,
    "eval": {"step.eval", "step.inputs"} | MODEL,
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic pair batch at 32 px (hand + object, 2 pairs) and MANO."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HOCON_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
    mano = synthetic_mano_model(0, device="cpu")
    ds = get_dataset("synthetic", "train", image_size=RES, use_objects=True, train=True,
                     pair_mode=True, fraction=0.5, synth_videos=2, synth_frames=4, seed=2,
                     synth_obj_faces=80, uint8_images=True, mano=mano, device="cpu")
    batch = next(iter(BatchLoader(ds, 2, seed=0)))
    mp.undo()
    return mano, batch


def _step(kind, mano):
    model = HOCNet(with_object=True, seed=0, device="cpu")
    optimizer = make_optimizer("adam", 1e-4)
    state = create_train_state(model, optimizer)
    if kind == "warp":
        step = make_warp_train_step(model, mano, optimizer, image_size=(RES, RES),
                                    device="cpu")
    elif kind == "sup":
        sup = make_train_step(model, mano, optimizer, device="cpu")

        def step(st, batch):
            return sup(st, batch["ref"])
    else:
        ev = make_eval_step(model, mano, device="cpu")

        def step(st, batch):
            return st, ev(st, batch["ref"])
    return state, step


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.device_type.name == "CPU"]


def _spans(events):
    return [e for e in events if e.name.startswith(PREFIXES)]


def test_span_is_the_shared_noop_without_a_profiler(scene, monkeypatch):
    """No profiler: ``span`` hands out one shared no-op and never builds a
    ``record_function``, through a whole warp train step."""
    def refuse(*args, **kw):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    off = trace.span("step.warp", "0")
    assert off is trace.span("model.trunk") and isinstance(off, contextlib.nullcontext)
    mano, batch = scene
    state, step = _step("warp", mano)
    state, terms = step(state, batch)
    assert state.step == 1 and torch.isfinite(terms["loss_total"])


@pytest.mark.parametrize("kind", ["warp", "sup", "eval"])
def test_step_emits_its_spans_nested_in_the_step(scene, kind):
    """Under the profiler each step kind emits every span of its layers,
    each nested in ``step.<kind>``, which holds every aten op of the step;
    no ``render.*`` span outside the warp step."""
    mano, batch = scene
    state, step = _step(kind, mano)
    _, events = _profiled(lambda: step(state, batch))
    spans = _spans(events)
    names = {e.name for e in spans}
    assert names == EXPECTED[kind], names ^ EXPECTED[kind]
    (outer,) = [e for e in spans if e.name == f"step.{kind}"]
    a, b = outer.time_range.start, outer.time_range.end
    for e in spans:
        assert a <= e.time_range.start and e.time_range.end <= b, e.name
    aten = [e for e in events if e.name.startswith("aten::")]
    assert aten
    for e in aten:
        assert a <= e.time_range.start and e.time_range.end <= b, e.name


def test_model_and_render_spans_do_not_nest(scene):
    """``model.*`` and ``render.*`` ranges are siblings under the step (no
    range holds another of its layer), so their sums count each moment
    once; ``model.heads`` is two ranges around ``model.mano``."""
    mano, batch = scene
    state, step = _step("warp", mano)
    _, events = _profiled(lambda: step(state, batch))
    spans = [e for e in _spans(events) if not e.name.startswith("step.warp")]
    for x in spans:
        for y in spans:
            if x is not y and x.name.split(".")[0] == y.name.split(".")[0]:
                assert (x.time_range.end <= y.time_range.start
                        or y.time_range.end <= x.time_range.start), (x.name, y.name)
    heads = sorted(e.time_range.start for e in spans if e.name == "model.heads")
    (mano_span,) = [e for e in spans if e.name == "model.mano"]
    assert len(heads) == 2 and heads[0] < mano_span.time_range.start < heads[1]


def test_warp_step_bits_with_and_without_a_profiler(scene):
    """The spans record and change nothing: a warp train step gives the
    same bits of loss, terms and parameters under a profiler as without."""
    mano, batch = scene
    state0, step0 = _step("warp", mano)
    state1, step1 = _step("warp", mano)
    state0, terms0 = step0(state0, batch)
    (state1, terms1), _ = _profiled(lambda: step1(state1, batch))
    assert terms0.keys() == terms1.keys()
    for k in terms0:
        assert torch.equal(terms0[k], terms1[k]), k
    p0 = dict(state0.model.named_parameters())
    for k, p in state1.model.named_parameters():
        assert torch.equal(p0[k], p), k


def test_epoch_pass_marks_the_data_wait(scene):
    """``epoch_pass`` puts each wait on the loader in ``data.wait`` (the
    last one finds the end) and each batch's copy in ``data.to_device``,
    outside the step's range."""
    mano, batch = scene

    class Loader:
        def epoch(self, epoch):
            return iter([batch, batch])

    state, step = _step("warp", mano)
    (_, metrics), events = _profiled(
        lambda: epoch_pass(Loader(), state, step, train=True, device="cpu"))
    spans = _spans(events)
    count = {n: sum(e.name == n for e in spans) for n in
             ("data.wait", "data.to_device", "step.warp")}
    assert count == {"data.wait": 3, "data.to_device": 2, "step.warp": 2}
    steps = [e for e in spans if e.name == "step.warp"]
    for e in spans:
        if e.name.startswith("data."):
            assert all(e.time_range.end <= s.time_range.start
                       or s.time_range.end <= e.time_range.start for s in steps)
    assert metrics["loss_total"] > 0
