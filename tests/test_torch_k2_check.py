"""``chip_smoke.py``'s check of K2 against float64, exercised on the CPU.

On the card the kernel is held group by group (depth row, attribute rows,
rows 0-8 chained to the vertices) against ``raster_bwd_plain`` in float64.
Here the kernel's stand-in is ``raster_bwd_plain`` evaluated in f32 with
each affine row rounded once, as the kernel's fused multiply-adds round
it (on the H100 the two agree to within a few per cent of each group's
error). The stand-in must pass the check, and versions of it with one term
of the chain broken, built in memory from the module's source, must fail
it at one gamma or both, as must the faults ``chip_smoke.py`` plants in
the kernel's output. The scene is ``chip_smoke.py``'s, at 2 views of
128^2.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke as CS
import hocon_torch.render.raster_cuda as TRC

torch.set_num_threads(1)

PAIRS, RES = 2, 128

# name: (text in raster_bwd_plain, its broken replacement)
MUTATIONS = {
    "clip mask dropped": ("clip_mask = ((zraw > 0.0) & (zraw < 1.0)).to(dt)",
                          "clip_mask = torch.ones_like(zraw)"),
    "take_a branch dropped": ("take_a = ((a_side > b_side) & (a_side > 0)).to(dt)",
                              "take_a = torch.zeros_like(a_side)"),
    "outside tie split dropped": (
        "o_sel = _rcp123(o_masks[0] + o_masks[1] + o_masks[2]) * (1.0 - insf)",
        "o_sel = 1.0 - insf"),
    "direct attribute term dropped": ("grads[10 + c] = what * g_c",
                                      "grads[10 + c] = torch.zeros_like(what)"),
    "softmax term dropped from the depth row": (
        "grads[9] = (what * px(g_z) - dl * inv_gamma) * clip_mask",
        "grads[9] = what * px(g_z) * clip_mask"),
    "silhouette term dropped": ("dx = px(gs1) * sig + dl * (1.0 - sig)",
                                "dx = dl * (1.0 - sig)"),
}


def _rounded_once_row(self, i):
    """Plane row i with one rounding to f32, as fma(a0, x, fma(a1, y, a2))."""
    a, f64 = self.a, torch.float64
    inner = (a[:, :, i, 1, None, None].to(f64) * self.y.to(f64)
             + a[:, :, i, 2, None, None].to(f64)).float()
    return (a[:, :, i, 0, None, None].to(f64) * self.x.to(f64) + inner.to(f64)).float()


def _stand_in(mutation=None):
    """``raster_bwd_plain`` of a fresh copy of the module, rows rounded
    once, with ``mutation`` applied to its source."""
    with open(TRC.__file__) as fh:
        src = fh.read()
    if mutation is not None:
        old, new = MUTATIONS[mutation]
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    module = types.ModuleType("raster_cuda_stand_in")
    exec(compile(src, TRC.__file__, "exec"), module.__dict__)
    module._ChunkCells.row = _rounded_once_row
    return module.raster_bwd_plain


@pytest.fixture(scope="module")
def scene():
    tgt, ref, faces, k = CS.make_scene(torch, "cpu", pairs=PAIRS, res=RES)
    coeffs, bounds, krange = CS.raster_inputs(torch, tgt, ref, faces, k, RES)
    chain = CS.geometry_chain(torch, tgt, faces, k)
    cfg, size = TRC.default_config(), (RES, RES)
    cases = []
    for gamma in CS.GAMMAS:
        # K1's near-exact state: the forward in float64, stored in f32.
        fwd = [t.float() for t in TRC.raster_fwd_plain(coeffs.double(), bounds, krange, size,
                                                        CS.SIGMA, gamma, cfg)]
        rng = np.random.default_rng(0)
        sup = (fwd[0] > 1e-3).float()

        def noise(t):
            return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))

        state = (*fwd, noise(fwd[0]) * sup, noise(fwd[1]) * sup[:, None], noise(fwd[0]) * sup)
        args = (bounds, krange, *state, size, CS.SIGMA, gamma, cfg)
        want64 = TRC.raster_bwd_plain(coeffs.double(), bounds, krange,
                                      *(t.double() for t in state), size, CS.SIGMA, gamma, cfg)
        cases.append((gamma, args, want64))
    return coeffs, cases, chain


def _outputs(scene, fn):
    """dcoeffs of ``fn`` (a ``raster_bwd_plain``) per gamma."""
    coeffs, cases, _ = scene
    return {gamma: fn(coeffs, *args) for gamma, args, _ in cases}


def _failures(scene, outputs, fault=lambda d: d):
    _, cases, chain = scene
    return {gamma: CS.k2_failures(CS.k2_compare(fault(outputs[gamma]), want64, chain))
            for gamma, _, want64 in cases}


@pytest.fixture(scope="module")
def stand_in_out(scene):
    return _outputs(scene, _stand_in())


def test_k2_check_passes_the_stand_in(scene, stand_in_out):
    assert _failures(scene, stand_in_out) == {gamma: [] for gamma in CS.GAMMAS}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_k2_check_fails_a_broken_chain(scene, mutation):
    failures = _failures(scene, _outputs(scene, _stand_in(mutation)))
    assert any(failures.values()), f"{mutation} passes the check: {failures}"


@pytest.mark.parametrize("fault", list(CS.K2_PLANTED))
def test_k2_check_fails_the_planted_faults(scene, stand_in_out, fault):
    failures = _failures(scene, stand_in_out, CS.K2_PLANTED[fault])
    assert all(failures.values()), f"{fault} passes the check at some gamma: {failures}"
