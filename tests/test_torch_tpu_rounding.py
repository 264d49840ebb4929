"""The tools of the excess-warp-gain study: ``tools/repro_tpu_rounding.py``
(the TPU's bf16 rounding emulated in the port's warp path) and
``tools/repro_long_parity.py`` (the long f32 parity on the CPU).

The rounding's pieces are held to their definition: a product at TPU
``DEFAULT`` precision takes bf16 operands and accumulates in f32, in the
forward and in the transposed products of the backward; the rounded
sampler takes a bf16 image and bf16 y-lerp weights. The swap must reach the
port's MANO, projection and plane-row products and restore them after.
Both tools' verdict rules are checked on made-up records.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tools.repro_long_parity as parity
import tools.repro_tpu_rounding as rounding
from hocon_torch.geometry import mano as mano_mod
from hocon_torch.geometry import project as project_mod
from hocon_torch.geometry import rot as rot_mod
from hocon_torch.render import raster as raster_mod
from hocon_torch.render import sample_cuda as SC

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def test_rounded_product_rounds_operands_and_cotangent():
    """Forward: bf16(a) @ bf16(b) in f32. Backward: the transposed products
    of bf16 operands, the cotangent rounded too; nothing else rounded."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(5, 7, generator=gen, requires_grad=True)
    b = torch.randn(7, 3, generator=gen, requires_grad=True)
    g = torch.randn(5, 3, generator=gen)
    y = rounding.rounded_product(torch.matmul, a, b)
    assert torch.equal(y, _bf16(a.detach()) @ _bf16(b.detach()))
    assert not torch.equal(y, a.detach() @ b.detach())
    y.backward(g)
    assert torch.equal(a.grad, _bf16(g) @ _bf16(b.detach()).T)
    assert torch.equal(b.grad, _bf16(a.detach()).T @ _bf16(g))
    # The einsum route of the module stand-in gives the same.
    calls = {"G": 0}
    fake = rounding._RoundingTorch(calls, "G", equations=("ij,jk->ik",))
    assert torch.equal(fake.einsum("ij,jk->ik", a, b), y)
    assert torch.equal(fake.einsum("ij,kj->ik", a, b.T), torch.einsum("ij,kj->ik", a, b.T))
    assert calls == {"G": 1}


def test_sample_fwd_rounded_is_the_tpu_kernels_rounding():
    """The rounded sampler against a float64 evaluation of the same
    rounding (bf16 image taps, bf16 y weights, exact x weights), and within
    bf16's step of the f32 plain version."""
    gen = torch.Generator().manual_seed(1)
    image = torch.rand(2, 9, 11, 3, generator=gen)
    coords = torch.rand(2, 4, 6, 2, generator=gen) * torch.tensor([11.0, 9.0])
    got = rounding.sample_fwd_rounded(image, coords).double()
    img = _bf16(image).double()
    x = coords[..., 0].double() - 0.5
    y = coords[..., 1].double() - 0.5
    x0 = torch.clamp(torch.floor(x), 0, 9).long()
    y0 = torch.clamp(torch.floor(y), 0, 7).long()
    fx = torch.clamp(x - x0, 0, 1)[..., None]
    fy = torch.clamp(y.float() - y0.float(), 0, 1)[..., None]  # f32, as the port's
    wy0, wy1 = _bf16(1 - fy).double(), _bf16(fy).double()
    bidx = torch.arange(2)[:, None, None]

    def tap(dy, dx):
        return img[bidx, y0 + dy, x0 + dx]

    want = ((tap(0, 0) * wy0 + tap(1, 0) * wy1) * (1 - fx)
            + (tap(0, 1) * wy0 + tap(1, 1) * wy1) * fx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-7)
    plain = SC.sample_fwd_plain(image, coords)
    diff = float((got.float() - plain).abs().max())
    assert 0 < diff <= 2 ** -8


def test_swap_reaches_the_products_and_restores_them(monkeypatch):
    """Under ``TpuRounding``: MANO (G1), the projection (G2) and the plane
    rows (G3) go through rounded products, K3's launcher is the rounded
    plain forward and K4's gets a bf16 image (G4); leaving restores every
    module. Outputs move by bf16's relative step, not more."""
    seen = []
    monkeypatch.setattr(SC, "sample_bwd_cuda", lambda image, coords, g: seen.append(image) or g)
    mano = mano_mod.synthetic_mano_model(0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    pose, betas = torch.randn(2, 30, generator=gen) * 0.5, torch.randn(2, 10, generator=gen)
    rot, trans = torch.randn(2, 3, generator=gen) * 0.3, torch.tensor([[0.0, 0.0, 0.6]] * 2)
    k = torch.tensor([[[240.0, 0, 32], [0, 240.0, 32], [0, 0, 1]]] * 2)

    def geometry():
        verts, _ = mano_mod.mano_forward(mano, pose, betas, rot, trans=trans)
        pix = project_mod.persp_project(verts / 1000.0, k)
        rows = raster_mod.face_planes(pix, verts[..., 2] / 1000.0, mano.faces, attrs=pix,
                                      backface_cull=True).rows
        return verts, pix, rows

    exact = geometry()
    modules = {m: m.torch for m in (mano_mod, project_mod, rot_mod, raster_mod)}
    swap = rounding.TpuRounding()
    with swap:
        rounded = geometry()
        image = torch.rand(1, 8, 8, 3, generator=gen)
        coords = torch.rand(1, 3, 3, 2, generator=gen) * 8
        assert torch.equal(SC.sample_fwd_cuda(image, coords),
                           rounding.sample_fwd_rounded(image, coords))
        SC.sample_bwd_cuda(image, coords, torch.zeros(1, 3, 3, 3))
    assert swap.calls["G1"] >= 20 and swap.calls["G2"] == 1 and swap.calls["G3"] == 2
    assert swap.calls["G4"] == 1 and swap.k4_bf16 == 1
    assert torch.equal(seen[0], _bf16(image))
    for mod, was in modules.items():
        assert mod.torch is was is torch
    assert SC.sample_fwd_cuda.__name__ == "sample_fwd_cuda"
    assert mano_mod.pca_to_full_pose.__module__ == mano_mod.__name__
    verts_rel = float((rounded[0] - exact[0]).norm() / exact[0].norm())
    pix_rel = float((rounded[1] - exact[1]).norm() / exact[1].norm())
    assert 0 < verts_rel < 2e-2 and 0 < pix_rel < 2e-2, (verts_rel, pix_rel)
    # Unknown groups are refused; a group alone swaps only its own modules.
    with pytest.raises(ValueError, match="unknown groups"):
        rounding.TpuRounding(["G5"])
    with rounding.TpuRounding(["G2"]):
        assert project_mod.torch is not torch and mano_mod.torch is torch
        assert SC.sample_fwd_cuda.__name__ == "sample_fwd_cuda"


def _tool_lines(records):
    return "\n".join(json.dumps(r) for r in records) + "\n"


def test_rounding_summary_verdicts(tmp_path, capsys):
    """``--summary`` against the TPU record: a full emulation within 1 mm of
    the TPU's warp mean and gain explains the excess; one that closes more
    than half the gap explains part; one at the port's level does not."""
    tpu = rounding._records(rounding.TPU_LOGS, (0, 0.125, 16))
    assert sorted(tpu) == list(range(8))

    def run(groups, warp_shift):
        out = []
        for seed, rec in tpu.items():
            r = dict(rec)
            r["warp_mpjpe_unannotated_mm"] = rec["warp_mpjpe_unannotated_mm"] + warp_shift
            r["consistency_gain_mm"] = (rec["control_extra_steps_mpjpe_unannotated_mm"]
                                        - r["warp_mpjpe_unannotated_mm"])
            out.append({"rounding": groups, "seed": seed, "record": r})
        return out

    for shift, verdict in ((0.3, "explains the excess"), (-1.6, "explains part"),
                           (-3.5, "does not explain")):
        path = tmp_path / f"run{shift}.log"
        path.write_text("{\"seed\": 0}\n" + _tool_lines(run(list(rounding.GROUPS), shift)))
        assert rounding.main(["--summary", str(path)]) == 0
        out = capsys.readouterr().out
        assert f"the rounding {verdict}" in out, out
    path = tmp_path / "g2.log"
    path.write_text(_tool_lines(run(["G2"], 0.0)))
    rounding.main(["--summary", str(path)])
    out = capsys.readouterr().out
    assert "rounding G2:" in out and "verdict" not in out


def _parity_run(losses, figures):
    return {"figures": figures, "warp": [{"loss_total": v, "grad_norm": 1.0} for v in losses],
            "supervised": [], "seconds": 1.0, "steps": {"base": 2, "warp": len(losses)}}


@pytest.mark.parametrize("case", ["faithful", "outside", "lower"])
def test_long_parity_verdict_rule(tmp_path, capsys, case):
    """The rule of ``tools/repro_long_parity.py``: at every 10th step the
    port within max(2 |eager - jit|, 1 %) of the jitted reference, and below
    it at no more than 80 % of the steps."""
    rng = np.random.default_rng(0)
    jit = 100.0 * np.exp(-np.arange(40) / 20.0)
    eager = jit * (1 + 0.05 * rng.standard_normal(40))
    halfway = jit + 0.5 * (eager - jit)  # inside the band; below jit where eager is
    port = {"faithful": halfway,
            "outside": halfway + np.where(np.arange(40) == 20, 30.0, 0.0),
            "lower": jit * (1 - 0.001 * (1 + rng.random(40)))}[case]
    figures = {f: 20.0 for f in parity.FIGURES}
    for name, losses in (("port", port), ("ref_pallas", jit), ("ref_eager", eager)):
        (tmp_path / f"{name}.json").write_text(json.dumps(_parity_run(list(losses), figures)))
    assert parity.main(["summary", str(tmp_path)]) == 0
    verdict = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert verdict["faithful_f32"] == (case == "faithful"), verdict
    assert verdict["checked_inside"] == (case != "outside")
    assert (verdict["lower_share"] > parity.MAX_LOWER_SHARE) == (case == "lower")


def test_rounding_tool_imports_no_jax_and_no_reference():
    """``tools/repro_tpu_rounding.py`` runs on the card: it imports the port
    only."""
    script = r"""
import sys
import tools.repro_tpu_rounding
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hocon"))
assert not bad, bad
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr[-3000:]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_cuda_missing = pytest.MonkeyPatch()
        try:
            torch_cuda_missing.setattr(torch.cuda, "is_available", lambda: False)
            rounding.main(["0"])
        finally:
            torch_cuda_missing.undo()
