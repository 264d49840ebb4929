#!/usr/bin/env python3
"""Drive hocon_torch on one CUDA card and check that it is right.

    python3 chip_smoke.py [--out DIR]   # one CUDA card

Phases, each reported on its own line:

1. device  — the card (``nvidia-smi`` name and power limit) and the TF32
   switches, set off explicitly so f32 matmuls and convolutions are f32;
2. build   — nvcc builds every kernel from ``hocon_torch/csrc`` in parallel;
3. K1      — the soft-raster kernel against its plain PyTorch version on
   the main path's scene (16 views of the synthetic hand + a 1300-face
   object at 256^2, backface culling on), at gamma 1/40 (fixed-m softmax)
   and 1/100 (streaming softmax);
4. K2      — the soft-raster backward on the same scene at both gammas,
   with seeded noise cotangents on covered pixels, against its plain
   version evaluated in float64 (the arbiter) group by group (depth row,
   attribute rows, edge rows chained to the vertices), run twice to show
   the same bits; faults planted in its output must fail the check;
5. K3      — the bilinear sampler against its plain version at the
   rendered coordinates, plus coordinates far outside the image;
6. K4      — the sampler's coordinate gradient against its plain version
   at the same coordinates plus integer ones;
7. slice   — ``warp_loss`` under ``torch.no_grad`` at full width (HOCNet
   with a ResNet-18 trunk in bf16 autocast, 16 frame pairs of 256^2 uint8
   frames from ``assets/synth_cache``, hand + 1300-face object), then
   ``eval_step``; launch counters are zeroed just before and read just
   after, and every loss term must be finite with a non-empty mask;
8. train   — ``make_warp_train_step`` with Adam on the same batch: one
   warm-up step, then timed steps with all four counters zeroed just
   before; every kernel must launch every step, every term and the
   gradient norm be finite, and the loss fall over 8 steps; one step is
   profiled.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Longer diagnostics (compiler register report, profiler tables) go to
``--out`` (default ``build/hocon_torch/smoke`` beside this script).
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RES = 256
PAIRS = 16
OBJ_FACES = 1280  # requested faces of the UV sphere: 1300 after rounding
SIGMA = 1.0
GAMMAS = (1.0 / 40.0, 1.0 / 100.0)  # fixed-m path, streaming path
TIMED_FORWARDS = 5
TRAIN_STEPS = 8  # one warm-up step, then TRAIN_STEPS - 1 timed ones
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Tolerances of kernel vs plain version (same inputs, both f32 on the card).
SIL_ATOL = 2e-5  # the reference's silhouette parity bar
ATOL = 2e-4  # depth / vis bar of the reference
SAMPLE_ATOL = 1e-5  # lerps of texels in [0, 1]
# K2 against float64, group by group (``k2_groups``): max abs error at most
# a share of the group's own max |d|, and a cosine. Measured on the H100
# (worse gamma): depth 5.6e-5, attributes 3.0e-4, rows 0-8 at the vertices
# 2.5e-5, every cosine >= 1 - 9.6e-10.
K2_BARS = {"zbar": (2.5e-4, 1 - 1e-8), "attr": (1e-3, 1 - 1e-8),
           "geometry@verts": (2.5e-4, 1 - 1e-8)}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build(out_dir: str) -> None:
    from hocon_torch.utils import cuda_build

    t0 = time.perf_counter()
    per_lib = cuda_build.build()
    total = time.perf_counter() - t0
    report = []
    for name in cuda_build.KERNELS:
        text = cuda_build.build_log(name)
        report.append(f"== {name}\n{text}")
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"build {name}: {per_lib.get(name, 0.0):.1f}s; ptxas: {regs[:2]}")
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as fh:
        fh.write("\n".join(report))
    log(f"build: {total:.1f}s wall for {len(per_lib)} libraries (parallel nvcc)")


def make_scene(torch, device, pairs: int = PAIRS, res: int = RES, seed: int = 0):
    """Camera-space hand + object meshes for ``pairs`` target views, their
    reference-view copies, faces (B, F, 3), and the synthetic intrinsics."""
    from hocon_torch.data.synthetic import OBJ_SCALE, synthetic_camintr, uv_sphere
    from hocon_torch.geometry.mano import mano_forward, synthetic_mano_model

    mano = synthetic_mano_model(0, device=device)
    rng = np.random.default_rng(seed)
    sv, sf = uv_sphere(OBJ_FACES)
    obj_can = torch.from_numpy(sv * (OBJ_SCALE * 0.5)).to(device)

    def posed(pose, root, trans):
        v, j = mano_forward(mano, *(torch.from_numpy(x).to(device) for x in
                                    (pose, np.zeros((pairs, 10), np.float32), root, trans)),
                            scale_mm=False)
        obj = obj_can[None] + j[:, :1] + torch.tensor([0.0, 0.04, 0.02], device=device)
        return torch.cat([v, obj], dim=1)

    pose = (rng.standard_normal((pairs, 15)) * 0.3).astype(np.float32)
    root = (rng.standard_normal((pairs, 3)) * 0.3).astype(np.float32)
    trans = np.concatenate([rng.uniform(-0.03, 0.03, (pairs, 2)),
                            rng.uniform(0.55, 0.7, (pairs, 1))], 1).astype(np.float32)
    tgt = posed(pose, root, trans)
    ref = posed(pose + 0.1 * rng.standard_normal(pose.shape).astype(np.float32),
                root + 0.05, trans + np.float32([0.005, -0.005, 0.01]))
    faces = torch.cat([mano.faces, torch.from_numpy(sf).long().to(device) + mano.n_verts])
    faces = faces[None].expand(pairs, -1, -1)
    k = torch.from_numpy(synthetic_camintr(res)).to(device)[None].expand(pairs, 3, 3)
    return tgt, ref, faces, k


def raster_inputs(torch, tgt, ref, faces, k, res: int):
    """The kernel interface of K1 for the warp render of ``tgt``."""
    from hocon_torch.geometry.project import persp_project
    from hocon_torch.render import raster as R
    from hocon_torch.render import raster_cuda as RC

    tgt_pix = persp_project(tgt, k)
    ref_pix = persp_project(ref, k)
    faces_sorted, bbox = RC.sort_faces_by_y(tgt_pix, faces, backface_cull=True)
    planes = R.face_planes(tgt_pix, R.normalize_depth(tgt[..., 2]), faces_sorted,
                           ref_pix, backface_cull=True)
    coeffs, bounds = RC.pack_sorted_planes(planes, bbox, SIGMA)
    krange = RC.chunk_ranges(bounds, RC.padded_size((res, res))[0])
    return coeffs, bounds, krange


def k1_bound(torch, coeffs, bounds, krange, res: int):
    """Least time for K1's work on this data: bytes in and out once over
    the HBM rate, or the surviving (face, pixel) pairs times the
    operations per pair over the f32 rate, whichever is larger."""
    from hocon_torch.render import raster_cuda as RC

    b, fp, r3 = coeffs.shape
    n_user = r3 // 3 - 10
    hp, wp = RC.padded_size((res, res))
    xb = RC.lane_block(wp)
    hits = RC.cell_hits(bounds, krange, hp, wp, xb)  # (B, NC, NYB, NXB)
    pairs = int(hits.sum()) * RC.FACE_CHUNK * RC.ROW_BLOCK * xb
    # Per (face, pixel), counting an FMA as 2 and a transcendental or a
    # divide as 1: 7 + C affine rows at 4 each, then ~50 for the distance
    # to the triangle, the coverage sigmoid and the softmax accumulation.
    ops = pairs * (4 * (7 + n_user) + 50)
    nbytes = 4 * (coeffs.numel() + bounds.numel() + krange.numel()
                  + b * hp * wp * (1 + (n_user + 1) + 1 + 2))
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), pairs


def phase_k1(torch, device, scene, smi: str, out: dict) -> torch.Tensor:
    from hocon_torch.render import raster_cuda as RC

    tgt, ref, faces, k = scene
    cfg = RC.default_config()
    worst, coords, failures = 0.0, None, []
    coeffs, bounds, krange = raster_inputs(torch, tgt, ref, faces, k, RES)
    for gamma in GAMMAS:
        args = (coeffs, bounds, krange, (RES, RES), SIGMA, gamma, cfg)
        # The dispatcher the slice calls.
        got = RC.raster_fwd(coeffs, bounds, krange, (RES, RES), SIGMA, gamma, cfg)
        torch.cuda.synchronize()
        want = RC.raster_fwd_plain(*args)
        want64 = RC.raster_fwd_plain(coeffs.double(), *args[1:])
        torch.cuda.synchronize()
        n_user = got[1].shape[1] - 1  # attr holds C pixel coordinates, then zbar
        errs = {name: float((g - w).abs().max()) for name, g, w in (
            ("sil", got[0], want[0]), ("vis", got[2], want[2]))}
        # Rows of rim sliver faces make the attribute block sensitive to
        # f32 rounding, and the plain version (no FMAs) rounds worse than
        # the kernel: its depth lands up to ~8e-4 from a float64 evaluation
        # of the same coefficients, its pixel coordinates up to ~0.6 px.
        # So float64 is the arbiter. Depth, in [0, 1], must lie within the
        # bar of it; each pixel-coordinate channel may be no further from it
        # than the f32 plain version's same channel is, plus the bar.
        def from64(x, c):
            return float((x[1][:, c] - want64[1][:, c]).abs().max())

        errs["depth"], plain_depth = from64(got, n_user), from64(want, n_user)
        coord_errs = [(from64(got, c), from64(want, c)) for c in range(n_user)]
        errs["coords"] = max(e for e, _ in coord_errs)
        plain_coords = max(p for _, p in coord_errs)
        # m and log(den) carry zbar / gamma: the depth bar times 1/gamma,
        # with the same float64 arbiter as the coordinates.
        def mden_errs(x):
            m = float((x[:, 0] - want64[3][:, 0]).abs().max())
            den = float(((x[:, 1] - want64[3][:, 1]).abs() / want64[3][:, 1]).max())
            return m, den

        (m_err, den_rel), (m_plain, den_plain) = mden_errs(got[3]), mden_errs(want[3])
        sil_cov = float((want[0] > 1e-3).float().mean())
        log(f"K1 gamma=1/{1 / gamma:.0f} ({'fixed-m' if 1 / gamma <= 60 else 'streaming'}): "
            f"max abs err from plain: sil {errs['sil']:.3g} vis {errs['vis']:.3g}; "
            f"from float64: depth {errs['depth']:.3g} (plain f32 {plain_depth:.3g}) "
            f"coords {errs['coords']:.3g} (plain f32 {plain_coords:.3g}) "
            f"m {m_err:.3g} (plain {m_plain:.3g}) den rel {den_rel:.3g} "
            f"(plain {den_plain:.3g}); covered share {sil_cov:.3f}")
        tag = f"K1 gamma={gamma:.4g}"
        for name, bar in (("sil", SIL_ATOL), ("vis", ATOL), ("depth", ATOL)):
            if not errs[name] <= bar:
                failures.append(f"{tag} {name}: max err {errs[name]:.3g} > {bar}")
        for c, (e, p) in enumerate(coord_errs):
            if not e <= p + ATOL:
                failures.append(f"{tag} coord {c}: kernel {e:.3g} from float64, plain f32 {p:.3g}")
        if not (m_err <= m_plain + ATOL / gamma and den_rel <= den_plain + ATOL / gamma):
            failures.append(f"{tag} mden from float64: m {m_err:.3g} (plain {m_plain:.3g}), "
                            f"den rel {den_rel:.3g} (plain {den_plain:.3g})")
        worst = max(worst, *errs.values())
        if gamma == GAMMAS[0]:
            ms = cuda_ms(torch, lambda: RC.raster_fwd_cuda(*args), 20)
            plain_ms = cuda_ms(torch, lambda: RC.raster_fwd_plain(*args), 2)
            bound_ms, bound_by, pairs = k1_bound(torch, coeffs, bounds, krange, RES)
            coords = got[1][:, :2, :RES, :RES].permute(0, 2, 3, 1).contiguous()
            log(f"K1 time: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {pairs / 1e6:.1f}M face-pixel pairs, "
                f"{coeffs.shape[1]} padded faces); card {smi}")
    if failures:
        fail("; ".join(failures))
    out.update(name="raster_fwd", route="cuda", source="hocon_torch/csrc/raster_fwd.cu",
               replaces="hocon/render/raster_pallas.py:304", max_abs_err=worst, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return coords


def k2_bound(torch, coeffs, bounds, krange, res: int):
    """Least time for K2's work on this data: the surviving (face, pixel)
    pairs (K1's) times K2's operations per pair over the f32 rate, or its
    bytes in and out once over the HBM rate, whichever is larger."""
    from hocon_torch.render import raster_cuda as RC

    b, fp, r3 = coeffs.shape
    n_user = r3 // 3 - 10
    hp, wp = RC.padded_size((res, res))
    xb = RC.lane_block(wp)
    pairs = int(RC.cell_hits(bounds, krange, hp, wp, xb).sum()) * RC.FACE_CHUNK * RC.ROW_BLOCK * xb
    # Per (face, pixel), an FMA as 2, a transcendental or a divide as 1:
    # 7 + C affine rows at 4 each; 5 for each of the 10 + C rows' three
    # sums; ~140 for the distances, sigmoid, softmax chain, tie masks and
    # overhang branches.
    ops = pairs * (4 * (7 + n_user) + 5 * (10 + n_user) + 140)
    per_pixel = 1 + (n_user + 1) + 1 + 2 + 1 + (n_user + 1) + 1  # 4 outputs, 3 cotangents
    nbytes = 4 * (2 * coeffs.numel() + bounds.numel() + krange.numel() + b * hp * wp * per_pixel)
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), pairs


def geometry_chain(torch, tgt, faces, k):
    """The chain rule from rows 0-8 of dcoeffs (edge, along-edge and length
    rows) to the target-view vertex pixels (B, V, 2), in float64.

    Outside a face near a vertex, the squared distances to its two edges
    (with their overhangs) both equal the squared distance to that vertex,
    over the whole vertex region and not on a line only: which edge's rows
    take a pixel's gradient is decided by rounding, at any precision. The
    rows therefore differ from any other evaluation edge by edge, while
    their sum at the vertex does not, so these rows are held there.
    """
    from hocon_torch.geometry.project import persp_project
    from hocon_torch.render import raster as R
    from hocon_torch.render import raster_cuda as RC

    tgt_pix = persp_project(tgt, k)
    faces_sorted, _ = RC.sort_faces_by_y(tgt_pix, faces, backface_cull=True)
    leaf = tgt_pix.detach().double().requires_grad_(True)
    planes = R.face_planes(leaf, R.normalize_depth(tgt[..., 2].double()), faces_sorted, None,
                           backface_cull=True)
    b, f = planes.valid.shape
    valid = planes.valid[..., None, None]

    def chain(dcoeffs):
        d = dcoeffs.double().reshape(b, -1, dcoeffs.shape[-1] // 3, 3)[:, :f, :9]
        return torch.autograd.grad(planes.rows[:, :, :9], leaf, d * valid, retain_graph=True)[0]

    return chain


def k2_groups(d, chain) -> dict:
    """dcoeffs (B, Fp, 3R) by group: the depth row 9, the attribute rows
    10-11 (the warp's reference-pixel coordinates) and rows 0-8 chained to
    the vertices; then, for the record only, rows 0-8 row group by group."""
    rows = d.reshape(d.shape[0], d.shape[1], -1, 3)
    return {"zbar": rows[:, :, 9], "attr": rows[:, :, 10:], "geometry@verts": chain(d),
            "edge": rows[:, :, 0:3], "along": rows[:, :, 3:6], "length": rows[:, :, 6:9]}


def k2_compare(got, want64, chain) -> dict:
    """Per group: (max abs error, the group's max |d|, cosine) from float64."""
    stats = {}
    want = k2_groups(want64, chain)
    for name, g in k2_groups(got.double(), chain).items():
        w = want[name]
        cos = float((g * w).sum() / (g.norm() * w.norm()))
        stats[name] = (float((g - w).abs().max()), float(w.abs().max()), cos)
    return stats


def k2_failures(stats: dict) -> list:
    failures = []
    for name, (rel, min_cos) in K2_BARS.items():
        err, scale, cos = stats[name]
        if not (err <= rel * scale and cos > min_cos):
            failures.append(f"{name}: max err {err:.4g} (bar {rel} x {scale:.4g}), cosine "
                            f"1-{1 - cos:.3g} (bar 1-{1 - min_cos:.3g})")
    return failures


def k2_line(stats: dict) -> str:
    return "; ".join(f"{name} {err:.3g} of {scale:.3g}, cos 1-{1 - cos:.2g}"
                     for name, (err, scale, cos) in stats.items())


def _planted(rows_sel, factor):
    def fault(d):
        d = d.clone()
        view = d.view(d.shape[0], d.shape[1], -1, 3)
        view[:, :, rows_sel] *= factor
        return d
    return fault


# Faults planted in the kernel's output: the check must fail each of them.
K2_PLANTED = {
    "attribute rows zeroed": _planted(slice(10, 12), 0.0),
    "attribute rows 0.5 % high": _planted(slice(10, 12), 1.005),
    "depth row 0.5 % low": _planted(9, 0.995),
    "along-edge rows zeroed": _planted(slice(3, 6), 0.0),
    "length rows zeroed": _planted(slice(6, 9), 0.0),
}


def phase_k2(torch, device, scene, smi: str, out: dict) -> None:
    from hocon_torch.render import raster_cuda as RC

    tgt, ref, faces, k = scene
    cfg = RC.default_config()
    size = (RES, RES)
    coeffs, bounds, krange = raster_inputs(torch, tgt, ref, faces, k, RES)
    chain = geometry_chain(torch, tgt, faces, k)
    worst, failures = 0.0, []
    for gamma in GAMMAS:
        fwd = RC.raster_fwd(coeffs, bounds, krange, size, SIGMA, gamma, cfg)
        sil = fwd[0]
        # Seeded noise cotangents on covered pixels (the reference's test):
        # elsewhere the culled kernel and an unculled raster differ by design.
        gen = torch.Generator(device=device).manual_seed(0)
        sup = (sil > 1e-3).float()
        gsil = torch.randn(sil.shape, generator=gen, device=device) * sup
        gattr = torch.randn(fwd[1].shape, generator=gen, device=device) * sup[:, None]
        gvis = torch.randn(sil.shape, generator=gen, device=device) * sup
        state = (*fwd, gsil, gattr, gvis)
        # The dispatcher the autograd Function calls, twice: no atomics, so
        # the same bits.
        got = RC.raster_bwd(coeffs, bounds, krange, *state, size, SIGMA, gamma, cfg)
        again = RC.raster_bwd(coeffs, bounds, krange, *state, size, SIGMA, gamma, cfg)
        torch.cuda.synchronize()
        same_bits = torch.equal(got, again)
        plain = RC.raster_bwd_plain(coeffs, bounds, krange, *state, size, SIGMA, gamma, cfg)
        # Rim slivers and vertex regions make every f32 evaluation round
        # differently: float64 on the same f32 inputs is the arbiter.
        want64 = RC.raster_bwd_plain(coeffs.double(), bounds, krange,
                                     *(t.double() for t in state), size, SIGMA, gamma, cfg)
        torch.cuda.synchronize()
        stats = k2_compare(got, want64, chain)
        tag = f"K2 gamma=1/{1 / gamma:.0f}"
        log(f"{tag} kernel from float64: {k2_line(stats)}; repeat bitwise equal: {same_bits}")
        log(f"{tag} plain f32 from float64: {k2_line(k2_compare(plain, want64, chain))}")
        failures += [f"{tag} {msg}" for msg in k2_failures(stats)]
        if not same_bits:
            failures.append(f"{tag}: two launches differ")
        missed = [name for name, fault in K2_PLANTED.items()
                  if not k2_failures(k2_compare(fault(got), want64, chain))]
        log(f"{tag} planted faults caught: {len(K2_PLANTED) - len(missed)} of {len(K2_PLANTED)}")
        failures += [f"{tag}: the check passes the planted fault '{name}'" for name in missed]
        worst = max(worst, float((got.double() - want64).abs().max()))
        if gamma == GAMMAS[0]:
            args = (coeffs, bounds, krange, *state, size, SIGMA, gamma, cfg)
            ms = cuda_ms(torch, lambda: RC.raster_bwd_cuda(*args), 20)
            plain_ms = cuda_ms(torch, lambda: RC.raster_bwd_plain(*args), 2)
            bound_ms, bound_by, pairs = k2_bound(torch, coeffs, bounds, krange, RES)
            log(f"K2 time: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {pairs / 1e6:.1f}M face-pixel pairs); card {smi}")
    if failures:
        fail("; ".join(failures))
    out.update(name="raster_bwd", route="cuda", source="hocon_torch/csrc/raster_bwd.cu",
               replaces="hocon/render/raster_pallas.py:553", max_abs_err=worst, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def load_frames():
    files = sorted(glob.glob(os.path.join(HERE, "assets", "synth_cache", "*.npz")))
    if not files:
        fail("no rendered frames under assets/synth_cache")
    with np.load(files[0]) as z:
        return z["images"], z["verts"], z["joints"]


def phase_k3(torch, device, coords, images, smi: str, out: dict) -> None:
    import torch.nn.functional as F

    from hocon_torch.render import sample_cuda as SC

    img = torch.from_numpy(images[:PAIRS]).to(device).float().div_(255.0).contiguous()
    xy = coords.clone()
    xy[:, 0, :8] = torch.tensor([[-40.0, 3.0], [RES + 40.0, 3.0], [5.0, -1e4], [7.5, RES + 9.0],
                                 [0.5, 0.5], [RES - 0.5, RES - 0.5], [3.0, 4.0], [1e6, 1e6]],
                                device=device)
    got = SC.sample_fwd(img, xy)  # the dispatcher the slice calls
    want = SC.sample_fwd_plain(img, xy)
    err = float((got - want).abs().max())
    if not err <= SAMPLE_ATOL:
        fail(f"K3 max err {err:.3g} > {SAMPLE_ATOL}")
    ms = cuda_ms(torch, lambda: SC.sample_fwd_cuda(img, xy), 50)
    plain_ms = cuda_ms(torch, lambda: SC.sample_fwd_plain(img, xy), 10)
    # Library yardstick: grid_sample with the same border clamp, NCHW in.
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = xy / torch.tensor([RES / 2.0, RES / 2.0], device=device) - 1.0
    lib = F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="border",
                        align_corners=False).permute(0, 2, 3, 1)
    lib_err = float((lib - want).abs().max())
    library_ms = cuda_ms(torch, lambda: F.grid_sample(
        img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=False), 50)
    nbytes = 4 * (xy.numel() + img.numel() + got.numel())
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    log(f"K3: max abs err {err:.3g} (grid_sample differs by {lib_err:.3g}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB); card {smi}")
    out.update(name="sample_fwd", route="cuda", source="hocon_torch/csrc/sample_fwd.cu",
               replaces="hocon/render/sample_pallas.py:105", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


def phase_k4(torch, device, coords, images, smi: str, out: dict) -> None:
    from hocon_torch.render import sample_cuda as SC

    img = torch.from_numpy(images[:PAIRS]).to(device).float().div_(255.0).contiguous()
    xy = coords.clone()
    # Off-image and clamped coordinates (gradient 0), pixel centres, and
    # coordinates whose x - 0.5 / y - 0.5 are integers (right-hand slope).
    xy[:, 0, :10] = torch.tensor([[-40.0, 3.0], [RES + 40.0, 3.0], [5.0, -1e4], [7.5, RES + 9.0],
                                  [0.5, 0.5], [RES - 0.5, RES - 0.5], [3.0, 4.0], [1e6, 1e6],
                                  [5.5, 7.5], [100.5, 20.25]], device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    g = torch.randn(xy.shape[:3] + (img.shape[-1],), generator=gen, device=device)
    got = SC.sample_bwd(img, xy, g)  # the dispatcher the autograd Function calls
    want = SC.sample_bwd_plain(img, xy, g)
    err = float((got - want).abs().max())
    if not err <= SAMPLE_ATOL:
        fail(f"K4 max err {err:.3g} > {SAMPLE_ATOL}")
    ms = cuda_ms(torch, lambda: SC.sample_bwd_cuda(img, xy, g), 50)
    plain_ms = cuda_ms(torch, lambda: SC.sample_bwd_plain(img, xy, g), 10)
    # Library yardstick: grid_sample's backward, grid gradient only.
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    grid = xy / torch.tensor([RES / 2.0, RES / 2.0], device=device) - 1.0
    lib_bwd = torch.ops.aten.grid_sampler_2d_backward

    def library():  # interpolation bilinear (0), padding border (1)
        return lib_bwd(g_nchw, img_nchw, grid, 0, 1, False, [False, True])[1]

    library_ms = cuda_ms(torch, library, 50)
    nbytes = 4 * (img.numel() + xy.numel() + g.numel() + got.numel())
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    log(f"K4: max abs err {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"grid_sampler_2d_backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB); card {smi}")
    out.update(name="sample_bwd", route="cuda", source="hocon_torch/csrc/sample_bwd.cu",
               replaces="hocon/render/sample_pallas.py:133", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


def make_batch(images, verts, joints):
    """16 (ref, tgt) pairs of cached 256^2 frames with their ground truth,
    in the reference's batch layout (uint8 images, centred-mm targets)."""
    from hocon_torch.data.synthetic import OBJ_SCALE, synthetic_camintr, uv_sphere

    sv, sf = uv_sphere(OBJ_FACES)
    obj_can = (sv * (OBJ_SCALE * 0.5)).astype(np.float32)
    k = synthetic_camintr(RES)
    videos = len(images) // 16
    ref_idx = np.array([v * 16 + r for v in range(videos) for r in range(PAIRS // videos)])
    tgt_idx = ref_idx + 4

    def view(idx, supervised):
        j, v = joints[idx], verts[idx]
        center = j[:, 9]
        hom = j @ k.T
        obj_cam = obj_can[None] + j[:, :1] + np.float32([0.0, 0.04, 0.02])
        n = len(idx)
        return {
            "image": images[idx],
            "camintr": np.repeat(k[None], n, 0),
            "joints2d": (hom[..., :2] / hom[..., 2:]).astype(np.float32),
            "joints3d": ((j - center[:, None]) * 1000.0).astype(np.float32),
            "verts3d": ((v - center[:, None]) * 1000.0).astype(np.float32),
            "center3d": center.astype(np.float32),
            "sup_mask": np.full((n,), float(supervised), np.float32),
            "obj_verts_can": np.repeat(obj_can[None], n, 0),
            "obj_faces": np.repeat(sf[None], n, 0).astype(np.int32),
            "objverts3d": ((obj_cam - center[:, None]) * 1000.0).astype(np.float32),
            "obj_verts_mask": np.ones((n, len(obj_can)), np.float32),
        }

    return {"ref": view(ref_idx, True), "tgt": view(tgt_idx, False)}


def phase_slice(torch, device, batch, smi: str, out_dir: str, kernels: list) -> None:
    from hocon_torch.geometry.mano import synthetic_mano_model
    from hocon_torch.models.hocnet import HOCNet
    from hocon_torch.render import raster_cuda as RC
    from hocon_torch.render import sample_cuda as SC
    from hocon_torch.train.steps import batch_to_device, eval_step, warp_loss

    mano = synthetic_mano_model(0, device=device)
    model = HOCNet(with_object=True, dtype=torch.bfloat16, seed=0, device=device)
    batch = batch_to_device(batch, torch.device(device))
    size = (RES, RES)
    with torch.no_grad():
        warp_loss(model, mano, batch, size, device=device)  # warm-up
        torch.cuda.synchronize()
        RC.raster_fwd.launches = SC.sample_fwd.launches = 0
        t0 = time.perf_counter()
        for _ in range(TIMED_FORWARDS):
            total, terms = warp_loss(model, mano, batch, size, device=device)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / TIMED_FORWARDS
        preds = eval_step(model, mano, batch["ref"], device=device)
        torch.cuda.synchronize()
        launches = {"raster_fwd": RC.raster_fwd.launches, "sample_fwd": SC.sample_fwd.launches}
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    if min(launches.values()) < TIMED_FORWARDS:
        fail(f"main path did not launch every kernel per forward: {launches}")
    vals = {k: float(v) for k, v in terms.items()}
    bad = [k for k, v in vals.items() if not math.isfinite(v)]
    if bad or vals["mask_area"] <= 0:
        fail(f"slice terms not finite or empty mask: {vals}")
    for k, v in preds.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"eval_step prediction {k} not finite")
    if tuple(preds["verts_c_mm"].shape) != (PAIRS, 778, 3):
        fail(f"eval_step verts shape {tuple(preds['verts_c_mm'].shape)}")
    log("slice terms: " + json.dumps({k: round(v, 6) for k, v in sorted(vals.items())}))
    log(f"slice: warp_loss forward {dt * 1e3:.2f} ms per {PAIRS} pairs at {RES}^2 -> "
        f"{PAIRS / dt:.1f} pairs/s; launches per forward {launches} over "
        f"{TIMED_FORWARDS} forwards; card {smi}")

    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warp_loss(model, mano, batch, size, device=device)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(out_dir, "profile_warp_loss.txt"), "w") as fh:
        fh.write(table)
    log(profile_line(prof, "one forward", smi))


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def profile_line(prof, what: str, smi: str) -> str:
    """Device time of a profiled window and its six largest kernels. Ranges
    such as ``Optimizer.step#...`` are annotations spanning kernels that
    are counted on their own, so they are left out."""
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    top = sorted(events, key=lambda e: -dev_us(e))[:6]
    return (f"profile: device time {sum(map(dev_us, events)) / 1e3:.2f} ms in {what}; top: "
            + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms" for e in top) + f"; card {smi}")


def phase_train(torch, device, batch, smi: str, out_dir: str, kernels: list) -> None:
    from hocon_torch.geometry.mano import synthetic_mano_model
    from hocon_torch.models.hocnet import HOCNet
    from hocon_torch.render import raster_cuda as RC
    from hocon_torch.render import sample_cuda as SC
    from hocon_torch.train.state import create_train_state, make_optimizer
    from hocon_torch.train.steps import batch_to_device, make_warp_train_step

    mano = synthetic_mano_model(0, device=device)
    model = HOCNet(with_object=True, dtype=torch.bfloat16, seed=0, device=device)
    optimizer = make_optimizer("adam", 5e-4)
    state = create_train_state(model, optimizer)
    step = make_warp_train_step(model, mano, optimizer, image_size=(RES, RES), device=device)
    batch = batch_to_device(batch, torch.device(device))
    counters = (RC.raster_fwd, RC.raster_bwd, SC.sample_fwd, SC.sample_bwd)

    state, terms = step(state, batch)  # warm-up
    first = {k: float(v) for k, v in terms.items()}
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    timed = TRAIN_STEPS - 1
    t0 = time.perf_counter()
    for _ in range(timed):
        state, terms = step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    launches = {c.__name__: c.launches for c in counters}
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    if min(launches.values()) < timed:
        fail(f"train step did not launch every kernel every step: {launches} over {timed} steps")
    last = {k: float(v) for k, v in terms.items()}
    bad = [k for k, v in {**first, **last}.items() if not math.isfinite(v)]
    if bad or not last["grad_norm"] > 0 or not last["mask_area"] > 0:
        fail(f"train terms not finite, zero gradient or empty mask: first {first}, last {last}")
    if not last["loss_total"] < first["loss_total"]:
        fail(f"loss did not fall over {TRAIN_STEPS} steps: {first['loss_total']} -> "
             f"{last['loss_total']}")
    log("train terms, step 1: " + json.dumps({k: round(v, 6) for k, v in sorted(first.items())}))
    log(f"train terms, step {TRAIN_STEPS}: "
        + json.dumps({k: round(v, 6) for k, v in sorted(last.items())}))
    log(f"train: warp train step {dt * 1e3:.2f} ms per {PAIRS} pairs at {RES}^2 -> "
        f"{PAIRS / dt:.1f} pairs/s (mean of {timed} steps after 1 warm-up); launches "
        f"{launches}; card {smi}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, terms = step(state, batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=100)
    with open(os.path.join(out_dir, "profile_train_step.txt"), "w") as fh:
        fh.write(table)
    log(profile_line(prof, "one train step", smi))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke drives the port on the card only")
    sys.path.insert(0, HERE)
    try:
        import hocon_torch
    except ImportError:
        fail("hocon_torch is not beside chip_smoke.py")
    if os.path.dirname(os.path.abspath(hocon_torch.__file__)) != os.path.join(HERE, "hocon_torch"):
        fail(f"hocon_torch imported from {hocon_torch.__file__}, not from this checkout")
    import argparse

    ap = argparse.ArgumentParser(description="Drive hocon_torch on one CUDA card.")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "hocon_torch", "smoke"),
                    help="directory for the ptxas report and the profiler table")
    out_dir = os.path.abspath(ap.parse_args().out)
    os.makedirs(out_dir, exist_ok=True)
    device = "cuda"

    smi = phase_device(torch)
    phase_build(out_dir)
    scene = make_scene(torch, device)
    k1, k2, k3, k4 = {}, {}, {}, {}
    coords = phase_k1(torch, device, scene, smi, k1)
    phase_k2(torch, device, scene, smi, k2)
    images, verts, joints = load_frames()
    phase_k3(torch, device, coords, images, smi, k3)
    phase_k4(torch, device, coords, images, smi, k4)
    batch = make_batch(images, verts, joints)
    phase_slice(torch, device, batch, smi, out_dir, [k1, k3])
    # The train step is the main path: its launches go into the table.
    phase_train(torch, device, batch, smi, out_dir, [k1, k2, k3, k4])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in (k1, k2, k3, k4)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
