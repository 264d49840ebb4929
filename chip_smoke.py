#!/usr/bin/env python3
"""Drive hocon_torch on one CUDA card and check that it is right.

    python3 chip_smoke.py [--out DIR]   # one CUDA card

Phases, each reported on its own line:

1. device  — the card (``nvidia-smi`` name and power limit) and the TF32
   switches, set off explicitly so f32 matmuls and convolutions are f32;
2. build   — nvcc builds every kernel from ``hocon_torch/csrc`` in parallel;
3. data    — the data path of ``bench_torch.py`` (its ``dataset_kwargs``):
   ``get_dataset`` renders the synthetic dataset (32 frames at 256^2, hand
   + 1300-face object) on the card through K1 at 3 colour channels, with
   K1's counter zeroed just before and read just after; K1 at C = 3 is
   checked on that render's own inputs (against its plain version, bit
   for bit against ``far_logit=inf``, and against float64 on the values
   that rim slivers do not move) and timed; the port's render of the
   verts stored with the TPU's frames (``TPU_FRAMES``) is compared with
   those frames, for the record; then one ``BatchLoader`` batch of 16
   pairs, which the slice and train phases use;
4. K1      — the soft-raster kernel against its plain PyTorch version on
   the warp's scene (16 views of the synthetic hand + a 1300-face object
   at 256^2, backface culling on), at gamma 1/40 (fixed-m softmax) and
   1/100 (streaming softmax), and against itself with its skip turned
   off (``far_logit=inf``), bit for bit; the tiles and pairs it evaluates
   are counted on the host (``raster_cuda.far_faces`` at ``K1_TILE``);
5. K2      — the soft-raster backward on the same scene at both gammas,
   with seeded noise cotangents on covered pixels, against its plain
   version evaluated in float64 (the arbiter) group by group (depth row,
   attribute rows, edge rows chained to the vertices), run twice to show
   the same bits; faults planted in its output must fail the check; the
   row segments and pairs it evaluates under its skip rule are counted on
   the host (``raster_cuda.far_faces``) against K1's pairs;
6. K3      — the bilinear sampler against its plain version on the
   rendered frames at K1's coordinates, plus coordinates far outside the
   image and a query count that is not a multiple of 4; timed in turns
   with ``grid_sample``, cold (inputs cycled past the L2) and L2-hot;
7. K4      — the sampler's coordinate gradient against its plain version
   at the same coordinates plus integer ones;
8. slice   — ``warp_loss`` under ``torch.no_grad`` at full width (HOCNet
   with a ResNet-18 trunk in bf16 autocast, the data phase's batch), then
   ``eval_step``; launch counters are zeroed just before and read just
   after, and every loss term must be finite with a non-empty mask;
9. train   — ``make_warp_train_step`` with Adam on the same batch: one
   warm-up step, then timed steps with all four counters zeroed just
   before; every kernel must launch every step, every term and the
   gradient norm be finite, and the loss fall over 8 steps; one step is
   profiled;
10. cli    — the port's entry points as a user runs them, in a temporary
   directory under ``--out`` (removed after): ``hocon_torch.cli.trainwarp``
   at full width (``CLI_FLAGS``: 256^2 crops, batch 16, hand + object,
   4 videos x 16 frames, a quarter annotated, 2 epochs, Adam at 5e-4; bf16
   autocast, frozen batch norm and every other flag at its default), with
   every counter zeroed just before and read just after: K1 at C = 3 once
   per dataset (train and val), K1 at C = 2, K2, K3 and K4 once per train
   step, every logged term finite, ``opt.txt`` / ``opt.json`` /
   ``metrics.jsonl`` / ``epochs.json`` / ``ckpt/8`` written; a second call
   with ``--epochs 1`` auto-restores step 8 and logs steps 9-12;
   ``evaluate --resume`` reproduces the trainer's last val MPJPE;
   ``predict`` covers the val split once through a padded tail batch; a
   2-step ``--no_freeze_batchnorm`` run moves the running statistics;
11. import_vis — PyTorch weight files and the visualisation, in a
   temporary directory under ``--out``: a torchvision-named ResNet-18 file
   and a reference-named checkpoint (``module.``-prefixed, axis-angle
   object rotation) written with ``torch.save`` from a seed
   (``tools/torch_weights.py``); ``train --torch_trunk --lr 0 --vis_freq 1``
   at full width (2 steps with eval): every trunk tensor bit for bit the
   file's, and one grid per eval batch; ``evaluate --torch_ckpt`` with the
   axis-angle override and a finite MPJPE; ``trainwarp --vis_freq 1`` for
   one epoch (2 steps, no eval) with every counter zeroed just before and
   read just after, and read around the one panel call: it launches K1 at
   C = 2 once and K3 once, K2 and K4 not at all, and its panels are finite
   with a non-empty mask; the PNGs are required where ``import
   matplotlib`` succeeds (the phase prints whether it does);
12. real_data — the FPHAB and HO-3D path: nvJPEG's decodes of the
   committed JPEG fixtures (``tests/data/jpeg/``) against their cv2 decodes
   within ``JPEG_BARS`` (a copy shifted by ``JPEG_FAULT`` levels on one
   channel must fail them), a 1920 x 1080 frame encoded and decoded by
   nvJPEG within ``ROUNDTRIP_BARS`` of its pixels (the same fault must fail
   them), a 640 x 480 PNG of every row filter bit for bit, one decode of
   each timed; then, in a temporary directory under
   ``--out``, an FPHAB tree (3 train + 1 test sequences of 16 1920 x 1080
   frames encoded by nvJPEG, MANO fits of the synthetic model, their joints
   as world-frame skeletons, object poses, a 20000-face PLY) and an HO-3D
   tree (2 sequences of 16 640 x 480 PNGs, meta pickles, a dense OBJ);
   ``trainwarp --check_data`` exits 0 with the object decimated to <= 1000
   faces; ``trainwarp`` at full width (256^2, batch 16, hand + object, a
   quarter annotated, 1 epoch) with K1 at C = 2, K2, K3 and K4 once per
   step, every JPEG through nvJPEG (the CPU decoder fails the phase), finite
   terms and a checkpoint; one batch's host time; the HO-3D fit-vertex
   memmap's build time; ``evaluate --check_data`` exits 0 and ``evaluate``
   of the FPHAB checkpoint gives a finite MPJPE on HO-3D;
13. workers — DataLoader workers and MANO assets, in a temporary directory
   under ``--out``: an FPHAB tree of 3 + 1 sequences of 64 frames (12 steps
   of 16 pairs per epoch) and the HO-3D tree; the first batch of
   ``WorkerEpochLoader`` with W workers (W from ``os.cpu_count()``,
   every core but two) bit for bit ``BatchLoader(prefetch=0)``'s, while the
   CPU decoder's batch differs, and the card's memory in use with the
   decoding workers and without; ``trainwarp`` on FPHAB at full width with
   ``--workers 0`` and ``--workers W`` in turns, two runs each (no eval),
   K1 at C = 2, K2, K3 and K4 once per step in this process and every
   nvJPEG decode in the workers; ``evaluate --workers W`` on HO-3D gives
   ``--workers 0``'s metrics exactly; ``MANO_RIGHT.pkl`` in the official
   pickle's layout (``tools/fixture_trees.write_mano_pkl``) read to CUDA
   tensors for the right hand, the left hand mirrored from it and read
   from a ``MANO_LEFT.pkl``; ``trainwarp --mano_side left`` from the pickle
   at full width with finite terms and K1-K4 once per step;
14. repro — the paper's consistency-gain ablation through the command line
   of ``tools/repro_torch_consistency.py`` at the reference's shapes (128^2,
   batch 16, 8 videos of 16 frames, 2 of 16 annotated, the box scene,
   seed 0), its three stages cut from 300 steps to ``REPRO_STEPS``: every
   counter zeroed just before and read just after, and around every step
   the tool takes, so K1 at C = 2, K2, K3 and K4 launch exactly once in
   each warp step and never in a supervised or eval step, and K1 at C = 3
   once per dataset; the six MPJPE figures finite, the JSON line with the
   reference's keys, the warp stage on a copy of the model; the phase's
   and each stage's seconds printed. The gain's sign is not gated: one
   short seed near the boundary is bistable.

After the phases, and after a failed one too, the script stops every
process it started (the workers' forkserver and multiprocessing's resource
tracker; the workers stop with their CLI calls) and fails if any process
under it is left.

Kernel times are CUDA-event means over many launches, with the stream held
while the host issues them (``cuda_ms_rotating``), so they are the card's
time and not the host's issue rate.

The line before the last is the kernel table as JSON (launches from the
cli phase's first ``trainwarp`` call, the slice's main path); the last
line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Longer diagnostics (compiler register report, profiler tables) go to
``--out`` (default ``build/hocon_torch/smoke`` beside this script).
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RES = 256
PAIRS = 16
OBJ_FACES = 1280  # requested faces of the UV sphere: 1300 after rounding
# The JAX bench's frames, rendered on the TPU by the Pallas kernel (its
# cache key: 1280-face object, 2 x 16 frames, 256^2, seed 0); compared with
# the port's render of the same verts for the record only.
TPU_FRAMES = os.path.join("assets", "synth_cache", "synth-e6ed93a93e4f739e.npz")
SIGMA = 1.0
GAMMAS = (1.0 / 40.0, 1.0 / 100.0)  # fixed-m path, streaming path
TIMED_FORWARDS = 5
TRAIN_STEPS = 8  # one warm-up step, then TRAIN_STEPS - 1 timed ones
# K3 and grid_sample are timed in turns (K3, grid_sample, grid_sample, K3)
# over SAMPLE_REPS launches each, cold: cycling through COLD_COPIES copies of
# image and coordinates (4 x 21 MB of inputs, past the 50 MB L2), and hot.
SAMPLE_REPS = 200
COLD_COPIES = 4
HOLD_CYCLES = 100_000_000  # ~50 ms of SM clock: longer than the host takes to issue a timing run
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Tolerances of kernel vs plain version (same inputs, both f32 on the card).
SIL_ATOL = 2e-5  # the reference's silhouette parity bar
ATOL = 2e-4  # depth / vis bar of the reference
ATTR_RTOL = 1e-4  # relative, for colours extrapolated past 1 (tests/test_torch_raster.py)
# Rim slivers: faces with |2 x area| below this share of their longest
# edge squared, whose plane rows f32 gets wrong in every evaluation order.
SLIVER_FRAC = 0.05
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
    return cuda_ms_rotating(torch, [fn], reps)


def cuda_ms_rotating(torch, fns: list, reps: int) -> float:
    """Mean device time per launch over ``reps`` launches that cycle
    through ``fns`` (CUDA events), after one warm-up call of each.

    The stream first spins for ``HOLD_CYCLES`` while the host enqueues
    every launch, so the events time the card running them back to back:
    a launch of ~0.02 ms costs the host about as long to issue, and
    without the hold the events time the host's issue rate.
    """
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
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


def ptxas_summary(text: str) -> list:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: registers, static
    shared memory and spills, e.g. '96 registers, 0 bytes smem, spills 0/0'."""
    out, spills = [], "?"
    for ln in text.splitlines():
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if found:
            spills = "/".join(found.groups())
        found = re.search(r"Used (\d+) registers", ln)
        if found:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{found.group(1)} registers, {smem.group(1) if smem else 0} bytes smem, "
                       f"spills {spills}")
    return out


def phase_build(out_dir: str) -> None:
    from hocon_torch.utils import cuda_build

    t0 = time.perf_counter()
    per_lib = cuda_build.build()
    total = time.perf_counter() - t0
    report = []
    for name in cuda_build.SOURCES:
        text = cuda_build.build_log(name)
        report.append(f"== {name}\n{text}")
        log(f"build {name}: {per_lib.get(name, 0.0):.1f}s; ptxas: {ptxas_summary(text)}")
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as fh:
        fh.write("\n".join(report))
    log(f"build: {total:.1f}s wall for {len(per_lib)} libraries (parallel nvcc)")


def make_scene(torch, device, pairs: int = PAIRS, res: int = RES, seed: int = 0):
    """Camera-space hand + object meshes for ``pairs`` target views, their
    reference-view copies, faces (B, F, 3), and the synthetic intrinsics."""
    from hocon_torch.data.synthetic import OBJ_OFFSET, OBJ_SCALE, synthetic_camintr, uv_sphere
    from hocon_torch.geometry.mano import mano_forward, synthetic_mano_model

    mano = synthetic_mano_model(0, device=device)
    rng = np.random.default_rng(seed)
    sv, sf = uv_sphere(OBJ_FACES)
    obj_can = torch.from_numpy(sv * (OBJ_SCALE * 0.5)).to(device)

    def posed(pose, root, trans):
        v, j = mano_forward(mano, *(torch.from_numpy(x).to(device) for x in
                                    (pose, np.zeros((pairs, 10), np.float32), root, trans)),
                            scale_mm=False)
        obj = obj_can[None] + j[:, :1] + torch.from_numpy(OBJ_OFFSET).to(device)
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


def cell_pairs(torch, bounds, krange, res: int) -> int:
    """The (face, pixel) pairs of the cells (8-row block x lane block) in
    which K1 evaluates each chunk: every face of the chunk at every pixel."""
    from hocon_torch.render import raster_cuda as RC

    hp, wp = RC.padded_size((res, res))
    xb = RC.lane_block(wp)
    hits = RC.cell_hits(bounds, krange, hp, wp, xb)  # (B, NC, NYB, NXB)
    return int(hits.sum()) * RC.FACE_CHUNK * RC.ROW_BLOCK * xb


def k1_bound(torch, coeffs, bounds, krange, res: int, pairs: int):
    """Least time for K1's work: bytes in and out once over the HBM rate,
    or ``pairs`` (face, pixel) pairs times the operations per pair over the
    f32 rate, whichever is larger."""
    from hocon_torch.render import raster_cuda as RC

    b, fp, r3 = coeffs.shape
    n_user = r3 // 3 - 10
    hp, wp = RC.padded_size((res, res))
    # Per (face, pixel), counting an FMA as 2 and a transcendental or a
    # divide as 1: 7 + C affine rows at 4 each, then ~50 for the distance
    # to the triangle, the coverage sigmoid and the softmax accumulation.
    ops = pairs * (4 * (7 + n_user) + 50)
    nbytes = 4 * (coeffs.numel() + bounds.numel() + krange.numel()
                  + b * hp * wp * (1 + (n_user + 1) + 1 + 2))
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def k1_tiles(torch, coeffs, bounds, krange, res: int, gamma: float, sigma: float = SIGMA) -> dict:
    """What K1 evaluates on this data, by its skip rule mirrored on the
    host (``raster_cuda.far_faces`` with ``K1_TILE``): the (chunk, tile)
    pairs of K1's cells, those with a live face, and the live (face, tile)
    and (face, pixel) pairs."""
    from hocon_torch.render import raster_cuda as RC

    cfg = RC.default_config()
    hp, wp = RC.padded_size((res, res))
    xb = RC.lane_block(wp)
    b, nc = bounds.shape[:2]
    th, tw = RC.K1_TILE
    in_cell = RC.cell_hits(bounds, krange, hp, wp, xb)  # (B, NC, NYB, NXB)
    in_cell = in_cell.repeat_interleave(RC.ROW_BLOCK // th, 2).repeat_interleave(xb // tw, 3)
    far = RC.far_faces(coeffs, bounds, krange, (res, res), sigma, cfg, tile=RC.K1_TILE,
                       far_logit=RC.k1_far_logit(gamma))
    live = in_cell[:, :, None] & ~far.view(b, nc, cfg.face_chunk, *in_cell.shape[2:])
    n_live = int(live.sum())
    return {"tiles": int(in_cell.sum()), "live_tiles": int(live.any(dim=2).sum()),
            "live": n_live, "pairs": n_live * th * tw}


def check_k1(torch, args, tag: str, moved=None) -> tuple[list, float, bool, tuple]:
    """K1 through its dispatcher on the kernel interface ``args``, held
    against its plain version (silhouette, visibility) and, for the
    attribute and depth channels and (m, den), a float64 evaluation of the
    plain version; and bit for bit against itself with its skip turned off
    (``far_logit=inf``). With ``moved`` (bool, the shape of the attribute
    block: the values that rim slivers move, ``sliver_moved``), the
    attribute and depth channels are held on the values that are not
    moved instead: no further from float64 than the f32 plain version,
    plus the bar. Returns (failures, worst error, same bits, output)."""
    from hocon_torch.render import raster_cuda as RC

    coeffs, gamma = args[0], args[5]
    got = RC.raster_fwd(*args)  # the dispatcher the main path calls
    every = RC.raster_fwd_cuda(*args, far_logit=math.inf)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(g.view(torch.int32), e.view(torch.int32))
                    for g, e in zip(got, every))
    want = RC.raster_fwd_plain(*args)
    want64 = RC.raster_fwd_plain(coeffs.double(), *args[1:])
    torch.cuda.synchronize()
    n_user = got[1].shape[1] - 1  # attr holds C attribute channels, then zbar
    errs = {name: float((g - w).abs().max()) for name, g, w in (
        ("sil", got[0], want[0]), ("vis", got[2], want[2]))}
    # Rows of rim sliver faces make the attribute block sensitive to
    # f32 rounding, and the plain version (no FMAs) rounds worse than
    # the kernel: its depth lands up to ~8e-4 from a float64 evaluation
    # of the same coefficients, its pixel coordinates up to ~0.6 px.
    # So float64 is the arbiter. Depth, in [0, 1], must lie within the
    # bar of it; each attribute channel may be no further from it than
    # the f32 plain version's same channel is, plus the bar.
    def from64(x, c):
        return float((x[1][:, c] - want64[1][:, c]).abs().max())

    if moved is not None:
        keep = ~moved
        err64 = ((got[1] - want64[1]).abs() - ATTR_RTOL * want64[1].abs())[keep]
        plain64 = ((want[1] - want64[1]).abs() - ATTR_RTOL * want64[1].abs())[keep]
        errs["unmoved"], plain_unmoved = float(err64.max()), float(plain64.max())
        log(f"{tag}: attribute and depth values not moved by rim slivers "
            f"({float(keep.double().mean()):.4f} of them), max |err| - {ATTR_RTOL} |x| from "
            f"float64: kernel {errs['unmoved']:.3g}, plain f32 {plain_unmoved:.3g} "
            f"(bar: plain + {ATOL})")
    errs["depth"], plain_depth = from64(got, n_user), from64(want, n_user)
    attr_errs = [(from64(got, c), from64(want, c)) for c in range(n_user)]
    errs["attrs"] = max(e for e, _ in attr_errs)
    plain_attrs = max(p for _, p in attr_errs)
    # m and log(den) carry zbar / gamma: the depth bar times 1/gamma,
    # with the same float64 arbiter as the attributes.
    def mden_errs(x):
        m = float((x[:, 0] - want64[3][:, 0]).abs().max())
        den = float(((x[:, 1] - want64[3][:, 1]).abs() / want64[3][:, 1]).max())
        return m, den

    (m_err, den_rel), (m_plain, den_plain) = mden_errs(got[3]), mden_errs(want[3])
    sil_cov = float((want[0] > 1e-3).float().mean())
    log(f"{tag} ({'fixed-m' if 1 / gamma <= 60 else 'streaming'}, C={n_user}): "
        f"max abs err from plain: sil {errs['sil']:.3g} vis {errs['vis']:.3g}; "
        f"from float64: depth {errs['depth']:.3g} (plain f32 {plain_depth:.3g}) "
        f"attrs {errs['attrs']:.3g} (plain f32 {plain_attrs:.3g}) "
        f"m {m_err:.3g} (plain {m_plain:.3g}) den rel {den_rel:.3g} "
        f"(plain {den_plain:.3g}); covered share {sil_cov:.3f}")
    failures = []
    bars = (("sil", SIL_ATOL), ("vis", ATOL))
    bars += (("depth", ATOL),) if moved is None else (("unmoved", plain_unmoved + ATOL),)
    for name, bar in bars:
        if not errs[name] <= bar:
            failures.append(f"{tag} {name}: max err {errs[name]:.3g} > {bar:.3g}")
    for c, (e, p) in enumerate(attr_errs if moved is None else []):
        if not e <= p + ATOL:
            failures.append(f"{tag} attr {c}: kernel {e:.3g} from float64, plain f32 {p:.3g}")
    if not (m_err <= m_plain + ATOL / gamma and den_rel <= den_plain + ATOL / gamma):
        failures.append(f"{tag} mden from float64: m {m_err:.3g} (plain {m_plain:.3g}), "
                        f"den rel {den_rel:.3g} (plain {den_plain:.3g})")
    if not same_bits:
        failures.append(f"{tag}: the skip changes the output bits")
    worst = max(v for k, v in errs.items() if moved is None or k not in ("depth", "attrs"))
    return failures, worst, same_bits, got


def time_k1(torch, args, res: int, smi: str, tag: str) -> dict:
    """K1's time (skip on and off), its plain version's and its bound from
    the pairs these inputs need (``raster_cuda.needed_pairs``)."""
    from hocon_torch.render import raster_cuda as RC

    coeffs, bounds, krange = args[:3]
    ms = cuda_ms(torch, lambda: RC.raster_fwd_cuda(*args), 20)
    every_ms = cuda_ms(torch, lambda: RC.raster_fwd_cuda(*args, far_logit=math.inf), 20)
    plain_ms = cuda_ms(torch, lambda: RC.raster_fwd_plain(*args), 2)
    needed, _ = RC.needed_pairs(*args)
    all_pairs = cell_pairs(torch, bounds, krange, res)
    bound_ms, bound_by = k1_bound(torch, coeffs, bounds, krange, res, needed)
    all_bound_ms, _ = k1_bound(torch, coeffs, bounds, krange, res, all_pairs)
    log(f"{tag} time: kernel {ms:.4f} ms (far_logit=inf, every pair: {every_ms:.4f} ms), "
        f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{needed / 1e6:.1f}M face-pixel pairs whose contribution is not exactly 0, "
        f"counted per pixel; over all {all_pairs / 1e6:.1f}M pairs of K1's cells "
        f"{all_bound_ms:.4f} ms), {coeffs.shape[0]} views, {coeffs.shape[1]} padded faces; "
        f"card {smi}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def k1_evaluated_line(torch, args, res: int, tag: str, same_bits: bool) -> str:
    from hocon_torch.render import raster_cuda as RC

    coeffs, bounds, krange, _, sigma, gamma = args[:6]
    n = k1_tiles(torch, coeffs, bounds, krange, res, gamma, sigma)
    all_pairs = cell_pairs(torch, bounds, krange, res)
    return (f"{tag} evaluated: {n['live_tiles']} of {n['tiles']} (chunk, "
            f"{RC.K1_TILE[0]}x{RC.K1_TILE[1]} tile) pairs with a live face, {n['live']} live "
            f"(face, tile) pairs = {n['pairs'] / 1e6:.1f}M face-pixel pairs against "
            f"{all_pairs / 1e6:.1f}M (host count, raster_cuda.far_faces, far_logit "
            f"{RC.k1_far_logit(gamma):.0f}); bitwise equal to far_logit=inf: {same_bits}")


def phase_k1(torch, device, scene, smi: str, out: dict) -> torch.Tensor:
    from hocon_torch.render import raster_cuda as RC

    tgt, ref, faces, k = scene
    cfg = RC.default_config()
    worst, coords, failures = 0.0, None, []
    coeffs, bounds, krange = raster_inputs(torch, tgt, ref, faces, k, RES)
    for gamma in GAMMAS:
        args = (coeffs, bounds, krange, (RES, RES), SIGMA, gamma, cfg)
        tag = f"K1 gamma=1/{1 / gamma:.0f}"
        fails, err, same_bits, got = check_k1(torch, args, tag)
        failures += fails
        worst = max(worst, err)
        log(k1_evaluated_line(torch, args, RES, tag, same_bits))
        if gamma == GAMMAS[0]:
            timing = time_k1(torch, args, RES, smi, "K1")
            coords = got[1][:, :2, :RES, :RES].permute(0, 2, 3, 1).contiguous()
    if failures:
        fail("; ".join(failures))
    out.update(name="raster_fwd", route="cuda", source="hocon_torch/csrc/raster_fwd.cu",
               replaces="hocon/render/raster_pallas.py:304", max_abs_err=worst,
               library_ms=None, **timing)
    return coords


def k2_bound(torch, coeffs, bounds, krange, res: int, pairs: int):
    """Least time for K2's work: ``pairs`` (face, pixel) pairs times K2's
    operations per pair over the f32 rate, or its bytes in and out once
    over the HBM rate, whichever is larger."""
    from hocon_torch.render import raster_cuda as RC

    b, fp, r3 = coeffs.shape
    n_user = r3 // 3 - 10
    hp, wp = RC.padded_size((res, res))
    # Per (face, pixel), an FMA as 2, a transcendental or a divide as 1:
    # 7 + C affine rows at 4 each; 5 for each of the 10 + C rows' three
    # sums; ~140 for the distances, sigmoid, softmax chain, tie masks and
    # overhang branches.
    ops = pairs * (4 * (7 + n_user) + 5 * (10 + n_user) + 140)
    per_pixel = 1 + (n_user + 1) + 1 + 2 + 1 + (n_user + 1) + 1  # 4 outputs, 3 cotangents
    nbytes = 4 * (2 * coeffs.numel() + bounds.numel() + krange.numel() + b * hp * wp * per_pixel)
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def k2_pairs(torch, coeffs, bounds, krange, res: int) -> dict:
    """What K2 evaluates on this data, by its skip rule mirrored on the
    host (``raster_cuda.far_faces``): the 32-pixel row segments it walks
    (K1's cells) and skips, the (face, pixel) pairs of the kept segments,
    and of those the pairs of faces that are not far from their segment."""
    from hocon_torch.render import raster_cuda as RC

    cfg = RC.default_config()
    hp, wp = RC.padded_size((res, res))
    xb = RC.lane_block(wp)
    b, nc = bounds.shape[:2]
    fc, seg = cfg.face_chunk, RC.SEGMENT
    in_cell = RC.cell_hits(bounds, krange, hp, wp, xb)  # (B, NC, NYB, NXB)
    in_cell = in_cell.repeat_interleave(RC.ROW_BLOCK, 2).repeat_interleave(xb // seg, 3)
    far = RC.far_faces(coeffs, bounds, krange, (res, res), SIGMA, cfg).view(b, nc, fc, hp, -1)
    kept = in_cell & ~far.all(dim=2)
    return {"walked": int(in_cell.sum()), "kept": int(kept.sum()),
            "pairs": int(kept.sum()) * fc * seg,
            "lane_pairs": int((~far & kept[:, :, None]).sum()) * seg}


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
            pairs = cell_pairs(torch, bounds, krange, RES)
            _, needed = RC.needed_pairs(coeffs, bounds, krange, size, SIGMA, gamma, cfg)
            bound_ms, bound_by = k2_bound(torch, coeffs, bounds, krange, RES, needed)
            all_bound_ms, _ = k2_bound(torch, coeffs, bounds, krange, RES, pairs)
            n = k2_pairs(torch, coeffs, bounds, krange, RES)
            log(f"K2 time: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {needed / 1e6:.1f}M face-pixel pairs whose coverage is not "
                f"exactly 0, counted per pixel; over all {pairs / 1e6:.1f}M pairs of K1's cells "
                f"{all_bound_ms:.4f} ms); card {smi}")
            log(f"K2 evaluated: {n['kept']} of {n['walked']} row segments "
                f"({n['walked'] - n['kept']} skipped), {n['pairs'] / 1e6:.1f}M face-pixel pairs "
                f"against K1's {pairs / 1e6:.1f}M; {n['lane_pairs'] / 1e6:.1f}M of them on faces "
                f"not far from their segment (host count, raster_cuda.far_faces)")
    if failures:
        fail("; ".join(failures))
    out.update(name="raster_bwd", route="cuda", source="hocon_torch/csrc/raster_bwd.cu",
               replaces="hocon/render/raster_pallas.py:553", max_abs_err=worst, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def colour_raster_inputs(torch, pose_ds, verts, joints, device):
    """The kernel interface of K1 for the synthetic dataset's render of
    hands ``verts`` / ``joints`` (and its object), as ``render_frames``
    builds it through ``soft_rasterize``: 3 vertex-colour channels, sigma
    0.7, no backface culling. Returns (coeffs, bounds, krange) of every
    face, and of the faces that are not rim slivers (the slivers inert)."""
    from hocon_torch.data import synthetic as S
    from hocon_torch.geometry.project import persp_project
    from hocon_torch.render import raster as R
    from hocon_torch.render import raster_cuda as RC

    all_v, all_f = pose_ds.meshes(verts, joints)
    v = torch.from_numpy(all_v).to(device)
    n, nv = v.shape[:2]
    vp = persp_project(v, torch.from_numpy(pose_ds.camintr).to(device)[None].expand(n, 3, 3))
    colors = torch.from_numpy(S.vertex_colors(nv)).to(device)[None].expand(n, nv, 3)
    faces_sorted, bbox = RC.sort_faces_by_y(vp, torch.from_numpy(all_f).to(device))
    planes = R.face_planes(vp, R.normalize_depth(v[..., 2]), faces_sorted, colors)
    fv = R.gather_faces(vp, faces_sorted)
    edge2 = ((fv - fv.roll(1, dims=-2)) ** 2).sum(-1).amax(-1)
    well = R.face_det2d(fv).abs() >= SLIVER_FRAC * edge2
    hp = RC.padded_size((pose_ds.image_size,) * 2)[0]
    out = []
    for p in (planes, R.FacePlanes(planes.rows, planes.valid * well)):
        coeffs, bounds = RC.pack_sorted_planes(p, bbox, S.RENDER_SIGMA)
        out.append((coeffs, bounds, RC.chunk_ranges(bounds, hp)))
    return out


def sliver_moved(torch, args, args_ws):
    """Attribute-block values (B, C+1, Hp, Wp) that rim slivers move: where
    the float64 plain renders with and without the slivers differ by more
    than the bar."""
    from hocon_torch.render import raster_cuda as RC

    full = RC.raster_fwd_plain(args[0].double(), *args[1:])[1]
    without = RC.raster_fwd_plain(args_ws[0].double(), *args_ws[1:])[1]
    return (full - without).abs() > ATOL


def phase_data(torch, device, smi: str, out: dict):
    """The data path of ``bench_torch.py``: ``get_dataset`` renders the
    synthetic dataset on the card (K1 at 3 colour channels), then one
    batch of 16 pairs from ``BatchLoader``. K1 at C = 3 is checked and
    timed on that render's own inputs; the port's render of the verts
    stored with the TPU's frames is compared with those frames, for the
    record. Returns the rendered frames and the batch."""
    from bench_torch import dataset_kwargs
    from hocon_torch.data import synthetic as S
    from hocon_torch.data.factory import get_dataset
    from hocon_torch.data.pipeline import BatchLoader
    from hocon_torch.geometry.mano import synthetic_mano_model
    from hocon_torch.render import raster_cuda as RC

    mano = synthetic_mano_model(0, device=device)
    torch.cuda.synchronize()
    RC.raster_fwd.launches = 0
    t0 = time.perf_counter()
    ds = get_dataset(**dataset_kwargs(OBJ_FACES), mano=mano, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = RC.raster_fwd.launches
    pose_ds = ds.pose_dataset
    frames = pose_ds.images
    log(f"data: get_dataset('synthetic') {setup_s:.3f} s for {len(frames)} frames at "
        f"{pose_ds.image_size}^2 ({len(pose_ds.mano.faces)} + {len(pose_ds.obj_faces)} faces), "
        f"K1 launches {launches}; card {smi}")
    if launches < 1:
        fail("the synthetic dataset rendered without launching K1")
    if frames.shape != (32, RES, RES, 3) or frames.dtype != np.uint8:
        fail(f"rendered frames {frames.shape} {frames.dtype}")

    cfg = RC.default_config()
    inputs, inputs_ws = colour_raster_inputs(torch, pose_ds, pose_ds.verts, pose_ds.joints,
                                             device)
    args = (*inputs, (RES, RES), S.RENDER_SIGMA, 1.0 / 40.0, cfg)
    moved = sliver_moved(torch, args, (*inputs_ws, *args[3:]))
    failures, worst, same_bits, _ = check_k1(torch, args, "K1 render", moved)
    log(k1_evaluated_line(torch, args, RES, "K1 render", same_bits))
    if failures:
        fail("; ".join(failures))
    timing = time_k1(torch, args, RES, smi, "K1 render")
    out.update(name="raster_fwd (C=3, synthetic render)", route="cuda",
               source="hocon_torch/csrc/raster_fwd.cu",
               replaces="hocon/render/raster_pallas.py:304", launches=launches,
               max_abs_err=worst, library_ms=None, **timing)

    # For the record: the port's render of the verts and joints stored with
    # the JAX bench's frames (rendered on the TPU by its Pallas kernel).
    with np.load(os.path.join(HERE, TPU_FRAMES)) as z:
        tpu_images, tpu_verts, tpu_joints = z["images"], z["verts"], z["joints"]
    mine = S.render_frames(*pose_ds.meshes(tpu_verts, tpu_joints), pose_ds.camintr, RES, device)
    diff = np.abs(mine.astype(int) - tpu_images.astype(int)).max(axis=-1)
    log(f"data: the port's render of {TPU_FRAMES}'s verts against its TPU frames: "
        f"{(diff > 1).mean():.4g} of pixels differ by more than 1 level in some channel "
        f"({(diff > 4).mean():.4g} by more than 4), largest {diff.max()}; the port's own MANO "
        f"verts are {np.abs(pose_ds.verts - tpu_verts).max():.3g} m from the stored ones")

    t0 = time.perf_counter()
    batch = next(iter(BatchLoader(ds, PAIRS, seed=0, drop_last=False)))
    batch_s = time.perf_counter() - t0
    shapes = {k: tuple(batch[k]["image"].shape) for k in ("ref", "tgt")}
    log(f"data: one BatchLoader batch of {PAIRS} pairs {batch_s:.3f} s on the host "
        f"(crop, augment, stack); images {shapes}; card {smi}")
    if any(s != (PAIRS, RES, RES, 3) for s in shapes.values()):
        fail(f"batch image shapes {shapes}")
    return frames, batch


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
    plain_ms = cuda_ms(torch, lambda: SC.sample_fwd_plain(img, xy), 10)
    # Library yardstick: grid_sample with the same border clamp, NCHW in.
    def to_grid(c):
        return c / torch.tensor([RES / 2.0, RES / 2.0], device=device) - 1.0

    def grid_sample(image_nchw, grid):
        return F.grid_sample(image_nchw, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    lib = grid_sample(img.permute(0, 3, 1, 2).contiguous(), to_grid(xy)).permute(0, 2, 3, 1)
    lib_err = float((lib - want).abs().max())
    # Hq * Wq = 35: each image has head and tail pixels off the float4 path.
    gen = torch.Generator(device=device).manual_seed(2)
    small = torch.rand((3, 9, 11, 3), generator=gen, device=device)
    small_xy = torch.rand((3, 5, 7, 2), generator=gen, device=device) * 14.0 - 2.0
    tail_err = float((SC.sample_fwd(small, small_xy) - SC.sample_fwd_plain(small, small_xy))
                     .abs().max())
    if not tail_err <= SAMPLE_ATOL:
        fail(f"K3 max err {tail_err:.3g} > {SAMPLE_ATOL} at 3 x 5 x 7 queries")
    err = max(err, tail_err)
    imgs = [img.clone() for _ in range(COLD_COPIES)]
    xys = [xy.clone() for _ in range(COLD_COPIES)]
    nchw = [i.permute(0, 3, 1, 2).contiguous() for i in imgs]
    grids = [to_grid(c) for c in xys]
    k3 = [lambda i=i: SC.sample_fwd_cuda(imgs[i], xys[i]) for i in range(COLD_COPIES)]
    gs = [lambda i=i: grid_sample(nchw[i], grids[i]) for i in range(COLD_COPIES)]

    def in_turns(copies):  # K3, grid_sample, grid_sample, K3
        k_a = cuda_ms_rotating(torch, k3[:copies], SAMPLE_REPS)
        g_a = cuda_ms_rotating(torch, gs[:copies], SAMPLE_REPS)
        g_b = cuda_ms_rotating(torch, gs[:copies], SAMPLE_REPS)
        k_b = cuda_ms_rotating(torch, k3[:copies], SAMPLE_REPS)
        return (k_a, k_b), (g_a, g_b)

    (cold_k, cold_g), (hot_k, hot_g) = in_turns(COLD_COPIES), in_turns(1)
    ms, library_ms = sum(cold_k) / 2, sum(cold_g) / 2
    nbytes = 4 * (xy.numel() + img.numel() + got.numel())
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    log(f"K3: max abs err {err:.3g} (grid_sample differs by {lib_err:.3g}); cold, in turns over "
        f"{COLD_COPIES} copies ({COLD_COPIES * 4 * (xy.numel() + img.numel()) / 1e6:.0f} MB of "
        f"inputs), {SAMPLE_REPS} launches each: kernel {cold_k[0]:.4f} / {cold_k[1]:.4f} ms, "
        f"grid_sample {cold_g[0]:.4f} / {cold_g[1]:.4f} ms; kernel {ms:.4f} ms = "
        f"{bound_ms / ms:.0%} of its bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), plain "
        f"{plain_ms:.4f} ms; card {smi}")
    log(f"K3 L2-hot, in turns on one copy, {SAMPLE_REPS} launches each: kernel "
        f"{hot_k[0]:.4f} / {hot_k[1]:.4f} ms, grid_sample {hot_g[0]:.4f} / {hot_g[1]:.4f} ms; "
        f"card {smi}")
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


# Phase 10: the flags of the trainer's first call; the others stay at the
# CLI's defaults (ResNet-18 in bf16 autocast, frozen batch norm, Adam,
# gamma 1/40, backend auto = K1 / K2).
CLI_FLAGS = {"dataset": "synthetic", "image_size": RES, "batch_size": PAIRS, "use_objects": True,
             "synth_videos": 4, "synth_frames": 16, "fraction": 0.25, "epochs": 2, "lr": 5e-4,
             "exp_id": "smoke"}
CLI_STEPS = 8  # 4 videos x 16 frames = 64 pairs = 4 steps of 16, 2 epochs
PREDICT_BATCH = 12  # the 32 val frames in batches of 12, 12 and 8 + 4 padding rows
MPJPE_RTOL = 1e-3


def cli_argv(flags: dict) -> list:
    """{"lr": 5e-4, "use_objects": True} -> ["--lr", "0.0005", "--use_objects"]."""
    out = []
    for k, v in flags.items():
        out += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return out


def run_cli(main, argv: list, device, exits: bool = False) -> tuple:
    """``main(argv, device=...)`` with its printed lines captured and
    echoed; returns (result, stdout text). ``exits``: the call ends in
    ``SystemExit`` (``--check_data``), whose code must be 0."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if exits:
            try:
                main(argv, device=device)
                result = "returned"
            except SystemExit as stop:
                result = stop.code
        else:
            result = main(argv, device=device)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    if exits and result != 0:
        fail(f"{main.__module__} {' '.join(argv)}: exit {result}, want 0")
    return result, text


def cli_setup_s(text: str) -> float:
    found = re.search(r"set-up ([0-9.]+) s", text)
    if not found:
        fail("the CLI printed no set-up line")
    return float(found.group(1))


def phase_cli(torch, device, smi: str, out_dir: str, kernels: dict) -> None:
    """The entry points of ``hocon_torch.cli`` at full width (see the
    module note, phase 10). Fills ``kernels`` with the launches of the
    first ``trainwarp`` call: K1 at C = 2 (``raster_fwd``) and C = 3
    (``raster_fwd C=3``), K2, K3 and K4 by their wrappers' names."""
    import shutil
    import tempfile

    from hocon_torch.cli import evaluate, predict, trainwarp
    from hocon_torch.render import raster_cuda as RC
    from hocon_torch.render import sample_cuda as SC

    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="cli-", dir=out_dir)
    os.chdir(work)
    t_phase = time.perf_counter()
    try:
        run = os.path.join(work, "checkpoints", "smoke")
        torch.cuda.synchronize()
        RC.raster_fwd.launches = RC.raster_bwd.launches = 0
        SC.sample_fwd.launches = SC.sample_bwd.launches = 0
        RC.raster_fwd.launches_by_attrs = {}
        t0 = time.perf_counter()
        state, text = run_cli(trainwarp.main, cli_argv(CLI_FLAGS), device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_c = dict(RC.raster_fwd.launches_by_attrs)
        launches = {"raster_fwd": by_c.get(2, 0), "raster_fwd C=3": by_c.get(3, 0),
                    "raster_bwd": RC.raster_bwd.launches, "sample_fwd": SC.sample_fwd.launches,
                    "sample_bwd": SC.sample_bwd.launches}
        kernels.update(launches)
        want = {k: CLI_STEPS for k in launches}
        want["raster_fwd C=3"] = 2  # the train and the val dataset
        if launches != want or set(by_c) - {2, 3}:
            fail(f"cli: launches {launches} (by C {by_c}), want {want}: K1 at C = 2, K2, K3 "
                 f"and K4 once per train step, K1 at C = 3 once per dataset")
        if state.step != CLI_STEPS:
            fail(f"cli: trainwarp ended at step {state.step}, want {CLI_STEPS}")
        missing = [f for f in ("opt.txt", "opt.json", "metrics.jsonl", "epochs.json",
                               os.path.join("ckpt", str(CLI_STEPS), "state.pt"))
                   if not os.path.exists(os.path.join(run, f))]
        if missing:
            fail(f"cli: the run directory lacks {missing}")
        setup_s = cli_setup_s(text)
        with open(os.path.join(run, "epochs.json")) as fh:
            epochs = json.load(fh)
        rates = [e["steps_per_sec"] for e in epochs if e["split"] == "train"]
        log(f"cli: trainwarp {CLI_STEPS} steps of {PAIRS} pairs at {RES}^2 in 2 epochs: set-up "
            f"{setup_s:.3f} s (MANO, two K1 renders, model); card {smi}")
        log(f"cli: steps_per_sec {rates[0]:.3f} and {rates[1]:.3f} (epoch 0 and 1, past 2 "
            f"warm-up steps each: {rates[0] * PAIRS:.1f} and {rates[1] * PAIRS:.1f} pairs/s); "
            f"the call {wall:.1f} s with eval and snapshots; launches {launches}; card {smi}")

        state, text = run_cli(trainwarp.main, cli_argv({**CLI_FLAGS, "epochs": 1}), device)
        with open(os.path.join(run, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        steps = [r["step"] for r in records]
        if ("auto-restored latest snapshot (step 8)" not in text or state.step != 12
                or steps != list(range(1, 13))):
            fail(f"cli: the second call did not continue step 8 to 12: logged steps {steps}, "
                 f"state step {state.step}")
        bad = [r["step"] for r in records
               if not all(math.isfinite(v) for v in r.values()) or r["mask_area"] <= 0]
        if bad:
            fail(f"cli: steps {bad} logged a term that is not finite or an empty mask")
        with open(os.path.join(run, "epochs.json")) as fh:
            epochs = json.load(fh)
        last_val = [e for e in epochs if e["split"] == "val"][-1]
        log(f"cli: resumed at step 8, logged steps 9-12; train steps_per_sec "
            f"{epochs[-2]['steps_per_sec']:.3f}; card {smi}")

        # The trainer's val split: max(2, 4 // 4) = 2 videos of 16 frames.
        ckpt = os.path.join(run, "ckpt")
        shared = {k: CLI_FLAGS[k] for k in ("dataset", "image_size", "batch_size", "use_objects",
                                            "synth_frames")}
        shared.update(synth_videos=2, resume=ckpt)
        metrics, _ = run_cli(evaluate.main, cli_argv(shared), device)
        rel = abs(metrics["mpjpe_mm"] - last_val["mpjpe_mm"]) / last_val["mpjpe_mm"]
        log(f"cli: evaluate MPJPE {metrics['mpjpe_mm']:.4f} mm against the trainer's last val "
            f"{last_val['mpjpe_mm']:.4f} mm (relative {rel:.3g}, bar {MPJPE_RTOL})")
        if not rel <= MPJPE_RTOL:
            fail(f"cli: evaluate MPJPE {metrics['mpjpe_mm']} != trainer's {last_val['mpjpe_mm']}")

        path, _ = run_cli(predict.main,
                          cli_argv({**shared, "batch_size": PREDICT_BATCH, "out": "preds"}), device)
        with np.load(path) as z:
            preds = {k: z[k] for k in z.files}
        n, n_val = preds["joints_cam"].shape[0], 2 * CLI_FLAGS["synth_frames"]
        finite = all(np.isfinite(v).all() for v in preds.values())
        log(f"cli: predict wrote {n} frames of the {n_val} of the split at batch {PREDICT_BATCH} "
            f"(a tail of {n_val % PREDICT_BATCH} and {-n_val % PREDICT_BATCH} padding rows); "
            f"finite {finite}")
        if (n != n_val or len({preds["joints_cam"][i].tobytes() for i in range(n)}) != n
                or not finite):
            fail(f"cli: predict covered {n} frames, want the {n_val} of the split once each")

        # 2 videos = 32 pairs = 2 steps; --eval_freq 2 skips the one epoch's eval.
        bn_flags = {**CLI_FLAGS, "synth_videos": 2, "epochs": 1, "eval_freq": 2, "exp_id": "bn",
                    "no_freeze_batchnorm": True}
        state, _ = run_cli(trainwarp.main, cli_argv(bn_flags), device)
        stats = {k: v for k, v in state.model.state_dict().items() if "running" in k}
        moved = sum(bool((v != (0.0 if k.endswith("mean") else 1.0)).any())
                    for k, v in stats.items())
        finite = all(bool(torch.isfinite(v).all()) for v in stats.values())
        log(f"cli: --no_freeze_batchnorm, {state.step} steps: {moved} of {len(stats)} running "
            f"statistics moved from (0, 1), finite {finite}")
        if state.step != 2 or moved != len(stats) or not finite:
            fail("cli: trainable batch norm did not move every running statistic")
        for name in ("opt.json", "epochs.json", "metrics.jsonl"):
            shutil.copy(os.path.join(run, name), os.path.join(out_dir, f"cli_{name}"))
        log(f"cli: the phase took {time.perf_counter() - t_phase:.1f} s (three trainwarp calls, "
            f"evaluate, predict); card {smi}")
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


# Phase 11: PyTorch weight files through the CLIs, and the visualisation.
IMPORT_FLAGS = {"dataset": "synthetic", "image_size": RES, "batch_size": PAIRS,
                "use_objects": True, "synth_videos": 2, "synth_frames": 16, "fraction": 0.25,
                "epochs": 1}
IMPORT_STEPS = 2  # 2 videos x 16 frames = 32 pairs (or frames) = 2 steps of 16


def _trunk_bits_equal(torch, trunk, tv: dict) -> tuple:
    """(tensors compared, tensors differing) between a port trunk and a
    torchvision state dict, by ``tools.torch_weights.torchvision_name``."""
    from tools.torch_weights import torchvision_name

    own = trunk.state_dict()
    differ = [k for k, v in own.items()
              if not torch.equal(v.cpu(), tv[torchvision_name(k)])]
    return len(own), differ


def phase_import_vis(torch, device, smi: str, out_dir: str) -> None:
    """Phase 11 (see the module note): ``--torch_trunk``, ``--torch_ckpt``
    and ``--vis_freq`` through the CLIs at full width."""
    import shutil
    import tempfile

    from hocon_torch.cli import evaluate, train, trainwarp
    from hocon_torch.visualize import warpvis
    from tools.torch_weights import reference_checkpoint, torchvision_resnet

    try:
        import matplotlib  # noqa: F401

        has_mpl = f"matplotlib {matplotlib.__version__}"
    except ImportError:
        has_mpl = None
    log(f"import_vis: import matplotlib: {has_mpl or 'fails (no PNG is written)'}")
    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="import-", dir=out_dir)
    os.chdir(work)
    t_phase = time.perf_counter()
    try:
        tv = torchvision_resnet(11)
        torch.save(tv, "trunk.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in reference_checkpoint(12).items()},
                    "epoch": 3}, "ref.pth")

        flags = {**IMPORT_FLAGS, "torch_trunk": "trunk.pth", "lr": 0.0, "exp_id": "trunk",
                 "vis_freq": 1}
        state, text = run_cli(train.main, cli_argv(flags), device)
        n, differ = _trunk_bits_equal(torch, state.model.trunk, tv)
        images = sorted(os.listdir(os.path.join("checkpoints", "trunk", "images"))) \
            if os.path.isdir(os.path.join("checkpoints", "trunk", "images")) else []
        log(f"import_vis: train --torch_trunk --lr 0, {state.step} steps: {n - len(differ)} of "
            f"{n} trunk tensors bit for bit the file's; --vis_freq 1 wrote {images}")
        if "imported ImageNet trunk weights" not in text or differ or state.step != IMPORT_STEPS:
            fail(f"import_vis: the trunk after {state.step} steps at rate 0 differs from the "
                 f"file in {differ[:5]} ({len(differ)} tensors)")
        if has_mpl and images != [f"ep0_b{i}.png" for i in range(IMPORT_STEPS)]:
            fail(f"import_vis: train --vis_freq 1 wrote {images}")

        flags = {k: IMPORT_FLAGS[k] for k in ("dataset", "image_size", "batch_size",
                                               "use_objects", "synth_videos", "synth_frames")}
        metrics, text = run_cli(evaluate.main, cli_argv({**flags, "torch_ckpt": "ref.pth"}),
                                device)
        log(f"import_vis: evaluate --torch_ckpt: MPJPE {metrics['mpjpe_mm']:.4f} mm, AUC "
            f"{metrics['auc']:.4f}")
        if ("implies --obj_rot_param axisang" not in text
                or "imported reference checkpoint" not in text
                or not math.isfinite(metrics["mpjpe_mm"])):
            fail(f"import_vis: evaluate --torch_ckpt gave {metrics} without the import lines")

        panels = []
        panel_calls = warpvis.warp_panels

        def counted_panels(*args, **kwargs):
            torch.cuda.synchronize()
            before = step_launches()
            out = panel_calls(*args, **kwargs)
            torch.cuda.synchronize()
            after = step_launches()
            panels.append(({k: after[0][k] - before[0][k] for k in before[0]}, out))
            return out

        warpvis.warp_panels = counted_panels
        try:
            counters_zeroed(torch)
            flags = {**IMPORT_FLAGS, "eval_freq": 2, "vis_freq": 1, "exp_id": "vis"}
            state, _ = run_cli(trainwarp.main, cli_argv(flags), device)
            launches = step_launches()[0]
        finally:
            warpvis.warp_panels = panel_calls
        if len(panels) != 1:
            fail(f"import_vis: trainwarp --vis_freq 1 made {len(panels)} panel calls, want 1")
        delta, (batch_np, preds, warp) = panels[0]
        png = os.path.join("checkpoints", "vis", "images", "warp_ep0.png")
        size = os.path.getsize(png) if os.path.exists(png) else 0
        finite = all(np.isfinite(a).all() for a in (*warp.values(), preds["joints2d"]))
        area = float(warp["mask"].sum(axis=(1, 2)).mean())
        log(f"import_vis: trainwarp --vis_freq 1, {state.step} steps: the panel call launched "
            f"{delta}; the run {launches}; panels {[tuple(a.shape) for a in warp.values()]}, "
            f"finite {finite}, mask area {area:.1f} px per row; {png} {size} bytes")
        want_panel = {"raster_fwd": 1, "raster_bwd": 0, "sample_fwd": 1, "sample_bwd": 0}
        want_run = {"raster_fwd": IMPORT_STEPS + 1, "raster_bwd": IMPORT_STEPS,
                    "sample_fwd": IMPORT_STEPS + 1, "sample_bwd": IMPORT_STEPS}
        if delta != want_panel or launches != want_run or state.step != IMPORT_STEPS:
            fail(f"import_vis: panel launches {delta} (want {want_panel}), run {launches} "
                 f"(want {want_run}) over {state.step} steps")
        if not finite or area <= 0 or warp["mask"].shape != (4, RES, RES):
            fail(f"import_vis: panels finite {finite}, mask area {area}, shape "
                 f"{warp['mask'].shape}")
        if has_mpl and size <= 1024:
            fail(f"import_vis: {png} is {size} bytes")
        if has_mpl:
            shutil.copy(png, os.path.join(out_dir, "warp_ep0.png"))
        log(f"import_vis: the phase took {time.perf_counter() - t_phase:.1f} s; card {smi}")
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


# Phase 12: FPHAB and HO-3D trees in the official layouts
# (tools/fixture_trees.py), read by the port's parsers and CLIs.
REAL_FRAMES = 16  # frames per sequence
FPHAB_TRAIN = ("Subject_1", "Subject_3", "Subject_4")
FPHAB_TEST = "Subject_2"
FPHAB_ACTION = "open_milk"  # an action with object poses (the milk carton)
FPHAB_HW = (1080, 1920)
HO3D_SEQS = ("ABF10", "MC1")
HO3D_HW = (480, 640)
HO3D_CAM = np.array([[617.3, 0.0, 320.0], [0.0, 617.3, 240.0], [0.0, 0.0, 1.0]], np.float32)
DENSE_POINTS = 10002  # on a sphere: a 20000-face hull, as dense as the scanned models
OBJ_BUDGET = 1000  # the face cap get_dataset decimates the real datasets' objects to
REAL_STEPS = 3  # 3 train sequences x 16 frames = 48 pairs = 3 steps of 16
JPEG_FIXTURES = ("odd_420", "odd_444")
# nvJPEG + jpeg_ycc_rgb against cv2 (libjpeg-turbo) on the committed
# fixtures: max and mean |diff| in levels (nvJPEG's inverse DCT is not
# libjpeg-turbo's). Measured on the H100: max 3 on both, mean 0.0315
# (4:2:0) and 0.0501 (4:4:4); nvJPEG's own RGB output, which replicates
# chroma, was 78 and 1.073 on the 4:2:0 fixture.
JPEG_BARS = {"max": 4, "mean": 0.1}
JPEG_FAULT = 8  # levels added to one channel: the check must fail
# A 1920 x 1080 frame (a gradient with noise and the hand's discs) encoded by
# nvJPEG at quality 90, 4:2:0, and decoded by nvJPEG + jpeg_ycc_rgb, against
# the frame's own pixels: max and mean |diff| in levels, and the largest
# channel's |mean signed diff|. Measured on the H100: max 46, mean 4.7423,
# bias 2.0548; with JPEG_FAULT on one channel: max 46, mean 5.4806, bias
# 6.2653, which must fail the mean and bias bars.
ROUNDTRIP_BARS = {"max": 50, "mean": 5.0, "bias": 2.5}


def jpeg_stats(got: np.ndarray, want: np.ndarray) -> dict:
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    bias = (got.astype(np.int64) - want.astype(np.int64)).reshape(-1, got.shape[-1]).mean(0)
    return {"max": int(diff.max()), "mean": float(diff.mean()), "bias": float(np.abs(bias).max()),
            "differ": float((diff > 0).mean()), "over2": float((diff > 2).mean())}


def jpeg_within_bars(stats: dict) -> bool:
    return stats["max"] <= JPEG_BARS["max"] and stats["mean"] <= JPEG_BARS["mean"]


def hand_frames(torch, device, joints_m, k, hw, seed: int):
    """uint8 (N, H, W, 3) frames on ``device``: a colour gradient with noise
    and the hand as discs around its projected joints."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    base = torch.stack([60 + 120 * xs / w, 50 + 100 * ys / h, 170 - 90 * (xs + ys) / (w + h)], -1)
    j = torch.as_tensor(joints_m, dtype=torch.float32, device=device)
    kk = torch.as_tensor(k, dtype=torch.float32, device=device)
    pix = j @ kk.T
    pix = pix[..., :2] / pix[..., 2:3]  # (N, 21, 2)
    radius = 0.012 * float(k[0, 0]) / j[..., 2].mean(-1)  # 12 mm at the hand's depth
    out = []
    for n in range(len(j)):
        d2 = ((xs[..., None] - pix[n, :, 0]) ** 2 + (ys[..., None] - pix[n, :, 1]) ** 2).amin(-1)
        hand = (d2 < radius[n] ** 2)[..., None]
        noise = torch.randn(base.shape, generator=g, device=device) * 6
        skin = torch.tensor([205.0, 150.0, 120.0], device=device)
        out.append(torch.where(hand, skin, base) + noise)
    return torch.stack(out).clamp(0, 255).round().to(torch.uint8)


def mano_clip(torch, mano, rng, n: int, trans) -> tuple:
    """A sequence of n MANO fits moving linearly between two random poses:
    (pose (n, 48) with the root first, betas (n, 10), trans (n, 3)) and the
    joints (n, 21, 3) in meters, in the standard order."""
    from hocon_torch.geometry.mano import mano_forward

    ends = [np.concatenate([rng.normal(0, 0.25, 3), rng.normal(0, 0.35, 45)]) for _ in range(2)]
    t = np.linspace(0.0, 1.0, n)[:, None]
    pose = ((1 - t) * ends[0] + t * ends[1]).astype(np.float32)
    betas = np.tile(rng.normal(0, 0.8, 10), (n, 1)).astype(np.float32)
    tr = (np.asarray(trans) + t * rng.normal(0, 0.02, 3)).astype(np.float32)
    dev = mano.v_template.device
    with torch.no_grad():
        p, b, tt = (torch.from_numpy(a).to(dev) for a in (pose, betas, tr))
        _, joints = mano_forward(mano, p[:, 3:], b, p[:, :3], trans=tt, use_pca=False,
                                 flat_hand_mean=False, scale_mm=False)
    return pose, betas, tr, joints.cpu().numpy()


def write_fphab_tree(torch, device, mano, root: str, frames: int | None = None) -> None:
    """3 train sequences and 1 test sequence of ``frames`` (``REAL_FRAMES``
    if None) 1920 x 1080 frames (nvJPEG, quality 90, 4:2:0) in
    ``FPHAB_ACTION``, with MANO fits, the fits' joints as skeletons (world
    mm, through the inverse of ``CAM_EXTR``), object poses beside the hand,
    and a dense PLY object."""
    from hocon_torch.data import fphab as TF
    from hocon_torch.data.images import encode_jpeg
    from tools import fixture_trees as FT

    frames = REAL_FRAMES if frames is None else frames
    rng = np.random.default_rng(11)
    world_from_cam = np.linalg.inv(TF.CAM_EXTR.astype(np.float64))
    for si, subject in enumerate(FPHAB_TRAIN + (FPHAB_TEST,)):
        pose, betas, trans, joints = mano_clip(torch, mano, rng, frames, [0.0, 0.03, 0.5])
        world = (joints * 1000.0) @ world_from_cam[:3, :3].T + world_from_cam[:3, 3]
        skel = np.empty_like(world)
        skel[:, list(TF.REORDER_IDX)] = world  # the standard order back to FPHAB's
        obj_cam = np.tile(np.eye(4), (frames, 1, 1))
        obj_cam[:, :3, 3] = joints[:, 0] * 1000.0 + [60.0, -20.0, 30.0]
        images = hand_frames(torch, device, joints, TF.CAM_INTR, FPHAB_HW, seed=si)
        fits = {i: {"pose": pose[i], "shape": betas[i], "trans": trans[i]}
                for i in range(frames)}
        FT.write_fphab_sequence(root, subject, FPHAB_ACTION, "1", skel,
                                [encode_jpeg(f, 90, "420") for f in images],
                                world_from_cam @ obj_cam, fits)
    verts, faces = FT.sphere_mesh(DENSE_POINTS, 40.0, seed=3)  # mm
    FT.write_ply(os.path.join(root, "Object_models", "milk_model", "milk_model.ply"),
                 verts, faces, binary=True)


def write_ho3d_tree(torch, device, mano, root: str) -> None:
    """2 train sequences of REAL_FRAMES 640 x 480 PNG frames (every row
    filter in turn), meta pickles in HO-3D's conventions (OpenGL camera,
    MANO joint order), and a dense OBJ object."""
    from hocon_torch.data import ho3d as TH
    from hocon_torch.data.images import encode_png
    from tools import fixture_trees as FT

    rng = np.random.default_rng(12)
    for si, seq in enumerate(HO3D_SEQS):
        # The fits live in the OpenGL frame (in front of the camera is -z).
        pose, betas, trans, joints_gl = mano_clip(torch, mano, rng, REAL_FRAMES,
                                                  [0.0, -0.02, -0.45])
        joints_cv = joints_gl @ TH.COORD_FLIP.T
        frames = hand_frames(torch, device, joints_cv, HO3D_CAM, HO3D_HW, seed=10 + si).cpu()
        for i in range(REAL_FRAMES):
            ho3d_order = np.empty_like(joints_gl[i])
            ho3d_order[list(TH.MANO_TO_STANDARD)] = joints_gl[i]
            meta = {"camMat": HO3D_CAM, "handJoints3D": ho3d_order, "handPose": pose[i],
                    "handBeta": betas[i], "handTrans": trans[i], "objName": "003_cracker_box",
                    "objRot": rng.normal(0, 1, 3).astype(np.float32),
                    "objTrans": (joints_gl[i, 0] + [0.05, 0.0, -0.03]).astype(np.float32)}
            FT.write_ho3d_frame(root, "train", seq, i, meta, encode_png(frames[i].numpy()))
    verts, faces = FT.sphere_mesh(DENSE_POINTS, 0.05, seed=4)
    FT.write_obj(os.path.join(root, "models_root", "models", "003_cracker_box",
                              "textured_simple.obj"), verts, faces)


def check_decoders(torch, device, smi: str) -> None:
    """nvJPEG with the ``jpeg_ycc_rgb`` kernel against the committed cv2
    decodes and a 1920 x 1080 frame against its own pixels after nvJPEG's
    encode (each with a planted fault), the kernel against its plain version
    bit for bit, a PNG of every row filter bit for bit, and the decodes
    timed."""
    from hocon_torch.data import images

    jpeg_dir = os.path.join(HERE, "tests", "data", "jpeg")
    for name in JPEG_FIXTURES:
        with open(os.path.join(jpeg_dir, f"{name}.jpeg"), "rb") as fh:
            data = fh.read()
        want = np.load(os.path.join(jpeg_dir, f"{name}.npy"))
        planes = images.jpeg_planes_cuda(data, device)
        got = images.ycc_to_rgb_cuda(*planes)
        if not torch.equal(got, images.ycc_to_rgb_plain(*planes)):
            fail(f"real_data: jpeg_ycc_rgb differs from its plain version on {name}")
        got = got.cpu().numpy()
        stats = jpeg_stats(got, want)
        faulty = got.astype(np.int64)
        faulty[..., 0] = np.clip(faulty[..., 0] + JPEG_FAULT, 0, 255)
        fault = jpeg_stats(faulty, want)
        log(f"real_data: nvJPEG + jpeg_ycc_rgb {name} {want.shape[1]}x{want.shape[0]} against "
            f"cv2: max |diff| {stats['max']}, mean {stats['mean']:.4f}, {100 * stats['differ']:.2f} "
            f"% of values differ, {100 * stats['over2']:.3f} % by more than 2 (bars: max "
            f"{JPEG_BARS['max']}, mean {JPEG_BARS['mean']}); the kernel equals its plain version; "
            f"+{JPEG_FAULT} levels on one channel: max {fault['max']}, mean {fault['mean']:.4f}")
        if got.shape != want.shape or not jpeg_within_bars(stats):
            fail(f"real_data: the decode of {name} is not within the bars of cv2's")
        if jpeg_within_bars(fault):
            fail(f"real_data: a +{JPEG_FAULT}-level fault in {name} passes the bars")

    rng = np.random.default_rng(5)
    h, w = HO3D_HW
    px = np.clip(np.mgrid[0:h, 0:w][1][..., None] * [0.3, 0.2, 0.1] + rng.normal(0, 20, (h, w, 3)),
                 0, 255).astype(np.uint8)
    png = images.encode_png(px)  # row filters 0-4 in turn
    if not np.array_equal(images.decode_png(png), px):
        fail("real_data: the PNG of every row filter did not decode to its pixels")
    t0 = time.perf_counter()
    for _ in range(5):
        images.decode_png(png)
    png_ms = (time.perf_counter() - t0) / 5 * 1e3

    frame = hand_frames(torch, device, np.array([[[0.0, 0.0, 0.5]] * 21]), np.array(
        [[1395.7, 0, 935.7], [0, 1395.7, 540.7], [0, 0, 1]]), FPHAB_HW, seed=0)[0]
    jpeg = images.encode_jpeg(frame, 90, "420")
    planes = images.jpeg_planes_cuda(jpeg, device)
    if not torch.equal(images.ycc_to_rgb_cuda(*planes), images.ycc_to_rgb_plain(*planes)):
        fail("real_data: jpeg_ycc_rgb differs from its plain version on the 1920x1080 frame")
    decoded = images.decode_jpeg_cuda(jpeg, device).cpu().numpy()
    roundtrip = jpeg_stats(decoded, frame.cpu().numpy())
    faulty = decoded.astype(np.int64)
    faulty[..., 0] = np.clip(faulty[..., 0] + JPEG_FAULT, 0, 255)
    fault = jpeg_stats(faulty, frame.cpu().numpy())
    log(f"real_data: the {FPHAB_HW[1]}x{FPHAB_HW[0]} frame encoded (quality 90, 4:2:0) and "
        f"decoded by nvJPEG + jpeg_ycc_rgb against its pixels: max |diff| {roundtrip['max']}, "
        f"mean {roundtrip['mean']:.4f}, channel bias {roundtrip['bias']:.4f} (bars: "
        f"{ROUNDTRIP_BARS}); +{JPEG_FAULT} levels on one channel: max {fault['max']}, "
        f"mean {fault['mean']:.4f}, bias {fault['bias']:.4f}")
    within = lambda st: all(st[k] <= ROUNDTRIP_BARS[k] for k in ROUNDTRIP_BARS)  # noqa: E731
    if decoded.shape != tuple(frame.shape) or not within(roundtrip):
        fail("real_data: the 1920x1080 round trip is not within its bars")
    if within(fault):
        fail(f"real_data: a +{JPEG_FAULT}-level fault in the 1920x1080 round trip passes its bars")
    kernel_ms = cuda_ms(torch, lambda: images.ycc_to_rgb_cuda(*planes), 200)
    plain_ms = cuda_ms(torch, lambda: images.ycc_to_rgb_plain(*planes), 20)
    nbytes = sum(p.numel() for p in planes[:3]) + frame.numel()
    for _ in range(3):
        images.decode_jpeg_cuda(jpeg, device).cpu()
    t0 = time.perf_counter()
    for _ in range(10):
        images.decode_jpeg_cuda(jpeg, device).cpu()
    jpeg_ms = (time.perf_counter() - t0) / 10 * 1e3
    log(f"real_data: a PNG of every row filter decodes to its pixels bit for bit; decode time "
        f"{w}x{h} PNG {png_ms:.1f} ms (host, numpy), {FPHAB_HW[1]}x{FPHAB_HW[0]} JPEG "
        f"({len(jpeg)} bytes) {jpeg_ms:.2f} ms (nvJPEG, jpeg_ycc_rgb and the copy to the host); "
        f"jpeg_ycc_rgb "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{nbytes / PEAK_BYTES * 1e3:.4f} ms (bytes: the planes read once, RGB written once); "
        f"card {smi}")


def phase_real_data(torch, device, smi: str, out_dir: str) -> None:
    """Phase 12: the decoders, then the port's CLIs on FPHAB and HO-3D trees
    (see the module note). Every JPEG on the path goes through nvJPEG: the
    CPU decoder is replaced by a failure for the phase."""
    import shutil
    import tempfile

    from hocon_torch.cli import evaluate, trainwarp
    from hocon_torch.data import images
    from hocon_torch.data import ho3d as TH
    from hocon_torch.geometry.mano import synthetic_mano_model
    from hocon_torch.render import raster_cuda as RC
    from hocon_torch.render import sample_cuda as SC

    t_phase = time.perf_counter()
    check_decoders(torch, device, smi)
    here, cpu_decoder = os.getcwd(), images.decode_jpeg_cpu
    cache_env = os.environ.get("HOCON_CACHE_DIR")
    work = tempfile.mkdtemp(prefix="real-", dir=out_dir)
    images.decode_jpeg_cpu = lambda data: fail("real_data: a JPEG reached the CPU decoder")
    os.environ["HOCON_CACHE_DIR"] = os.path.join(work, "cache")
    os.chdir(work)
    try:
        mano = synthetic_mano_model(0, device=device)
        fphab, ho3d, assets = (os.path.join(work, d) for d in ("fphab", "ho3d", "mano"))
        os.makedirs(assets)
        t0 = time.perf_counter()
        write_fphab_tree(torch, device, mano, fphab)
        write_ho3d_tree(torch, device, mano, ho3d)
        log(f"real_data: wrote FPHAB ({len(FPHAB_TRAIN)} + 1 sequences of {REAL_FRAMES} "
            f"{FPHAB_HW[1]}x{FPHAB_HW[0]} JPEGs) and HO-3D ({len(HO3D_SEQS)} x {REAL_FRAMES} "
            f"{HO3D_HW[1]}x{HO3D_HW[0]} PNGs) trees in {time.perf_counter() - t0:.1f} s; "
            f"card {smi}")

        flags = {"dataset": "fhbhands", "data_root": fphab, "image_size": RES,
                 "batch_size": PAIRS, "use_objects": True, "mano_assets": assets}
        _, text = run_cli(trainwarp.main, cli_argv({**flags, "check_data": True}), device,
                          exits=True)
        faces = re.search(r"obj (\d+)v/(\d+)f", text)
        if faces is None or not 0 < int(faces.group(2)) <= OBJ_BUDGET:
            fail(f"real_data: the object was not decimated to <= {OBJ_BUDGET} faces")
        log(f"real_data: trainwarp --check_data exit 0; the {2 * DENSE_POINTS - 4}-face PLY "
            f"decimated to {faces.group(2)} faces, {faces.group(1)} vertices")

        torch.cuda.synchronize()
        RC.raster_fwd.launches = RC.raster_bwd.launches = 0
        SC.sample_fwd.launches = SC.sample_bwd.launches = 0
        RC.raster_fwd.launches_by_attrs = {}
        images.ycc_to_rgb_cuda.launches = 0
        t0 = time.perf_counter()
        state, text = run_cli(trainwarp.main, cli_argv({
            **flags, "fraction": 0.25, "epochs": 1, "lr": 5e-4, "exp_id": "fphab"}), device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_c = dict(RC.raster_fwd.launches_by_attrs)
        launches = {"raster_fwd": by_c.get(2, 0), "raster_bwd": RC.raster_bwd.launches,
                    "sample_fwd": SC.sample_fwd.launches, "sample_bwd": SC.sample_bwd.launches}
        decodes = images.ycc_to_rgb_cuda.launches  # one jpeg_ycc_rgb launch per nvJPEG decode
        want_decodes = REAL_STEPS * PAIRS * 2 + REAL_FRAMES  # the pairs' two frames, val frames
        if launches != {k: REAL_STEPS for k in launches} or set(by_c) != {2}:
            fail(f"real_data: launches {launches} (K1 by C {by_c}): want K1 at C = 2, K2, K3 "
                 f"and K4 once per train step ({REAL_STEPS})")
        if decodes != want_decodes:
            fail(f"real_data: {decodes} nvJPEG decodes, want {want_decodes}")
        run = os.path.join(work, "checkpoints", "fphab")
        with open(os.path.join(run, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        if (state.step != REAL_STEPS or [r["step"] for r in records] != [1, 2, 3]
                or not all(math.isfinite(v) for r in records for v in r.values())
                or min(r["mask_area"] for r in records) <= 0):
            fail(f"real_data: trainwarp on FPHAB logged {records}, want {REAL_STEPS} finite steps")
        ckpt = os.path.join(run, "ckpt")
        if not os.path.exists(os.path.join(ckpt, str(REAL_STEPS), "state.pt")):
            fail("real_data: trainwarp on FPHAB wrote no checkpoint")
        with open(os.path.join(run, "epochs.json")) as fh:
            epochs = json.load(fh)
        rate = [e["steps_per_sec"] for e in epochs if e["split"] == "train"][0]
        log(f"real_data: trainwarp on FPHAB, {REAL_STEPS} steps of {PAIRS} pairs at {RES}^2: "
            f"set-up {cli_setup_s(text):.3f} s (MANO fits, decimation, model), steps_per_sec "
            f"{rate:.3f} (past 2 warm-up steps), the call {wall:.1f} s with eval and snapshot; "
            f"launches {launches}; {decodes} nvJPEG decodes; card {smi}")

        from hocon_torch.data.factory import get_dataset
        from hocon_torch.data.pipeline import BatchLoader

        ds = get_dataset("fhbhands", "train", fphab, RES, fraction=0.25, use_objects=True,
                         pair_mode=True, mano=mano, device=device)
        batches = BatchLoader(ds, PAIRS, prefetch=0).epoch(0)
        next(batches)
        t0 = time.perf_counter()
        next(batches)
        host_s = time.perf_counter() - t0
        log(f"real_data: one FPHAB batch of {PAIRS} pairs assembled on the host in {host_s:.3f} s "
            f"({2 * PAIRS} nvJPEG decodes of {FPHAB_HW[1]}x{FPHAB_HW[0]}, crops, jitter); "
            f"card {smi}")

        t0 = time.perf_counter()
        TH.HO3D(ho3d, split="train", mano=mano)
        log(f"real_data: HO-3D fit-vertex memmap of {len(HO3D_SEQS) * REAL_FRAMES} frames built "
            f"in {time.perf_counter() - t0:.3f} s (meta pickles, MANO on the card, the file); "
            f"card {smi}")
        ho3d_flags = {"dataset": "ho3dv2", "data_root": ho3d, "val_split": "train",
                      "image_size": RES, "batch_size": PAIRS, "use_objects": True,
                      "mano_assets": assets}
        run_cli(evaluate.main, cli_argv({**ho3d_flags, "check_data": True}), device, exits=True)
        t0 = time.perf_counter()
        metrics, _ = run_cli(evaluate.main, cli_argv({**ho3d_flags, "resume": ckpt}), device)
        if not (math.isfinite(metrics["mpjpe_mm"]) and math.isfinite(metrics["obj_verts_err_mm"])):
            fail(f"real_data: evaluate on HO-3D gave {metrics}")
        log(f"real_data: evaluate --check_data on HO-3D exit 0; evaluate of the FPHAB run on "
            f"HO-3D: MPJPE {metrics['mpjpe_mm']:.2f} mm over {len(HO3D_SEQS) * REAL_FRAMES} "
            f"frames in {time.perf_counter() - t0:.1f} s; card {smi}")
        log(f"real_data: the phase took {time.perf_counter() - t_phase:.1f} s; card {smi}")
    finally:
        images.decode_jpeg_cpu = cpu_decoder
        if cache_env is None:
            os.environ.pop("HOCON_CACHE_DIR", None)
        else:
            os.environ["HOCON_CACHE_DIR"] = cache_env
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


# Phase 13: the DataLoader workers on FPHAB and HO-3D trees, and MANO assets
# from a pickle, with the left hand.
WORKER_FRAMES = 64  # frames per FPHAB sequence: 3 x 64 = 192 pairs = 12 steps of 16
WORKER_STEPS = 12
LEFT_FLAGS = {"dataset": "synthetic", "image_size": RES, "batch_size": PAIRS, "use_objects": True,
              "synth_videos": 2, "synth_frames": 16, "fraction": 0.25, "epochs": 1, "lr": 5e-4,
              "mano_side": "left", "exp_id": "left"}
LEFT_STEPS = 2  # 2 videos x 16 frames = 32 pairs = 2 steps of 16


def worker_count() -> tuple:
    """(the host's cores, the workers to use): every core but two, one for
    the process that drives the card and one for the rest of the host."""
    cores = os.cpu_count() or 1
    return cores, max(1, cores - 2)


def with_hbm_peak(torch, fn):
    """``fn()`` while a thread reads the card's memory in use by every
    process (``torch.cuda.mem_get_info``) each 50 ms; returns (fn's result,
    the most in use, in bytes)."""
    import threading

    stop, peak = threading.Event(), [0]

    def poll():
        while not stop.is_set():
            free, total = torch.cuda.mem_get_info()
            peak[0] = max(peak[0], total - free)
            stop.wait(0.05)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        result = fn()
    finally:
        stop.set()
        thread.join()
    return result, peak[0]


def leaves(batch: dict, prefix: str = "") -> dict:
    """A nested batch as {"ref/image": array, ...}."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def batches_equal(a: dict, b: dict) -> bool:
    la, lb = leaves(a), leaves(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape
        and la[k].tobytes() == lb[k].tobytes() for k in la)


def counters_zeroed(torch) -> None:
    from hocon_torch.data import images
    from hocon_torch.render import raster_cuda as RC
    from hocon_torch.render import sample_cuda as SC

    torch.cuda.synchronize()
    RC.raster_fwd.launches = RC.raster_bwd.launches = 0
    SC.sample_fwd.launches = SC.sample_bwd.launches = 0
    RC.raster_fwd.launches_by_attrs = {}
    images.ycc_to_rgb_cuda.launches = 0


def step_launches() -> tuple:
    """(K1 at C = 2, K2, K3 and K4 launches, K1's launches by C)."""
    from hocon_torch.render import raster_cuda as RC
    from hocon_torch.render import sample_cuda as SC

    by_c = dict(RC.raster_fwd.launches_by_attrs)
    return ({"raster_fwd": by_c.get(2, 0), "raster_bwd": RC.raster_bwd.launches,
             "sample_fwd": SC.sample_fwd.launches, "sample_bwd": SC.sample_bwd.launches}, by_c)


def train_records(run: str, steps: int, what: str) -> list:
    """The run's logged steps, which must be ``steps`` finite ones with a
    non-empty mask."""
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    if ([r["step"] for r in records] != list(range(1, steps + 1))
            or not all(math.isfinite(v) for r in records for v in r.values())
            or min(r["mask_area"] for r in records) <= 0):
        fail(f"workers: {what} logged {records}, want {steps} finite steps")
    return records


def fphab_rate_run(torch, device, flags: dict, workers: int, exp_id: str, smi: str) -> dict:
    """``trainwarp`` on the FPHAB tree with ``--workers workers``: K1 at
    C = 2, K2, K3 and K4 once per step in this process, and every JPEG
    decoded here (``--workers 0``) or none (in the workers)."""
    from hocon_torch.cli import trainwarp
    from hocon_torch.data import images

    counters_zeroed(torch)
    t0 = time.perf_counter()
    (_, text), peak = with_hbm_peak(torch, lambda: run_cli(
        trainwarp.main, cli_argv({**flags, "workers": workers, "exp_id": exp_id}), device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_c = step_launches()
    decodes = images.ycc_to_rgb_cuda.launches
    if launches != {k: WORKER_STEPS for k in launches} or set(by_c) != {2}:
        fail(f"workers: --workers {workers}: launches {launches} (K1 by C {by_c}), want K1 at "
             f"C = 2, K2, K3 and K4 once per train step ({WORKER_STEPS}) in this process")
    want_decodes = 0 if workers else WORKER_STEPS * PAIRS * 2
    if decodes != want_decodes:
        fail(f"workers: --workers {workers}: {decodes} nvJPEG decodes in this process, "
             f"want {want_decodes}")
    run = os.path.join("checkpoints", exp_id)
    records = train_records(run, WORKER_STEPS, f"trainwarp --workers {workers} on FPHAB")
    with open(os.path.join(run, "epochs.json")) as fh:
        rate = [e["steps_per_sec"] for e in json.load(fh) if e["split"] == "train"][0]
    log(f"workers: trainwarp --workers {workers} on FPHAB, {WORKER_STEPS} steps of {PAIRS} "
        f"pairs at {RES}^2: steps_per_sec {rate:.3f} (past 2 warm-up steps), the call "
        f"{wall:.1f} s, set-up {cli_setup_s(text):.3f} s; launches {launches}; {decodes} nvJPEG "
        f"decodes in this process; most HBM in use {peak / 2**30:.2f} GiB; card {smi}")
    first = {k: v for k, v in records[0].items() if k != "time"}
    return {"rate": rate, "peak": peak, "first": first}


def check_mano_assets(torch, device, work: str) -> str:
    """MANO_RIGHT.pkl from the synthetic arrays in the official pickle's
    layout (``tools/fixture_trees.write_mano_pkl``: chumpy objects, a sparse
    joint regressor), read by ``load_mano_or_synthetic`` for the right hand,
    for the left from the right file (mirrored), and for the left from a
    MANO_LEFT.pkl (written with the published left asset's sign in x of
    shapedirs, which the loader fixes). Returns the right-only directory."""
    from hocon_torch.cli import opts
    from hocon_torch.geometry.mano import mirror_mano_model, synthetic_mano_arrays
    from tools.fixture_trees import write_mano_pkl

    arrays = synthetic_mano_arrays(0)
    right_dir, both_dir = os.path.join(work, "mano_right"), os.path.join(work, "mano_both")
    write_mano_pkl(os.path.join(right_dir, "MANO_RIGHT.pkl"), arrays)
    write_mano_pkl(os.path.join(both_dir, "MANO_RIGHT.pkl"), arrays)
    fields = ("v_template", "shapedirs", "posedirs", "joint_regressor", "skin_weights",
              "hands_components", "hands_mean", "faces")
    models = {}
    for name, where, side in (("right", right_dir, "right"), ("left mirrored", right_dir, "left")):
        models[name] = opts.load_mano_or_synthetic(where, side, device=device)
    mirror = mirror_mano_model(models["right"])
    left_arrays = {k: getattr(mirror, k).cpu().numpy() for k in fields}
    left_arrays["shapedirs"] = arrays["shapedirs"]  # the left asset's x sign, as published
    write_mano_pkl(os.path.join(both_dir, "MANO_LEFT.pkl"), left_arrays)
    models["left from MANO_LEFT.pkl"] = opts.load_mano_or_synthetic(both_dir, "left",
                                                                    device=device)
    for name, model in models.items():
        if not all(getattr(model, k).is_cuda for k in fields):
            fail(f"workers: the MANO model ({name}) is not on the card")
    if not all(torch.equal(getattr(models["right"], k).cpu(), torch.from_numpy(
            np.asarray(arrays[k])).to(getattr(models["right"], k).dtype)) for k in fields):
        fail("workers: MANO_RIGHT.pkl did not load to the arrays it was written from")
    for name in ("left mirrored", "left from MANO_LEFT.pkl"):
        model = models[name]
        if model.side != "left" or not all(torch.equal(getattr(model, k), getattr(mirror, k))
                                           for k in fields):
            fail(f"workers: the left hand ({name}) is not the mirrored right hand")
    log("workers: load_mano_or_synthetic on the card: MANO_RIGHT.pkl (chumpy objects, a "
        "scipy.sparse.csc joint regressor, uint32 faces) loads to its arrays; the left hand "
        "mirrored from it and the one read from MANO_LEFT.pkl (shapedirs' x sign fixed) are "
        "the mirror bit for bit; every tensor on the card")
    return right_dir


def phase_workers(torch, device, smi: str, out_dir: str) -> None:
    """Phase 13: DataLoader workers for ``trainwarp`` on FPHAB and
    ``evaluate`` on HO-3D, and MANO assets from a pickle with the left hand
    (see the module note)."""
    import shutil
    import tempfile

    from hocon_torch.cli import evaluate, trainwarp
    from hocon_torch.data.factory import get_dataset
    from hocon_torch.data.pipeline import BatchLoader, WorkerEpochLoader
    from hocon_torch.geometry.mano import synthetic_mano_model

    t_phase = time.perf_counter()
    cores, workers = worker_count()
    here, cache_env = os.getcwd(), os.environ.get("HOCON_CACHE_DIR")
    work = tempfile.mkdtemp(prefix="workers-", dir=out_dir)
    os.environ["HOCON_CACHE_DIR"] = os.path.join(work, "cache")
    os.chdir(work)
    try:
        mano = synthetic_mano_model(0, device=device)
        fphab, ho3d, assets = (os.path.join(work, d) for d in ("fphab", "ho3d", "mano"))
        os.makedirs(assets)
        t0 = time.perf_counter()
        write_fphab_tree(torch, device, mano, fphab, WORKER_FRAMES)
        write_ho3d_tree(torch, device, mano, ho3d)
        log(f"workers: {cores} cores, {workers} workers; wrote FPHAB ({len(FPHAB_TRAIN)} + 1 "
            f"sequences of {WORKER_FRAMES} {FPHAB_HW[1]}x{FPHAB_HW[0]} JPEGs) and HO-3D trees "
            f"in {time.perf_counter() - t0:.1f} s; card {smi}")

        # The first batch: in this process, then from the workers (which
        # decode on the card), then with the CPU decoder (PIL) for contrast.
        ds = get_dataset("fhbhands", "train", fphab, RES, fraction=0.25, use_objects=True,
                         pair_mode=True, mano=mano, device=device)
        t0 = time.perf_counter()
        want = next(BatchLoader(ds, PAIRS, seed=0, prefetch=0).epoch(0))
        host_s = time.perf_counter() - t0
        used0 = torch.cuda.mem_get_info()
        with WorkerEpochLoader(ds, PAIRS, seed=0, worker_count=workers) as loader:
            t0 = time.perf_counter()
            got = next(iter(loader.epoch(0)))
            first_s = time.perf_counter() - t0
            time.sleep(1.0)  # the other workers' first batches
            used1 = torch.cuda.mem_get_info()
        ds.cfg.decode_device = torch.device("cpu")
        on_cpu = next(BatchLoader(ds, PAIRS, seed=0, prefetch=0).epoch(0))
        if not batches_equal(got, want):
            fail("workers: the first worker batch is not BatchLoader(prefetch=0)'s, bit for bit")
        want_leaves, cpu_leaves = leaves(want), leaves(on_cpu)
        img = [k for k in want_leaves if k.endswith("image")]
        differ = sum(int((cpu_leaves[k] != want_leaves[k]).sum()) for k in img)
        total = sum(want_leaves[k].size for k in img)
        if differ == 0:
            fail("workers: the CPU decoder gives the card's bits: the equality shows nothing")
        per_worker = ((used0[0] - used1[0]) / workers) / 2**30
        log(f"workers: the first batch of {PAIRS} pairs from {workers} workers "
            f"(decoding on the card) equals BatchLoader(prefetch=0)'s bit for bit; with the CPU "
            f"decoder (PIL) {differ} of {total} image values differ; in this process the batch "
            f"took {host_s:.3f} s, from the workers {first_s:.3f} s (the workers' start and the "
            f"batch); HBM in use {(used0[1] - used0[0]) / 2**30:.2f} GiB before the workers, "
            f"{(used1[1] - used1[0]) / 2**30:.2f} GiB with them: {per_worker:.3f} GiB per "
            f"decoding worker; card {smi}")

        flags = {"dataset": "fhbhands", "data_root": fphab, "image_size": RES,
                 "batch_size": PAIRS, "use_objects": True, "mano_assets": assets,
                 "fraction": 0.25, "epochs": 1, "eval_freq": 2, "lr": 5e-4}
        runs = {0: [], workers: []}
        for rnd in range(2):
            for w in (0, workers):
                runs[w].append(fphab_rate_run(torch, device, flags, w, f"w{w}_{rnd}", smi))
        same = all(r["first"] == runs[0][0]["first"] for r in runs[0] + runs[workers])
        rates = {w: [r["rate"] for r in rs] for w, rs in runs.items()}
        peaks = {w: max(r["peak"] for r in rs) / 2**30 for w, rs in runs.items()}
        log(f"workers: trainwarp on FPHAB, steps_per_sec --workers 0 {rates[0][0]:.3f} / "
            f"{rates[0][1]:.3f}, --workers {workers} {rates[workers][0]:.3f} / "
            f"{rates[workers][1]:.3f} (in turns: 0, {workers}, 0, {workers}); most HBM in use "
            f"{peaks[0]:.2f} GiB against {peaks[workers]:.2f} GiB; the first step's logged "
            f"terms equal in all four runs: {same}; card {smi}")

        ckpt = os.path.join(work, "checkpoints", f"w{workers}_0", "ckpt")
        ho3d_flags = {"dataset": "ho3dv2", "data_root": ho3d, "val_split": "train",
                      "image_size": RES, "batch_size": PAIRS, "use_objects": True,
                      "mano_assets": assets, "resume": ckpt}
        evals = {}
        for w in (0, workers):
            t0 = time.perf_counter()
            (metrics, _), peak = with_hbm_peak(torch, lambda: run_cli(
                evaluate.main, cli_argv({**ho3d_flags, "workers": w}), device))
            evals[w] = (metrics, time.perf_counter() - t0, peak / 2**30)
        keys = sorted(set(evals[0][0]) - {"steps_per_sec"})
        if any(evals[workers][0][k] != evals[0][0][k] for k in keys):
            fail(f"workers: evaluate on HO-3D with --workers {workers} gave {evals[workers][0]}, "
                 f"with --workers 0 {evals[0][0]}")
        log(f"workers: evaluate on HO-3D (PNG frames): --workers {workers} gives --workers 0's "
            f"metrics exactly (MPJPE {evals[0][0]['mpjpe_mm']:.4f} mm, object vertex error "
            f"{evals[0][0]['obj_verts_err_mm']:.4f} mm, AUC {evals[0][0]['auc']:.4f}); the "
            f"calls {evals[0][1]:.1f} / {evals[workers][1]:.1f} s, most HBM in use "
            f"{evals[0][2]:.2f} / {evals[workers][2]:.2f} GiB (workers reading PNGs open no CUDA "
            f"context); card {smi}")

        right_dir = check_mano_assets(torch, device, work)
        counters_zeroed(torch)
        t0 = time.perf_counter()
        state, _ = run_cli(trainwarp.main, cli_argv({**LEFT_FLAGS, "mano_assets": right_dir}),
                           device)
        torch.cuda.synchronize()
        launches, by_c = step_launches()
        if state.step != LEFT_STEPS or launches != {k: LEFT_STEPS for k in launches}:
            fail(f"workers: trainwarp --mano_side left: step {state.step}, launches {launches}, "
                 f"want K1 at C = 2, K2, K3 and K4 once per step ({LEFT_STEPS})")
        records = train_records(os.path.join("checkpoints", "left"), LEFT_STEPS,
                                "trainwarp --mano_side left")
        log(f"workers: trainwarp --mano_side left (the right pickle mirrored) on synthetic data, "
            f"{LEFT_STEPS} steps of {PAIRS} pairs at {RES}^2 in {time.perf_counter() - t0:.1f} s: "
            f"every term finite, loss {records[0]['loss_total']:.4f} -> "
            f"{records[-1]['loss_total']:.4f}, mask area {records[-1]['mask_area']:.1f}; "
            f"launches {launches}, K1 by C {by_c}; card {smi}")
        log(f"workers: the phase took {time.perf_counter() - t_phase:.1f} s; card {smi}")
    finally:
        if cache_env is None:
            os.environ.pop("HOCON_CACHE_DIR", None)
        else:
            os.environ["HOCON_CACHE_DIR"] = cache_env
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


# Phase 14: the paper's consistency-gain ablation
# (tools/repro_torch_consistency.py) at the reference's shapes: 128^2, batch
# 16, 8 videos of 16 frames, 2 of 16 annotated, the box scene, seed 0, with
# the protocol's 300 steps per stage cut to REPRO_STEPS.
REPRO_STEPS = 30
REPRO_ARGV = ["0", "--frames", "16", "--fraction", "0.125"]
REPRO_DATASETS = 3  # single, pair and eval: one K1 render at C = 3 each
# The reference's JSON keys, in order (scripts/repro_synthetic_consistency.py:184-199).
REPRO_KEYS = ("seed", "obj_faces", "fraction", "frames_per_video", "lambda_consist", "spacing",
              "baseline_mpjpe_unannotated_mm", "control_extra_steps_mpjpe_unannotated_mm",
              "warp_mpjpe_unannotated_mm", "baseline_mpjpe_all_mm", "warp_mpjpe_all_mm",
              "consistency_gain_mm")


def phase_repro(torch, device, smi: str) -> None:
    """``tools/repro_torch_consistency.py``'s command line on the card (see
    the module note, phase 14): the launches of every step it takes are
    read around that step, so K1 at C = 2, K2, K3 and K4 must launch once in
    each warp step and never in a supervised or an eval step, and K1 at
    C = 3 once per dataset."""
    from tools import repro_torch_consistency as repro

    made = {"make_train_step": "supervised", "make_warp_train_step": "warp",
            "make_eval_step": "eval"}
    saved = {name: getattr(repro, name) for name in (*made, "STEPS_BASE", "STEPS_WARP")}
    deltas = {kind: [] for kind in made.values()}

    def now() -> tuple:
        launches, by_c = step_launches()
        return (*launches.values(), by_c.get(3, 0))

    def counting(kind, make):
        def make_counted(*args, **kwargs):
            step = make(*args, **kwargs)

            def counted(*a, **kw):
                before = now()
                out = step(*a, **kw)
                deltas[kind].append(tuple(x - y for x, y in zip(now(), before)))
                return out
            return counted
        return make_counted

    for name, kind in made.items():
        setattr(repro, name, counting(kind, saved[name]))
    repro.STEPS_BASE = repro.STEPS_WARP = REPRO_STEPS
    try:
        counters_zeroed(torch)
        t0 = time.perf_counter()
        (run,), text = run_cli(repro.cli_main, REPRO_ARGV, device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_c = step_launches()
    finally:
        for name, value in saved.items():
            setattr(repro, name, value)
    record = json.loads(text)
    once, none = (1, 1, 1, 1, 0), (0,) * 5
    log(f"repro: {' '.join(REPRO_ARGV)} at {repro.RES}^2, batch {repro.BATCH}, "
        f"{repro.VIDEOS} videos, {REPRO_STEPS} steps per stage: the phase {wall:.1f} s; "
        f"datasets {run.seconds['datasets']:.2f} s, baseline {run.seconds['baseline']:.2f} s, "
        f"warp {run.seconds['warp']:.2f} s, control {run.seconds['control']:.2f} s; launches "
        f"{launches}, K1 at C = 3 {by_c.get(3, 0)}; card {smi}")
    figures = {f"{stage} {part}": round(v, 4) for (stage, part), v in run.mpjpe.items()}
    log(f"repro: MPJPE (mm) {figures}; gain {record['consistency_gain_mm']} mm "
        f"(not gated: one short seed)")
    if len(deltas["warp"]) != REPRO_STEPS or any(d != once for d in deltas["warp"]):
        fail(f"repro: warp steps launched {sorted(set(deltas['warp']))} (K1 C=2, K2, K3, K4, "
             f"K1 C=3) in {len(deltas['warp'])} steps, want {once} in each of {REPRO_STEPS}")
    for kind in ("supervised", "eval"):
        if not deltas[kind] or any(d != none for d in deltas[kind]):
            fail(f"repro: {kind} steps launched {sorted(set(deltas[kind]))}, want none")
    if (launches != {k: REPRO_STEPS for k in launches} or set(by_c) != {2, 3}
            or by_c[3] != REPRO_DATASETS):
        fail(f"repro: launches {launches} (by C {by_c}), want {REPRO_STEPS} of each and "
             f"{REPRO_DATASETS} at C = 3")
    if tuple(record) != REPRO_KEYS:
        fail(f"repro: the line's keys {list(record)}, want the reference's {list(REPRO_KEYS)}")
    if not all(math.isfinite(v) for v in run.mpjpe.values()):
        fail(f"repro: MPJPE figures {figures} are not all finite")
    if (run.warp_state.model is run.base_state.model or run.warp_state.step != REPRO_STEPS
            or run.base_state.step != 2 * REPRO_STEPS):
        fail(f"repro: stage states: warp step {run.warp_state.step}, baseline + control "
             f"{run.base_state.step}, want {REPRO_STEPS} on a copy and {2 * REPRO_STEPS}")


def descendants(pid: int) -> dict:
    """The processes under ``pid`` (children, their children, ...), from
    ``/proc``: pid -> (name, state)."""
    children = {}
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        rest = stat[stat.rindex(")") + 2:].split()
        children.setdefault(int(rest[1]), []).append(
            (int(d), stat[stat.index("(") + 1:stat.rindex(")")], rest[0]))
    found, todo = {}, [pid]
    while todo:
        for child, name, state in children.get(todo.pop(), []):
            found[child] = (name, state)
            todo.append(child)
    return found


def stop_processes() -> None:
    """Stop every process this script started, and fail if one is left:
    the loaders' workers stop with their CLI calls, the forkserver and the
    resource tracker here (``stop_worker_server``). Processes seen under
    this one before that must be gone within 10 s, and none may be left."""
    from hocon_torch.data.pipeline import stop_worker_server

    started = descendants(os.getpid())
    stop_worker_server()
    deadline = time.monotonic() + 10.0
    while True:
        left = {pid: what for pid, what in started.items() if os.path.exists(f"/proc/{pid}")}
        left.update(descendants(os.getpid()))
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, os.WNOHANG)
        except (ProcessLookupError, ChildProcessError):
            pass
    log(f"processes: {len(started)} under this one before the stop "
        f"({sorted(name for name, _ in started.values())}), {len(left)} left after it")
    if left:
        fail(f"processes left running after the stop (killed now): {left}")


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

    try:
        kernels = run_phases(torch, out_dir)
    finally:
        stop_processes()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def run_phases(torch, out_dir: str) -> list:
    """Every phase; returns the kernel table."""
    t_start = time.perf_counter()
    device = "cuda"
    smi = phase_device(torch)
    phase_build(out_dir)
    k1c3, k1, k2, k3, k4 = {}, {}, {}, {}, {}
    # The data path: its K1 launches (C = 3) go into the table.
    images, batch = phase_data(torch, device, smi, k1c3)
    scene = make_scene(torch, device)
    coords = phase_k1(torch, device, scene, smi, k1)
    phase_k2(torch, device, scene, smi, k2)
    phase_k3(torch, device, coords, images, smi, k3)
    phase_k4(torch, device, coords, images, smi, k4)
    phase_slice(torch, device, batch, smi, out_dir, [k1, k3])
    # The train step is the main path: its launches go into the table.
    phase_train(torch, device, batch, smi, out_dir, [k1, k2, k3, k4])
    # The slice's main path, the trainer's CLI: its launches go into the table.
    cli = {}
    phase_cli(torch, device, smi, out_dir, cli)
    phase_import_vis(torch, device, smi, out_dir)
    phase_real_data(torch, device, smi, out_dir)
    phase_workers(torch, device, smi, out_dir)
    phase_repro(torch, device, smi)
    for kern, name in ((k1, "raster_fwd"), (k1c3, "raster_fwd C=3"), (k2, "raster_bwd"),
                       (k3, "sample_fwd"), (k4, "sample_bwd")):
        kern["launches"] = cli[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"phases: {time.perf_counter() - t_start:.1f} s in all; card {smi}")
    return [{k: kern[k] for k in keys} for kern in (k1, k1c3, k2, k3, k4)]


if __name__ == "__main__":
    main()
