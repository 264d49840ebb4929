#!/usr/bin/env python3
"""Which recipe rendered the stored TPU frames?

``assets/synth_cache/synth-e6ed93a93e4f739e.npz`` holds 32 frames that
``hocon``'s synthetic dataset rendered on the TPU (its Pallas kernel), with
the hand verts and joints they were rendered from. Rendered again today,
those verts give the same silhouettes but other colours. This tool finds
out why, on the CPU:

1. the cache key (``hocon/data/synthetic.py:_cache_path``, backend
   ``"pallas"``): which dataset configuration of today's tree, or of a
   commit of the window below, hashes to the file's name;
2. the stored verts and joints (``--frames``, a subset of the 32) rendered
   as the dataset renders its own, several ways:

   - ``hocon, pallas interpret``: today's ``hocon``, its Pallas kernel in
     interpret mode;
   - ``hocon, xla``: today's ``hocon``, the ``xla`` backend;
   - ``port, plain``: ``hocon_torch``'s render on the CPU (K1's plain
     version);
   - ``port, plain, TPU rounding (...)``: the same with products that the
     TPU ran at ``DEFAULT`` precision (bf16 operands, f32 accumulation)
     rounded so, as ``tools/repro_tpu_rounding.py`` does (``ROUNDINGS``):
     the projection (G2) with the depth and attribute plane rows (G3), and
     the projection with the attribute rows alone;
   - ``<commit>, xla``: ``hocon`` at each commit that touched
     ``hocon/data/synthetic.py``, ``hocon/data/meshes.py`` or
     ``hocon/render/`` from ``9fa5b9a`` (the data layer) to ``7d1295a`` (the
     commit that added the file), taken with ``git archive`` into a
     temporary directory and run in a subprocess;

   each ``hocon`` render is the dataset's own ``__init__`` with
   ``mano_forward`` returning the stored verts and joints, so the colours,
   the object at the wrist, the sigma and the background are the commit's;
3. each render against the file's frames, silhouettes and colours apart
   (``frame_split``): the share of pixels covered in one and not the other
   (covered: some channel more than ``COVER_LEVELS`` from the background
   level), and, on the pixels covered in both, the share whose largest
   channel difference exceeds 1 and 4 levels, and its median.

A render reproduces the file when ``reproduces`` holds. The first one that
does names the recipe.

    python -u tools/tpu_frames_recipe.py [--frames 0 10 21 31]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_FRAMES = os.path.join(HERE, "assets", "synth_cache", "synth-e6ed93a93e4f739e.npz")
FIRST, LAST = "9fa5b9a", "7d1295a"
RECIPE_PATHS = ("hocon/data/synthetic.py", "hocon/data/meshes.py", "hocon/render/")
BACKGROUND_LEVEL = 38  # uint8(0.15 * 255): the synthetic frames' background
COVER_LEVELS = 1
# A render reproduces the file's frames when its silhouettes differ on at
# most SIL_SHARE of the pixels and, on the pixels covered in both, at most
# COLOUR_SHARE_4 differ by more than 4 levels, with a median of at most
# MEDIAN_LEVELS.
SIL_SHARE, COLOUR_SHARE_4, MEDIAN_LEVELS = 0.005, 0.20, 2.0
RES = 256
CONFIG = dict(image_size=RES, with_object=True, obj_n_faces=1280)  # bench.py's
# Configurations whose cache key is tried: 32 frames at 256^2, seed, object.
KEY_GRID = [dict(n_videos=nv, frames_per_video=32 // nv, seed=s, with_object=wo, obj_n_faces=of)
            for nv in (1, 2, 4) for s in (0, 1, 2, 3) for wo in (True, False)
            for of in ((0, 1280) if wo else (0,))]


def covered(frames: np.ndarray) -> np.ndarray:
    """(..., H, W) bool: some channel lies more than ``COVER_LEVELS`` from
    the background level."""
    return (np.abs(frames.astype(np.int16) - BACKGROUND_LEVEL) > COVER_LEVELS).any(axis=-1)


def frame_split(mine: np.ndarray, theirs: np.ndarray) -> dict:
    """Silhouettes and colours of two uint8 (N, H, W, 3) frame stacks apart:
    ``silhouette``, the share of all pixels covered in one and not the
    other; ``silhouette_of_covered``, that count over the pixels covered in
    either; on the pixels covered in both, ``colour_gt1`` / ``colour_gt4``,
    the shares whose largest channel difference exceeds 1 / 4 levels, and
    ``colour_median`` (levels)."""
    a, b = covered(mine), covered(theirs)
    both, either = a & b, a | b
    d = np.abs(mine.astype(np.int16) - theirs.astype(np.int16)).max(axis=-1)[both]
    return {"silhouette": float((a ^ b).mean()),
            "silhouette_of_covered": float((a ^ b).sum() / max(either.sum(), 1)),
            "covered": float(b.mean()),
            "colour_gt1": float((d > 1).mean()) if d.size else 0.0,
            "colour_gt4": float((d > 4).mean()) if d.size else 0.0,
            "colour_median": float(np.median(d)) if d.size else 0.0}


def reproduces(split: dict) -> bool:
    return (split["silhouette"] <= SIL_SHARE and split["colour_gt4"] <= COLOUR_SHARE_4
            and split["colour_median"] <= MEDIAN_LEVELS)


def recipe_commits() -> list[str]:
    """Oldest first: the commits from FIRST to LAST that touched the recipe."""
    out = subprocess.run(["git", "log", "--format=%h", f"{FIRST}^..{LAST}", "--",
                          *RECIPE_PATHS], capture_output=True, text=True, check=True, cwd=HERE)
    return out.stdout.split()[::-1]


# ---- worker: one tree's hocon, in its own process ---------------------------


def _cache_keys(S) -> list[dict]:
    """The KEY_GRID configurations whose key under backend "pallas" names the
    file, with this tree's ``_cache_path``."""
    import jax

    want = os.path.basename(TPU_FRAMES)
    hits, objs = [], {}
    for cfg in KEY_GRID:  # each configuration's MANO model and object mesh
        obj = (cfg["with_object"], cfg["obj_n_faces"])
        if obj not in objs:
            kw = {"obj_n_faces": cfg["obj_n_faces"]} if cfg["obj_n_faces"] else {}
            ds = S.SyntheticHandDataset.__new__(S.SyntheticHandDataset)
            proto = _tiny(S, cfg["with_object"], kw)
            ds.__dict__.update({k: v for k, v in proto.__dict__.items()
                                if k in ("mano", "obj_verts_can", "obj_faces", "with_object")})
            objs[obj] = ds
    default_backend, cache = jax.default_backend, os.environ.pop("HOCON_SYNTH_CACHE", None)
    jax.default_backend = lambda: "tpu"
    try:
        for cfg in KEY_GRID:
            ds = objs[(cfg["with_object"], cfg["obj_n_faces"])]
            ds.image_size, ds.frames_per_video = RES, cfg["frames_per_video"]
            if os.path.basename(ds._cache_path(cfg["n_videos"], cfg["seed"])) == want:
                hits.append(cfg)
    finally:
        jax.default_backend = default_backend
        if cache is not None:
            os.environ["HOCON_SYNTH_CACHE"] = cache
    return hits


def _tiny(S, with_object: bool, kw: dict):
    """A 1 x 2-frame dataset at 16 px (for its MANO model and object mesh)."""
    return S.SyntheticHandDataset(n_videos=1, frames_per_video=2, image_size=16, seed=0,
                                  with_object=with_object, **kw)


def worker(tree: str, backend: str, frames: list[int], out: str) -> dict:
    """Renders the stored verts and joints of ``frames`` with ``tree``'s
    ``hocon`` dataset recipe on ``backend``; saves the frames to ``out``."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["HOCON_SYNTH_CACHE"] = "0"
    sys.path.insert(0, tree)
    import jax.numpy as jnp

    import hocon
    import hocon.data.synthetic as S
    import hocon.render.raster as R

    rec = {"tree": tree, "hocon": os.path.dirname(hocon.__file__), "backend": backend}
    if not os.path.realpath(rec["hocon"]).startswith(os.path.realpath(tree)):
        raise RuntimeError(f"imported {hocon.__file__}, not the tree's")
    if "obj_n_faces" not in S.SyntheticHandDataset.__init__.__code__.co_varnames:
        rec["error"] = "no obj_n_faces: this tree cannot render the 1280-face object"
        return rec
    try:
        rec["key_configs"] = _cache_keys(S)
    except Exception as e:  # a tree without the cache key
        rec["key_configs"], rec["key_error"] = [], f"{type(e).__name__}: {e}"
    with np.load(TPU_FRAMES) as z:
        verts, joints = z["verts"][frames], z["joints"][frames]
    S.mano_forward = lambda *a, **k: (jnp.asarray(verts), jnp.asarray(joints))
    if backend != "auto":
        raster = R.soft_rasterize
        R.soft_rasterize = lambda *a, **k: raster(*a, **dict(k, backend=backend))
    t0 = time.time()
    ds = S.SyntheticHandDataset(n_videos=1, frames_per_video=len(frames), seed=0, **CONFIG)
    rec["seconds"] = round(time.time() - t0, 1)
    rec["verts_taken"] = bool(np.array_equal(np.asarray(ds.verts), verts))
    np.save(out, np.asarray(ds.images))
    return rec


def run_tree(tree: str, backend: str, frames: list[int], tmp: str) -> tuple[dict, np.ndarray | None]:
    out = os.path.join(tmp, f"frames-{len(os.listdir(tmp))}.npy")
    cmd = [sys.executable, "-u", os.path.abspath(__file__), "--worker", tree, "--backend",
           backend, "--out", out, "--frames", *map(str, frames)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOCON_SYNTH_CACHE="0",
               PYTHONPATH=tree, HOCON_CACHE_DIR=tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode or not lines:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
        return {"tree": tree, "backend": backend, "error": " | ".join(tail)}, None
    rec = json.loads(lines[-1])
    return rec, (np.load(out) if os.path.exists(out) else None)


# ---- the port's renders, in this process --------------------------------------


# The TPU's DEFAULT-precision products emulated in the port's render, as
# ``tools/repro_tpu_rounding.py`` rounds them: G2 + G3 (its set), and G2
# with only the attribute rows of G3 (the depth row left in f32).
ROUNDINGS = {"G2 + G3": ("G2", "G3"), "G2 + attribute rows": ("G2", "attr")}


class _Rounded:
    """Rounds the ``variant``'s products while entered; ``calls`` counts
    them by group."""

    def __init__(self, variant: str | None):
        from tools import repro_tpu_rounding as TR

        groups = ROUNDINGS[variant] if variant else ()
        self.swap = TR.TpuRounding(tuple(g for g in groups if g in TR.GROUPS))
        self.calls = self.swap.calls
        self.stand_in = None
        if "attr" in groups:
            self.calls["attr"] = 0
            self.stand_in = TR._RoundingTorch(self.calls, "attr", equations=TR.PLANE_ROWS[1:],
                                              matmul=False)

    def __enter__(self):
        from hocon_torch.render import raster as raster_mod

        self.swap.__enter__()
        if self.stand_in is not None:
            self.saved = raster_mod.torch
            raster_mod.torch = self.stand_in
        return self

    def __exit__(self, *exc):
        from hocon_torch.render import raster as raster_mod

        if self.stand_in is not None:
            raster_mod.torch = self.saved
        return self.swap.__exit__(*exc)


def port_render(frames: list[int], variant: str | None = None) -> tuple[np.ndarray, dict]:
    """The port's dataset recipe on the CPU for the stored verts, with the
    products of ``ROUNDINGS[variant]`` rounded as the TPU ran them; returns
    the frames and the rounded calls by group."""
    import torch

    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from hocon_torch.data import synthetic as PS

    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    with np.load(TPU_FRAMES) as z:
        verts, joints = z["verts"][frames], z["joints"][frames]
    ds = PS.SyntheticHandDataset.__new__(PS.SyntheticHandDataset)
    ds.mano = PS.synthetic_mano_model(0, device="cpu")
    ds.with_object, ds.obj_scale = True, PS.OBJ_SCALE
    sv, sf = PS.uv_sphere(CONFIG["obj_n_faces"])
    ds.obj_verts_can, ds.obj_faces = sv * (ds.obj_scale * 0.5), sf
    with _Rounded(variant) as swap:
        images = PS.render_frames(*ds.meshes(verts, joints), PS.synthetic_camintr(RES), RES,
                                  torch.device("cpu"))
    return images, dict(swap.calls)


def fmt(split: dict) -> str:
    return (f"silhouette {split['silhouette']:.4%} of pixels "
            f"({split['silhouette_of_covered']:.3%} of covered); colours on covered-in-both: "
            f">1 level {split['colour_gt1']:.2%}, >4 levels {split['colour_gt4']:.2%}, "
            f"median {split['colour_median']:g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("tpu_frames_recipe")
    ap.add_argument("--frames", type=int, nargs="+", default=[0, 10, 21, 31])
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="auto", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    cli = ap.parse_args(argv)
    if cli.worker:
        print(json.dumps(worker(cli.worker, cli.backend, cli.frames, cli.out)), flush=True)
        return 0

    with np.load(TPU_FRAMES) as z:
        tpu = z["images"][cli.frames]
    print(f"file {os.path.relpath(TPU_FRAMES, HERE)}: frames {cli.frames} of 32 at {RES}^2; "
          f"covered {covered(tpu).mean():.3%} of pixels (some channel > {COVER_LEVELS} "
          f"level from the background {BACKGROUND_LEVEL}); reproduces: silhouette <= "
          f"{SIL_SHARE:.1%}, > 4 levels <= {COLOUR_SHARE_4:.0%}, median <= {MEDIAN_LEVELS:g}",
          flush=True)
    rows = []

    def report(name: str, images, extra: str = "") -> None:
        if images is None:
            print(f"{name}: {extra}", flush=True)
            return
        split = frame_split(images, tpu)
        rows.append((name, split))
        print(f"{name}: {fmt(split)}; {'REPRODUCES' if reproduces(split) else 'differs'}"
              f"{'; ' + extra if extra else ''}", flush=True)
        print(json.dumps({"render": name, **{k: round(v, 6) for k, v in split.items()},
                          "reproduces": reproduces(split)}), flush=True)

    with tempfile.TemporaryDirectory(prefix="hocon-frames-recipe-") as tmp:
        today = {}
        for backend, name in (("pallas", "hocon, pallas interpret"), ("xla", "hocon, xla")):
            rec, images = run_tree(HERE, backend, cli.frames, tmp)
            today[backend] = images
            report(name, images, _describe(rec))
        images, _ = port_render(cli.frames)
        report("port, plain", images)
        for variant in ROUNDINGS:
            images, calls = port_render(cli.frames, variant)
            report(f"port, plain, TPU rounding ({variant})", images, f"rounded calls {calls}")
        if today["xla"] is not None and today["pallas"] is not None:
            split = frame_split(today["pallas"], today["xla"])
            print(f"(hocon pallas interpret against hocon xla: {fmt(split)})", flush=True)
        for commit in recipe_commits():
            tree = os.path.join(tmp, commit)
            os.makedirs(tree)
            archive = subprocess.run(["git", "archive", commit, "hocon"], cwd=HERE,
                                     capture_output=True, check=True).stdout
            subprocess.run(["tar", "-x", "-C", tree], input=archive, check=True)
            rec, images = run_tree(tree, "xla", cli.frames, tmp)
            subject = subprocess.run(["git", "log", "-1", "--format=%ad %s", "--date=short",
                                      commit], cwd=HERE, capture_output=True,
                                     text=True).stdout.strip()
            report(f"{commit} ({subject[:60]}), xla", images, _describe(rec))
    every = list(range(32))
    with np.load(TPU_FRAMES) as z:
        split = frame_split(port_render(every)[0], z["images"])
    print(f"port, plain, all 32 frames (chip_smoke.py's data phase gates this silhouette "
          f"share): {fmt(split)}", flush=True)
    first = next((name for name, split in rows if reproduces(split)), None)
    print(f"verdict: {'the first render that reproduces the file: ' + first if first else 'no render reproduces the file'}",
          flush=True)
    return 0


def _describe(rec: dict) -> str:
    if "error" in rec:
        return f"not rendered: {rec['error']}"
    keys = rec.get("key_configs")
    key = (f"cache key matches {keys}" if keys else
           f"no configuration's key matches ({rec.get('key_error', 'tried ' + str(len(KEY_GRID)))})")
    return (f"{key}; verts taken {rec.get('verts_taken')}; render {rec.get('seconds')} s")


if __name__ == "__main__":
    sys.exit(main())
