#!/usr/bin/env python3
"""Compare the raster kernels' outputs of two checkouts, bit for bit.

    python3 tools/raster_bits.py OTHER_CHECKOUT [--out DIR]   # one CUDA card

Runs K1 (``raster_fwd``: the four padded outputs) and K2 (``raster_bwd``:
dcoeffs, with seeded noise cotangents on covered pixels, as the K2 phase of
``chip_smoke.py`` makes them) at both gammas of ``chip_smoke.GAMMAS``, once
with this checkout's ``hocon_torch`` and once with OTHER_CHECKOUT's, each in
its own process that builds its own kernels. Both run on the same inputs:
the main path's scene (16 views at 256^2) made once by this checkout's
``chip_smoke.make_scene`` and ``raster_inputs``. Prints, per output,
whether the bits are identical, else how many elements differ and the
largest difference.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dump(root: str, inputs: str, out: str) -> None:
    """In a child process: run ``root``'s kernels on ``inputs``, save them."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as CS
    import hocon_torch
    from hocon_torch.render import raster_cuda as RC

    if os.path.dirname(os.path.abspath(hocon_torch.__file__)) != os.path.join(root, "hocon_torch"):
        raise RuntimeError(f"hocon_torch imported from {hocon_torch.__file__}, not from {root}")
    if os.path.exists(inputs):
        coeffs, bounds, krange = torch.load(inputs)
    else:
        coeffs, bounds, krange = CS.raster_inputs(torch, *CS.make_scene(torch, "cuda"), CS.RES)
        torch.save((coeffs, bounds, krange), inputs)
    size, cfg, result = (CS.RES, CS.RES), RC.default_config(), {}
    for gamma in CS.GAMMAS:
        tag = f"gamma=1/{1 / gamma:.0f}"
        fwd = RC.raster_fwd(coeffs, bounds, krange, size, CS.SIGMA, gamma, cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        sup = (fwd[0] > 1e-3).float()
        cot = (torch.randn(fwd[0].shape, generator=gen, device="cuda") * sup,
               torch.randn(fwd[1].shape, generator=gen, device="cuda") * sup[:, None],
               torch.randn(fwd[0].shape, generator=gen, device="cuda") * sup)
        dcoeffs = RC.raster_bwd(coeffs, bounds, krange, *fwd, *cot, size, CS.SIGMA, gamma, cfg)
        for name, t in zip(("sil", "attr", "vis", "mden"), fwd):
            result[f"K1 {tag} {name}"] = t.cpu()
        result[f"K2 {tag} dcoeffs"] = dcoeffs.cpu()
    torch.save(result, out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "hocon_torch", "bits"),
                    help="directory for the inputs and both checkouts' outputs")
    ap.add_argument("--dump", nargs=3, metavar=("ROOT", "INPUTS", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        dump(*args.dump)
        return
    if args.other is None:
        ap.error("the root of the other checkout is required")
    import torch

    if not torch.cuda.is_available():
        sys.exit("raster_bits: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    inputs = os.path.join(args.out, "inputs.pt")
    if os.path.exists(inputs):
        os.remove(inputs)
    outs = {}
    for side, root in (("this", HERE), ("other", os.path.abspath(args.other))):
        outs[side] = os.path.join(args.out, f"{side}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--dump", root, inputs,
                        outs[side]], check=True)
    this, other = torch.load(outs["this"]), torch.load(outs["other"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"raster_bits: {HERE} against {os.path.abspath(args.other)}; card {smi}")
    for key, a in this.items():
        b = other[key]
        differ = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        if differ == 0:
            print(f"{key}: identical bits ({a.numel()} elements)")
        else:
            gap = float((a.double() - b.double()).abs().max())
            print(f"{key}: {differ} of {a.numel()} elements differ, max abs difference {gap:.6g}")


if __name__ == "__main__":
    main()
