#!/usr/bin/env python3
"""Where K1's time goes: each warp's start, end and live faces, on one card.

    python3 tools/k1_warp_times.py   # one CUDA card

Builds a copy of ``hocon_torch/csrc/raster_fwd.cu`` into which every warp
writes the ``%globaltimer`` (ns) at its start and end, its SM and the live
faces it evaluated, runs it through ``raster_cuda.raster_fwd_cuda`` on
``chip_smoke.py``'s scene (16 views at 256^2, gamma 1/40) with its skip
and with ``far_logit=inf``, and prints the kernel's CUDA-event time, the
span of the warps, quantiles of their end times and the longest warps.
The copy is made by inserting lines at fixed places of the source; the
tool fails if one of them is gone.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_WARPS = 1 << 16
# Where the records go in, as (line of raster_fwd.cu, what follows it).
PROBES = (
    ("namespace {\n", f"__device__ unsigned long long g_warps[{MAX_WARPS}][4];\n"),
    ("  const int b = blockIdx.z;\n",
     "  unsigned long long t_start;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));\n'
     "  int n_live = 0;\n"),
    ("      live = __ballot_sync(kAllLanes, !far);\n", "      n_live += __popc(live);\n"),
    ("  const size_t plane = static_cast<size_t>(hp) * wp;\n",
     "  {\n    unsigned long long t_end;\n    unsigned sm;\n"
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_end));\n'
     '    asm("mov.u32 %0, %%smid;" : "=r"(sm));\n'
     "    const int w = ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * kWarps"
     " + threadIdx.y;\n"
     f"    if (lane == 0 && w < {MAX_WARPS}) {{\n"
     "      g_warps[w][0] = t_start;\n      g_warps[w][1] = t_end;\n"
     "      g_warps[w][2] = sm;\n      g_warps[w][3] = n_live;\n    }\n  }\n"),
)
COPY_OUT = ('\nextern "C" int hocon_warp_times(void* dst, size_t bytes) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_warps, bytes));\n}\n")


def build(out_dir: str) -> ctypes.CDLL:
    from hocon_torch.utils import cuda_build

    src = (cuda_build.SRC_DIR / "raster_fwd.cu").read_text()
    for anchor, probe in PROBES:
        if anchor not in src:
            raise RuntimeError(f"k1_warp_times: raster_fwd.cu no longer has {anchor.strip()!r}")
        src = src.replace(anchor, anchor + probe, 1)
    path = os.path.join(out_dir, "raster_fwd_timed.cu")
    with open(path, "w") as fh:
        fh.write(src + COPY_OUT)
    lib_path = os.path.join(out_dir, "raster_fwd_timed.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{cuda_build.SRC_DIR}",
                    "-o", lib_path, path], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hocon_raster_fwd.argtypes = [p] * 7 + [i] * 8 + [f] * 5 + [i, p]
    lib.hocon_raster_fwd.restype = i
    lib.hocon_warp_times.argtypes = [p, ctypes.c_size_t]
    lib.hocon_warp_times.restype = i
    return lib


def main() -> None:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as CS
    from hocon_torch.render import raster_cuda as RC

    if not torch.cuda.is_available():
        sys.exit("k1_warp_times: no CUDA device")
    smi = CS.phase_device(torch)
    out_dir = os.path.join(HERE, "build", "hocon_torch", "k1_warp_times")
    os.makedirs(out_dir, exist_ok=True)
    lib = build(out_dir)
    RC._kernel_lib = lambda: lib
    coeffs, bounds, krange = CS.raster_inputs(torch, *CS.make_scene(torch, "cuda"), CS.RES)
    cfg, gamma = RC.default_config(), CS.GAMMAS[0]
    for far_logit in (None, math.inf):
        def run():
            return RC.raster_fwd_cuda(coeffs, bounds, krange, (CS.RES, CS.RES), CS.SIGMA, gamma,
                                      cfg, far_logit=far_logit)

        ms = CS.cuda_ms(torch, run, 20)
        run()
        torch.cuda.synchronize()
        rec = np.zeros((MAX_WARPS, 4), np.uint64)
        if lib.hocon_warp_times(rec.ctypes.data, rec.nbytes) != 0:
            sys.exit("k1_warp_times: copying the records failed")
        hp, wp = RC.padded_size((CS.RES, CS.RES))
        n = coeffs.shape[0] * (hp // 8) * (wp // 8)  # one warp per 8 x 8 tile
        rec = rec[:n].astype(np.int64)
        start, end, sm, live = (rec[:, j] for j in range(4))
        t0 = start.min()
        dur = end - start
        ends = [float(np.quantile(end - t0, q)) / 1e3 for q in (0.5, 0.9, 0.99, 1.0)]
        print(f"far_logit={far_logit}: kernel {ms:.4f} ms (CUDA events); {n} warps span "
              f"{(end.max() - t0) / 1e3:.1f} us; warps end by (50/90/99/100 %) "
              + " / ".join(f"{e:.1f}" for e in ends) + " us; live faces per warp mean "
              f"{live.mean():.1f}, max {live.max()}; corr(duration, live faces) "
              f"{np.corrcoef(dur, live)[0, 1]:.3f}; card {smi}")
        for w in np.argsort(-dur)[:5]:
            print(f"  warp {w}: {dur[w] / 1e3:.1f} us from {(start[w] - t0) / 1e3:.1f} us, "
                  f"{live[w]} live faces ({dur[w] / max(live[w], 1):.0f} ns each), SM {sm[w]}")
        heavy = live > 200
        print(f"  {int(heavy.sum())} warps with more than 200 live faces: median "
              f"{np.median(dur[heavy] / live[heavy]):.0f} ns per face")


if __name__ == "__main__":
    main()
