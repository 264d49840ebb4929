"""Build the port's CUDA kernels from ``hocon_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). Libraries land in ``build/hocon_torch/`` beside the
package, named by a hash of the source, the shared headers and the flags
(a source's own link flags included), so an edited source or header
rebuilds and an unchanged one is reused. ``csrc/jpeg.cu`` is the one source
that is not a kernel: the nvJPEG decoder, linked with ``-lnvjpeg``.
``build()`` starts one ``nvcc`` per missing library, all at once, and waits
for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hocon_torch"
KERNELS = ("raster_fwd", "raster_bwd", "sample_fwd", "sample_bwd")
SOURCES = KERNELS + ("jpeg",)
# Libraries a source links beyond the CUDA runtime; the toolkit's library
# directory goes into the library's run path, so ctypes finds them there.
LINK_FLAGS = {"jpeg": ("-lnvjpeg",)}
# No fast-math: approximate exp / reciprocal break the silhouette parity,
# whose error compounds through the product over faces. -Xptxas -v writes
# each kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: hocon_torch builds its CUDA kernels from source at "
        "first use and needs the CUDA toolkit"
    )


def lib_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (and the shared
    ``csrc/*.cuh`` headers) lives."""
    digest = hashlib.sha1((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output from the build of ``name`` ('' if reused)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _link_flags(name: str, nvcc: str) -> list:
    flags = list(LINK_FLAGS.get(name, ()))
    if flags:
        libdir = Path(nvcc).resolve().parent.parent / "lib64"
        flags += ["-Xlinker", f"-rpath,{libdir}"]
    return flags


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library in parallel; seconds per compiled one."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = out.with_suffix(".log")
        nvcc = _nvcc()
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu"),
               *_link_flags(name, nvcc)]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log, time.perf_counter()))
    seconds, failed = {}, []
    for name, proc, tmp, out, log, t0 in jobs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log.read_text()[-4000:]}")
            continue
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if it is missing."""
    build((name,))
    return ctypes.CDLL(str(lib_path(name)))
