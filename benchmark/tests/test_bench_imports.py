"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names (``hocon_torch`` begins with ``hocon``), and the reference
loads nothing of the port."""

import os
import subprocess
import sys
import textwrap

import run

BENCH = os.path.dirname(os.path.abspath(run.__file__))


def _modules_after(code: str) -> set:
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {BENCH!r})
        {code}
        print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, check=True, cwd=run.ROOT)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    code = textwrap.dedent("""
        import torch
        import run
        sys.path.insert(0, {bench!r} + "/tests")
        from conftest import shrink
        orig = run.load_cell
        run.load_cell = lambda n: (shrink(orig(n)[0]), orig(n)[1])
        torch.set_num_threads(1)
        run.run("hocnet_r18_128_box.warp", 7, 0.2, True, "cpu")
        for name in ("step.launches", "step.syncs", "step.mfu", "model.conv_ms",
                     "kernels.raster_roofline", "kernels.sample_roofline",
                     "device.busy_ms", "device.idle_share", "model.host_ms",
                     "render.host_ms", "render.device_ms", "optim.host_ms"):
            run.load_metric(name)
    """).format(bench=BENCH).replace("\n", "\n        ")
    loaded = _modules_after(code)
    assert "hocon_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    loaded = _modules_after("import reference.step, reference.render, reference.model, "
                            "reference.families.hocnet")
    assert not loaded & {"hocon_torch", *run.FORBIDDEN}
    scanned = []
    for folder, _, names in os.walk(os.path.join(BENCH, "reference")):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                scanned.append(os.path.relpath(path, BENCH))
                src = open(path).read()
                assert "hocon_torch" not in src.replace("``hocon_torch``", ""), path
    assert os.path.join("reference", "families", "hocnet.py") in scanned
