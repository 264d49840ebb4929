"""Model families: each architecture the benchmark runs, found by name.

A configuration names its family in ``cfg["model"]["family"]``; without
the key it is ``hocnet``. A family is two files of its own name:
``benchmark/reference/families/<family>.py`` (the plain reference: the
model, its seeded weights and its FLOP count) and
``benchmark/harness/families/<family>.py`` (the port's model), so that a
new architecture joins the benchmark as new files only. ``run.py``'s
docstring states what each provides.
"""

from __future__ import annotations

import importlib

DEFAULT = "hocnet"
DIRS = ("benchmark/reference/families", "benchmark/harness/families")


def name(cfg: dict) -> str:
    return cfg["model"].get("family", DEFAULT)


def load(cfg: dict, package: str = __name__):
    """The module of ``cfg``'s family in ``package`` (this one, or
    ``harness.families``); a ``ValueError`` for a family that has none."""
    family = name(cfg)
    if family.isidentifier():
        module = f"{package}.{family}"
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    raise ValueError(f"unknown model family {family!r}: a family is {DIRS[0]}/{family}.py "
                     f"and {DIRS[1]}/{family}.py")
