"""Reproducibility helpers.

Port of ``hocon/exp/args.py``: ``save_args`` dumps the full flag dict to
the run directory at experiment start, ``opt.txt`` for people (the command
line, then one ``key: value`` line per flag) and ``opt.json`` for programs,
byte for byte as the reference writes them.
"""

from __future__ import annotations

import json
import os
import sys


def save_args(args, run_dir: str, prefix: str = "opt") -> None:
    os.makedirs(run_dir, exist_ok=True)
    d = vars(args) if hasattr(args, "__dict__") else dict(args)
    with open(os.path.join(run_dir, f"{prefix}.txt"), "w") as f:
        f.write(" ".join(sys.argv) + "\n\n")
        for k in sorted(d):
            f.write(f"{k}: {d[k]}\n")
    with open(os.path.join(run_dir, f"{prefix}.json"), "w") as f:
        # Native JSON types round-trip as themselves; repr() only for values
        # json cannot encode.
        json.dump(d, f, indent=1, default=repr)
