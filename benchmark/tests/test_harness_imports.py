"""What a run loads: never JAX or the JAX package; and the plain reference
loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "sdpgs_tpu"}
RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from pathlib import Path
import torch
torch.set_num_threads(2)
from benchmark import spec
from benchmark.run import run_cell, forbidden_modules
cell = spec.load_cell({cell!r}, root=Path({bench!r}))
run_cell(cell, 5, 0.5, False, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(small_bench):
    """Whole top-level names after a run of a train cell and a render cell
    (the port's name begins with the JAX package's and is no match)."""
    for cell in ("m360-train-plain", "llff-render"):
        mods = top_level_modules(RUN.format(root=str(ROOT), cell=cell, bench=str(small_bench)))
        assert "sdpgs_torch" in mods and not (mods & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "import benchmark.reference.raster, benchmark.reference.losses, "
              "benchmark.reference.dpt, benchmark.reference.step, "
              "benchmark.reference.precision, benchmark.reference.camera, "
              "benchmark.reference.densify, benchmark.check, "
              "benchmark.scene, benchmark.poses, benchmark.work, benchmark.control\n"
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    mods = top_level_modules(code)
    assert not (mods & (FORBIDDEN | {"sdpgs_torch"}))
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"sdpgs_torch"}, (path, n)
