"""Protocol-scale end-to-end training.

Counterpart of ``scripts/protocol_run.py``: 10,000 iterations at 504x378
(LLFF /8), capacity 131,072, the random-weight DPT-Hybrid in the pseudo
window 2,000-5,500, SH warm-up to 3, the densify window with proximity and
opacity resets, segment-feature losses over a real segment structure,
driven by the port's ``Trainer`` on a synthetic scene whose ground truth is
rendered from a hidden 61,440-Gaussian set (so PSNR measures convergence).
It is ``ablation_run``'s ``full`` arm with one test view, tests at 1,000,
2,000, 3,000, 5,000 and 10,000 and a checkpoint at 5,000; the scene and the
depth net come from ``ablation_run.build_scene`` and ``random_dpt``.

Run (``SDPGS_PROTOCOL_OUT`` for the output directory, a temporary one by
default):

    python -m sdpgs_torch.cli.protocol_run

Outputs: ``<out>/{training_history,eval_results,protocol_summary}.json``
and ``<out>/checkpoints/ckpt_5000.pt``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

from sdpgs_torch import default_device
from sdpgs_torch.cli import ablation_run

OUT = Path(os.environ.get("SDPGS_PROTOCOL_OUT", Path(tempfile.gettempdir()) / "protocol_run"))
TEST_ITERATIONS = (1000, 2000, 3000, 5000, 10000)
CHECKPOINT_ITERATIONS = (5000,)


def main(out=None, iterations: int = ablation_run.ITERATIONS, device=None) -> dict:
    from sdpgs_torch.train.loop import Trainer

    dev = default_device(device)
    out = Path(out if out is not None else OUT)
    t0 = time.time()
    print("building protocol-scale synthetic scene...", flush=True)
    scene, raster = ablation_run.build_scene(n_test=1, device=dev)
    out.mkdir(parents=True, exist_ok=True)
    scene.model_path = str(out)
    print(f"scene built in {time.time() - t0:.1f}s", flush=True)

    cfg = ablation_run.build_cfg(raster, iterations)
    cfg.optim.test_iterations = tuple(i for i in TEST_ITERATIONS if i <= iterations)
    cfg.optim.checkpoint_iterations = CHECKPOINT_ITERATIONS
    trainer = Trainer(cfg, scene=scene, mono_depth_fn=ablation_run.random_dpt(dev), device=dev)

    t1 = time.time()
    hist = trainer.train(iterations=iterations, log_every=100)
    wall = time.time() - t1
    res = {
        "iterations": iterations,
        "wall_s": round(wall, 1),
        "iters_per_s": round(iterations / wall, 2),
        "final": hist[-1] if hist else None,
        "eval": trainer.eval_history,
    }
    (out / "protocol_summary.json").write_text(json.dumps(res, indent=2))
    print(json.dumps(res["final"]))
    print(f"PROTOCOL RUN DONE: {iterations} iters in {wall:.1f}s "
          f"({iterations / wall:.2f} it/s incl. events/eval)", flush=True)
    return res


if __name__ == "__main__":
    main()
