"""The rendering generator: one client in a closed loop over the render
CLI's spiral path (``frames`` poses, cycled), each view rendered by the
program's ``render`` of the configuration's cloud, its float image
brought to the host and turned into the 8-bit RGB frame by the program's
viewer (``GuiServer.send``, its connection a sink that keeps the frame),
as the viewer and the render CLI take it.

Set-up builds the cloud and the path from the seed and serves the whole
path once. The window serves views until ``seconds`` have passed; each
view's latency runs from its request to its bytes on the host. Every run
then profiles one more pass over the path, which gives the card's busy
time a view (``render_device_ms_per_view``) and, in a traced run, the
per-layer readings.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, program, scene as scene_lib, work
from benchmark.measure import Run
from benchmark.reference.camera import Cam
from benchmark.reference.precision import context
from benchmark.reference.raster import FIELDS, render as ref_render, to_rgb8
from benchmark.tracing import profiled

SAMPLED_VIEWS = 4    # path poses binned for the work counts


class Sink:
    """The viewer's connection: keeps the first buffer sent, the frame."""

    frame = None

    def sendall(self, data):
        if self.frame is None:
            self.frame = data


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float):
    """One run of a render cell; returns (Run, readings, peak bytes,
    attempted, failed)."""
    from sdpgs_torch.render import render
    from sdpgs_torch.viewer.network_gui import GuiServer

    cfg, tr = cell.config, cell.traffic
    sh = cfg["cloud"]["sh_degree"]
    out = Run(kind="render")
    t = out.lap("start", t_start)
    sc = scene_lib.build(cfg, seed, dev, with_pseudo=False)
    t = out.lap("scene", t)
    views = scene_lib.spiral_views(sc, int(tr["frames"]))
    g = program.gaussians(sc.hidden, sh)
    cams = [program.camera(v) for v in views]
    rcfg = program.raster_config(cfg)
    bg = torch.zeros(3, device=dev)

    H, W = views[0].height, views[0].width

    @torch.no_grad()
    def serve(i):
        viewer = SimpleNamespace(conn=Sink())
        GuiServer.send(viewer, render(cams[i], g, rcfg, bg, sh, device=dev).color.cpu().numpy(),
                       "")
        return viewer.conn.frame

    for i in range(len(cams)):
        serve(i)
    program.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = out.lap("warm_up", t)
    out.setup_s = time.perf_counter() - t_start
    served, failed = {}, 0
    t_open = time.perf_counter()
    n = 0
    while True:
        i = n % len(cams)
        t = time.perf_counter()
        img = serve(i)
        done = time.perf_counter()
        out.latencies_ms.append((done - t) * 1e3)
        if i not in served:
            served[i] = torch.frombuffer(bytearray(img), dtype=torch.uint8).reshape(H, W, 3)
        n += 1
        if done - t_open >= seconds:
            break
    out.window_s = time.perf_counter() - t_open
    out.units = n
    out.unit_s = out.window_s / n
    t = out.lap("window", t_open)
    out.trace = profiled(lambda: [serve(i) for i in range(len(cams))])
    out.traced_units = len(cams)
    t = out.lap("profiled", t)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    hidden = {k: sc.hidden[k] for k in FIELDS}
    del g
    gc.collect()
    if trace:
        raster = scene_lib.raster_of(cfg)
        rng = np.random.default_rng(seed)
        picks = rng.choice(len(views), SAMPLED_VIEWS, replace=False)
        ws = [work.view_work(sc.hidden, Cam.of(views[int(i)], dev), raster, sh) for i in picks]
        pixels = ws[0].pixels
        # K1-K3, then the float image read for its copy to the host
        out.work = {"bytes_per_unit": float(np.mean([w.forward(sh) for w in ws])
                                            + pixels * 3 * 4),
                    "k3_bytes_per_unit": float(np.mean([w.k3() for w in ws]))}
    rng = np.random.default_rng(seed)
    sample = sorted(rng.choice(sorted(served), min(int(tr["checked_views"]), len(served)),
                               replace=False))
    ref = []
    with torch.no_grad(), context(False):
        raster = scene_lib.raster_of(cfg)
        for i in sample:
            ref.append(to_rgb8(ref_render(hidden, sc.hidden["alive"], Cam.of(views[int(i)], dev),
                                          raster, bg, sh).color).cpu())
    readings = check.render_readings([served[int(i)] for i in sample], ref)
    out.lap("reference", t)
    return out, readings, peak, n, failed
