"""The work counts behind the roofline and mfu metrics, against hand
counts at small shapes."""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from benchmark import spec, work
from benchmark.measure import Run
from benchmark.reference import dpt as ref_dpt
from benchmark.reference.camera import Cam, View
from benchmark.reference.raster import Raster
from benchmark.tracing import Trace, summarize


def test_view_bytes_by_hand():
    w = work.ViewWork(pixels=12, tiles=2, npix=4, capacity=3, visible=2, K=4, entries=3,
                      rows_read=2)
    assert w.k1(0) == (11 + 3 + 11) * 4 * 3
    assert w.k2() == (2 * 2 + 1 + 2 * 4 + 2) * 4
    assert w.k3() == 2 * 13 * 4 + 3 * 4 + (2 + 2 * 4 * 8) * 4
    assert w.k4(0) == (33 + 6) * 4 * 3
    assert w.k5() == 2 * 13 * 4 + 3 * 4 + 4 * 13 * 4 + 2 * 4 * 10 * 4
    assert work.adam_bytes(10) == 7 * 4 * 62 * 10
    assert work.loss_bytes(100, pseudo=False) == 22 * 4 * 100


def test_entries_by_hand():
    """A 32x32 view with 16-pixel tiles and a 90 degree field of view: a
    tiny Gaussian on the axis at depth 4 (pixel 15.5, radius 3) covers
    all four tiles; one at (-2, -2, 4) (pixel 7.5) covers tile 0 alone; a
    dead one none."""
    geo = {"xyz": torch.tensor([[0.0, 0.0, 4.0], [-2.0, -2.0, 4.0], [1.0, 1.0, 4.0]]),
           "scaling": torch.full((3, 3), math.log(1e-4)),
           "rotation": torch.tensor([[1.0, 0, 0, 0]] * 3),
           "alive": torch.tensor([1.0, 1.0, 0.0])}
    cam = Cam.of(View(R=np.eye(3), T=np.zeros(3), fovx=math.pi / 2, fovy=math.pi / 2,
                      width=32, height=32), "cpu")
    w = work.view_work(geo, cam, Raster(tile=16, max_per_tile=32, max_tiles_per_gaussian=8,
                                        chunk=32), 0)
    assert (w.entries, w.rows_read, w.visible, w.tiles, w.npix, w.capacity) == (5, 2, 2, 4,
                                                                                256, 3)


def test_depth_net_operations_by_hand(monkeypatch):
    """The tiny hybrid's forward by hand: every convolution and linear
    layer from its output's shape, the attention's two products per layer
    and the separable resizes; the input gradient repeats each product
    once, the attention's twice (both operands follow the image), and the
    position embeddings' resize not at all (no gradient reaches them)."""
    from conftest import TINY_DPT

    cfg = json.loads(json.dumps(spec.load_cell("llff-train-pseudo").config))
    cfg["depth_net"]["arch"] = TINY_DPT
    cfg["image"].update(width=64, height=48)
    arch = TINY_DPT

    counted = {"layers": 0.0, "resize": 0.0, "attention": 0.0, "positions": 0.0}
    real = ref_dpt.resize2d

    def resize(x, out_h, out_w, method="bicubic", align_corners=False):
        H, W = x.shape[-2:]
        n = x.numel() // (H * W)
        grid = x.dim() == 4 and x.shape[1] == arch["hidden_size"] and (H, W) == (24, 24)
        counted["positions" if grid else "resize"] += 2 * n * (out_h * H * W + out_h * W * out_w)
        return real(x, out_h, out_w, method, align_corners)

    def hook(mod, inp, out):
        k = mod.weight.shape
        if isinstance(mod, torch.nn.Linear):
            counted["layers"] += 2 * out.numel() * k[1]
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            counted["layers"] += 2 * inp[0].numel() * k[1] * k[2] * k[3]
        else:   # Conv2d and the weight-standardised WSConv2d
            counted["layers"] += 2 * out.numel() * k[1] * k[2] * k[3]

    monkeypatch.setattr(ref_dpt, "resize2d", resize)
    net = ref_dpt.DPT(ref_dpt.DPTArch(**{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in arch.items() if k != "bit"},
                                      bit=ref_dpt.BitArch(**{k: tuple(v) if isinstance(v, list)
                                                             else v for k, v in
                                                             arch["bit"].items()})))
    for m in net.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                          ref_dpt.WSConv2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        ref_dpt.MonoDepth(net)(torch.rand(3, 48, 64))
    N = (384 // 16) * (512 // 16) + 1
    counted["attention"] = arch["num_layers"] * 4 * N * N * arch["hidden_size"]
    monkeypatch.setattr(ref_dpt, "resize2d", real)
    by_hand = (2 * (counted["layers"] + counted["resize"]) + 3 * counted["attention"]
               + counted["positions"])
    assert work.depth_net_flops(cfg) == by_hand


def test_shares_by_hand():
    """The roofline and mfu readers' arithmetic on a made-up trace."""
    tr = summarize([("void (anonymous namespace)::composite_bwd_kernel(float const*)", 0, 40),
                    ("aten::add_kernel", 50, 60)], [("bench.train_step", 0, 100)])
    assert abs(tr.kernel_s("K5") - 40e-6) < 1e-15 and tr.device_ops == 2
    assert abs(tr.busy_s - 50e-6) < 1e-12 and abs(tr.window_s - 100e-6) < 1e-12
    run = Run(kind="train", window_s=2.0, units=100, unit_s=0.02, pseudo_units=100, trace=tr,
              traced_units=1,
              work={"bytes_per_unit": 3.35e6, "flops_per_unit": 9.89e8,
                    "k5_bytes_per_unit": 6.7e7})
    # 20 us of K5's bytes over its 40 us
    assert abs(spec.reader("k5_roofline_pct")(run) - 50.0) < 1e-9
    # 1 us of bytes and 1 us of operations over 20 ms an iteration
    assert abs(spec.reader("train_mfu")(run) - 100.0 * 2e-6 / 0.02) < 1e-12
    # 50 us busy an iteration of the 20 ms an unprofiled iteration takes
    assert abs(spec.reader("device_idle_pct.train")(run) - 100.0 * (1 - 50e-6 / 0.02)) < 1e-9
    assert spec.reader("launches_per_iter")(run) == 2
    assert spec.reader("launches_per_view")(run) is None
    assert spec.reader("depth_net_ms")(run) is None
    assert spec.reader("train_it_per_s")(Run(kind="train", window_s=4.0, units=100)) == 25.0
    view = Run(kind="render", window_s=3.0, units=300, traced_units=2,
               trace=summarize([("composite_fwd_kernel", 0, 40), ("aten::add_kernel", 30, 60),
                                ("Memcpy DtoH (Device -> Pageable)", 60, 160),
                                ("composite_fwd_kernel", 200, 220)], []))
    # 80 us busy over the two views of the profiled pass, the copy left out
    assert abs(spec.reader("render_device_ms_per_view")(view) - 0.04) < 1e-12
    assert abs(view.trace.busy_s - 180e-6) < 1e-12
    assert spec.reader("render_views_per_s.host")(view) == 100.0
    assert spec.reader("render_device_ms_per_view")(run) is None
    assert Trace().device_ops == 0
    chunk = Run(kind="train", window_s=2.0, units=100, pseudo_units=0, traced_units=2,
                work={"bytes_per_unit": 3.35e6, "flops_per_unit": 0.0,
                      "k5_bytes_per_unit": 6.7e7},
                trace=summarize([("composite_fwd_kernel", 0, 40),
                                 ("Memcpy HtoD (Pageable -> Device)", 40, 90),
                                 ("fused_adam_kernel", 100, 140),
                                 ("Memcpy DtoH (Device -> Pageable)", 150, 170)], []))
    # 80 us busy over the two iterations of the profiled chunk, both copies left out
    assert abs(spec.reader("train_device_ms_per_iter")(chunk) - 0.04) < 1e-12
    assert spec.reader("train_device_ms_per_iter")(view) is None
    # 1 us of bytes over the card's 40 us an iteration
    assert abs(spec.reader("train_mfu.device")(chunk) - 100.0 * 1e-6 / 40e-6) < 1e-9
    assert spec.reader("train_it_per_s.host")(chunk) == 50.0
    assert spec.reader("launches_per_iter.device")(chunk) == 2
    assert abs(spec.reader("adam_ms_per_iter.device")(chunk) - 0.02) < 1e-12
    assert spec.reader("k5_roofline_pct.device")(chunk) is None
    assert spec.reader("k5_roofline_pct.device")(run) == spec.reader("k5_roofline_pct")(run)
