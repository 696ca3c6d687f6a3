"""The entry cull K3 and K5 share (csrc/composite_math.cuh:entry_box) on
the CPU.

K3 and K5 skip an entry for a warp's pixel patch where the entry's pixel
box misses the patch; the box must hold every pixel at which their shared
per-pixel test (csrc/composite_math.cuh:entry_alpha) passes. Here both are
mirrored in numpy: entry_alpha in float32, step by step in its rounding
order (fma emulated through float64), and entry_box in float64 as the
kernel computes it. Random Gaussians from round to 100:1 elongated, over
opacities down to below alpha_min, put every passing pixel inside the box,
and the box is no wider than the exact ellipse's by more than its stated
margins (relative 1e-4 plus 4 kRel times the conic's condition number).
Where no bound is proven (NaN, huge or indefinite conics) the box is the
whole plane; where the opacity is not positive it is empty."""

import re
from pathlib import Path

import numpy as np
import pytest

from sdpgs_torch.config import RasterizeConfig

CFG = RasterizeConfig()
ALPHA_MIN, ALPHA_MAX = np.float32(CFG.alpha_min), np.float32(CFG.alpha_max)
# entry_box's constants (composite_math.cuh; test_constants_match_the_kernel)
MAX_COORD, MAX_CONIC = 2.0 ** 20, 2.0 ** 40
REL, SLACK, MIN_DET, MIN_ALPHA = 1e-5, 1e-5, 1e-9, 1e-20
KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "sdpgs_torch" / "csrc" / "composite_math.cuh"
GRID = 96   # pixel centres 0..95 in x and y
f32 = np.float32


def fma32(a, b, c):
    """fmaf: a * b is exact in float64 for float32 operands."""
    return (a.astype(np.float64) * b + c).astype(f32)


def entry_alpha_passes(mx, my, a, b, c, op, px, py):
    """composite_math.cuh:entry_alpha's decision, in its float32 steps."""
    dx = (mx - px).astype(f32)
    dy = (my - py).astype(f32)
    q = fma32((a * dx).astype(f32), dx, ((c * dy).astype(f32) * dy).astype(f32))
    power = fma32(np.full_like(q, -0.5), q, -((b * dx).astype(f32) * dy).astype(f32))
    with np.errstate(over="ignore", invalid="ignore"):
        ex = np.exp(power).astype(f32)
        alpha_raw = (op * ex).astype(f32)
    alpha = np.fmin(ALPHA_MAX, alpha_raw)
    return ~(power > 0) & ~(alpha < ALPHA_MIN)


def entry_box(mx, my, a, b, c, op):
    """composite_math.cuh:entry_box for one entry: (x0, x1, y0, y1)."""
    everywhere = (-np.inf, np.inf, -np.inf, np.inf)
    vals = (abs(mx), abs(my), abs(a), abs(b), abs(c), abs(op))
    limits = (MAX_COORD, MAX_COORD, MAX_CONIC, MAX_CONIC, MAX_CONIC, MAX_COORD)
    if not all(v <= lim for v, lim in zip(vals, limits)):
        return everywhere
    if op <= 0:
        return (np.inf, -np.inf, np.inf, -np.inf)
    a, b, c = float(a), float(b), float(c)
    ap = a - REL * (abs(a) + abs(b))
    cp = c - REL * (abs(c) + abs(b))
    det = ap * cp - b * b
    if not (ap > 0 and cp > 0 and det > MIN_DET * ap * cp):
        return everywhere
    tau = max(np.log(float(op) / float(ALPHA_MIN)), 0.0) + SLACK
    r = 2.0 * tau + SLACK
    hx = np.sqrt(r * cp / det) * (1 + 1e-6) + 1e-6
    hy = np.sqrt(r * ap / det) * (1 + 1e-6) + 1e-6
    # float32, rounded outward
    return (np.nextafter(f32(mx - hx), f32(-np.inf)), np.nextafter(f32(mx + hx), f32(np.inf)),
            np.nextafter(f32(my - hy), f32(-np.inf)), np.nextafter(f32(my + hy), f32(np.inf)))


def random_entries(seed, n, max_ratio):
    """n Gaussians over the grid: conics from covariances of random
    orientation, sigma 0.4-12 px and up to max_ratio elongation; opacities
    from 0.5 alpha_min to 1, a tenth of them just above alpha_min."""
    rng = np.random.default_rng(seed)
    s1 = rng.uniform(0.4, 12.0, n)
    s2 = s1 / rng.uniform(1.0, max_ratio, n)
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    cxx = (cs * s1) ** 2 + (sn * s2) ** 2
    cyy = (sn * s1) ** 2 + (cs * s2) ** 2
    cxy = cs * sn * (s1 ** 2 - s2 ** 2)
    det = cxx * cyy - cxy ** 2
    a, b, c = (cyy / det).astype(f32), (-cxy / det).astype(f32), (cxx / det).astype(f32)
    op = rng.uniform(0.5 * float(ALPHA_MIN), 1.0, n)
    near = rng.random(n) < 0.1
    op[near] = float(ALPHA_MIN) * rng.uniform(1.0, 1.01, int(near.sum()))
    mx, my = (rng.uniform(20, GRID - 20, n).astype(f32) + f32(0.5) for _ in range(2))
    return mx, my, a, b, c, op.astype(f32)


@pytest.mark.parametrize("seed,max_ratio", [(0, 1.5), (1, 20.0), (2, 100.0)])
def test_box_holds_every_passing_pixel(seed, max_ratio):
    py, px = (g.astype(f32) for g in np.mgrid[0:GRID, 0:GRID])
    n_pass = n_tight = 0
    for mx, my, a, b, c, op in zip(*random_entries(seed, 300, max_ratio)):
        passing = entry_alpha_passes(mx, my, a, b, c, op, px, py)
        x0, x1, y0, y1 = entry_box(mx, my, a, b, c, op)
        inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
        assert not (passing & ~inside).any(), (mx, my, a, b, c, op)
        n_pass += int(passing.any())
        # the exact ellipse op e^(-Q/2) >= alpha_min, without the margins;
        # kRel moves det' by about kRel times the conic's condition number
        tau = np.log(float(op) / float(ALPHA_MIN))
        det = float(a) * float(c) - float(b) ** 2
        lam = np.linalg.eigvalsh(np.array([[a, b], [b, c]], np.float64))
        if tau > 0.5:
            n_tight += 1
            hx = np.sqrt(2 * tau * float(c) / det)
            assert (x1 - x0) / 2 <= hx * (1 + 1e-4 + 4 * REL * lam[1] / lam[0]) + 1e-3
    assert n_pass > 200 and n_tight > 200   # the cases reach what they are for


@pytest.mark.parametrize("name,entry,box", [
    ("nan conic", (40.5, 40.5, np.nan, 0.0, 1.0, 0.5), "all"),
    ("poisoned conic", (40.5, 40.5, -500.0, 0.0, -500.0, 0.5), "all"),
    ("indefinite", (40.5, 40.5, 1.0, 2.0, 1.0, 0.5), "all"),
    ("huge conic", (40.5, 40.5, 2.0 ** 41, 0.0, 1.0, 0.5), "all"),
    ("far mean", (3e6, 40.5, 1.0, 0.0, 1.0, 0.5), "all"),
    ("zero opacity", (40.5, 40.5, 1.0, 0.0, 1.0, 0.0), "none"),
    ("negative opacity", (40.5, 40.5, 1.0, 0.0, 1.0, -0.3), "none"),
])
def test_box_gates(name, entry, box):
    entry = tuple(f32(v) for v in entry)
    got = entry_box(*entry)
    if box == "all":
        assert got == (-np.inf, np.inf, -np.inf, np.inf), name
    else:
        assert got[0] > got[1] and got[2] > got[3], name
        py, px = (g.astype(f32) for g in np.mgrid[0:GRID, 0:GRID])
        assert not entry_alpha_passes(*entry, px, py).any(), name


def test_constants_match_the_kernel():
    """The mirror's constants are the kernel's: its constexpr values and the
    margins entry_box writes inline."""
    src = KERNEL_SOURCE.read_text()
    consts = dict(re.findall(r"constexpr (?:float|double) (k\w+) = ([0-9.e+-]+)f?;", src))
    assert {k: float(consts[k]) for k in ("kMaxCoord", "kMaxConic", "kRel", "kSlack",
                                          "kMinDet", "kMinAlpha")} == {
        "kMaxCoord": MAX_COORD, "kMaxConic": MAX_CONIC, "kRel": REL, "kSlack": SLACK,
        "kMinDet": MIN_DET, "kMinAlpha": MIN_ALPHA}
    body = src[src.index("Box entry_box("):]
    body = body[:body.index("\n}\n")]
    for line in ("fabsf(op) <= kMaxCoord", "if (op <= 0.0f) return",
                 "ap = ad - kRel * (fabs(ad) + fabs(bd))",
                 "cp = cd - kRel * (fabs(cd) + fabs(bd))",
                 "det = ap * cp - bd * bd",
                 "ap > 0.0 && cp > 0.0 && det > kMinDet * ap * cp",
                 "fmax(log(static_cast<double>(op) / alpha_min), 0.0) + kSlack",
                 "r = 2.0 * tau + kSlack",
                 "hx = sqrt(r * cp / det) * (1.0 + 1e-6) + 1e-6",
                 "hy = sqrt(r * ap / det) * (1.0 + 1e-6) + 1e-6",
                 "__double2float_rd(mx - hx)", "__double2float_ru(mx + hx)",
                 "__double2float_rd(my - hy)", "__double2float_ru(my + hy)"):
        assert line in body, line
