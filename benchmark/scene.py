"""The benchmark's inputs, made from the seed: a hidden Gaussian cloud, the
train cameras and their targets (rendered from the hidden cloud by the
reference's rasterizer), the segment prototypes, the trainee (the hidden
cloud perturbed), the pseudo cameras, the DPT's weights and the render
path.

A configuration with ``cloud.isolated`` also holds that many large
Gaussians far behind the cameras, in groups of four whose corners meet
FSGS's proximity rule (``add_isolated``); the others draw nothing more.

The clouds and weights are drawn on the device with one ``torch.Generator``
in a few large calls; the cameras and poses in numpy from the same seed,
the pseudo poses by the sampler of the layout's kind (``pseudo_poses``).
The cloud recipe is ``chip_smoke.py``'s ``make_cloud`` and ``perturb``;
the scene's layout (targets rendered from a hidden cloud, segments by
angle around the view axis) is ``sdpgs_torch/data/synthetic.py``'s, both
copied here. Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from benchmark import poses as pose_lib
from benchmark.reference.camera import Cam, View
from benchmark.reference.raster import FIELDS, Raster, render

C0 = 0.28209479177387814
SEED_MASK = (1 << 63) - 1


@dataclass
class Scene:
    views: list                  # train View records
    image: torch.Tensor          # [V, 3, H, W] targets in [0, 1]
    depth: torch.Tensor          # [V, H, W] the depth prior (the hidden cloud's depth)
    feature: torch.Tensor        # [V, 3, H, W] language-feature targets
    seg_map: torch.Tensor        # [V, H, W] int32 segment ids
    protos: torch.Tensor         # [S, 3]
    hidden: dict                 # field -> [P, ...]; "alive" [P]
    trainee: dict
    bounds: np.ndarray           # [V, 2] near, far of each view's depth
    extent: float                # the cameras' radius (nerf++ normalisation) x 1.1
    pseudo_poses: Optional[np.ndarray] = None   # [N, 4, 4] world to camera

    def pseudo_view(self, i: int) -> View:
        pose = self.pseudo_poses[i]
        v = self.views[0]
        return View(R=pose[:3, :3].T, T=pose[:3, 3], fovx=v.fovx, fovy=v.fovy,
                    width=v.width, height=v.height)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)


def raster_of(cfg: dict) -> Raster:
    return Raster(**cfg["raster"])


def make_cloud(gen: torch.Generator, cloud: dict, layout: dict, n_segments: int, protos,
               device) -> dict:
    """Trained-like parameters at the configuration's capacity: ``alive``
    live slots, the rest dead (scale and opacity logits -10, identity
    rotation)."""
    P, n = cloud["capacity"], cloud["alive"]
    K = (cloud["sh_degree"] + 1) ** 2
    f32 = dict(generator=gen, device=device, dtype=torch.float32)
    center = torch.tensor(layout["center"], dtype=torch.float32, device=device)
    if layout["kind"] == "forward":
        spread = torch.tensor(layout["spread"], dtype=torch.float32, device=device)
        xyz = torch.randn((n, 3), **f32) * spread + center
        ang = torch.atan2(xyz[:, 1] - center[1], xyz[:, 0] - center[0])
    else:
        # uniform in a ball: direction times radius * u^(1/3)
        d = torch.randn((n, 3), **f32)
        d = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        xyz = center + d * layout["radius"] * torch.rand((n, 1), **f32) ** (1.0 / 3.0)
        ang = torch.atan2(xyz[:, 2] - center[2], xyz[:, 0] - center[0])
    quat = torch.randn((n, 4), **f32)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    seg = ((ang + np.pi) / (2 * np.pi) * n_segments).long().clamp(0, n_segments - 1)
    live = dict(
        xyz=xyz,
        features_dc=((torch.rand((n, 1, 3), **f32) - 0.5) / C0),
        features_rest=torch.randn((n, K - 1, 3), **f32) * 0.05,
        scaling=float(np.log(cloud["scale"])) + torch.randn((n, 3), **f32) * cloud["scale_sd"],
        rotation=quat,
        opacity=torch.rand((n, 1), **f32) * 5.0 - 2.0,
        language_feature=protos[seg],
    )
    out = {}
    for k, v in live.items():
        fill = -10.0 if k in ("scaling", "opacity") else 0.0
        full = torch.full((P,) + tuple(v.shape[1:]), fill, dtype=torch.float32, device=device)
        full[:n] = v
        out[k] = full
    out["rotation"][n:, 0] = 1.0
    out["alive"] = (torch.arange(P, device=device) < n).to(torch.float32)
    return out


def perturb(hidden: dict, gen: torch.Generator, n: int) -> dict:
    """The trainee: the hidden cloud moved, dimmed and recoloured."""
    out = {k: v.clone() for k, v in hidden.items()}
    dev = hidden["xyz"].device
    f32 = dict(generator=gen, device=dev, dtype=torch.float32)
    out["xyz"][:n] += torch.randn((n, 3), **f32) * 0.01
    out["opacity"][:n] -= 0.5
    out["features_dc"][:n] += torch.randn((n, 1, 3), **f32) * 0.2
    out["language_feature"][:n] += torch.randn((n, 3), **f32) * 0.1
    return out


# The isolated Gaussians come in groups of four, the corners of this
# tetrahedron (edge 1): its six edges all differ, so each corner's three
# nearest neighbours are the other three at squared distances at least 0.11
# apart, and their mean is 1.88-2.84 (edges squared: AB 1.21, AC 1.78,
# BC 2.33, AD 2.66, BD 2.77, CD 3.10).
TETRAHEDRON = np.array([[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [0.3, 1.3, 0.0], [0.5, 0.4, 1.5]])


def isolated_positions(spec: dict, rng: np.random.Generator) -> np.ndarray:
    """[count, 3] centres: ``count / 4`` tetrahedra of edge ``edge``, each
    turned at random about its centroid, their centroids ``spacing`` apart
    on the smallest cubic grid around ``center`` that holds them, moved by
    up to a tenth of the spacing. A corner's three nearest neighbours are
    its own group's other corners; the next lies in another group, over
    0.8 ``spacing`` - 2.3 ``edge`` away (corners lie within 1.13 ``edge``
    of their centroid)."""
    groups = spec["count"] // 4
    if groups * 4 != spec["count"]:
        raise ValueError("cloud.isolated.count must be a multiple of 4")
    side = int(np.ceil(groups ** (1.0 / 3.0) - 1e-9))
    axis = (np.arange(side) - (side - 1) / 2.0) * spec["spacing"]
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)[:groups]
    grid = grid + np.asarray(spec["center"], np.float64)
    grid += rng.uniform(-0.1, 0.1, (groups, 3)) * spec["spacing"]
    shape = (TETRAHEDRON - TETRAHEDRON.mean(0)) * spec["edge"]
    turns = np.linalg.qr(rng.standard_normal((groups, 3, 3)))[0]
    return (grid[:, None, :] + np.einsum("gij,kj->gki", turns, shape)).reshape(-1, 3)


@torch.no_grad()
def add_isolated(hidden: dict, trainee: dict, spec: dict, n: int, protos,
                 gen: torch.Generator, rng: np.random.Generator) -> None:
    """Write ``spec["count"]`` large Gaussians (``cloud.isolated``) into
    the last live slots of both clouds, the same in each: at
    ``isolated_positions``, scales log-normal around ``spec["scale"]``,
    opaque, coloured and labelled at random."""
    m = spec["count"]
    dev = hidden["xyz"].device
    f32 = dict(generator=gen, device=dev, dtype=torch.float32)
    K1 = hidden["features_rest"].shape[1]
    quat = torch.randn((m, 4), **f32)
    fields = dict(
        xyz=torch.from_numpy(isolated_positions(spec, rng)).to(dev, torch.float32),
        features_dc=(torch.rand((m, 1, 3), **f32) - 0.5) / C0,
        features_rest=torch.randn((m, K1, 3), **f32) * 0.05,
        scaling=float(np.log(spec["scale"])) + torch.randn((m, 3), **f32) * spec["scale_sd"],
        rotation=quat / quat.norm(dim=-1, keepdim=True),
        opacity=torch.rand((m, 1), **f32) * 2.0 + 1.0,
        language_feature=protos[torch.randint(0, protos.shape[0], (m,), generator=gen,
                                              device=dev)],
    )
    for cloud in (hidden, trainee):
        for k, v in fields.items():
            cloud[k][n - m:n] = v


def train_views(layout: dict, size: dict, rng: np.random.Generator) -> list:
    """Forward-facing views on a short baseline (LLFF), or a ring of views
    looking at the centre (mip-NeRF 360)."""
    W, H = size["width"], size["height"]
    fovx, fovy = size["fovx"], size["fovy"]
    n = layout["n_train"]
    views = []
    if layout["kind"] == "forward":
        for dx in np.linspace(-layout["baseline"] / 2, layout["baseline"] / 2, n):
            T = np.array([dx, 0.02 * rng.standard_normal(), 0.0])
            views.append(View(R=np.eye(3), T=T, fovx=fovx, fovy=fovy, width=W, height=H))
        return views
    center = np.asarray(layout["center"], np.float64)
    for a in np.linspace(0.0, 2.0 * np.pi, n, endpoint=False) + 0.1 * rng.standard_normal():
        pos = center + np.array([layout["ring"] * np.cos(a), -layout["height"],
                                 layout["ring"] * np.sin(a)])
        c2w = pose_lib.viewmatrix(center - pos, np.array([0.0, -1.0, 0.0]), pos)
        # camera convention: +z forward, x right, y down (c2w columns)
        R = np.stack([c2w[:, 0], c2w[:, 1], c2w[:, 2]], axis=1)
        T = -R.T @ pos
        views.append(View(R=R, T=T, fovx=fovx, fovy=fovy, width=W, height=H))
    return views


def extent_of(views: list) -> float:
    centers = np.stack([-(v.R @ v.T) for v in views])
    return float(np.max(np.linalg.norm(centers - centers.mean(0), axis=-1)) * 1.1)


@torch.no_grad()
def build(cfg: dict, seed: int, device, with_pseudo: bool) -> Scene:
    """The configuration's scene from ``seed`` on ``device``."""
    gen = generator(seed, device)
    rng = np.random.default_rng(int(seed))
    layout, cloud, size = cfg["layout"], cfg["cloud"], cfg["image"]
    S = layout["n_segments"]
    protos = torch.randn((S, 3), generator=gen, device=device, dtype=torch.float32)
    protos = protos / (protos.norm(dim=-1, keepdim=True) + 1e-8)
    hidden = make_cloud(gen, cloud, layout, S, protos, device)
    trainee = perturb(hidden, gen, cloud["alive"])
    views = train_views(layout, size, rng)
    if "isolated" in cloud:
        add_isolated(hidden, trainee, cloud["isolated"], cloud["alive"], protos, gen, rng)
    raster = raster_of(cfg)
    bg = torch.zeros(3, device=device)
    params = {k: hidden[k] for k in FIELDS}
    imgs, depths, feats = [], [], []
    for v in views:
        out = render(params, hidden["alive"], Cam.of(v, device), raster, bg,
                     cloud["sh_degree"])
        imgs.append(out.color.permute(2, 0, 1))
        depths.append(out.depth)
        feats.append(out.feature.permute(2, 0, 1))
    image, depth, feature = torch.stack(imgs), torch.stack(depths), torch.stack(feats)
    seg_map = torch.argmax(torch.einsum("vchw,sc->vshw", feature, protos), dim=1)
    bounds = np.stack([np.percentile(d[d > 0], [1.0, 99.0]) for d in depth.cpu().numpy()])
    scene = Scene(views=views, image=image, depth=depth, feature=feature,
                  seg_map=seg_map.to(torch.int32), protos=protos, hidden=hidden,
                  trainee=trainee, bounds=bounds, extent=extent_of(views))
    if with_pseudo:
        scene.pseudo_poses = pseudo_poses(layout, views, bounds, rng)
    return scene


def pseudo_poses(layout: dict, views: list, bounds: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    """``layout["n_pseudo"]`` pseudo poses by the program's sampler for the
    layout (``sdpgs_torch/data/scene.py``): the LLFF sampler for
    forward-facing views, FSGS's 360 sampler for a ring around the scene."""
    Rs, Ts = [v.R for v in views], [v.T for v in views]
    if layout["kind"] == "forward":
        return pose_lib.generate_random_poses_llff(Rs, Ts, bounds, n_poses=layout["n_pseudo"],
                                                   rng=rng)
    if layout["kind"] == "inward":
        return pose_lib.generate_random_poses_360(Rs, Ts, n_poses=layout["n_pseudo"], rng=rng)
    raise ValueError(f"no pseudo-pose sampler for layout kind {layout['kind']!r}")


def spiral_views(scene: Scene, n_frames: int) -> list:
    """The render CLI's spiral path over the train views."""
    v0 = scene.views[0]
    path = pose_lib.generate_spiral_path([v.R for v in scene.views], [v.T for v in scene.views],
                                         scene.bounds, n_frames=n_frames)
    return [View(R=p[:3, :3].T, T=p[:3, 3], fovx=v0.fovx, fovy=v0.fovy, width=v0.width,
                 height=v0.height) for p in path]


def dpt_weights(names_shapes: list, seed: int, device, dtype) -> dict:
    """The depth net's random weights by parameter name, drawn in one call
    (the program's ``random_params`` recipe: N(0, 0.02) for every matrix,
    kernel and position embedding, ones for the norms' scales, zeros for
    biases and the class token)."""
    gen = generator(seed ^ 0x5EED, device)
    normal = [(k, s) for k, s in names_shapes
              if len(s) > 1 and not k.endswith("cls_token")]
    total = sum(int(np.prod(s)) for _, s in normal)
    flat = torch.randn((total,), generator=gen, device=device, dtype=dtype) * 0.02
    out, o = {}, 0
    for k, s in names_shapes:
        if (k, s) in normal:
            n = int(np.prod(s))
            out[k] = flat[o:o + n].view(s)
            o += n
        elif k.endswith(".weight"):
            out[k] = torch.ones(s, device=device, dtype=dtype)
        else:
            out[k] = torch.zeros(s, device=device, dtype=dtype)
    return out
