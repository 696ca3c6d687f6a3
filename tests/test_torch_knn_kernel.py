"""The k-NN kernel (``csrc/knn.cu``) and its wrapper (``ops/knn.py``).

On the CPU: the wrapper's largest k is the kernel's, CPU tensors take the
plain version (counted), and the kernel's wrapper refuses a k it has no
instance for and a tensor off the card.

On the card (``card``; run there with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_knn_kernel.py -m card``): the kernel
against the plain version run on the card, from the same points and mask:
indices equal everywhere and distances equal bit for bit, one launch a
call, at a masked ragged N, exact duplicates (ties to the lower index),
rows with fewer than k valid neighbours, ``mean_sq_dist_to_knn``, and the
early densify cell's shape (131,072 slots, 60,000 alive, 256 of them in
isolated tetrahedra whose corners list their group's three).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import few_threads  # noqa: F401

from sdpgs_torch import _kernels
from sdpgs_torch.ops import knn as tknn

KERNEL_SOURCE = Path(tknn.__file__).resolve().parents[1] / "csrc" / "knn.cu"


def points(rng, n, dup=False):
    pts = (rng.normal(size=(n, 3)) * 0.4 + [0.0, 0.0, 3.0]).astype(np.float32)
    if dup:
        pts[1::4] = pts[0::4][:len(pts[1::4])]
        pts[2::4] = pts[0::4][:len(pts[2::4])]
    return pts


# ---- on the CPU ----------------------------------------------------------


def test_max_k_matches_the_kernel():
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", KERNEL_SOURCE.read_text()))
    assert int(consts["kMaxK"]) == tknn.MAX_K
    # one template instance for each k the wrapper lets through
    src = KERNEL_SOURCE.read_text()
    assert [int(k) for k in re.findall(r"case (\d+): err = launch_k<\1>", src)] == list(
        range(1, tknn.MAX_K + 1))


def test_cpu_tensors_take_the_plain_version():
    pts = torch.from_numpy(points(np.random.default_rng(3), 64))
    _kernels.reset_counts()
    d2, idx = tknn.knn(pts, k=3, device="cpu")
    assert _kernels.PLAIN_CALLS["knn"] == 1 and _kernels.LAUNCHES["knn"] == 0
    assert d2.shape == idx.shape == (64, 3) and idx.dtype == torch.int64


@pytest.mark.parametrize("k", [0, tknn.MAX_K + 1])
def test_kernel_refuses_a_k_it_has_no_instance_for(k):
    with pytest.raises(ValueError, match="takes k from 1"):
        tknn.knn_cuda(torch.zeros((16, 3)), k=k)


def test_kernel_refuses_a_tensor_off_the_card():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tknn.knn_cuda(torch.zeros((16, 3)), k=3)


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _assert_same(dev, pts, mask, k, chunk=1024):
    """The kernel's (d2, idx) against the plain version's on the card: one
    launch, indices equal, distances equal bit for bit."""
    p = torch.from_numpy(pts).to(dev)
    m = None if mask is None else torch.from_numpy(mask).to(dev)
    before = _kernels.LAUNCHES["knn"]
    kd, ki = tknn.knn(p, k=k, mask=m, device=dev)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["knn"] == before + 1
    pd, pi = tknn.knn_plain(p, k=k, mask=m, chunk=chunk)
    assert kd.shape == pd.shape == (len(pts), k) and kd.dtype == torch.float32
    assert ki.dtype == torch.int64
    assert torch.equal(ki, pi), int((ki != pi).sum())
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32)), int((kd != pd).sum())
    return kd.cpu().numpy(), ki.cpu().numpy()


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 3, 8])
def test_masked_ragged(cuda_device, k):
    # N a multiple of neither the block's 256 rows nor its 512 staged candidates
    rng = np.random.default_rng(0)
    n = 1_337
    mask = (rng.random(n) > 0.2).astype(np.float32)
    d2, idx = _assert_same(cuda_device, points(rng, n), mask, k, chunk=500)
    valid = mask > 0
    assert valid[idx].all() and (idx != np.arange(n)[:, None]).all()
    assert (np.diff(d2, axis=1) >= 0).all()


@pytest.mark.card
def test_no_mask_bool_mask_and_duplicates(cuda_device):
    rng = np.random.default_rng(1)
    _assert_same(cuda_device, points(rng, 700), None, 3)
    n = 900
    pts = points(rng, n, dup=True)
    mask = rng.random(n) > 0.1
    d2, idx = _assert_same(cuda_device, pts, mask, 3)
    # exact ties were reached, and each went to the lower index
    tied = d2[:, 0] == d2[:, 1]
    assert tied.sum() > 20
    assert (idx[tied, 0] < idx[tied, 1]).all()


@pytest.mark.card
@pytest.mark.parametrize("valid", [(5, 77), (300,), ()])
def test_rows_with_fewer_than_k_valid_neighbours(cuda_device, valid):
    # every row has under 3 valid neighbours: its list ends in the lowest-index
    # dropped slots (the invalid ones and itself) at +inf
    n = 600
    mask = np.zeros(n, np.float32)
    mask[list(valid)] = 1.0
    d2, idx = _assert_same(cuda_device, points(np.random.default_rng(2), n), mask, 3)
    assert np.isinf(d2[:, 2]).all()
    assert (idx[~np.isinf(d2)] < n).all()


@pytest.mark.card
def test_mean_sq_dist_to_knn(cuda_device, monkeypatch):
    rng = np.random.default_rng(4)
    n = 2_000
    p = torch.from_numpy(points(rng, n)).to(cuda_device)
    m = torch.from_numpy((rng.random(n) > 0.3).astype(np.float32)).to(cuda_device)
    before = _kernels.LAUNCHES["knn"]
    got = tknn.mean_sq_dist_to_knn(p, k=3, mask=m, device=cuda_device)
    assert _kernels.LAUNCHES["knn"] == before + 1
    monkeypatch.setattr(tknn, "knn", lambda pts, k=3, mask=None, device=None:
                        tknn.knn_plain(pts, k, mask))
    want = tknn.mean_sq_dist_to_knn(p, k=3, mask=m, device=cuda_device)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# The early densify cell's isolated Gaussians: groups of four at the corners
# of this tetrahedron (edge 1; its six edges all differ), turned at random,
# their centroids 6 apart on a 4x4x4 grid around (0, 0, -12).
TETRAHEDRON = np.array([[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [0.3, 1.3, 0.0], [0.5, 0.4, 1.5]])


def isolated_positions(rng, count=256, center=(0.0, 0.0, -12.0), spacing=6.0):
    groups = count // 4
    side = int(np.ceil(groups ** (1.0 / 3.0) - 1e-9))
    axis = (np.arange(side) - (side - 1) / 2.0) * spacing
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)[:groups]
    grid = grid + np.asarray(center) + rng.uniform(-0.1, 0.1, (groups, 3)) * spacing
    shape = TETRAHEDRON - TETRAHEDRON.mean(0)
    turns = np.linalg.qr(rng.standard_normal((groups, 3, 3)))[0]
    return (grid[:, None, :] + np.einsum("gij,kj->gki", turns, shape)).reshape(-1, 3)


@pytest.mark.card
def test_the_early_cells_shape(cuda_device):
    rng = np.random.default_rng(5)
    P, alive, iso = 131_072, 60_000, 256
    pts = np.zeros((P, 3), np.float32)
    pts[:alive] = rng.normal(size=(alive, 3)) * [1.2, 0.9, 0.6] + [0.0, 0.0, 4.0]
    pts[alive - iso:alive] = isolated_positions(rng)
    mask = (np.arange(P) < alive).astype(np.float32)
    _, idx = _assert_same(cuda_device, pts, mask, 3)
    corners = np.arange(alive - iso, alive)
    group = (corners - (alive - iso)) // 4
    for c, g in zip(corners, group):
        own = set(range(alive - iso + 4 * g, alive - iso + 4 * g + 4)) - {c}
        assert set(idx[c].tolist()) == own, c
