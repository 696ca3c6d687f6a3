"""The port's viewer server, utils and the last transform on the CPU, each
against sdpgs_tpu's: the SIBR loopback round trip of test_viewer.py (the
received camera equal to JAX's to 1e-6, on the host; the reply bytes), a
poll that drops the connection on a failing render, vis, safe_state,
trace, and symm6_to_covariance."""

import io
import json
import random
import socket
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_torch.core.transforms import covariance_to_symm6, symm6_to_covariance
from sdpgs_torch.utils import general as tgeneral
from sdpgs_torch.utils import profiling as tprofiling
from sdpgs_torch.utils import vis as tvis
from sdpgs_torch.viewer import GuiServer as TServer
from sdpgs_tpu.core import transforms as jtransforms
from sdpgs_tpu.utils import general as jgeneral
from sdpgs_tpu.utils import vis as jvis
from sdpgs_tpu.viewer import GuiServer as JServer

W, H = 32, 24


def sibr_message(rng):
    """A camera as SIBR sends it: the transposed world-view matrix with its
    y and z columns negated."""
    a = 0.3
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    view[:3, 3] = rng.normal(size=3)
    vm = view.T.copy()
    vm[:, 1] *= -1
    vm[:, 2] *= -1
    return {
        "resolution_x": W, "resolution_y": H,
        "train": True, "keep_alive": False,
        "scaling_modifier": 1.0, "shs_python": False, "rot_scale_python": False,
        "fov_x": 0.9, "fov_y": 0.7, "z_near": 0.01, "z_far": 100.0,
        "view_matrix": vm.flatten().tolist(),
        "view_projection_matrix": np.eye(4, dtype=np.float32).flatten().tolist(),
    }, view


def read_exact(c, n):
    buf = b""
    while len(buf) < n:
        chunk = c.recv(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def client(port, msg, result):
    """Send one message; read the frame (none without a resolution) and the
    verify string, or whatever arrives before the server hangs up."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
        payload = json.dumps(msg).encode()
        c.sendall(len(payload).to_bytes(4, "little") + payload)
        result["img"] = read_exact(c, msg["resolution_x"] * msg["resolution_y"] * 3)
        vlen = read_exact(c, 4)
        if len(vlen) == 4:
            result["verify"] = read_exact(c, int.from_bytes(vlen, "little")).decode()


def serve_one(server_cls, msg, image):
    server = server_cls(port=0)
    result = {}
    t = threading.Thread(target=client, args=(server.listener.getsockname()[1], msg, result))
    t.start()
    try:
        deadline = time.monotonic() + 5
        while not server.try_connect():
            assert time.monotonic() < deadline, "no viewer connected"
        cam, controls = server.receive()
        server.send(image, "scene")
    finally:
        t.join(timeout=5)
        server.drop()
        server.listener.close()
    assert not t.is_alive()
    return cam, controls, result


def test_gui_roundtrip_matches_jax(rng):
    msg, view = sibr_message(rng)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    cam, controls, result = serve_one(TServer, msg, image)
    jcam, jcontrols, jresult = serve_one(JServer, msg, image)
    assert controls == jcontrols and controls["train"] is True
    assert result == jresult and result["verify"] == "scene"
    assert result["img"] == (np.clip(image, 0, 1) * 255).astype(np.uint8).tobytes()
    assert (cam.width, cam.height) == (jcam.width, jcam.height) == (W, H)
    np.testing.assert_allclose(cam.view.numpy(), view, atol=1e-6)
    for k in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy"):
        got, ref = getattr(cam, k), np.asarray(getattr(jcam, k))
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6, err_msg=k)


def test_gui_without_resolution_has_no_camera(rng):
    msg, _ = sibr_message(rng)
    msg["resolution_x"] = 0
    cam, controls, result = serve_one(TServer, msg, None)
    assert cam is None and controls["keep_alive"] is False
    assert result["img"] == b""


def test_poll_drops_the_viewer_when_render_fails(rng):
    """The reference protocol: any failure while serving drops the
    connection, and training goes on."""
    msg, _ = sibr_message(rng)
    server = TServer(port=0)
    result = {}
    t = threading.Thread(target=client, args=(server.listener.getsockname()[1], msg, result))
    t.start()
    try:
        deadline = time.monotonic() + 5
        while not server.try_connect():
            assert time.monotonic() < deadline

        def failing_render(cam, controls):
            raise RuntimeError("render failed")

        assert server.poll(failing_render, "scene", training_done=False) is True
        assert server.conn is None
    finally:
        t.join(timeout=5)
        server.listener.close()
    assert not t.is_alive() and result["img"] == b""


def test_vis_equal(rng):
    depth = rng.uniform(0.5, 6.0, (24, 32))
    depth[:3] = 0
    mask = rng.random((24, 32)) < 0.7
    t = rng.uniform(-0.2, 1.2, (10, 7))
    np.testing.assert_array_equal(tvis.turbo_colormap(t), jvis.turbo_colormap(t))
    np.testing.assert_array_equal(tvis.weighted_percentile(depth, mask, [5, 50, 95]),
                                  jvis.weighted_percentile(depth, mask, [5, 50, 95]))
    for m in (None, mask):
        np.testing.assert_array_equal(tvis.vis_depth(depth, m), jvis.vis_depth(depth, m))
    img = tvis.depth_to_image(depth)
    assert img.dtype == np.uint8 and img.shape == (24, 32, 3)
    np.testing.assert_array_equal(img, jvis.depth_to_image(depth))
    x = rng.uniform(0.01, 0.99, 50)
    np.testing.assert_array_equal(tgeneral.inverse_sigmoid_np(x), jgeneral.inverse_sigmoid_np(x))


class _Out(io.StringIO):
    """A stdout whose ``write`` may be replaced, as safe_state does."""


@pytest.mark.parametrize("quiet", [True, False])
def test_safe_state_matches_jax(monkeypatch, quiet):
    draws = {}
    for name, mod in (("t", tgeneral), ("j", jgeneral)):
        out = _Out()
        monkeypatch.setattr(sys, "stdout", out)
        mod.safe_state(quiet=quiet, seed=7)
        draws[name] = (np.random.rand(3).tolist(), random.random())
        sys.stdout.write("one line\n")
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
        text = out.getvalue()
        assert text.startswith("one line") and (text == "one line\n") == quiet, text
    assert draws["t"] == draws["j"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprofiling.trace(tmp_path / "prof") as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path.exists() and path.parent == tmp_path / "prof"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_symm6_to_covariance_matches_jax(rng):
    sym = rng.normal(size=(5, 4, 6)).astype(np.float32)
    got = symm6_to_covariance(torch.from_numpy(sym))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtransforms.symm6_to_covariance(jnp.asarray(sym))))
    assert torch.equal(covariance_to_symm6(got), torch.from_numpy(sym))
    assert torch.equal(got, got.transpose(-1, -2))
