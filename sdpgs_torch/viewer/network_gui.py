"""SIBR remote-viewer protocol server.

Parity with reference/gaussian_renderer/network_gui.py: non-blocking TCP
listener; messages are a little-endian u32 length + JSON with camera
parameters (row-major *transposed* view / view-projection matrices with the
SIBR y/z sign flips); replies are raw RGB bytes + a u32-length verify
string. Polled from the training loop each iteration
(reference train.py:65-78).

Counterpart of ``sdpgs_tpu/viewer/network_gui.py``. Instead of
module-level globals, the server is an object; cameras are converted
straight into the port's (untransposed) :class:`Camera` convention and kept
on the host: the render takes them by value.
"""

from __future__ import annotations

import json
import math
import socket
from typing import Optional, Tuple

import numpy as np

from sdpgs_torch.utils.profiling import span


class GuiServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, addr = self.listener.accept()
            self.conn.settimeout(None)
            print(f"\nviewer connected from {addr}")
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return buf

    def receive(self) -> Tuple[Optional[object], dict]:
        """-> (Camera | None, control dict with train/keep_alive/
        scaling_modifier/shs_python/rot_scale_python)."""
        from sdpgs_torch.core.camera import Camera, projection_matrix

        raw_len = int.from_bytes(self._read_exact(4), "little")
        msg = json.loads(self._read_exact(raw_len).decode("utf-8"))
        controls = {
            "train": bool(msg.get("train", False)),
            "keep_alive": bool(msg.get("keep_alive", True)),
            "scaling_modifier": float(msg.get("scaling_modifier", 1.0)),
            "shs_python": bool(msg.get("shs_python", False)),
            "rot_scale_python": bool(msg.get("rot_scale_python", False)),
        }
        width = int(msg.get("resolution_x", 0))
        height = int(msg.get("resolution_y", 0))
        if width == 0 or height == 0:
            return None, controls

        # SIBR sends the transposed world-view matrix with y/z columns
        # flipped (reference network_gui.py:73-78); undo both to get our
        # untransposed world->camera matrix.
        vm = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        vm[:, 1] *= -1
        vm[:, 2] *= -1
        view = vm.T

        fovx = float(msg["fov_x"])
        fovy = float(msg["fov_y"])
        znear = float(msg.get("z_near", 0.01))
        zfar = float(msg.get("z_far", 100.0))
        proj = projection_matrix(znear, zfar, fovx, fovy)
        cam = Camera.from_numpy(dict(
            view=view,
            full_proj=proj @ view,
            cam_pos=np.linalg.inv(view)[:3, 3],
            tan_fovx=np.float32(math.tan(fovx * 0.5)),
            tan_fovy=np.float32(math.tan(fovy * 0.5)),
            height=height,
            width=width,
        ), device="cpu")
        return cam, controls

    def send(self, image: Optional[np.ndarray], verify: str) -> None:
        """image: [H, W, 3] float in [0,1] or None."""
        with span("viewer.send", unit="view"):
            if image is not None:
                data = (np.clip(image, 0, 1) * 255).astype(np.uint8).tobytes()
                self.conn.sendall(data)
            self.conn.sendall(len(verify).to_bytes(4, "little"))
            self.conn.sendall(verify.encode("ascii"))

    def drop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def poll(self, render_fn, source_path: str, training_done: bool) -> bool:
        """One training-loop poll (reference train.py:65-78): serve frames
        while connected; returns True when training should continue. Any
        failure while serving drops the connection, as the reference's
        protocol does; the viewer reconnects."""
        if not self.try_connect():
            return True
        while self.conn is not None:
            try:
                cam, controls = self.receive()
                img = render_fn(cam, controls) if cam is not None else None
                self.send(img, source_path)
                if controls["train"] and (not training_done or not controls["keep_alive"]):
                    break
            except Exception:
                self.drop()
        return True
