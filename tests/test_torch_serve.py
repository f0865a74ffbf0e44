"""nerf_tpu_torch.serve on the CPU: one /frame through the HTTP handler.

The service runs at size 16 with a small ESS grid (R=4) and 16+16 samples,
so that the plain PyTorch path renders it in about a second.
"""
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from serve import look_at_pose as jax_serve_look_at_pose

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.serve import (RenderService, decode_png, encode_png, look_at_pose,
                                  make_server)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = ["trained_model_dir", os.path.join(ROOT, "checkpoints/nerf/lego/nerf"),
         "occupancy_grid_resolution", "4", "task_arg.N_samples", "16",
         "task_arg.N_importance", "16"]


def _cfg(extra=()):
    return make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"), SMALL + list(extra))


@pytest.fixture(scope="module")
def served():
    service = RenderService(_cfg(), size=16, device="cpu")
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield service, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_frame_is_a_png_of_the_render(served):
    service, base = served
    status, ctype, body = _get(f"{base}/frame?theta=0.5&phi=0.3&radius=4.0")
    assert (status, ctype) == (200, "image/png")
    img = decode_png(body)
    assert img.shape == (16, 16, 3)
    want = (np.clip(service.render(0.5, 0.3, 4.0).numpy(), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(img, want)
    assert 0 < img.mean() < 0.98 * 255


def test_index_and_unknown_path(served):
    _, base = served
    status, ctype, body = _get(f"{base}/")
    assert (status, ctype) == (200, "text/html") and b"/frame" in body
    assert _get(f"{base}/nope")[0] == 404


def test_frame_error_answers_500_and_is_counted(served):
    service, base = served
    before = service.errors
    status, ctype, body = _get(f"{base}/frame?theta=abc")
    assert (status, ctype) == (500, "application/json")
    assert "error" in json.loads(body)
    assert service.errors == before + 1


def test_png_round_trip():
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    bad = bytearray(encode_png(img))
    bad[30] ^= 1
    with pytest.raises(ValueError):
        decode_png(bytes(bad))


@pytest.mark.parametrize("theta,phi,radius", [(0.5, 0.3, 4.0), (2.0, -0.7, 3.0)])
def test_look_at_pose_matches_jax_server(theta, phi, radius):
    np.testing.assert_allclose(look_at_pose(theta, phi, radius),
                               jax_serve_look_at_pose(theta, phi, radius), atol=1e-6)


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderService(_cfg(), size=16)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        RenderService(_cfg(["trained_model_dir", str(tmp_path)]), size=16, device="cpu")
