"""The comparison that decides ``correct`` catches a broken timed path, and
the control (the reference in fp8 in the program's place) fails the cells'
own limits (CPU, tiny sizes).

Each fault test drives a whole run but the look for a card, once with the
program as it is and once with a fault planted underneath the timed path:
a step that returns its state unchanged, half of the batch left out (the
mean over the rest), an answer altered where it is produced. The program
runs its float32 path here, where it follows the reference to rounding, so
the tests' own limits can be tight (the hash tables stay bfloat16, whose
Adam moves them 0.3% apart); the cells' limits are set on the card.
(The exchange between chips does not exist in these one-chip cells.)
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import bench  # noqa: E402
from portbench.tests import tiny  # noqa: E402

TIGHT = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2, "rgb_mae": 1e-4,
         "rgb_tile_mae98": 2e-4, "png_share_over_2": 0.01}
TRAIN = ["lego.train", "hashgrid"]  # the second: tiny.hashgrid of lego.train


def cell(name):
    c = tiny.hashgrid(bench.find_cell("lego.train")) if name == "hashgrid" else bench.find_cell(name)
    return tiny.shrink(c, dtype="float32",
                       limits={k: v for k, v in TIGHT.items() if k in c.limits})


def unchanged_state(monkeypatch):
    from nerf_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, params, grads, state: None)


def half_batch(monkeypatch):
    from nerf_tpu_torch.train import state

    orig = state.nerf_loss

    def half(params, rays_o, rays_d, target, opts, grid, generator=None):
        h = rays_o.shape[0] // 2
        return orig(params, rays_o[:h], rays_d[:h], target[:h], opts, grid, generator)

    monkeypatch.setattr(state, "nerf_loss", half)


def altered_colour(monkeypatch):
    from nerf_tpu_torch.render import renderer
    from nerf_tpu_torch.train import state

    orig = renderer.render_rays

    def altered(*args, **kw):
        out = dict(orig(*args, **kw))
        bump = torch.zeros_like(out["rgb_map"])
        bump[::4] = 0.05
        out["rgb_map"] = out["rgb_map"] + bump
        return out

    monkeypatch.setattr(renderer, "render_rays", altered)
    monkeypatch.setattr(state, "render_rays", altered)  # the train step's own name


@pytest.mark.parametrize("name", TRAIN)
def test_sound_train_run_is_correct(name):
    line, _ = tiny.run(cell(name))
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_colour])
@pytest.mark.parametrize("name", TRAIN)
def test_train_faults_are_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    line, _ = tiny.run(cell(name))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("broken", [False, True])
def test_render_altered_frame_is_caught(broken, monkeypatch):
    if broken:
        altered_colour(monkeypatch)
    line, _ = tiny.run(cell("lego.render"))
    assert line["correct"] is not broken, line["checks"]


@pytest.mark.parametrize("broken", [False, True])
def test_render_one_altered_tile_is_caught(broken, monkeypatch):
    """A fault in the last, partial render tile of each frame alone, which
    the frame's mean (under a loose limit here) averages away."""
    c = cell("lego.render")
    c.limits["rgb_mae"] = 0.02
    tile = int(c.config["cfg"]["render_tile_rays"])
    if broken:
        from nerf_tpu_torch.render import renderer

        orig = renderer.render_rays

        def last_tile_off(params, rays_o, *args, **kw):
            out = dict(orig(params, rays_o, *args, **kw))
            if rays_o.shape[0] < tile:
                out["rgb_map"] = out["rgb_map"] + 0.05
            return out

        monkeypatch.setattr(renderer, "render_rays", last_tile_off)
    line, _ = tiny.run(c)
    assert line["correct"] is not broken, line["checks"]
    assert line["checks"]["rgb_mae"]["value"] < 0.02


@pytest.mark.parametrize("broken", [False, True])
def test_serve_altered_frame_is_caught(broken, monkeypatch):
    if broken:
        from nerf_tpu_torch import serve

        orig = serve.RenderService.render
        monkeypatch.setattr(serve.RenderService, "render",
                            lambda self, *a, **k: orig(self, *a, **k) * 0.9)
    line, _ = tiny.run(cell("lego.serve"))
    assert line["correct"] is not broken, line["checks"]


@pytest.mark.parametrize("name", ["lego.train", "lego.render", "lego.serve"])
def test_the_control_fails_the_cells_limits(name):
    """The reference computed in fp8 in the program's place reads above one of
    the cell's own limits."""
    c = bench.find_cell(name)
    nums = bench.driver(c.kind).control(tiny.context(tiny.shrink(c)), "fp8")
    assert any(v > c.limits[k] for k, v in nums.items()), (nums, c.limits)
