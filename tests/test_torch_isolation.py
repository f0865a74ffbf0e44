"""nerf_tpu_torch and chip_smoke.py import neither JAX nor nerf_tpu (AST scan)."""
import ast
import os

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(os.path.join(ROOT, "nerf_tpu_torch")) for f in fs
    if f.endswith(".py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "nerf_tpu")


def _imported_modules(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_port_has_modules():
    assert len(FILES) > 10 and "nerf_tpu_torch/serve.py" in FILES


@pytest.mark.parametrize("path", FILES)
def test_no_jax_and_no_nerf_tpu(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


# the evaluation slice's modules: each is found by the scan above
EVAL_SLICE = ["nerf_tpu_torch/utils/png.py", "nerf_tpu_torch/utils/profiling.py",
              "nerf_tpu_torch/data/blender.py", "nerf_tpu_torch/data/samplers.py",
              "nerf_tpu_torch/eval/metrics.py", "nerf_tpu_torch/eval/background.py",
              "nerf_tpu_torch/eval/evaluator.py", "nerf_tpu_torch/eval/video.py",
              "nerf_tpu_torch/render/spiral.py", "nerf_tpu_torch/render/marched.py",
              "nerf_tpu_torch/run.py", "nerf_tpu_torch/render_novel_views.py",
              "nerf_tpu_torch/create_video_from_images.py"]


@pytest.mark.parametrize("path", EVAL_SLICE)
def test_the_evaluation_slice_is_scanned(path):
    assert path in FILES
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]


# the float32 slice's modules: each is found by the scan above
F32_SLICE = ["nerf_tpu_torch/tools/f32_check.py", "nerf_tpu_torch/ops/fused_mlp.py",
             "nerf_tpu_torch/ops/fused_mlp_bwd.py", "nerf_tpu_torch/train/state.py",
             "nerf_tpu_torch/models/nerf_mlp.py", "nerf_tpu_torch/render/renderer.py"]


@pytest.mark.parametrize("path", F32_SLICE)
def test_the_float32_slice_is_scanned(path):
    assert path in FILES
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]


# the KiloNeRF and harness slice's modules: each is found by the scan above
KILO_SLICE = ["nerf_tpu_torch/ops/kilonerf.py", "nerf_tpu_torch/train/distill.py",
              "nerf_tpu_torch/train/optim.py", "nerf_tpu_torch/train/checkpoint.py",
              "nerf_tpu_torch/distill_kilonerf.py", "nerf_tpu_torch/bench.py",
              "nerf_tpu_torch/ess_ert.py", "nerf_tpu_torch/quick_ess_ert.py",
              "nerf_tpu_torch/performance_test.py", "nerf_tpu_torch/run.py",
              "nerf_tpu_torch/serve.py", "nerf_tpu_torch/train/loop.py"]


@pytest.mark.parametrize("path", KILO_SLICE)
def test_the_kilonerf_and_harness_slice_is_scanned(path):
    assert path in FILES
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]


# the data- and expert-parallel slice's modules: each is found by the scan above
PARALLEL_SLICE = ["nerf_tpu_torch/parallel/__init__.py", "nerf_tpu_torch/parallel/multihost.py",
                  "nerf_tpu_torch/parallel/mesh.py", "nerf_tpu_torch/parallel/train_step.py",
                  "nerf_tpu_torch/parallel/kilonerf_ep.py", "nerf_tpu_torch/parallel/dryrun.py",
                  "nerf_tpu_torch/bench_scaling.py", "nerf_tpu_torch/train/__main__.py",
                  "nerf_tpu_torch/render/sampling.py", "nerf_tpu_torch/render/composite.py"]


@pytest.mark.parametrize("path", PARALLEL_SLICE)
def test_the_parallel_slice_is_scanned(path):
    assert path in FILES
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]


# the breadth slice's modules (encoders, dynamic models, img_fit, losses,
# light stage): each is found by the scan above
BREADTH_SLICE = ["nerf_tpu_torch/models/encoders.py", "nerf_tpu_torch/models/triplane.py",
                 "nerf_tpu_torch/models/dnerf.py", "nerf_tpu_torch/models/hash_variants.py",
                 "nerf_tpu_torch/models/img_fit.py", "nerf_tpu_torch/data/img_fit.py",
                 "nerf_tpu_torch/data/latent.py", "nerf_tpu_torch/data/light_stage.py",
                 "nerf_tpu_torch/train/img_fit_loop.py", "nerf_tpu_torch/train/losses.py",
                 "nerf_tpu_torch/utils/vis_utils.py", "nerf_tpu_torch/utils/remap.py",
                 "nerf_tpu_torch/ops/precision.py"]


@pytest.mark.parametrize("path", BREADTH_SLICE)
def test_the_breadth_slice_is_scanned(path):
    assert path in FILES
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]


# the slice of the native loader, mesh extraction, reference checkpoints and
# COLMAP, with their CLIs: each is found by the scan above
TOOLS_SLICE = ["nerf_tpu_torch/native/__init__.py", "nerf_tpu_torch/utils/mesh.py",
               "nerf_tpu_torch/utils/torch_port.py", "nerf_tpu_torch/utils/colmap.py",
               "nerf_tpu_torch/utils/colmap_database.py",
               "nerf_tpu_torch/utils/colmap_export.py", "nerf_tpu_torch/extract_mesh.py",
               "nerf_tpu_torch/port_torch_checkpoint.py", "nerf_tpu_torch/colmap2nerf.py"]


@pytest.mark.parametrize("path", TOOLS_SLICE)
def test_the_loader_mesh_checkpoint_and_colmap_slice_is_scanned(path):
    assert path in FILES
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]


# the helpers' slice (data, image, mask and ray utilities, the profiling
# hooks, the config's exp-name rules): each is found by the scan above
HELPERS_SLICE = ["nerf_tpu_torch/utils/data_utils.py", "nerf_tpu_torch/utils/img_utils.py",
                 "nerf_tpu_torch/utils/mask_utils.py", "nerf_tpu_torch/utils/ray_utils.py",
                 "nerf_tpu_torch/utils/profiling.py", "nerf_tpu_torch/config.py",
                 "nerf_tpu_torch/data/samplers.py"]


@pytest.mark.parametrize("path", HELPERS_SLICE)
def test_the_helpers_slice_is_scanned(path):
    assert path in FILES
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]


# image libraries: installed here, partly on the card's machine (cv2 and PIL,
# not imageio, not matplotlib); a module that tried one would run another
# path where it is missing, so the data, model and helper modules use the
# port's own codec, remap, resizes, polygon fill and colour map
IMAGE_LIBS = ("cv2", "imageio", "PIL", "matplotlib")
IMAGE_FREE = sorted(f for f in FILES if f.startswith(("nerf_tpu_torch/data/",
                                                      "nerf_tpu_torch/models/"))) + [
    "nerf_tpu_torch/train/img_fit_loop.py", "nerf_tpu_torch/utils/remap.py",
    "nerf_tpu_torch/utils/vis_utils.py", "nerf_tpu_torch/utils/png.py",
    "nerf_tpu_torch/native/__init__.py", "nerf_tpu_torch/utils/mesh.py",
    "nerf_tpu_torch/utils/torch_port.py", "nerf_tpu_torch/utils/data_utils.py",
    "nerf_tpu_torch/utils/img_utils.py", "nerf_tpu_torch/utils/mask_utils.py",
    "nerf_tpu_torch/utils/ray_utils.py"] + sorted(
    f for f in FILES if f.startswith("nerf_tpu_torch/utils/colmap"))


@pytest.mark.parametrize("path", IMAGE_FREE)
def test_data_and_model_modules_import_no_image_library(path):
    assert "nerf_tpu_torch/data/light_stage.py" in IMAGE_FREE
    assert "nerf_tpu_torch/utils/colmap_export.py" in IMAGE_FREE
    assert "nerf_tpu_torch/utils/img_utils.py" in IMAGE_FREE and "matplotlib" in IMAGE_LIBS
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in IMAGE_LIBS]
    assert not bad, f"{path} imports {bad}"


CSRC = sorted(f for f in os.listdir(os.path.join(ROOT, "nerf_tpu_torch", "csrc"))
              if f.endswith((".cu", ".cuh")))


@pytest.mark.parametrize("name", CSRC)
def test_kernel_sources_include_no_pytorch_header(name):
    """Each CUDA source builds with plain nvcc in seconds: no PyTorch header."""
    text = open(os.path.join(ROOT, "nerf_tpu_torch", "csrc", name)).read()
    assert "fused_mlp_f32.cuh" in CSRC and "fused_mlp_bwd_f32.cu" in CSRC
    for header in ("torch/", "ATen/", "c10/", "pybind11"):
        assert f"#include <{header}" not in text, header
