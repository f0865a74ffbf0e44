"""The port's native image loader (``nerf_tpu_torch/native``) on the CPU.

- ``tests/test_native_loader.py``'s cases against the port's copy: RGBA on
  white, RGB, the bilinear resize against ``F.interpolate``, 16 frames over
  8 threads (1e-6, as there); a missing file raises and names it (the JAX
  package's copy returns None).
- The port's copy against the JAX package's (``nerf_tpu.native`` as it
  stands) on the same files: 1e-6 (the JAX build multiplies by 1/255 and
  may fuse multiply-adds; the port divides, as numpy does).
- Formats against ``imageio.imread`` on files imageio (Pillow) writes in
  the test: 8-bit PNGs of every colour type, palette PNGs with and without
  transparency, and an Adam7-interlaced PNG written here: equal. JPEGs
  (RGB and gray): within 1 of 255 (two libjpeg builds may round the IDCT
  differently; where the two builds match they agree exactly). 16-bit PNGs: the port keeps
  each sample's high byte (libpng's ``png_set_strip_16``, as the JAX
  package's native loader): equal to ``value >> 8``, and to imageio's RGB
  and RGBA; imageio returns 16-bit gray as uint16, within 1/255 of the
  port's as value / 65535. Palettes with transparency: imageio's colours,
  and Pillow's alpha.
- A light-stage rig of JPEG frames: the same batches as the JAX loader's
  (which reads them with imageio).
- Without the library: 8-bit PNGs through ``utils/png.py`` after one
  warning naming what is missing; a JPEG, a 16-bit or an interlaced PNG
  raises and names the file.
"""
import os
import struct
import subprocess
import warnings
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from nerf_tpu import native as jax_native
from nerf_tpu.data.light_stage import LightStageDataset as JaxLightStage

from nerf_tpu_torch import native
from nerf_tpu_torch.data import light_stage
from nerf_tpu_torch.data.blender import BlenderDataset, write_blender_scene
from nerf_tpu_torch.data.light_stage import LightStageDataset
from nerf_tpu_torch.utils.png import read_png

ANGLE = 0.6911112070083618


@pytest.fixture(scope="module")
def lib():
    reason = native.unavailable_reason()  # the tests need g++, png.h and jpeglib.h
    if reason is not None:
        pytest.fail(f"the port's native loader does not build: {reason}")
    return native.get_lib()


@pytest.fixture
def no_lib(monkeypatch):
    """The library as it is on a host without g++: unavailable, not yet warned."""
    state = native._State()
    monkeypatch.setattr(native, "_state", state)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR / "absent-for-tests")
    return state


def _composite(img):
    f = img.astype(np.float32) / 255.0
    return f[..., :3] * f[..., 3:] + (1 - f[..., 3:])


# tests/test_native_loader.py's cases, on the port's copy
def test_rgba_white_composite(tmp_path, lib):
    img = np.random.RandomState(0).randint(0, 255, (32, 40, 4), np.uint8)
    p = str(tmp_path / "a.png")
    imageio.imwrite(p, img)
    out = native.load_images([p], white_bkgd=True)
    assert out.shape == (1, 32, 40, 3)
    np.testing.assert_allclose(out[0], _composite(img), atol=1e-6)


def test_rgb_no_alpha(tmp_path, lib):
    img = np.random.RandomState(1).randint(0, 255, (16, 16, 3), np.uint8)
    p = str(tmp_path / "b.png")
    imageio.imwrite(p, img)
    out = native.load_images([p], white_bkgd=True)
    np.testing.assert_allclose(out[0], img.astype(np.float32) / 255.0, atol=1e-6)


def test_resize_matches_torch_bilinear(tmp_path, lib):
    img = np.random.RandomState(2).randint(0, 255, (64, 64, 3), np.uint8)
    p = str(tmp_path / "c.png")
    imageio.imwrite(p, img)
    out = native.load_images([p], H=32, W=32, white_bkgd=True)
    f = torch.from_numpy(img.astype(np.float32) / 255.0)
    want = F.interpolate(f.permute(2, 0, 1)[None], size=(32, 32), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(out[0], want, atol=1e-5)


def test_many_images_threaded(tmp_path, lib):
    rng = np.random.RandomState(3)
    paths, truth = [], []
    for i in range(16):
        img = rng.randint(0, 255, (24, 24, 4), np.uint8)
        p = str(tmp_path / f"t{i}.png")
        imageio.imwrite(p, img)
        paths.append(p)
        truth.append(_composite(img))
    out = native.load_images(paths, white_bkgd=True, n_threads=8)
    np.testing.assert_allclose(out, np.stack(truth), atol=1e-6)


def test_missing_file_raises_and_names_it(tmp_path, lib):
    missing = str(tmp_path / "missing.png")
    for call in (lambda: native.load_images([missing]), lambda: native.decode(missing)):
        with pytest.raises(FileNotFoundError, match="missing.png"):
            call()


def test_a_file_of_another_format_raises_and_names_it(tmp_path, lib):
    p = str(tmp_path / "frame.bmp")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(p)
    with pytest.raises(ValueError, match="frame.bmp"):
        native.decode(p)
    good = str(tmp_path / "good.png")
    imageio.imwrite(good, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="frame.bmp"):  # the first failed frame is named
        native.load_images([good, p, good], H=4, W=4)


def test_blender_dataset_uses_native(tmp_path, lib):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (4, 40, 40, 4), dtype=np.uint8)
    imgs[:, :4, :4, 3] = 0  # transparent corners
    write_blender_scene(str(tmp_path / "lego"), {"val": (imgs, np.stack([np.eye(4)] * 4))},
                        ANGLE)
    ds = BlenderDataset(str(tmp_path), split="val", scene="lego", cams=[0, 4, 1], H=40, W=40)
    assert ds.images.shape == (4, 40, 40, 3) and ds.images.dtype == np.float32
    assert 0.0 <= ds.images.min() and ds.images.max() <= 1.0
    assert ds.images[0, 0, 0].min() > 0.95
    np.testing.assert_array_equal(ds.images, _composite(imgs))


@pytest.mark.parametrize("ratio", [1.0, 0.5])
@pytest.mark.parametrize("white", [True, False])
def test_the_port_s_copy_matches_the_jax_package_s(tmp_path, lib, ratio, white):
    if jax_native.get_lib() is None:
        pytest.fail("the JAX package's native loader does not build here")
    rng = np.random.default_rng(6)
    paths = []
    for i, c in enumerate((4, 3, 4, 2, 1)):
        p = str(tmp_path / f"f{i}.png")
        imageio.imwrite(p, rng.integers(0, 256, (30, 30, c)[:2 + (c > 1)], dtype=np.uint8))
        paths.append(p)
    jpg = str(tmp_path / "f5.jpg")
    imageio.imwrite(jpg, rng.integers(0, 256, (30, 30, 3), dtype=np.uint8))
    paths.append(jpg)
    size = int(30 * ratio)
    got = native.load_images(paths, size, size, white, n_threads=3)
    want = jax_native.load_images(paths, size, size, white, n_threads=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert native.image_dims(jpg) == jax_native.image_dims(jpg) == (30, 30)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_8bit_pngs_decode_as_imageio(tmp_path, lib, channels):
    img = np.random.default_rng(channels).integers(0, 256, (13, 17, channels), dtype=np.uint8)
    img = img[..., 0] if channels == 1 else img
    p = str(tmp_path / "x.png")
    imageio.imwrite(p, img)
    got = native.decode(p)
    np.testing.assert_array_equal(got, imageio.imread(p))
    np.testing.assert_array_equal(got, read_png(p))
    assert got.dtype == np.uint8


@pytest.mark.parametrize("transparency", [False, True])
def test_palette_pngs_decode_as_imageio(tmp_path, lib, transparency):
    """A palette expands to RGB as imageio expands it. With a tRNS chunk the
    port (libpng's tRNS_to_alpha, as the JAX native loader) adds the alpha
    that Pillow's convert("RGBA") gives; imageio 2.37 returns the colours
    alone: equal there."""
    rng = np.random.default_rng(7)
    pal = Image.fromarray(rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)).quantize(16)
    p = str(tmp_path / "pal.png")
    pal.save(p, **({"transparency": bytes([0, 128] + [255] * 14)} if transparency else {}))
    assert Image.open(p).mode == "P"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Pillow's note on byte transparency
        want = imageio.imread(p)
        rgba = np.asarray(Image.open(p).convert("RGBA"))
    got = native.decode(p)
    assert want.shape == (19, 23, 3)
    np.testing.assert_array_equal(got[..., :3], want)
    if transparency:
        np.testing.assert_array_equal(got, rgba)
        assert set(np.unique(got[..., 3])) <= {0, 128, 255} and got[..., 3].min() < 255
    else:
        assert got.shape == want.shape
    with pytest.raises(ValueError):  # the port's own codec reads no palette
        read_png(p)


def _interlaced_png(img):
    """An 8-bit Adam7-interlaced PNG of [H, W, C] uint8, every row filter 0."""
    h, w, c = img.shape
    passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
              (1, 0, 2, 2), (0, 1, 1, 2)]
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        raw += b"".join(b"\x00" + row.tobytes() for row in sub)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_interlaced_pngs_decode_as_imageio(tmp_path, lib, channels):
    img = np.random.default_rng(8).integers(0, 256, (21, 19, channels), dtype=np.uint8)
    p = str(tmp_path / "adam7.png")
    with open(p, "wb") as f:
        f.write(_interlaced_png(img))
    np.testing.assert_array_equal(imageio.imread(p), img)  # the file is what it says
    np.testing.assert_array_equal(native.decode(p), img)
    out = native.load_images([p], white_bkgd=False)
    np.testing.assert_array_equal(out[0], img[..., :3].astype(np.float32) / 255.0)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_16bit_pngs_keep_their_high_byte(tmp_path, lib, channels):
    """Every 16-bit sample becomes its high byte (libpng's strip_16, as the
    JAX native loader). imageio (Pillow) does the same to RGB and RGBA, but
    returns gray as uint16: a known difference (ROADMAP.md), within 1/255 of
    imageio's value / 65535."""
    img = np.random.default_rng(9).integers(0, 65536, (11, 14, channels), dtype=np.uint16)
    p = str(tmp_path / "deep.png")
    if channels == 1:
        img = img[..., 0]
        imageio.imwrite(p, img)
    else:  # Pillow writes no 16-bit colour PNG; cv2 does, in BGR(A) order
        cv2.imwrite(p, img[..., [2, 1, 0, 3][:channels]])
    got, want = native.decode(p), imageio.imread(p)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, (img >> 8).astype(np.uint8))
    if channels == 1:
        assert want.dtype == np.uint16
        np.testing.assert_array_equal(want, img)
        assert np.abs(got / 255.0 - want / 65535.0).max() <= 1 / 255
    else:
        np.testing.assert_array_equal(got, want)
    out = native.load_images([p], white_bkgd=True)[0]
    rgb = np.repeat(got[..., None], 3, -1) if channels == 1 else got
    np.testing.assert_array_equal(out, _composite(rgb) if channels == 4
                                  else rgb[..., :3].astype(np.float32) / 255.0)


@pytest.mark.parametrize("gray", [False, True])
def test_jpegs_decode_as_imageio(tmp_path, lib, gray):
    rng = np.random.default_rng(10)
    yy, xx = np.mgrid[0:48, 0:40]
    img = np.clip(np.stack([xx * 5, yy * 4, xx + yy], -1) + rng.integers(-20, 20, (48, 40, 3)),
                  0, 255).astype(np.uint8)
    img = img[..., 0] if gray else img
    p = str(tmp_path / "frame.jpg")
    imageio.imwrite(p, img, quality=85)
    want, got = imageio.imread(p), native.decode(p)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    out = native.load_images([p], white_bkgd=True)[0]
    rgb = np.repeat(got[..., None], 3, -1) if gray else got
    np.testing.assert_array_equal(out, rgb.astype(np.float32) / 255.0)


@pytest.fixture(scope="module")
def jpeg_rig(tmp_path_factory):
    """write_synthetic_rig's rig with every frame re-encoded as a JPEG (the
    ZJU captures' format); masks stay PNGs."""
    root = str(tmp_path_factory.mktemp("jpeg_rig"))
    light_stage.write_synthetic_rig(root, n_cams=3, n_frames=2, H=48, W=64, seed=11)
    annots = np.load(os.path.join(root, "annots.npy"), allow_pickle=True).item()
    for frame in annots["ims"]:
        for i, rel in enumerate(frame["ims"]):
            src = os.path.join(root, rel)
            jpg = os.path.splitext(rel)[0] + ".jpg"
            imageio.imwrite(os.path.join(root, jpg), imageio.imread(src), quality=90)
            os.remove(src)
            frame["ims"][i] = jpg
    np.save(os.path.join(root, "annots.npy"), annots)
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_a_light_stage_rig_of_jpegs_matches_jax(jpeg_rig, lib, split):
    kw = dict(split=split, n_rays=128, seed=2)
    got, want = LightStageDataset(jpeg_rig, **kw), JaxLightStage(jpeg_rig, **kw)
    assert len(got) == len(want) == 6
    assert got.items[0]["img_path"].endswith(".jpg")
    for i in (0, 4, 2):
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g["rays"], w["rays"])
        # the undistortion is cv2's to the last bit (test_torch_light_stage.py),
        # and the decoded JPEG is imageio's here
        np.testing.assert_array_equal(g["rgb"], w["rgb"])


def test_without_the_library_pngs_fall_back_with_one_warning(tmp_path, no_lib):
    img = np.random.default_rng(12).integers(0, 256, (9, 7, 3), dtype=np.uint8)
    p = str(tmp_path / "ok.png")
    imageio.imwrite(p, img)
    assert "g++ is not on PATH" in native.unavailable_reason()
    with pytest.warns(RuntimeWarning, match="g\\+\\+ is not on PATH"):
        np.testing.assert_array_equal(native.read_image(p), img)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one warning a process
        np.testing.assert_array_equal(native.read_image(p), img)
    with pytest.raises(native.LoaderUnavailable):
        native.decode(p)


def test_without_the_library_other_formats_raise_and_name_the_file(tmp_path, no_lib):
    jpg = str(tmp_path / "cam00.jpg")
    imageio.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    deep = str(tmp_path / "deep.png")
    imageio.imwrite(deep, np.zeros((8, 8), np.uint16))
    adam7 = str(tmp_path / "adam7.png")
    with open(adam7, "wb") as f:
        f.write(_interlaced_png(np.zeros((8, 8, 3), np.uint8)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for path in (jpg, deep, adam7):
            with pytest.raises(ValueError, match=os.path.basename(path)):
                native.read_image(path)


def test_without_the_library_the_blender_loader_reads_pngs_and_names_a_bad_one(
        tmp_path, no_lib):
    imgs = np.random.default_rng(13).integers(0, 256, (2, 6, 6, 4), dtype=np.uint8)
    write_blender_scene(str(tmp_path / "lego"), {"train": (imgs, np.stack([np.eye(4)] * 2))},
                        ANGLE)
    with pytest.warns(RuntimeWarning, match="utils/png.py"):
        ds = BlenderDataset(str(tmp_path), split="train", H=6, W=6)
    np.testing.assert_array_equal(ds.images, _composite(imgs))
    imageio.imwrite(str(tmp_path / "lego" / "train" / "r_1.png"), np.zeros((6, 6), np.uint16))
    with pytest.raises(ValueError, match="r_1.png"):
        BlenderDataset(str(tmp_path), split="train", H=6, W=6)


def test_a_failed_build_names_what_is_missing():
    log = ("loader.cpp:40:10: fatal error: png.h: No such file or directory\n"
           "compilation terminated.\n")
    assert "png.h" in native._missing(log)
    assert "libjpeg" in native._missing("/usr/bin/ld: cannot find -ljpeg: No such file")


def test_a_failed_build_is_recorded_and_not_tried_again(tmp_path, monkeypatch):
    """A build that lacks headers leaves <lib>.unavailable with the reason;
    the next process reads it and runs no g++; other flags are tried anew."""
    runs = []

    def failing_gxx(cmd, **kw):
        runs.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 1, "", "loader.cpp:40:10: fatal error: png.h: No such file or directory\n")

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: "/usr/bin/g++")
    monkeypatch.setattr(native.subprocess, "run", failing_gxx)
    for process in range(2):
        monkeypatch.setattr(native, "_state", native._State())
        reason = native.unavailable_reason()
        assert "png.h" in reason and len(runs) == 1
    marker = native.lib_path().with_suffix(".unavailable")
    assert "png.h" in marker.read_text() and "recorded in" in reason
    assert not native.lib_path().exists() and not list(tmp_path.glob("*.tmp"))
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ["-DOTHER"])
    monkeypatch.setattr(native, "_state", native._State())
    assert "png.h" in native.unavailable_reason() and len(runs) == 2


def _blender_images(root, decoder, monkeypatch, **kw):
    """BlenderDataset(root, split="val", **kw).images, its frames decoded by
    the native library or, as on a host that cannot build it, by utils/png.py."""
    if decoder == "png":
        monkeypatch.setattr(native, "_state", native._State())
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR / "absent-for-tests")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return BlenderDataset(root, split="val", **kw).images


@pytest.mark.parametrize("decoder", ["native", "png"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_both_blender_paths_read_every_colour_type_alike(tmp_path, lib, monkeypatch, decoder,
                                                         channels):
    """The Blender loader's two decoders (the native library; utils/png.py
    where it cannot be built) at input_ratio 1: the frames composited on
    white bit for bit, for gray, gray+alpha, RGB and RGBA frames."""
    imgs = np.random.default_rng(14).integers(0, 256, (2, 9, 11, channels), dtype=np.uint8)
    write_blender_scene(str(tmp_path / "lego"), {"val": (imgs, np.stack([np.eye(4)] * 2))},
                        ANGLE)
    got = _blender_images(str(tmp_path), decoder, monkeypatch, H=9, W=11)
    f = imgs.astype(np.float32) / 255
    rgb, alpha = (f[..., :-1], f[..., -1:]) if channels in (2, 4) else (f, None)
    want = rgb * alpha + (1 - alpha) if alpha is not None else rgb
    np.testing.assert_array_equal(got, np.broadcast_to(want, (2, 9, 11, 3)))


@pytest.mark.parametrize("white", [True, False])
def test_the_blender_images_do_not_depend_on_the_decoder(tmp_path, lib, monkeypatch, white):
    """At input_ratio 0.5 (lego_400_coarse's) the native and the PNG-codec
    paths give the same images bit for bit: both decode the same uint8
    frame, composite it, then resize it."""
    imgs = np.random.default_rng(15).integers(0, 256, (3, 16, 12, 4), dtype=np.uint8)
    imgs[:, :3, :3, 3] = 0
    write_blender_scene(str(tmp_path / "lego"), {"val": (imgs, np.stack([np.eye(4)] * 3))},
                        ANGLE)
    kw = dict(H=16, W=12, input_ratio=0.5, white_bkgd=white)
    native_images = _blender_images(str(tmp_path), "native", monkeypatch, **kw)
    png_images = _blender_images(str(tmp_path), "png", monkeypatch, **kw)
    assert native_images.shape == (3, 8, 6, 3)
    np.testing.assert_array_equal(native_images, png_images)
