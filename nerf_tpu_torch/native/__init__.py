"""Native (C++) image loading, built with g++ on first use and bound with ctypes.

The port's copy of ``nerf_tpu/native``: ``loader.cpp`` decodes PNG
(libpng) and JPEG (libjpeg) frames in a thread pool. It is built at first
use into ``build/nerf_tpu_torch/`` at the root of the checkout (ignored by
git), named by a hash of the source and flags, as ``ops/build.py`` builds
the CUDA kernels. A build that fails for want of headers or libraries
leaves ``<name>.unavailable`` beside it, holding the reason, and later
processes read that instead of running g++ again (delete it once the
libpng/libjpeg development files are installed; a changed source or flag
set has another name and is tried anew).

- ``load_images(paths, H, W, white_bkgd)``: [N, H, W, 3] float32 in [0, 1],
  composited on white and resized bilinearly (the JAX package's contract).
- ``decode(path)``: one image's 8-bit samples as stored, [H, W] (gray) or
  [H, W, C] uint8, as ``imageio.imread`` returns an 8-bit file. 16-bit PNG
  samples keep their high byte (libpng's ``png_set_strip_16``), where
  imageio returns uint16.
- ``read_image(path)``: ``decode`` where the library builds; otherwise an
  8-bit PNG goes through ``utils/png.py`` after one warning that names what
  is missing, and any other file raises ``ValueError`` naming it.

A missing file raises ``FileNotFoundError`` and one that cannot be decoded
``ValueError``, each naming it; nothing returns None.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.png import read_png

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]
LINK_FLAGS = ["-lpng", "-ljpeg", "-lpthread"]
BUILD_TIMEOUT_S = 120


class LoaderUnavailable(RuntimeError):
    """The native library could not be built or loaded; the message says why."""


class _State:
    """The loaded library, or why there is none (one attempt a process)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.reason: Optional[str] = None
        self.warned = False


_state = _State()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"native_loader_{h.hexdigest()[:16]}.so"


def _marker(lib: Path) -> Path:
    """Where a failed build of ``lib`` records why it failed."""
    return lib.with_suffix(".unavailable")


def _missing(log: str) -> str:
    """What a failed g++ run lacked, from its output."""
    headers = sorted(set(re.findall(r"fatal error: ([\w./]+): No such file", log)))
    if headers:
        return "the headers " + ", ".join(headers) + " (libpng and libjpeg development files)"
    libs = sorted(set(re.findall(r"cannot find -l(\w+)", log)))
    if libs:
        return "the libraries " + ", ".join(f"lib{x}" for x in libs)
    return "a working g++ build (" + (log.strip().splitlines() or ["no output"])[-1] + ")"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise LoaderUnavailable("g++ is not on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise LoaderUnavailable(f"g++ took more than {BUILD_TIMEOUT_S} s") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        reason = f"g++ cannot build {SOURCE.name}: it lacks " + _missing(proc.stdout + proc.stderr)
        note = _marker(out).with_suffix(f".{os.getpid()}.tmp")
        note.write_text(reason + "\n")
        os.replace(note, _marker(out))
        raise LoaderUnavailable(reason)
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ntpu_load_images.restype = ctypes.c_int
    lib.ntpu_load_images.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.ntpu_image_dims.restype = ctypes.c_int
    lib.ntpu_image_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.ntpu_decode_u8.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.ntpu_decode_u8.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.ntpu_free.restype = None
    lib.ntpu_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises ``LoaderUnavailable``
    (the first failure's reason, every call) where it cannot be had."""
    with _state.lock:
        if _state.lib is None and _state.reason is None:
            path = lib_path()
            try:
                if not path.exists() and _marker(path).exists():
                    raise LoaderUnavailable(_marker(path).read_text().strip()
                                            + f" (recorded in {_marker(path)})")
                if not path.exists():
                    _build(path)
                try:
                    _state.lib = _bind(ctypes.CDLL(str(path)))
                except OSError:  # built elsewhere against libraries not here
                    _build(path)
                    _state.lib = _bind(ctypes.CDLL(str(path)))
            except (LoaderUnavailable, OSError) as e:
                _state.reason = str(e)
        if _state.lib is None:
            raise LoaderUnavailable(f"the native image loader is unavailable: {_state.reason}")
        return _state.lib


def unavailable_reason() -> Optional[str]:
    """Why the library cannot be had, or None where it can."""
    try:
        get_lib()
        return None
    except LoaderUnavailable as e:
        return str(e)


def _exist(paths: Sequence[str]) -> None:
    for p in paths:
        if not os.path.isfile(p):
            raise FileNotFoundError(f"no image at {p}")


def image_dims(path: str) -> Tuple[int, int]:
    dims = (ctypes.c_int * 2)()
    if get_lib().ntpu_image_dims(os.fsencode(path), dims) != 0:
        raise ValueError(f"cannot decode {path} (not a readable PNG or JPEG)")
    return int(dims[0]), int(dims[1])


def load_images(paths: Sequence[str], H: int = 0, W: int = 0, white_bkgd: bool = True,
                n_threads: int = 0) -> np.ndarray:
    """Decode ``paths`` -> [N, H, W, 3] float32 in [0, 1] (H, W = 0: the first
    image's size), RGBA composited as rgb * a + (1 - a) when ``white_bkgd``.
    Raises ``ValueError`` naming the first file that does not decode."""
    lib = get_lib()
    paths = list(paths)
    _exist(paths)
    if not paths:
        return np.zeros((0, H, W, 3), np.float32)
    if H == 0 or W == 0:
        H, W = image_dims(paths[0])
    out = np.empty((len(paths), H, W, 3), np.float32)
    names = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * len(names))(*names)
    rc = lib.ntpu_load_images(arr, len(paths), H, W, int(white_bkgd),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc != 0:
        raise ValueError(f"cannot decode {paths[rc - 1]} (not a readable PNG or JPEG)")
    return out


def decode(path: str) -> np.ndarray:
    """One PNG or JPEG -> its 8-bit samples as stored: [H, W] uint8 (gray) or
    [H, W, C] (C = 2 gray+alpha, 3 RGB, 4 RGBA; a palette expands to RGB, or
    RGBA with transparency). Raises ``ValueError`` naming the file."""
    lib = get_lib()
    _exist([path])
    dims = (ctypes.c_int * 3)()
    ptr = lib.ntpu_decode_u8(os.fsencode(path), dims)
    if not ptr:
        raise ValueError(f"cannot decode {path} (not a readable PNG or JPEG)")
    try:
        h, w, c = (int(d) for d in dims)
        img = np.ctypeslib.as_array(ptr, shape=(h, w, c)).copy()
    finally:
        lib.ntpu_free(ptr)
    return img[..., 0] if c == 1 else img


def read_image(path: str) -> np.ndarray:
    """``decode(path)`` where the library can be had. Without it, an 8-bit
    PNG is read by ``utils/png.py`` (one warning a process names what is
    missing) and any other file raises ``ValueError`` naming it."""
    try:
        get_lib()
    except LoaderUnavailable as e:
        warn_fallback(str(e))
        try:
            return read_png(path)
        except ValueError as err:
            raise ValueError(f"cannot read {path}: {err}; without the native loader only "
                             f"8-bit PNGs are read ({e})") from err
    return decode(path)


def warn_fallback(reason: str) -> None:
    """One warning a process that frames are read by ``utils/png.py``."""
    with _state.lock:
        if _state.warned:
            return
        _state.warned = True
    warnings.warn(f"{reason}; 8-bit PNGs are read with nerf_tpu_torch/utils/png.py and "
                  "other formats raise", RuntimeWarning, stacklevel=3)
