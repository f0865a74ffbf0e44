"""nerf_tpu_torch's PNG codec against imageio (the JAX package's reader) and a
per-pixel reading of the PNG spec.

Every comparison is exact: decoding is integer arithmetic mod 256. Inputs
come from numpy.random.default_rng, with flat patches so that the filters'
predictors see equal neighbours (Paeth's ties) as well as noise.
"""
import io
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from nerf_tpu_torch.utils import png

FILTERS = [0, 1, 2, 3, 4, "mixed"]


def _image(c, h=29, w=41, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[4:15, 6:30] = rng.integers(0, 256, c, dtype=np.uint8)  # a flat patch
    img[20:, :8] = 255
    return img if c > 1 else img[..., 0]


def _filters(f, h):
    return np.random.default_rng(1).integers(0, 5, h) if f == "mixed" else f


def _chunks(data):
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def _assemble(chunks):
    return png.SIGNATURE + b"".join(png._chunk(tag, body) for tag, body in chunks)


@pytest.mark.parametrize("f", FILTERS)
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_decode_equals_imageio_on_the_ports_encoder(c, f):
    img = _image(c)
    data = png.encode_png(img, _filters(f, img.shape[0]))
    got, want = png.decode_png(data), imageio.imread(io.BytesIO(data))
    assert got.shape == want.shape == img.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_decode_equals_imageio_on_imageio_files(c):
    buf = io.BytesIO()
    imageio.imwrite(buf, _image(c, seed=c), format="png")
    data = buf.getvalue()
    np.testing.assert_array_equal(png.decode_png(data), imageio.imread(io.BytesIO(data)))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_decode_equals_imageio_on_cv2_files(c):
    ok, enc = cv2.imencode(".png", _image(c, seed=10 + c))
    assert ok
    data = enc.tobytes()
    np.testing.assert_array_equal(png.decode_png(data), imageio.imread(io.BytesIO(data)))


def test_several_idat_chunks():
    img = _image(4, 64, 70)
    chunks = _chunks(png.encode_png(img, 4))
    idat = b"".join(body for tag, body in chunks if tag == b"IDAT")
    split = [(b"IDAT", idat[i:i + 97]) for i in range(0, len(idat), 97)]
    data = _assemble([chunks[0], *split, chunks[-1]])
    assert len(split) > 10
    np.testing.assert_array_equal(png.decode_png(data), imageio.imread(io.BytesIO(data)))
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_sixteen_bit_raises():
    ok, enc = cv2.imencode(".png", np.full((5, 6, 3), 40000, np.uint16))
    assert ok
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode_png(enc.tobytes())


def test_interlaced_raises():
    chunks = _chunks(png.encode_png(_image(3)))
    w, h, depth, color, comp, filt, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    chunks[0] = (b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, comp, filt, 1))
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(_assemble(chunks))


def test_palette_raises():
    buf = io.BytesIO()
    Image.fromarray(_image(3)).convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="palette"):
        png.decode_png(buf.getvalue())


def test_bad_crc_and_bad_filter_raise():
    data = bytearray(png.encode_png(_image(3)))
    data[40] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    rows = png.filter_rows(_image(3), np.zeros(29, np.int64))
    rows[3, 0] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        png.unfilter(rows, 3)


def _unfilter_by_the_spec(rows, bpp):
    """PNG spec 9.2-9.4, one byte at a time."""
    h, n = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, n), np.int64)
    for r in range(h):
        ft = int(rows[r, 0])
        for i in range(n):
            x = int(rows[r, 1 + i])
            a = int(out[r, i - bpp]) if i >= bpp else 0
            b = int(out[r - 1, i]) if r > 0 else 0
            c = int(out[r - 1, i - bpp]) if r > 0 and i >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[r, i] = (x + pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_unfilter_equals_the_spec_byte_for_byte(c):
    """Filtered bytes that are pure noise (not the filter of any image), so
    every predictor branch and every wrap-around mod 256 is taken."""
    rng = np.random.default_rng(c)
    h, w = 9, 13
    rows = rng.integers(0, 256, (h, 1 + w * c), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h)
    got = png.unfilter(rows, c)
    np.testing.assert_array_equal(got.reshape(h, w * c), _unfilter_by_the_spec(rows, c))


def test_encode_rejects_what_png_cannot_hold():
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="1-4 channels"):
        png.encode_png(np.zeros((2, 2, 5), np.uint8))
    with pytest.raises(ValueError, match="0-4"):
        png.encode_png(np.zeros((2, 2, 3), np.uint8), 5)


def test_serve_keeps_the_codec():
    from nerf_tpu_torch import serve

    assert serve.encode_png is png.encode_png and serve.decode_png is png.decode_png
    img = _image(3)
    rows = np.concatenate([np.zeros((img.shape[0], 1), np.uint8),
                           img.reshape(img.shape[0], -1)], axis=1)
    idat = [body for tag, body in _chunks(png.encode_png(img)) if tag == b"IDAT"]
    assert zlib.decompress(b"".join(idat)) == rows.tobytes()  # filter 0 by default
