"""Image I/O: PNG (8-bit sRGB) and PFM (float), plus EXR/TGA errors.

Mirrors /root/reference/src/core/imageio.rs semantics exactly:

* PNG write quantizes with ``to_byte = clamp(255*gamma_correct(v)+0.5, 0, 255)``
  (imageio.rs:66-68); PNG read maps 8-bit RGB to [0,1] *without* degamma
  (imageio.rs:163-173) so write-then-read equals ``to_byte(v)/255``
  (roundtrip test imageio.rs:325-360).
* PFM: header "PF"/"Pf", scale sign encodes endianness, rows stored
  bottom-up (imageio.rs:87-138, 186-213).
* ``write_image`` writes only the ``output_bounds`` crop (imageio.rs:235-236).
"""

from __future__ import annotations

import struct
import sys
import zlib
from pathlib import Path

import numpy as np

from pbrt_tpu import float_t, gamma_correct
from pbrt_tpu.core.geometry import Bounds2i


class ImageIOError(ValueError):
    pass


def to_byte(v):
    """Gamma-correct float -> byte (imageio.rs:66-68), vectorized."""
    return np.clip(255.0 * gamma_correct(np.asarray(v, dtype=float_t)) + 0.5, 0.0, 255.0).astype(
        np.uint8
    )


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels per PNG colour type: grey, RGB, grey+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _write_png(name: str, rgb8: np.ndarray) -> None:
    """8-bit RGB PNG: filter 0 on every row, one zlib stream."""
    h, w, _ = rgb8.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1
    )
    with open(name, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (PNG spec §9)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 1 or ftype == 3 or ftype == 4:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b = prev[x]
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 0:
            cur = line
        else:
            raise ImageIOError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _read_png(name: str) -> np.ndarray:
    """8-bit, non-interlaced PNG -> [H, W, 3] uint8 RGB (alpha dropped,
    grey expanded)."""
    data = Path(name).read_bytes()
    if not data.startswith(_PNG_SIG):
        raise ImageIOError(f"{name}: not a PNG file")
    pos = len(_PNG_SIG)
    idat = []
    hdr = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ImageIOError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ImageIOError(
            f"{name}: only 8-bit non-interlaced grey/RGB(A) PNG is supported"
        )
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ch < 3:
        return np.repeat(px[..., :1], 3, axis=-1)
    return px[..., :3]


def _read_pfm(name: str):
    with open(name, "rb") as f:
        data = f.read()

    pos = 0

    def read_word():
        nonlocal pos
        start = pos
        while pos < len(data) and data[pos : pos + 1] not in (b" ", b"\n", b"\t"):
            pos += 1
        word = data[start:pos].decode("ascii")
        pos += 1  # consume single whitespace
        return word

    hdr = read_word()
    if hdr == "PF":
        n_channels = 3
    elif hdr == "Pf":
        n_channels = 1
    else:
        raise ImageIOError(f"invalid PFM header {hdr!r}")
    width = int(read_word())
    height = int(read_word())
    scale = float(read_word())
    n_floats = n_channels * width * height
    dt = np.dtype("<f4") if scale < 0 else np.dtype(">f4")
    raw = np.frombuffer(data[pos : pos + 4 * n_floats], dtype=dt).astype(np.float64)
    raw = raw * abs(scale) if abs(scale) != 1.0 else raw
    img = raw.reshape(height, width, n_channels)[::-1]  # rows bottom-up
    if n_channels == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(float_t), (width, height)


def read_image(name: str):
    """Read image -> ([H, W, 3] float RGB in [0,1]-ish, (width, height)).

    PNG bytes are divided by 255 with no degamma (imageio.rs:163-173).
    """
    ext = Path(name).suffix.lower()
    if ext == ".png":
        arr = _read_png(name).astype(float_t) / float_t(255.0)
        return arr, (arr.shape[1], arr.shape[0])
    if ext == ".pfm":
        return _read_pfm(name)
    if ext in (".exr", ".tga"):
        raise ImageIOError(f"reading '{ext}' files is not yet implemented")
    raise ImageIOError(f"unknown extension '{ext}'")


def _write_pfm(name: str, rgb: np.ndarray, width: int, height: int) -> None:
    host_le = sys.byteorder == "little"
    scale = -1.0 if host_le else 1.0
    with open(name, "wb") as f:
        f.write(f"PF\n{width} {height}\n{scale}\n".encode("ascii"))
        img = np.asarray(rgb, dtype=np.float32).reshape(height, width, 3)
        # bottom-up rows per netpbm PFM spec (imageio.rs:198-209)
        f.write(img[::-1].astype("<f4" if host_le else ">f4").tobytes())


def write_image(name: str, rgb, output_bounds: Bounds2i, total_resolution=None) -> None:
    """Write cropped RGB data; format chosen by extension (imageio.rs:235-283).

    ``rgb`` is flat [w*h*3] or [h, w, 3] covering ``output_bounds``.
    """
    w, h = output_bounds.diagonal()
    rgb = np.asarray(rgb, dtype=float_t).reshape(h, w, 3)
    ext = Path(name).suffix.lower()
    if ext == ".png":
        _write_png(name, to_byte(rgb))
    elif ext == ".pfm":
        _write_pfm(name, rgb, w, h)
    elif ext in (".exr", ".tga"):
        raise ImageIOError(f"writing '{ext}' files is not implemented")
    else:
        raise ImageIOError(f"unknown file extension {ext}")
