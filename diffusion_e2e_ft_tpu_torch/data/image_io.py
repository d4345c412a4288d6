"""Image files without PIL or cv2: a PNG codec in numpy and the standard
library's `zlib`, and `decode_image`, which sniffs the format.

The port's counterpart of the PIL and cv2 calls of the JAX package's readers
and CLIs (the H100 host has neither). PNG: 8-bit gray, gray+alpha, RGB and
RGBA, 16-bit gray and RGB (and gray+alpha, RGBA), non-interlaced, all five
row filters; palette, sub-byte and interlaced files raise, naming what they
are. `decode_image` decodes a PNG through `native_io` (libpng) when that
built on this host, else through the numpy codec, and a JPEG through
`native_io` only; any other format raises. No decoder returns a blank image
for a file it cannot read.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from diffusion_e2e_ft_tpu_torch import native_io

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_COLOR_TYPES = {c: t for t, c in _CHANNELS.items()}
_FORMATS = {  # leading bytes -> name, for the error of an unsupported format
    b"BM": "BMP", b"GIF8": "GIF", b"RIFF": "RIFF (WebP)", b"II*\x00": "TIFF", b"MM\x00*": "TIFF",
    b"\x76\x2f\x31\x01": "OpenEXR", b"\x93NUMPY": "npy",
}


class ImageFormatError(ValueError):
    """A file this module cannot decode; the message names what it is."""


def format_name(buf: bytes) -> str:
    if buf[:8] == PNG_SIGNATURE:
        return "PNG"
    if buf[:2] == JPEG_SIGNATURE:
        return "JPEG"
    for magic, name in _FORMATS.items():
        if buf.startswith(magic):
            return name
    return f"unknown (leading bytes {buf[:8]!r})"


# ---------------------------------------------------------------------------
# PNG decode
# ---------------------------------------------------------------------------


def _chunks(buf: bytes):
    pos = 8
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos : pos + 8])
        data = buf[pos + 8 : pos + 8 + length]
        if len(data) != length:
            raise ImageFormatError(f"PNG chunk {kind!r} truncated")
        (crc,) = struct.unpack(">I", buf[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + data) != crc:
            raise ImageFormatError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, data
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ImageFormatError("PNG ends without an IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays (PNG spec 9.4)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filters: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of `rows` [H, stride] uint8 (filter bytes apart),
    `bpp` bytes a pixel. Images whose rows are all None, Sub or Up go row by
    row, each row vectorised. Average and Paeth depend on the decoded pixel
    to the left, so an image with such rows goes along its anti-diagonals:
    pixel (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1), all on earlier
    diagonals, so each of the H + W - 1 steps decodes one diagonal's pixels
    at once, across rows and channels, with each row's own filter."""
    h, stride = rows.shape
    w = stride // bpp
    if not np.isin(filters, (0, 1, 2, 3, 4)).all():
        raise ImageFormatError(f"PNG row filter types {sorted(set(filters.tolist()) - {0, 1, 2, 3, 4})} invalid")
    if filters.max(initial=0) <= 2:
        out = np.empty_like(rows)
        prev = np.zeros(stride, np.uint8)
        for y in range(h):
            line, f = rows[y], filters[y]
            if f == 0:
                out[y] = line
            elif f == 1:
                out[y] = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
            else:
                out[y] = line + prev
            prev = out[y]
        return out
    raw = rows.reshape(h, w, bpp).astype(np.int16)
    out = np.zeros((h + 1, w + 1, bpp), np.int16)  # a zero row above and a zero column to the left
    kind = filters.astype(np.int16)[:, None]
    for t in range(h + w - 1):
        y = np.arange(max(0, t - w + 1), min(h, t + 1))
        x = t - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        k = kind[y]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(k == 3, (a + b) >> 1,
                        np.where(k == 4, _paeth(a, b, c), 0))))
        out[y + 1, x + 1] = (raw[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png_numpy(buf: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] or [H, W, C] uint8 / uint16 (host byte order)."""
    if buf[:8] != PNG_SIGNATURE:
        raise ImageFormatError(f"not a PNG: {format_name(buf)}")
    header, idat = None, []
    for kind, data in _chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ImageFormatError("PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color == 3:
        raise ImageFormatError("palette PNG (colour type 3) is not supported")
    if color not in _CHANNELS:
        raise ImageFormatError(f"PNG colour type {color} is invalid")
    if depth not in (8, 16):
        raise ImageFormatError(f"{depth}-bit PNG is not supported (8 or 16 bits a sample)")
    if interlace:
        raise ImageFormatError("interlaced (Adam7) PNG is not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if data.size != height * (stride + 1):
        raise ImageFormatError(f"PNG image data holds {data.size} bytes, expected {height * (stride + 1)}")
    data = data.reshape(height, stride + 1)
    pixels = _unfilter(data[:, 0], data[:, 1:], bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape)


# ---------------------------------------------------------------------------
# PNG encode
# ---------------------------------------------------------------------------


def _filter_rows(pixels: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Apply one filter type to every row of `pixels` [H, stride] uint8."""
    if filter_type == 0:
        return pixels
    x = pixels.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if filter_type == 4:
        up_left = np.zeros_like(x)
        up_left[1:, bpp:] = x[:-1, :-bpp]
        pred = _paeth(left, up, up_left)
    else:
        pred = {1: left, 2: up, 3: (left + up) >> 1}[filter_type]
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(array: np.ndarray, filter_type: int = 0) -> bytes:
    """[H, W] or [H, W, C] uint8 / uint16 -> PNG bytes, every row with
    `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    a = np.asarray(array)
    if a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write a PNG from uint8 or uint16, not {a.dtype}")
    if filter_type not in (0, 1, 2, 3, 4):
        raise ValueError(f"PNG filter type {filter_type} invalid (0-4)")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"write a PNG from [H, W] or [H, W, 1-4], not {np.asarray(array).shape}")
    h, w, c = a.shape
    depth = 8 * a.dtype.itemsize
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).view(np.uint8).reshape(h, -1)
    filtered = _filter_rows(rows, c * a.dtype.itemsize, filter_type)
    payload = np.concatenate([np.full((h, 1), filter_type, np.uint8), filtered], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPES[c], 0, 0, 0)
    return PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(payload)) + chunk(b"IEND", b"")


def write_png(path: str, array: np.ndarray, filter_type: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(array, filter_type))


# ---------------------------------------------------------------------------
# Any image
# ---------------------------------------------------------------------------


def png_decoder() -> str:
    """Which PNG decoder `decode_image` uses on this host: "native_io"
    (libpng, when `native_io` built) or "numpy"."""
    return "native_io" if native_io.available() else "numpy"


def decode_image(buf: bytes, decoder: Optional[str] = None) -> np.ndarray:
    """Image bytes -> [H, W] or [H, W, C] uint8 / uint16. PNG through
    `decoder` ("native_io" or "numpy"; default `png_decoder()`), JPEG
    through `native_io` (raises with g++'s message where it did not build);
    any other format raises, naming it."""
    kind = format_name(buf)
    if kind == "PNG":
        if (decoder or png_decoder()) == "native_io":
            return native_io.decode_png(buf)
        return decode_png_numpy(buf)
    if kind == "JPEG":
        if not native_io.available():
            raise ImageFormatError(f"JPEG needs native_io (libjpeg), which did not build: {native_io.build_error()}")
        return native_io.decode_jpeg(buf)
    raise ImageFormatError(f"cannot decode {kind} (PNG and JPEG only)")


def read_image(path: str, decoder: Optional[str] = None) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read(), decoder)
