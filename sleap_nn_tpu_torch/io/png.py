"""PNG encode and decode on ``zlib``, for the frames a ``.slp`` file embeds.

The JAX package calls ``cv2.imencode`` / ``cv2.imdecode`` there
(``sleap_nn_tpu/io/slp.py``, ``io/video.py``); the port must not need
cv2. Only what embedded frames use is covered: 8-bit grayscale and RGB,
not interlaced. The encoder writes every row with filter type 0 (none);
the decoder undoes all five filter types, since libpng (behind cv2)
chooses a filter per row. Pixels are stored in RGB order, as
``cv2.imencode`` stores a BGR array: the JAX package flips its RGB frames
to BGR before encoding and back after decoding, so either package reads
the other's frames to the same pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}  # channels -> PNG color type (gray, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """A uint8 ``(H, W)``, ``(H, W, 1)`` or RGB ``(H, W, 3)`` image -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encoding takes uint8 frames, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"PNG encoding takes 1 or 3 channels, got {c}")
    rows = np.zeros((h, 1 + w * c), dtype=np.uint8)  # filter byte 0 on every row
    rows[:, 1:] = img.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the decompressed scanlines."""
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum of each channel along the row, mod 256
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.uint64), axis=0)
                   .reshape(-1) & 0xFF).astype(np.uint8)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before it
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), dtype=np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit gray or RGB) -> uint8 ``(H, W, C)``, C in {1, 3}."""
    data = bytes(data)
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG stream")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG stream has no IHDR chunk")
    w, h, depth, color, _comp, _filt, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"PNG decoding takes 8-bit gray or RGB, not interlaced; got bit depth "
                         f"{depth}, color type {color}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    return _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)
