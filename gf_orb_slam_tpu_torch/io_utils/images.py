"""8-bit grayscale image files with the standard library and numpy: PNG
(zlib, filter types 0-4, not interlaced) and binary PGM (P5), read and
written. The reference reads frames with cv2 or PIL, which the port does
not need.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth_row(raw: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """Paeth unfiltering of one row (one byte per pixel); each byte depends
    on the one decoded before it."""
    out = bytearray(len(raw))
    a = c = 0
    for x, (r, b) in enumerate(zip(raw.tolist(), prior.tolist())):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a = out[x] = (r + pred) & 0xFF
        c = b
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, prior: np.ndarray) -> np.ndarray:
    out = bytearray(len(raw))
    a = 0
    for x, (r, b) in enumerate(zip(raw.tolist(), prior.tolist())):
        a = out[x] = (r + ((a + b) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _read_png(data: bytes, path: str) -> np.ndarray:
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace != 0:
        raise ValueError(f"{path}: only 8-bit grayscale, non-interlaced PNG is read "
                         f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, width + 1)
    out = np.empty((height, width), np.uint8)
    prior = np.zeros(width, np.uint8)
    for y in range(height):
        kind, row = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:
            cur = np.cumsum(row, dtype=np.uint8)  # wraps modulo 256
        elif kind == 2:
            cur = row + prior
        elif kind == 3:
            cur = _average_row(row, prior)
        elif kind == 4:
            cur = _paeth_row(row, prior)
        else:
            raise ValueError(f"{path}: PNG filter type {kind} in row {y}")
        out[y] = prior = cur
    return out


def _read_pgm(data: bytes, path: str) -> np.ndarray:
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end : end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    width, height, maxval = fields
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM is not read")
    pos += 1  # the one whitespace byte after the header
    return np.frombuffer(data[pos : pos + width * height], np.uint8).reshape(height, width).copy()


def read_gray(path: str) -> np.ndarray:
    """(H, W) uint8 pixels of an 8-bit grayscale PNG or binary PGM."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return _read_png(data, path)
    if data.startswith(b"P5"):
        return _read_pgm(data, path)
    raise ValueError(f"{path}: neither PNG nor binary PGM")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_gray(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 pixels as PNG (every row 'Up'-filtered) or, for a
    .pgm path, binary PGM."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected an (H, W) uint8 image, got {img.dtype} {img.shape}")
    height, width = img.shape
    if path.lower().endswith(".pgm"):
        payload = f"P5\n{width} {height}\n255\n".encode() + img.tobytes()
    else:
        up = img - np.concatenate([np.zeros((1, width), np.uint8), img[:-1]])  # wraps modulo 256
        rows = np.concatenate([np.full((height, 1), 2, np.uint8), up], axis=1)
        payload = (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0))
                   + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(payload)
