"""Image input/output without OpenCV on the write path.

``load_image`` reads ``.npy`` arrays directly and imports ``cv2`` only for
``.jpg``/``.png`` inputs; ``write_png`` is a small RGB8 PNG encoder on the
standard library's ``zlib``; ``image_size`` reads a JPEG's or PNG's size
from its header.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Image file -> [H,W,3] float32 RGB in [0,1].

    ``.npy`` holds [H,W,3] RGB, uint8 or float in [0,1].
    """
    if path.endswith(".npy"):
        img = np.load(path)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"{path}: expected [H,W,3], got {img.shape}")
        if img.dtype == np.uint8:
            return img.astype(np.float32) / 255.0
        return img.astype(np.float32)
    import cv2  # only image files need OpenCV

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].astype(np.float32) / 255.0


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write [H,W,3] uint8 RGB as an 8-bit PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected [H,W,3], got {rgb.shape}")
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# JPEG start-of-frame markers (every SOFn but DHT, JPG and DAC)
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def image_size(path: str) -> tuple:
    """(height, width) of a PNG or JPEG file from its header; raises
    ``ValueError`` for any other file."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
            w, h = struct.unpack(">II", head[16:24])
            return h, w
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither PNG nor JPEG")
        f.seek(2)
        while True:
            marker = f.read(2)
            if len(marker) < 2 or marker[0] != 0xFF:
                raise ValueError(f"{path}: no JPEG frame header")
            if marker[1] in (0x01, 0xFF) or 0xD0 <= marker[1] <= 0xD7:
                f.seek(-1 if marker[1] == 0xFF else 0, 1)
                continue
            n = struct.unpack(">H", f.read(2))[0]
            if marker[1] in _SOF:
                h, w = struct.unpack(">HH", f.read(5)[1:])
                return h, w
            f.seek(n - 2, 1)
