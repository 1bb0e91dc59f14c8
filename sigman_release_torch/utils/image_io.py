"""Image input/output without OpenCV on the write path.

``load_image`` reads ``.npy`` arrays directly and imports ``cv2`` only for
``.jpg``/``.png`` inputs; ``write_png`` is a small RGB8 PNG encoder on the
standard library's ``zlib``.
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
