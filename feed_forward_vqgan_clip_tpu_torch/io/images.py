"""Image grids and PNG files with numpy and the standard library only.

Port of feed_forward_vqgan_clip_tpu/io/images.py without Pillow: the PNG is
written with zlib and struct (8-bit RGB or grey, no interlace).
"""

import struct
import zlib

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """images: (N, H, W, C) floats in [0,1] -> (H', W', C) grid, torchvision layout."""
    images = np.asarray(images, np.float32)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = -(-n // ncol)
    grid = np.full(
        (nr * (h + padding) + padding, ncol * (w + padding) + padding, c),
        pad_value,
        np.float32,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 1) floats in [0,1] -> PNG bytes, 8 bits per channel."""
    arr = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    u8 = (arr * 255.0 + 0.5).astype(np.uint8)
    h, w, c = u8.shape
    color_type = {1: 0, 3: 2}[c]
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))  # filter 0 per row
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def save_image(img: np.ndarray, path: str) -> None:
    """img: (H, W, C) floats in [0,1] -> 8-bit PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def save_grid(images, path: str, nrow: int = 8) -> None:
    save_image(make_grid(np.asarray(images), nrow=nrow), path)
