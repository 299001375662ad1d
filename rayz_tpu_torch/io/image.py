"""Image output: gamma encoding, PPM (reference-exact), and PNG.

Same writers and reader as :mod:`rayz_tpu.io.image` (numpy and the standard
library only); images may be numpy arrays or torch tensors on any device.
The PPM path matches the reference's ``Image.writePPM`` byte for byte given
the same pixel values: header ``P3\\n{w} {h}\\n255\\n``, then one ASCII
``r g b\\n`` triplet per pixel in row-major order, each channel gamma-2
encoded (sqrt with negatives clamped to 0), clamped to [0, 1], scaled by 255
and truncated toward zero.
"""

from __future__ import annotations

import struct
import zlib
from typing import IO, Union

import numpy as np

__all__ = ["to_u8", "write_ppm", "write_png", "read_ppm"]


def _as_numpy(img) -> np.ndarray:
    if hasattr(img, "detach"):  # torch tensor on any device
        img = img.detach().cpu().numpy()
    return np.asarray(img, dtype=np.float64)


def to_u8(img) -> np.ndarray:
    """Linear [H, W, 3] float -> gamma-2 uint8, reference semantics."""
    a = _as_numpy(img)
    a = np.sqrt(np.maximum(a, 0.0))
    a = np.clip(a, 0.0, 1.0)
    return np.trunc(a * 255.0).astype(np.uint8)


def _open(path_or_file: Union[str, IO[bytes]], mode: str):
    if hasattr(path_or_file, "write"):
        return path_or_file, False
    return open(path_or_file, mode), True


def write_ppm(img, path_or_file: Union[str, IO[bytes]]) -> None:
    """Write a linear [H, W, 3] float image as ASCII P3 PPM."""
    u8 = to_u8(img)
    h, w = u8.shape[:2]
    f, should_close = _open(path_or_file, "wb")
    try:
        f.write(f"P3\n{w} {h}\n255\n".encode())
        flat = u8.reshape(-1, 3)
        lines = "\n".join(f"{r} {g} {b}" for r, g, b in flat)
        f.write(lines.encode())
        f.write(b"\n")
    finally:
        if should_close:
            f.close()


def read_ppm(path_or_file: Union[str, IO[bytes]]) -> np.ndarray:
    """Read an ASCII P3 PPM into a uint8 [H, W, 3] array."""
    f, should_close = _open(path_or_file, "rb")
    try:
        tokens = f.read().split()
    finally:
        if should_close:
            f.close()
    if tokens[0] != b"P3":
        raise ValueError("only ASCII P3 PPM is supported")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"only maxval 255 is supported, got {maxval}")
    data = np.array(tokens[4 : 4 + w * h * 3], dtype=np.uint8)
    return data.reshape(h, w, 3)


def write_png(img, path_or_file: Union[str, IO[bytes]]) -> None:
    """Write a linear [H, W, 3] float image as 8-bit RGB PNG using stdlib zlib."""
    u8 = to_u8(img)
    h, w = u8.shape[:2]
    raw = b"".join(b"\x00" + u8[row].tobytes() for row in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    f, should_close = _open(path_or_file, "wb")
    try:
        f.write(png)
    finally:
        if should_close:
            f.close()
