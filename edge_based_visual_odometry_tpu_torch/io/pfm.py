"""PFM (portable float map) reader/writer.

Copy of `edge_based_visual_odometry_tpu/io/pfm.py`. NumPy
re-implementation of the reference's binary PFM reader with endianness handling (readPFM, src/Dataset.cpp:318-413), used for ETH3D GT
disparity maps. The writer is the inverse (the reference has none; used
for test fixtures and debug dumps).
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file into a float32 (H, W) or (H, W, 3) array.

    PFM stores rows bottom-to-top; returns top-to-bottom like the
    reference (src/Dataset.cpp:383-407 flips while copying).
    """
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path!r} (header {header!r})")

        dims = f.readline().decode("latin-1")
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM dims in {path!r}: {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().decode("latin-1").rstrip())
        little_endian = scale < 0

        data = np.frombuffer(
            f.read(width * height * channels * 4),
            dtype="<f4" if little_endian else ">f4")
        shape = (height, width, channels) if channels == 3 else (height, width)
        img = data.reshape(shape)
        return np.ascontiguousarray(img[::-1]).astype(np.float32)


def write_pfm(path: str, img: np.ndarray, little_endian: bool = True):
    """Write a float32 (H, W) or (H, W, 3) array as PFM (rows stored
    bottom-to-top, negative scale = little-endian)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        header = b"Pf"
    elif img.ndim == 3 and img.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"PFM requires (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    scale = -1.0 if little_endian else 1.0
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{scale}\n".encode())
        data = np.ascontiguousarray(img[::-1]).astype(
            "<f4" if little_endian else ">f4")
        f.write(data.tobytes())
