"""Orbit-animation writer (GIF / frame sequences).

The reference's visual output is a live window / browser canvas; the
headless equivalents are a frame-sequence dump and an animated GIF of
the orbit — also the artifact the study's "5 orbit rotations" protocol
produces when you want to *see* the benchmark run.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np


# A fixed 6 x 7 x 6 colour cube (252 entries) stands in for a per-image
# palette: frames are quantized per pixel with no search.
_LEVELS = (6, 7, 6)


def _palette() -> np.ndarray:
    r, g, b = np.meshgrid(
        *[np.linspace(0, 255, n).round() for n in _LEVELS], indexing="ij"
    )
    pal = np.stack([r, g, b], -1).reshape(-1, 3).astype(np.uint8)
    return np.concatenate([pal, np.zeros((256 - len(pal), 3), np.uint8)])


def _quantize(frame: np.ndarray) -> np.ndarray:
    idx = [
        np.round(frame[..., c].astype(np.float32) * (n - 1) / 255.0)
        .astype(np.int64)
        for c, n in enumerate(_LEVELS)
    ]
    return ((idx[0] * _LEVELS[1] + idx[1]) * _LEVELS[2] + idx[2]).astype(
        np.uint8
    )


def _lzw_literal(indices: np.ndarray) -> bytes:
    """GIF image data for 8-bit ``indices`` without compression: 9-bit
    literal codes, with a clear code before the decoder's table would
    widen its codes (valid LZW that every decoder reads)."""
    clear, eoi = 256, 257
    codes = []
    flat = indices.reshape(-1).tolist()
    for i in range(0, len(flat), 250):
        codes.append(clear)
        codes.extend(flat[i : i + 250])
    codes.append(eoi)
    acc = nbits = 0
    out = bytearray()
    for code in codes:
        acc |= code << nbits
        nbits += 9
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    blocks = bytearray([8])  # LZW minimum code size
    for i in range(0, len(out), 255):
        part = out[i : i + 255]
        blocks.append(len(part))
        blocks.extend(part)
    blocks.append(0)
    return bytes(blocks)


def write_gif(
    path: str,
    frames: list[np.ndarray],
    fps: int = 20,
) -> None:
    """Write uint8 RGB frames as a looping animated GIF."""
    import struct

    if not frames:
        raise ValueError("no frames to write")
    h, w = frames[0].shape[:2]
    delay = max(1, round(100 / fps))  # hundredths of a second
    data = bytearray(b"GIF89a")
    data += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # global 256 colours
    data += _palette().tobytes()
    data += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop
    for frame in frames:
        data += struct.pack("<BBBBHB", 0x21, 0xF9, 4, 0, delay, 0) + b"\x00"
        data += struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0)
        data += _lzw_literal(_quantize(frame))
    data += b"\x3b"
    with open(path, "wb") as f:
        f.write(bytes(data))


def render_orbit_gif(
    renderer,
    path: str,
    frames: int = 60,
    rotations: float = 1.0,
    fps: int = 20,
) -> list[float]:
    """Render a full camera orbit to a GIF; returns per-frame seconds."""
    from rt_rs_tpu.scene.camera import ORBIT_RATE

    mult = (rotations * 2.0 * math.pi) / frames / ORBIT_RATE
    collected: list[np.ndarray] = []
    times: list[float] = []

    import time

    for _ in range(frames):
        t0 = time.perf_counter()
        image = renderer.render_image()
        times.append(time.perf_counter() - t0)
        collected.append(image)
        renderer.orbit(mult)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_gif(path, collected, fps=fps)
    return times
