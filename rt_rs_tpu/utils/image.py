"""PNG image IO in numpy and ``zlib``.

The reference presents frames through a wgpu surface blit
(``src/lib/shaders/render.wgsl``); headless rendering writes PNGs
instead.  Row 0 of the array is texture row ``y = 0``, matching the
storage-texture coordinates of ``compute.wgsl:284-293``.

The codec covers what this package writes and reads: 8-bit
non-interlaced greyscale, RGB and RGBA images, all five row filters on
read; writes are RGB with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """``[H, W, 3] uint8`` -> PNG file bytes."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {image.shape}")
    h, w, _ = image.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1
    )
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an ``[H, W, 3] uint8`` image."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> [h, stride] uint8."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 2:  # up
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):  # sub / average / paeth: left-dependent
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> ``[H, W, 3] uint8`` (alpha dropped, grey
    replicated)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (depth {depth}, colour type {ctype}, "
            f"interlace {interlace})"
        )
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ch == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def golden_diff_ok(
    img: np.ndarray,
    golden: np.ndarray,
    *,
    allow_edge_flips: bool = False,
    edge_px_frac: float = 0.005,
) -> tuple[bool, str]:
    """Compare a render against a golden image.

    The strict criterion (``max <= 2`` per channel, <2% of values off)
    is what the packet paths hold across backends.  Scenes that route
    through the XLA ``shade.trace`` fallback (negative materials) are
    compiled per backend, and XLA's f32 scheduling (FMA contraction)
    legitimately flips knife-edge hit/miss pixels between CPU goldens
    and accelerator renders.  With
    ``allow_edge_flips`` a small budget (``edge_px_frac``) of such
    pixels passes IF each one lies on a contrast edge of the golden:
    some 8-neighbor of the golden matches the rendered value within the
    strict tolerance, i.e. the render picked the other side of a real
    boundary — any non-edge divergence (wrong shading, wrong color)
    still fails.  Returns ``(ok, detail)``."""
    img = img.astype(np.int64)
    golden = golden.astype(np.int64)
    diff = np.abs(img - golden)
    detail = f"max {diff.max()} ({(diff > 0).mean():.2%} px)"
    if diff.max() <= 2 and (diff > 0).mean() < 0.02:
        return True, detail
    if not allow_edge_flips:
        return False, detail
    bad = np.argwhere(diff.max(axis=-1) > 2)
    if len(bad) > edge_px_frac * diff.shape[0] * diff.shape[1]:
        return False, detail + f", {len(bad)} flipped px over budget"
    h, w = golden.shape[:2]
    for y, x in bad:
        neigh = golden[
            max(y - 1, 0) : y + 2, max(x - 1, 0) : x + 2
        ].reshape(-1, 3)
        if not (np.abs(neigh - img[y, x]).max(axis=-1) <= 2).any():
            return False, detail + f", non-edge divergence at ({y},{x})"
    return True, detail + f", {len(bad)} edge flips OK"
