"""Map files without third-party readers: the ROS map YAML and its image.

``load_map`` reads a ROS ``map_server`` pair — a flat YAML file (``image``,
``resolution``, ``origin`` as a flow ``[x, y, yaw]`` or block ``- x``
list, ``negate``, ``occupied_thresh``, ``free_thresh``, ``mode``) and an
8-bit grayscale/RGB(A) PNG or binary PGM — with the standard library and
numpy only, so the main path needs neither PyYAML nor Pillow.

Images come back as 8-bit luminance, converted exactly as Pillow's
``convert("L")`` does (ITU-R 601-2 weights in 16-bit fixed point; alpha
ignored), so maps load identically with or without Pillow.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path

import numpy as np

_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9]*\.[0-9]+|[0-9]+\.[0-9]*)([eE][-+]?[0-9]+)?$")


def _scalar(text: str):
    """One YAML 1.1 plain or quoted scalar, as PyYAML's safe loader reads
    the values of a map file."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    low = s.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("", "~", "null"):
        return None
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line.rstrip()


def parse_map_yaml(text: str) -> dict:
    """Parse the flat key/value YAML of a ROS map file.

    Supports top-level ``key: scalar``, ``key: [a, b, c]`` and a block
    list (``key:`` followed by ``- item`` lines). Anything nested deeper
    raises ``ValueError``: this is a map-file reader, not a YAML parser."""
    out: dict = {}
    pending = None  # key whose block list is being read
    block_keys = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        body = line.strip()
        if body.startswith("- ") or body == "-":
            if pending is None:
                raise ValueError(f"list item outside a key: {raw!r}")
            out[pending].append(_scalar(body[1:]))
            continue
        if line[0] in " \t":
            raise ValueError(f"nested YAML is not supported: {raw!r}")
        key, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"not a 'key: value' line: {raw!r}")
        key, value = key.strip(), value.strip()
        pending = None
        if not value:
            out[key] = []
            pending = key
            block_keys.append(key)
        elif value.startswith("["):
            if not value.endswith("]"):
                raise ValueError(f"unterminated flow list: {raw!r}")
            inner = value[1:-1].strip()
            out[key] = [_scalar(v) for v in inner.split(",")] if inner else []
        else:
            out[key] = _scalar(value)
    for key in block_keys:  # "key:" with no items is a null
        if out[key] == []:
            out[key] = None
    return out


def read_map_yaml(path: str | Path) -> dict:
    return parse_map_yaml(Path(path).read_text())


# ---- images ---------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # gray, RGB, gray+alpha, RGBA


def _unfilter(data: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the five PNG scanline filters. ``data`` is (H, W, bpp) of
    filtered bytes; pixel (y, x) depends on its left, upper and upper-left
    neighbours only, so all pixels on one anti-diagonal y + x = d are
    reconstructed together (H + W - 1 vector steps)."""
    h, w, _ = data.shape
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # zero row/col 0 = outside
    raw = data.astype(np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a = out[y + 1, x]      # left
        b = out[y, x + 1]      # up
        c = out[y, x]          # upper left
        f = filters[y][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4],
            [a, b, (a + b) >> 1, paeth],
            0,
        )
        out[y + 1, x + 1] = (raw[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(blob: bytes) -> np.ndarray:
    """8-bit, non-interlaced PNG (gray, gray+alpha, RGB, RGBA) -> (H, W)
    uint8 gray or (H, W, C) uint8."""
    if not blob.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        chunk = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace}): only 8-bit non-interlaced gray, "
            "gray+alpha, RGB and RGBA"
        )
    bpp = _PNG_CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * bpp)
    if (rows[:, 0] > 4).any():
        raise ValueError("corrupt PNG: unknown scanline filter")
    img = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0], bpp)
    return img[..., 0] if bpp == 1 else img


def decode_pgm(blob: bytes) -> np.ndarray:
    """Binary (P5) PGM with maxval 255 -> (H, W) uint8."""
    fields, pos = [], 2
    if not blob.startswith(b"P5"):
        raise ValueError("not a binary (P5) PGM file")
    while len(fields) < 3:
        while blob[pos:pos + 1].isspace():
            pos += 1
        if blob[pos:pos + 1] == b"#":
            pos = blob.index(b"\n", pos) + 1
            continue
        end = pos
        while not blob[end:end + 1].isspace():
            end += 1
        fields.append(int(blob[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"unsupported PGM maxval {maxval} (255 only)")
    pos += 1  # the single whitespace byte before the raster
    return np.frombuffer(blob, np.uint8, count=w * h, offset=pos).reshape(h, w)


def to_luminance(img: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("L")``: gray passes through; gray+alpha keeps
    the gray channel; RGB(A) -> (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return img[..., 0].copy()
    rgb = img[..., :3].astype(np.uint32)
    lum = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
           + 0x8000) >> 16
    return lum.astype(np.uint8)


def read_image(path: str | Path) -> np.ndarray:
    """A map image (PNG or binary PGM) as (H, W) uint8 luminance."""
    blob = Path(path).read_bytes()
    if blob.startswith(_PNG_SIGNATURE):
        return to_luminance(decode_png(blob))
    if blob.startswith(b"P5"):
        return decode_pgm(blob)
    raise ValueError(f"{path}: unsupported map image (PNG or P5 PGM only)")
