"""Angle-quantized precomputed range LUT — the production ray "cast".

The reference's hot loop marches every ray cell-by-cell at query time
(O(max_range_px) grid reads per ray, reference src/particle_filter.cpp:
611-650, 28.8M reads per update at defaults). The engine inverts the
cost: ranges for EVERY (cell, quantized-angle) pair are precomputed once
per map, and a query becomes ONE u8 read — 48x fewer memory touches than
sphere marching, ~240x fewer than DDA.

This is the RangeLibc "pre-computed LUT" idea the reference's vestigial
``rangelib_variant``/``theta_discretization`` keys allude to
(config/mcl_config.yaml:34-36).

Precompute uses shear-scan dynamic programming (native C++/OpenMP, numpy
fallback): for angle theta, shearing each grid line by the ray's per-line
drift makes all rays straight in sheared coordinates (error <= 0.5 cell,
non-accumulating), so one O(H*W) backward sweep yields every cell's range.
Full build: O(H*W*T) simple ops, seconds in C++ even at T=1440.

Accuracy: angle quantization at T=1440 is 0.25 deg (a real 270-deg/1080-
beam lidar's native increment); lateral snap <= ~1 cell — both well under
the beam model's sigma_hit (8 px default).
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

DEFAULT_THETA_BINS = 1440  # 0.25 deg — matches a 1080-beam 270-deg lidar
DEFAULT_LUT_CACHE = Path(__file__).resolve().parents[2] / ".lut_cache"


def lut_dtype(max_range_px: int) -> np.dtype:
    """u8 up to 254 px (the common case, half the memory), u16 beyond —
    long-range or fine-resolution maps. Both query paths are
    dtype-agnostic; rows are stored in 512 B tiles of 512 u8 or 256 u16
    ranges (ops.pallas_lut.entries_per_subrow)."""
    if max_range_px <= 254:
        return np.dtype(np.uint8)
    if max_range_px <= 65534:
        return np.dtype(np.uint16)
    raise ValueError(
        f"max_range_px={max_range_px} > 65534 — lower max_range or use a "
        "coarser map"
    )


def build_range_lut_numpy(
    occupied: np.ndarray, t_bins: int, max_range_px: int
) -> np.ndarray:
    """Pure-numpy shear-scan DP (fallback + correctness oracle)."""
    occupied = occupied.astype(bool)
    h, w = occupied.shape
    out = np.empty((h, w, t_bins), dtype=lut_dtype(max_range_px))
    for t in range(t_bins):
        theta = 2.0 * np.pi * t / t_bins
        c, s = np.cos(theta), np.sin(theta)
        row_axis = abs(s) >= abs(c)
        occ_p = occupied if row_axis else occupied.T  # (P, Q)
        p_len, q_len = occ_p.shape
        sp = 1 if (s > 0 if row_axis else c > 0) else -1
        denom = abs(s) if row_axis else abs(c)
        delta = (c if row_axis else s) / denom
        step_len = 1.0 / denom

        dist = np.zeros((p_len, q_len), dtype=np.float32)
        d_prev = np.zeros(q_len, dtype=np.float32)
        order = range(p_len - 1, -1, -1) if sp > 0 else range(p_len)
        qs = np.arange(q_len)
        for p in order:
            shift_p = np.rint(delta * sp * p)
            shift_n = np.rint(delta * sp * (p + sp))
            rel = int(shift_n - shift_p)
            qn = qs + rel
            valid = (qn >= 0) & (qn < q_len)
            nxt = np.where(valid, d_prev[np.clip(qn, 0, q_len - 1)], 0.0)
            d_cur = np.where(occ_p[p], 0.0, nxt + 1.0)
            dist[p] = d_cur
            d_prev = d_cur
        px = np.clip(dist * step_len - 1.0, 0.0, max_range_px)
        px_q = (px + 0.5).astype(out.dtype)
        out[:, :, t] = px_q if row_axis else px_q.T
    return out


def build_range_lut(
    occupied: np.ndarray,
    t_bins: int = DEFAULT_THETA_BINS,
    max_range_px: int = 240,
    backend: str = "auto",
    row_stride: int = 0,
) -> np.ndarray:
    """(H, W, T) range-in-px LUT — u8, or u16 when max_range_px > 254.
    backend: auto | native | numpy.

    With ``row_stride > t_bins`` the last axis is padded to ``row_stride``
    with angle-wraparound content (entry b = bin b % T) for the Pallas
    query kernel. Query paths index the LUT as a 2-D (cell, bin) array so
    no single flat index needs to fit int32; the total size is bounded
    only by memory.
    """
    dtype = lut_dtype(max_range_px)
    h, w = occupied.shape
    nbytes = h * w * (row_stride or t_bins) * dtype.itemsize
    max_bytes = int(os.environ.get("MCL_LUT_MAX_BYTES", 16 << 30))
    if nbytes > max_bytes:
        raise ValueError(
            f"range LUT would be {nbytes / 2**30:.1f} GiB "
            f"(H={h}, W={w}, stride={row_stride or t_bins}) > "
            f"{max_bytes / 2**30:.1f} GiB limit; reduce t_bins or set "
            "MCL_LUT_MAX_BYTES"
        )
    lut = None
    if backend in ("auto", "native"):
        try:
            from monte_carlo_localization_tpu.native import native_build_range_lut

            lut = native_build_range_lut(
                occupied, t_bins, max_range_px, dtype=dtype
            )
        except Exception:
            if backend == "native":
                raise
    if lut is None:
        lut = build_range_lut_numpy(occupied, t_bins, max_range_px)
    if row_stride and row_stride != t_bins:
        if row_stride < t_bins:
            raise ValueError(f"row_stride {row_stride} < t_bins {t_bins}")
        reps = -(-row_stride // t_bins)
        lut = np.ascontiguousarray(
            np.tile(lut.reshape(-1, t_bins), (1, reps))[:, :row_stride]
        ).reshape(*occupied.shape, row_stride)
    return lut


def _cache_key(
    occupied: np.ndarray, t_bins: int, max_range_px: int, row_stride: int = 0
) -> str:
    hsh = hashlib.sha256()
    hsh.update(np.ascontiguousarray(occupied.astype(np.uint8)).tobytes())
    # dtype tag only for u16 so existing u8 cache entries stay valid
    tag = "|u16" if lut_dtype(max_range_px).itemsize == 2 else ""
    hsh.update(
        f"{t_bins}|{max_range_px}|{row_stride or t_bins}|v3{tag}".encode()
    )
    return hsh.hexdigest()[:24]


def cached_range_lut(
    occupied: np.ndarray,
    t_bins: int = DEFAULT_THETA_BINS,
    max_range_px: int = 240,
    cache_dir: str | os.PathLike | None = None,
    backend: str = "auto",
    row_stride: int = 0,
) -> np.ndarray:
    """build_range_lut with a per-map on-disk cache (npy, mmap-loaded) in
    ``cache_dir``, else ``$MCL_LUT_CACHE``, else ``.lut_cache/`` at the
    repository root."""
    cache_dir = Path(
        cache_dir or os.environ.get("MCL_LUT_CACHE") or DEFAULT_LUT_CACHE
    )
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / (
        f"rlut_{_cache_key(occupied, t_bins, max_range_px, row_stride)}.npy"
    )
    if path.exists():
        return np.load(path, mmap_mode="r")
    lut = build_range_lut(
        occupied, t_bins, max_range_px, backend=backend, row_stride=row_stride
    )
    # per-process tmp name: concurrent builders of the same entry (e.g.
    # jax.distributed processes sharing one cache dir) each publish via
    # their OWN tmp + atomic replace — a shared tmp name let the first
    # winner's os.replace delete the loser's file mid-save (seen as a
    # FileNotFoundError race in the 2-process multihost dryrun)
    tmp = path.with_name(
        f"{path.stem}.{os.getpid()}-{os.urandom(4).hex()}.tmp.npy"
    )
    try:
        np.save(tmp, lut)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return lut
