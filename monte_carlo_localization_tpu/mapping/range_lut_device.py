"""On-device (JAX) range-LUT builder.

Device-side twin of the C++ shear-scan DP in mapping/range_lut.py: ranges
for every (cell, theta-bin) pair via one backward sweep per angle. On the
device this avoids building the multi-hundred-MB LUT on host and shipping it over
PCIe — the occupancy grid (H*W bytes) is the only upload.

Vectorization: bins are grouped by (driving axis, sweep direction) into
four static groups and processed as a batch axis B. The per-line shear
drift is always in {-1, 0, +1} (|delta| <= 1 once the driving axis is the
dominant one), so each sweep step is three static lane shifts + a select —
no gathers, no dynamic rolls. One `lax.scan` over the P grid lines per
group; everything jit-compiled.

Numerics match build_range_lut_numpy exactly (validated in tests).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def _group_bins(t_bins: int):
    """Split bin indices into 4 static groups: (row/col major, sp +/-).
    Identical to ``_group_bins_padded(t, t)`` (no wraparound tail)."""
    return _group_bins_padded(t_bins, t_bins)


def _sweep_group(occ_p: jnp.ndarray, rel: np.ndarray, step_len: np.ndarray,
                 forward: bool, max_range_px: int,
                 out_dtype=jnp.uint8) -> jnp.ndarray:
    """One group's backward sweep.

    occ_p: (P, Q) bool — occupancy with the driving axis first.
    rel: (P, B) int8 — shear drift between line p and the next line along
         the ray (precomputed on host; static shapes).
    step_len: (B,) float32 — px advanced per line (1/|dominant component|).
    forward: sweep order. Returns (P, B, Q) ``out_dtype`` ranges in px
    (uint8 for max_range_px <= 254, uint16 for long-range maps — f32 line
    counts stay exact far past any u16 range).
    """
    p_len, q_len = occ_p.shape
    b = rel.shape[1]
    rel_j = jnp.asarray(rel)
    step_j = jnp.asarray(step_len)[None, :, None]  # (1, B, 1)
    maxr = jnp.float32(max_range_px)

    order = jnp.arange(p_len) if forward else jnp.arange(p_len - 1, -1, -1)
    occ_seq = occ_p[order]  # (P, Q) in sweep order
    rel_seq = rel_j[order]  # (P, B)

    def step(d_prev, inputs):
        occ_row, rel_row = inputs  # (Q,), (B,)
        # neighbor distance along the ray: shift D by rel in {-1, 0, +1}
        left = jnp.concatenate(
            [d_prev[:, 1:], jnp.zeros((b, 1), d_prev.dtype)], axis=1
        )
        right = jnp.concatenate(
            [jnp.zeros((b, 1), d_prev.dtype), d_prev[:, :-1]], axis=1
        )
        r = rel_row[:, None]
        nxt = jnp.where(r == 1, left, jnp.where(r == -1, right, d_prev))
        d_new = jnp.where(occ_row[None, :], 0.0, nxt + 1.0)
        px = jnp.clip(d_new * step_j[0] - 1.0, 0.0, maxr)
        return d_new, (px + 0.5).astype(out_dtype)

    _, out_seq = jax.lax.scan(
        step, jnp.zeros((b, q_len), jnp.float32), (occ_seq, rel_seq)
    )
    # undo the sweep ordering
    return out_seq[jnp.argsort(order)]  # (P, B, Q)


def _group_bins_padded(t_bins: int, row_stride: int):
    """Like _group_bins but over ``row_stride`` physical bins where physical
    bin b carries the angle of logical bin ``b % t_bins`` (the wraparound
    padding the lut_pallas query needs). Building the duplicates inside
    the same sweep costs ~stride/T extra compute but avoids a separate
    giant pad/gather program over the whole LUT."""
    thetas = 2.0 * np.pi * (np.arange(row_stride) % t_bins) / t_bins
    c, s = np.cos(thetas), np.sin(thetas)
    row_major = np.abs(s) >= np.abs(c)
    sp = np.where(row_major, np.sign(s), np.sign(c)).astype(np.int64)
    sp[sp == 0] = 1
    groups = {}
    for rm in (True, False):
        for d in (1, -1):
            idx = np.nonzero(row_major == rm)[0]
            idx = idx[sp[idx] == d]
            if len(idx):
                groups[(rm, d)] = idx
    return groups, c, s


def build_range_lut_jax(
    occupied, t_bins: int, max_range_px: int, row_stride: int = 0,
    lut_dtype=jnp.uint8,
) -> jnp.ndarray:
    """(H, W, T) uint8/uint16 range LUT, built entirely on device.

    With ``row_stride > t_bins`` the output's last axis is ``row_stride``
    with wraparound content (entry b = logical bin b % t_bins), ready for
    the Pallas query kernel — no separate padding pass needed.
    ``lut_dtype=jnp.uint16`` for long-range maps (max_range_px > 254).
    """
    occupied = jnp.asarray(occupied, jnp.bool_)
    h, w = occupied.shape
    if row_stride and row_stride != t_bins:
        groups, c, s = _group_bins_padded(t_bins, row_stride)
    else:
        groups, c, s = _group_bins(t_bins)
    out_parts = []
    bin_order = []

    for (rm, d), idx in groups.items():
        denom = np.abs(s[idx]) if rm else np.abs(c[idx])
        delta = (c[idx] if rm else s[idx]) / denom
        step_len = (1.0 / denom).astype(np.float32)
        p_len = h if rm else w

        # per-line shear drift rel(p) = shift(p + d) - shift(p)
        p = np.arange(p_len)
        shift = np.rint(delta[None, :] * d * p[:, None])  # (P, B)
        shift_n = np.rint(delta[None, :] * d * (p[:, None] + d))
        rel = (shift_n - shift).astype(np.int8)

        occ_p = occupied if rm else occupied.T
        part = _sweep_group(
            occ_p, rel, step_len, forward=(d < 0),
            max_range_px=max_range_px, out_dtype=lut_dtype,
        )  # (P, B, Q)
        # back to (H, W, B)
        part = (
            jnp.transpose(part, (0, 2, 1))
            if rm
            else jnp.transpose(part, (2, 0, 1))
        )
        out_parts.append(part)
        bin_order.append(idx)

    order = np.concatenate(bin_order)
    inv = np.argsort(order)
    lut = jnp.concatenate(out_parts, axis=2)[:, :, inv]
    return lut


build_range_lut_jax_jit = jax.jit(
    build_range_lut_jax, static_argnums=(1, 2, 3, 4)
)


# ---------------------------------------------------------------------------
# Compacted builder for giant maps (Spielberg-scale).
#
# A cell whose clearance is >= max_range_px + margin sees max_range in EVERY
# direction, so its LUT row is the constant [max_range_px] * stride — all
# such cells share ONE row. Only cells within max_range of an obstacle (or
# the map border, which also stops rays) get real rows, addressed through a
# (H*W,) int32 row map. On Spielberg (2000x2000, 1080 beams) this turns a
# 12.3 GB dense padded LUT into 9.6 GB of rows + a 16 MB row map, fitting
# HBM; the build runs in theta-bin chunks so the transient dense slab stays
# ~1 GB instead of 2x the full LUT.
# ---------------------------------------------------------------------------

# margin over max_range_px for the shared far row: +1 for the reference's
# -1 px DDA bias, +1 for the shear-scan DP's <=0.5-cell lateral snap
FAR_ROW_MARGIN = 2


def compact_row_map(clearance: np.ndarray, max_range_px: int):
    """(row_map (H*W,) int32, row_cells (K,) int64): row 0 is the shared
    far row; cells with clearance < max_range_px + margin get rows 1..K."""
    near = (
        np.asarray(clearance).reshape(-1) < max_range_px + FAR_ROW_MARGIN
    )
    row_cells = np.nonzero(near)[0]
    row_map = np.zeros(near.shape[0], np.int32)
    row_map[row_cells] = np.arange(1, len(row_cells) + 1, dtype=np.int32)
    return row_map, row_cells


SPAN = 512  # u8 physical-bin span per write: one (4, 128) u8 DMA block column


def _span_bins(itemsize: int) -> int:
    """Physical-bin span per write column — one 512 B DMA subrow: 512 u8
    entries, 256 u16 entries (tile (2, 128))."""
    return SPAN // itemsize


@partial(jax.jit, donate_argnums=(0,), static_argnums=(5,))
def _write_span(buf, flats, cells_slice, span_idx, r0, sub_lanes):
    """Write one subrow-span's rows into the donated LUT buffer."""
    cols = [f[cells_slice] for f in flats]
    vals = cols[0] if len(cols) == 1 else jnp.concatenate(cols, 1)
    vals = vals.reshape(vals.shape[0], 1, sub_lanes, 128)
    return jax.lax.dynamic_update_slice(buf, vals, (r0, span_idx, 0, 0))


def build_compact_range_lut_jax(
    occupied,
    clearance,
    t_bins: int,
    max_range_px: int,
    row_stride: int,
    chunk: int = 0,  # kept for API compat; spans are fixed at one subrow
    *,
    out=None,
    row_base: int = 0,
    lut_dtype=np.uint8,
):
    """Compacted range LUT + (H*W,) int32 row map, built on device.

    Returns (lut, row_map np.int32) where lut is
    (K+1, stride//512, 4, 128) jnp.uint8 for maps with
    max_range_px <= 254, or (K+1, stride//256, 2, 128) jnp.uint16 for
    long-range maps (``lut_dtype=np.uint16``) — either way the Pallas
    kernel's native 512 B subrow tile layout.

    With ``out``/``row_base`` the rows are written into a CALLER-provided
    donated buffer starting at ``row_base`` (the member-block assembly
    path of ``GridMap.with_member_compact_luts``: one big buffer holds
    every member's [far, rows...] block, so no multi-GB host build,
    host->device transfer, or device-side concatenation ever happens —
    peak memory is the final buffer plus the ~1 GB sweep slab). The
    caller must pre-fill the buffer with ``max_range_px`` (far rows are
    never written) and must rebind its reference to the RETURNED array
    (the input is donated).

    The output uses the Pallas kernel's native 512-byte-block layout
    directly: dims 2-3 are exactly one u8 packing tile, so downstream
    ``reshape(-1, 4, 128)`` (kernel) and ``reshape(-1, stride)`` (XLA
    gather paths, in-jit) are free dimension merges — an eagerly-reshaped
    2-D tiled buffer forced a full multi-GB relayout copy and OOM'd at
    Spielberg scale.

    Writes go span by span: each 512-aligned physical-bin span is
    assembled in-jit from the (1-3) group arcs overlapping it, the compact
    rows are gathered, the constant far row prepended, and the result
    written with ``dynamic_update_slice`` on the donated buffer (in-place;
    a column scatter forced a whole-buffer copy per chunk). Chunks are
    serialized — async dispatch would keep every span's ~2 GB of sweep
    transients live at once.
    """
    del chunk
    lut_dtype = np.dtype(lut_dtype)
    if lut_dtype.itemsize not in (1, 2):
        raise ValueError(f"unsupported LUT dtype {lut_dtype} (u8/u16 only)")
    span = _span_bins(lut_dtype.itemsize)  # bins per 512 B write column
    sub_lanes = span // 128
    jdtype = jnp.uint8 if lut_dtype.itemsize == 1 else jnp.uint16
    occupied = jnp.asarray(occupied, jnp.bool_)
    h, w = occupied.shape
    if row_stride % span != 0:
        raise ValueError(f"row_stride must be a multiple of {span}")
    row_map, row_cells = compact_row_map(clearance, max_range_px)
    k_rows = len(row_cells)
    groups, c, s = (
        _group_bins_padded(t_bins, row_stride)
        if row_stride != t_bins
        else _group_bins(t_bins)
    )

    if out is None:
        out = jnp.full(
            (k_rows + 1, row_stride // span, sub_lanes, 128), max_range_px,
            jdtype,
        )
    else:
        # lax.dynamic_update_slice CLAMPS out-of-bounds starts, so a
        # miscomputed member base would silently overwrite the previous
        # member's rows instead of erroring — validate up front
        if row_base < 0 or row_base + k_rows + 1 > out.shape[0]:
            raise ValueError(
                f"member LUT block [{row_base}, {row_base + k_rows + 1}) "
                f"exceeds the donated buffer's {out.shape[0]} rows"
            )
        if out.shape[1:] != (row_stride // span, sub_lanes, 128):
            raise ValueError(
                f"donated buffer tile shape {out.shape[1:]} != "
                f"({row_stride // span}, {sub_lanes}, 128) for row_stride "
                f"{row_stride}"
            )
        if out.dtype != jdtype:
            raise ValueError(
                f"donated buffer dtype {out.dtype} != {jdtype.__name__}"
            )
    cells_j = jnp.asarray(row_cells, jnp.int32)

    @partial(jax.jit, static_argnums=(3, 4, 5))
    def sweep_flat(occ_p, rel, step_len, forward, maxr, rm):
        """Sweep one piece and return it cell-major: (H*W, bc)."""
        part = _sweep_group(occ_p, rel, step_len, forward, maxr, jdtype)
        return (
            jnp.transpose(part, (0, 2, 1))
            if rm
            else jnp.transpose(part, (2, 0, 1))
        ).reshape(h * w, part.shape[1])

    # physical bin -> (group key, position inside that group's idx array)
    owner = {}
    for key, idx in groups.items():
        for pos, b in enumerate(idx):
            owner[int(b)] = (key, pos)

    # precompute per-group host metadata
    meta = {}
    for key, idx in groups.items():
        rm, d = key
        denom = np.abs(s[idx]) if rm else np.abs(c[idx])
        delta = (c[idx] if rm else s[idx]) / denom
        step_len_g = (1.0 / denom).astype(np.float32)
        p_len = h if rm else w
        p = np.arange(p_len)
        shift = np.rint(delta[None, :] * d * p[:, None])
        shift_n = np.rint(delta[None, :] * d * (p[:, None] + d))
        meta[key] = ((shift_n - shift).astype(np.int8), step_len_g)

    # rows are written in chunks so each write's gather/relayout temps stay
    # a few hundred MB next to the multi-GB donated buffer; LUT row 0 (the
    # constant far row) is never written — the buffer is initialized to
    # max_range_px. _write_span is a module-level jit so repeated member
    # builds of the same shape reuse one compiled program.
    row_chunk = 1 << 20

    for c0 in range(0, row_stride, span):
        # split this span into runs owned by one group each
        pieces = []  # (key, group positions) per contiguous piece
        b = c0
        while b < c0 + span:
            key, pos = owner[b]
            ln = 1
            while (
                b + ln < c0 + span
                and owner[b + ln][0] == key
                and owner[b + ln][1] == pos + ln
            ):
                ln += 1
            pieces.append((key, pos, ln))
            b += ln
        flats = []
        for key, pos, ln in pieces:
            rm, d = key
            rel_g, step_len_g = meta[key]
            sel = np.arange(pos, pos + ln)
            occ_p = occupied if rm else occupied.T
            flats.append(
                sweep_flat(
                    occ_p,
                    jnp.asarray(rel_g[:, sel]),
                    jnp.asarray(step_len_g[sel]),
                    d < 0,
                    max_range_px,
                    rm,
                )
            )
        span_idx = jnp.int32(c0 // span)
        for r0 in range(0, k_rows, row_chunk):
            rc = min(row_chunk, k_rows - r0)
            out = _write_span(
                out, flats, cells_j[r0 : r0 + rc], span_idx,
                jnp.int32(row_base + r0 + 1), sub_lanes,
            )
        # serialize spans: async dispatch would keep every span's ~2 GB
        # sweep slab live at once next to the multi-GB buffer
        jax.block_until_ready(out)
    return out, row_map
