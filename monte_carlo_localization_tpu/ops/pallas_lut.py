"""Fused LUT likelihood: expected ranges from the range LUT + beam model.

Beam j of a particle reads bin ``b0 + q_j`` of that particle's LUT row,
where the lane offsets ``q_j = k*j + e_j`` are STATIC for a scan geometry
(the theta-bin count T is chosen so that one beam step is an integer
number k of bins, :func:`suggest_theta_bins`; the small residuals e_j
absorb the rounding). LUT rows are padded past T with angle-wraparound
content (physical bin b holds logical bin b % T), so a particle's R reads
never wrap: they all sit in ``[b0, b0 + span)`` of one physical row.

One addressing function, :func:`lut_address`, computes each particle's
``(row, b0)`` for every LUT layout the filters use (dense, compact row
map, padded per-member blocks, tight per-member blocks, compact
per-member blocks; u8 and u16), and :func:`lut_likelihood` gathers
the (N, R) expected ranges ``lut[row, b0 + q]``, evaluates
``SensorModel.log_prob_analytic`` and sums. XLA fuses the gather, the
beam model and the reduction; on an H100 a hand-written Pallas (Triton)
kernel of the same sum measured no faster end to end, so none is kept
(PERF.md).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax.numpy as jnp

SUBROW_BYTES = 512  # LUT storage tile: builders write rows in 512 B spans


def entries_per_subrow(itemsize: int) -> int:
    """LUT entries per 512 B storage tile: 512 for u8, 256 for u16."""
    if itemsize not in (1, 2):
        raise ValueError(f"unsupported LUT itemsize {itemsize} (u8/u16 only)")
    return SUBROW_BYTES // itemsize


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def suggest_theta_bins(beam_angles: np.ndarray, target: int = 1440) -> int:
    """T near ``target`` such that one beam step == an integer number k of
    theta bins for this beam set (the static lane layout needs integral
    k >= 1).

    For a full-resolution 1080-beam 270-degree scan this lands on k=1,
    T~1439; for an 18x-downsampled 60-beam scan on k=18, T~1416 — the same
    0.25-degree angular quantization either way.
    """
    a = np.asarray(beam_angles, np.float64)
    if len(a) < 2:
        return target
    inc = np.median(np.abs(np.diff(a)))
    k = max(1, int(round(inc * target / (2.0 * math.pi))))
    return max(8, int(round(2.0 * math.pi * k / inc)))


def beam_geometry(beam_angles: np.ndarray, t_bins: int):
    """Static decomposition: bin(beam_j) = base + k*j + e_j.

    Returns (base, k, e (R,) int32 with 0 <= e <= emax).
    """
    delta = 2.0 * math.pi / t_bins
    bins = np.round(np.asarray(beam_angles, np.float64) / delta).astype(np.int64)
    r = len(bins)
    if r > 1:
        k = max(1, int(round((bins[-1] - bins[0]) / (r - 1))))
    else:
        k = 1
    e = (bins - bins[0] - k * np.arange(r, dtype=np.int64)).astype(np.int64)
    base = int(bins[0] + e.min())
    e = (e - e.min()).astype(np.int32)
    return base, k, e


def beam_lanes(beam_angles: np.ndarray, t_bins: int):
    """(base, q (R,) int32): the static per-beam bin offsets q_j = k*j + e_j
    from a particle's start bin. Rejects a beam set whose span exceeds one
    circle of T bins, or that maps two beams onto one bin (a non-monotone,
    jittery beam set — real lidars are monotone)."""
    base, k, e = beam_geometry(beam_angles, t_bins)
    r = len(e)
    q = (k * np.arange(r) + e).astype(np.int32)
    span = int(q.max()) + 1
    if span > t_bins:
        raise ValueError(
            f"beam window spans {span} bins > T={t_bins}; use "
            "T = suggest_theta_bins(beam_angles)"
        )
    if len(set(q.tolist())) < r:
        raise ValueError(
            "beam set maps two beams to one LUT bin (non-monotone "
            "residuals); sort/uniform-space the beams or change t_bins"
        )
    return base, q


def required_row_stride(
    t_bins: int, beam_angles: np.ndarray, itemsize: int = 1
) -> int:
    """LUT row stride in entries: every read window ``[b0, b0 + span)``
    with ``b0 < T`` fits one physical row, rounded up to the 512 B storage
    tile the LUT builders write."""
    _, q = beam_lanes(beam_angles, t_bins)
    span = int(q.max()) + 1
    return _round_up(t_bins - 1 + span, entries_per_subrow(itemsize))


def lut_address(
    particles,
    *,
    t_bins: int,
    base: int,
    resolution: float,
    height: int,
    width: int,
    origin_x,
    origin_y,
    row_stride: int,
    subrow_entries: int,
    num_members: int = 1,
    per_member_maps: bool = False,
    row_map=None,
    member_base=0,
    origins=None,
    map_of=None,
    dims=None,
    lut_bases=None,
    row_map_bases=None,
):
    """Per-particle LUT addressing: ``(row, b0, oob)``, each (N,) —
    ``row`` indexes the LUT viewed as (rows, row_stride), ``b0`` is the
    start bin in [0, T), ``oob`` marks particles outside their map.

    Layouts (``GridMap`` leaves):

    * dense single map: row = cell; with ``row_map`` (compact LUT,
      ``with_compact_range_lut``): row = row_map[cell].
    * ``per_member_maps`` (heterogeneous fleet): the N particles are
      ``num_members`` contiguous groups; member i of this call is global
      member ``member_base + i``, mapped to its map by ``map_of``
      (identity if None) and placed at that map's ``origins``.
      - padded blocks (``with_range_lut`` on a stacked map): row =
        map * H*W + cell;
      - tight blocks (``with_member_luts``): true per-map ``dims`` and
        ``lut_bases`` (block starts in 512 B tiles);
      - compact tight blocks (``with_member_compact_luts``): the cell
        maps through ``row_map[row_map_bases[map] + cell]`` first.
    """
    n = particles.shape[0]
    if per_member_maps:
        if origins is None:
            raise ValueError(
                "per_member_maps query needs origins=(ox (M,), oy (M,))"
            )
        npm = max(n // num_members, 1)
        mi = member_base + jnp.arange(n, dtype=jnp.int32) // npm
        if map_of is not None:
            mi = jnp.asarray(map_of, jnp.int32)[mi]
        ox, oy = origins[0][mi], origins[1][mi]
        if dims is not None:
            d = jnp.asarray(dims, jnp.int32)
            h_m, w_m = d[mi, 0], d[mi, 1]
        else:
            h_m, w_m = height, width
    else:
        ox, oy = origin_x, origin_y
        h_m, w_m = height, width
    gx = ((particles[:, 0] - ox) / resolution).astype(jnp.int32)
    gy = ((particles[:, 1] - oy) / resolution).astype(jnp.int32)
    oob = (gx < 0) | (gx >= w_m) | (gy < 0) | (gy >= h_m)
    row = jnp.clip(gy, 0, h_m - 1) * w_m + jnp.clip(gx, 0, w_m - 1)
    if row_map is not None:  # compact LUT: cell -> LUT row indirection
        if per_member_maps:
            if row_map_bases is None or lut_bases is None:
                raise ValueError(
                    "compact per-member LUTs need row_map_bases and "
                    "lut_bases (GridMap.with_member_compact_luts)"
                )
            row = row_map[jnp.asarray(row_map_bases, jnp.int32)[mi] + row]
        else:
            row = row_map[row]
    if per_member_maps:  # offset into this particle's map's LUT block
        if lut_bases is not None:
            tiles_per_row = row_stride // subrow_entries
            row = row + jnp.asarray(lut_bases, jnp.int32)[mi] // tiles_per_row
        else:
            row = row + mi * (height * width)
    b0 = jnp.round(particles[:, 2] * (t_bins / (2.0 * math.pi)))
    # jnp's % is floor-mod: already in [0, T) for any sign
    b0 = (b0.astype(jnp.int32) + base) % t_bins
    return row, b0, oob


def lut_likelihood(lut2d, row, b0, q, obs_px, sensor):
    """Log-likelihood per particle, (N,): gather the (N, R) expected ranges
    ``lut2d[row, b0 + q]``, apply the analytic beam model and sum over
    beams times ``inv_squash``. ``obs_px`` is (F, R) — one scan per group
    of N/F contiguous particles."""
    d = lut2d[row[:, None], b0[:, None] + jnp.asarray(q)[None, :]]
    f, r = obs_px.shape
    d = d.astype(jnp.float32).reshape(f, -1, r)
    logp = sensor.log_prob_analytic(obs_px[:, None, :], d)
    return sensor.inv_squash_factor * jnp.sum(logp, axis=-1).reshape(-1)


def build_lut_query_fn(
    t_bins: int,
    beam_angles: np.ndarray,
    num_particles: int,
    *,
    height: int,
    width: int,
    resolution: float,
    origin_x: float,
    origin_y: float,
    max_range_px: int,
    row_stride: int,
    z_hit: float,
    z_short: float,
    z_max: float,
    z_rand: float,
    sigma_hit: float,
    inv_squash: float,
    num_members: int = 1,
    lut_dtype: np.dtype = np.uint8,
    per_member_maps: bool = False,
):
    """Returns query(lut, particles, obs_px, **layout) -> (N,) log
    weights, out-of-map particles at -1e4.

    ``lut``: the GridMap's range LUT in any shape whose row-major order is
    (rows, ``row_stride``) — u8 for max_range_px <= 254, u16 beyond.
    ``particles``: (N, 3). ``obs_px``: (R,) observed ranges in px, or
    (F, R) with ``num_members`` = F (one scan per contiguous group of N/F
    particles). The layout keywords are those of :func:`lut_address`.
    """
    from monte_carlo_localization_tpu.models.sensor import SensorModel

    base, q = beam_lanes(beam_angles, t_bins)
    lut_dtype = np.dtype(lut_dtype)
    eps = entries_per_subrow(lut_dtype.itemsize)
    need = required_row_stride(t_bins, beam_angles, lut_dtype.itemsize)
    if row_stride < need:
        raise ValueError(f"row_stride {row_stride} < required {need}")
    if row_stride % eps != 0:
        raise ValueError(f"row_stride must be a multiple of {eps}")
    n = num_particles
    if n % num_members != 0:
        raise ValueError(
            f"num_particles {n} must divide over {num_members} members"
        )
    sensor = SensorModel.create(
        max_range_px=max_range_px, resolution=resolution, z_hit=z_hit,
        z_short=z_short, z_max=z_max, z_rand=z_rand, sigma_hit=sigma_hit,
        squash_factor=1.0 / inv_squash,
    )
    address = functools.partial(
        lut_address, t_bins=t_bins, base=base, resolution=resolution,
        height=height, width=width, origin_x=origin_x, origin_y=origin_y,
        row_stride=row_stride, subrow_entries=eps, num_members=num_members,
        per_member_maps=per_member_maps,
    )

    def query(lut, particles, obs_px, **layout):
        row, b0, oob = address(particles, **layout)
        lut2d = lut.reshape(-1, row_stride)
        obs = jnp.minimum(obs_px, float(max_range_px)).reshape(-1, len(q))
        logw = lut_likelihood(lut2d, row, b0, q, obs, sensor)
        return jnp.where(oob, -1e4, logw)

    return query
