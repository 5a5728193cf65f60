"""Batched grid ray casting — the hot op.

Interchangeable backends behind one contract (the accelerator rebuild of the
reference's ``calc_range_many`` / ``cast_ray``,
reference src/particle_filter.cpp:586-650):

* :func:`cast_rays_dda` — reference-exact fixed-step marcher. Steps
  ``max_range_px`` times by one map resolution along (cos a, sin a),
  truncating world->grid coordinates like the C++ ``static_cast<int>``,
  returning ``step * resolution`` at the first out-of-bounds or
  occupancy>50 cell, else ``max_range_meters``. O(max_range_px) gathers.
  This is the correctness oracle.

* :func:`cast_rays_sphere` — EDT sphere marching. Each iteration reads the
  precomputed clearance field (distance in px to the nearest obstacle or
  map border) and advances the ray by the full clearance (minus a safety
  margin), so open space is crossed in a handful of iterations instead of
  one step per cell. Fixed trip count (jit-static), masked convergence.
  Needs no per-map precompute beyond the EDT; its step-skipping near
  corners is no worse than the reference's own 1-px stepping.

* :func:`cast_rays_lut` — precomputed range LUT, ONE u8 gather per query:
  the production XLA backend (and the data source for the even faster
  fused Pallas kernel in ops/pallas_lut.py, the single-filter fast path).

Both are pure jax.numpy (vmap/jit/shard_map-safe, CPU-runnable). All
computation happens in pixel space; queries are (x, y, absolute angle)
world-space triples as in the reference.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.mapping.grid_map import GridMap

# Reference semantics quirk: cast_ray returns `step * resolution` where step
# is the 0-based count at the CHECK AFTER advancing (reference :620-647), so
# reported ranges are one cell short of the true crossing distance. The
# sphere marcher subtracts this bias to agree with the oracle.
_DDA_BIAS_PX = 1.0


def _world_to_grid_trunc(px, py):
    """float pixel coords -> integer cell via C-style truncation toward zero.

    XLA's float->int convert rounds toward zero, matching the reference's
    ``static_cast<int>`` (reference :625-627).
    """
    return px.astype(jnp.int32), py.astype(jnp.int32)


def cast_rays_dda(grid_map: GridMap, queries: jnp.ndarray) -> jnp.ndarray:
    """Reference-exact fixed-step ray march.

    Args:
      grid_map: the map.
      queries: (Q, 3) float32 — (x_world, y_world, absolute ray angle).
    Returns:
      (Q,) float32 ranges in meters.
    """
    res = grid_map.resolution
    h, w = grid_map.height, grid_map.width
    max_px = grid_map.max_range_px
    occ_flat = grid_map.occupied.reshape(-1)

    x0 = queries[:, 0]
    y0 = queries[:, 1]
    ang = queries[:, 2]
    dx = jnp.cos(ang) * res
    dy = jnp.sin(ang) * res

    sentinel = jnp.int32(max_px)
    hit0 = jnp.full(x0.shape, sentinel, dtype=jnp.int32)

    def body(step, hit):
        # position after (step+1) advances, in world coords (reference :622-624)
        cx = x0 + dx * (step + 1).astype(x0.dtype)
        cy = y0 + dy * (step + 1).astype(y0.dtype)
        gx, gy = _world_to_grid_trunc(
            (cx - grid_map.origin_x) / res, (cy - grid_map.origin_y) / res
        )
        oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
        idx = jnp.clip(gy, 0, h - 1) * w + jnp.clip(gx, 0, w - 1)
        occ = occ_flat[idx]
        blocked = oob | occ
        return jnp.where((hit == sentinel) & blocked, jnp.int32(step), hit)

    hit = jax.lax.fori_loop(0, max_px, body, hit0)
    return jnp.where(
        hit < sentinel,
        hit.astype(queries.dtype) * res,
        jnp.asarray(grid_map.max_range_meters, dtype=queries.dtype),
    )


def cast_rays_sphere(
    grid_map: GridMap, queries: jnp.ndarray, num_iters: int = 48
) -> jnp.ndarray:
    """EDT sphere-marching ray cast.

    Advances each ray by ``max(clearance - 1.5, 1.0)`` px per iteration:
    the 1.5-px margin guarantees a step can never pass through an obstacle
    cell when taking the full clearance, and the 1-px floor guarantees
    DDA-rate progress when hugging walls. A ray that exhausts its
    iterations reports its traveled distance (conservative underestimate).

    Args:
      grid_map: the map (uses the precomputed clearance field).
      queries: (Q, 3) float32 — (x_world, y_world, absolute ray angle).
      num_iters: fixed trip count (static for jit).
    Returns:
      (Q,) float32 ranges in meters, matching DDA semantics within ~1 px.
    """
    res = grid_map.resolution
    h, w = grid_map.height, grid_map.width
    max_px = jnp.asarray(grid_map.max_range_px, dtype=queries.dtype)
    clearance_flat = grid_map.clearance.reshape(-1)

    # pixel-space ray origin and unit direction
    px0 = (queries[:, 0] - grid_map.origin_x) / res
    py0 = (queries[:, 1] - grid_map.origin_y) / res
    ang = queries[:, 2]
    ux = jnp.cos(ang)
    uy = jnp.sin(ang)

    t0 = jnp.zeros_like(px0)
    done0 = jnp.zeros(px0.shape, dtype=jnp.bool_)

    def body(_, carry):
        t, done = carry
        cx = px0 + ux * t
        cy = py0 + uy * t
        gx, gy = _world_to_grid_trunc(cx, cy)
        oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
        idx = jnp.clip(gy, 0, h - 1) * w + jnp.clip(gx, 0, w - 1)
        c = jnp.where(oob, 0.0, clearance_flat[idx])
        hit_now = c <= 0.0
        past_max = t >= max_px
        newly_done = hit_now | past_max
        step = jnp.maximum(c - 1.5, 1.0)
        t_next = jnp.where(done | newly_done, t, t + step)
        return t_next, done | newly_done

    t, _ = jax.lax.fori_loop(0, num_iters, body, (t0, done0))
    t = jnp.clip(t - _DDA_BIAS_PX, 0.0, max_px)
    r = t * res
    return jnp.minimum(r, jnp.asarray(grid_map.max_range_meters, dtype=r.dtype))


def cast_rays_lut(grid_map: GridMap, queries: jnp.ndarray) -> jnp.ndarray:
    """Precomputed-LUT ray cast: ONE u8 gather per query.

    Requires ``grid_map.with_range_lut()``. Angle is rounded to the nearest
    of T bins; the origin snaps to its cell. Query outside the map returns
    0 (immediate border hit, matching DDA from an out-of-bounds origin).
    """
    if grid_map.range_lut is None:
        raise ValueError(
            "GridMap has no range LUT — call grid_map.with_range_lut() first"
        )
    res = grid_map.resolution
    h, w = grid_map.height, grid_map.width
    t = grid_map.lut_theta_bins

    gx, gy = _world_to_grid_trunc(
        (queries[:, 0] - grid_map.origin_x) / res,
        (queries[:, 1] - grid_map.origin_y) / res,
    )
    oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
    ang = queries[:, 2]
    # bin = round(theta / (2*pi/T)) mod T, branch-free for any angle
    # jnp's % is floor-mod (unlike lax.rem): already in [0, t) for any sign
    b = jnp.round(ang * (t / (2.0 * jnp.pi))).astype(jnp.int32) % t
    cell = jnp.clip(gy, 0, h - 1) * w + jnp.clip(gx, 0, w - 1)
    if grid_map.lut_row_map is not None:  # compacted LUT (giant maps)
        cell = grid_map.lut_row_map[cell]
    row_stride = grid_map.lut_row_stride or t
    # 2-D (cell, bin) indexing: each index stays < 2^31 even for maps where
    # the flat cell*stride+bin product would overflow int32 (Spielberg-scale)
    lut2d = grid_map.range_lut.reshape(-1, row_stride)
    px = lut2d[cell, b].astype(queries.dtype)
    r = jnp.where(oob, 0.0, px * res)
    return jnp.minimum(r, jnp.asarray(grid_map.max_range_meters, dtype=r.dtype))


def lut_expected_px(
    grid_map: GridMap, particles: jnp.ndarray, beam_angles: jnp.ndarray
) -> jnp.ndarray:
    """Expected ranges in PIXELS for all particle x beam pairs, fused.

    Skips the (N*R, 3) query materialization of the generic contract: the
    LUT index is computed straight from (particles, beams). Pixel-space
    output feeds the analytic sensor model without a meter round-trip.
    Returns (N, R) float32; out-of-map particles read 0 px everywhere.
    """
    if grid_map.range_lut is None:
        raise ValueError(
            "GridMap has no range LUT — call grid_map.with_range_lut() first"
        )
    res = grid_map.resolution
    h, w = grid_map.height, grid_map.width
    t = grid_map.lut_theta_bins
    gx, gy = _world_to_grid_trunc(
        (particles[:, 0] - grid_map.origin_x) / res,
        (particles[:, 1] - grid_map.origin_y) / res,
    )
    oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
    cell = jnp.clip(gy, 0, h - 1) * w + jnp.clip(gx, 0, w - 1)
    if grid_map.lut_row_map is not None:  # compacted LUT (giant maps)
        cell = grid_map.lut_row_map[cell]
    ang = particles[:, 2:3] + beam_angles[None, :]
    # jnp's % is floor-mod (unlike lax.rem): already in [0, t) for any sign
    b = jnp.round(ang * (t / (2.0 * jnp.pi))).astype(jnp.int32) % t
    row_stride = grid_map.lut_row_stride or t
    # 2-D (cell, bin) indexing avoids int32 flat-offset overflow at
    # Spielberg-scale H*W*stride (see cast_rays_lut)
    lut2d = grid_map.range_lut.reshape(-1, row_stride)
    px = lut2d[cell[:, None], b]
    return jnp.where(oob[:, None], 0.0, px.astype(jnp.float32))


def cast_rays(
    grid_map: GridMap,
    queries: jnp.ndarray,
    method: str = "sphere",
    num_iters: int = 48,
) -> jnp.ndarray:
    """Dispatch on backend. Contract identical to the reference's
    calc_range_many: (Q, 3) queries -> (Q,) ranges in meters."""
    if method == "dda":
        return cast_rays_dda(grid_map, queries)
    if method == "sphere":
        return cast_rays_sphere(grid_map, queries, num_iters=num_iters)
    if method == "lut":
        return cast_rays_lut(grid_map, queries)
    raise ValueError(f"Unknown raycast method: {method!r}")
