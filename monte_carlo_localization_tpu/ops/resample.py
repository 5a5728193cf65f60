"""Resampling primitives (device-side, O(N), fully vectorized).

The reference uses multinomial resampling via std::discrete_distribution
(reference src/particle_filter.cpp:657-665). The engine defaults to
low-variance systematic resampling (cumsum + a gather-free scatter/cummax
CDF inversion instead of N sequential draws) and keeps multinomial as a
compatibility mode. Both operate on LOG weights, normalized internally.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _normalized_weights(log_weights: jnp.ndarray) -> jnp.ndarray:
    return jax.nn.softmax(log_weights)


def multinomial_resample_indices(
    key: jax.Array, log_weights: jnp.ndarray, num_samples: int | None = None
) -> jnp.ndarray:
    """N iid draws from Categorical(weights) — reference-compatible mode."""
    n = log_weights.shape[0] if num_samples is None else num_samples
    return jax.random.categorical(key, log_weights, shape=(n,)).astype(jnp.int32)


def systematic_resample_indices(
    key: jax.Array, log_weights: jnp.ndarray, num_samples: int | None = None
) -> jnp.ndarray:
    """Low-variance systematic resampling.

    One uniform offset u0 ~ U[0,1); target position (i + u0)/M for output
    slot i is inverted through the weight CDF. The textbook inversion is
    ``searchsorted(cdf, positions)``, which the compiler of the hardware
    this was first built for lowered to ~log2(N) serialized gather rounds
    (ROADMAP speed item 5 re-measures it on the GPU). Instead the inversion
    is computed scatter-side in
    O(N): source j's FIRST output slot is ``floor(M·cdf[j-1] - u0) + 1``;
    scatter j there (slot collisions between zero-count sources and the one
    covering source resolve with ``max`` — the covering source always has
    the largest j at that slot) and forward-fill with a cumulative max.
    One scatter + one cummax, no gathers. Agrees with the searchsorted
    formulation on every tested platform (pinned by
    tests/test_resample.py), though the two compute the boundary
    comparison in algebraically rearranged f32 forms — a knife-edge
    weight vector could in principle flip one slot by an ulp, and either
    answer is a valid systematic resample.
    """
    n = log_weights.shape[0]
    m = n if num_samples is None else num_samples
    w = _normalized_weights(log_weights)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(key, ())
    return systematic_invert_cdf_window(cdf, u0, m, 0, m)


def systematic_invert_cdf_window(
    cdf: jnp.ndarray,
    u0: jnp.ndarray,
    num_samples: int,
    slot0,
    window: int,
) -> jnp.ndarray:
    """Invert a systematic-resampling CDF for output slots
    ``[slot0, slot0 + window)`` — scatter-side, no gathers.

    With ``g[j] = num_samples·cdf[j] - u0``, source j owns output slots
    ``(g[j-1], g[j]]``, so its first slot is ``floor(g[j-1]) + 1``. Scatter
    j into the window (out-of-window slots drop; collisions between
    zero-count sources and the covering source resolve with ``max`` — the
    covering source always carries the largest j at its slot), seed slot 0
    with the boundary source covering ``slot0`` (the smallest j with
    ``g[j] >= slot0``, i.e. ``#{j: g[j] < slot0}`` — a pure reduction),
    and forward-fill with a cumulative max. ``slot0`` may be traced (the
    sharded filter passes ``shard · n_local``); ``window`` must be static.
    Returns int32 ``(window,)`` source indices.
    """
    n = cdf.shape[0]
    g = num_samples * cdf - u0
    first_slot = (
        jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.floor(g[:-1]).astype(jnp.int32) + 1]
        )
        - slot0
    )
    src = jnp.arange(n, dtype=jnp.int32)
    seeded = jnp.zeros(window, jnp.int32).at[first_slot].max(src, mode="drop")
    j0 = jnp.sum((g < slot0).astype(jnp.int32))
    seeded = seeded.at[0].max(j0)
    return jnp.clip(jax.lax.cummax(seeded), 0, n - 1)


def systematic_resample_rows(
    key: jax.Array,
    log_weights: jnp.ndarray,
    particles: jnp.ndarray,
    num_samples: int | None = None,
) -> jnp.ndarray:
    """Systematic resampling that MATERIALIZES the proposal rows without a
    gather.

    ``particles[systematic_resample_indices(...)]`` pays an (M, D) scattered
    gather. Ownership of output slots is already
    known scatter-side (see :func:`systematic_invert_cdf_window`): source j
    covers the contiguous slot range ``[floor(g[j-1])+1, floor(g[j])]`` with
    ``g[j] = M*cdf[j] - u0``, so each covered source scatters its ROW into
    its first slot (at most one writer per slot — zero-count sources are
    dropped outright instead of max-resolved) and a "last valid wins"
    associative scan forward-fills the remaining slots. One (M, D) scatter +
    one log-depth elementwise scan, no gathers. Bitwise-identical to the
    gather formulation (same g arithmetic, same ownership; pinned by
    tests/test_resample.py).
    """
    n = log_weights.shape[0]
    m = n if num_samples is None else num_samples
    w = _normalized_weights(log_weights)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(key, ())

    g = m * cdf - u0
    floors = jnp.floor(g).astype(jnp.int32)
    prev = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), floors[:-1]]
    )
    # source j owns slots [prev[j]+1, floors[j]]; it owns at least one
    # slot iff floors[j] > prev[j], and first slots of covered sources are
    # strictly increasing, so each slot has at most ONE writer
    covered = floors > prev
    target = jnp.where(covered, prev + 1, m)  # m = out of range -> dropped
    valid = (
        jnp.zeros((m,), jnp.bool_).at[target].set(True, mode="drop")
    )
    rows = (
        jnp.zeros((m,) + particles.shape[1:], particles.dtype)
        .at[target]
        .set(particles, mode="drop")
    )

    def last_valid(a, b):
        av, ar = a
        bv, br = b
        keep_b = bv.reshape(bv.shape + (1,) * (br.ndim - bv.ndim))
        return av | bv, jnp.where(keep_b, br, ar)

    # Seed slot 0 with its covering source j0 = #{j: g[j] < 0}, exactly as
    # systematic_invert_cdf_window does. In exact arithmetic the scatter
    # already wrote particles[j0] there (g[n-1] = m - u0 >= 0 guarantees a
    # writer), but f32 cumsum round-off can leave cdf[n-1] < 1 and — for
    # small m and u0 on the knife edge — no j with floors[j] >= 0 at all;
    # the clip then lands on source n-1, matching the indices version.
    j0 = jnp.clip(jnp.sum((g < 0).astype(jnp.int32)), 0, n - 1)
    rows = rows.at[0].set(jnp.take(particles, j0, axis=0))
    valid = valid.at[0].set(True)
    _, filled = jax.lax.associative_scan(last_valid, (valid, rows))
    return filled


def _last_valid_scan(valid: jnp.ndarray, rows: jnp.ndarray):
    """Forward-fill ``rows`` with the last valid row (associative scan)."""

    def last_valid(a, b):
        av, ar = a
        bv, br = b
        keep_b = bv.reshape(bv.shape + (1,) * (br.ndim - bv.ndim))
        return av | bv, jnp.where(keep_b, br, ar)

    return jax.lax.associative_scan(last_valid, (valid, rows))


def distributed_systematic_resample_rows(
    particles: jnp.ndarray,
    global_cdf_local: jnp.ndarray,
    u0: jnp.ndarray,
    num_total: int,
    axis: str,
    num_shards: int,
    fringe: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bucketed distributed systematic resampling — call INSIDE shard_map.

    The straightforward sharded resampler all-gathers the full (N, D)
    particle matrix plus the (N,) global CDF every step (O(N) bytes between
    devices,
    the SURVEY §7 hard-part-6 anti-pattern). This version exchanges only
    what actually crosses shards:

    * Shard p owns global sources ``[p*n_local, (p+1)*n_local)`` and output
      slots of the same range. With ``g[j] = N*cdf[j] - u0``, source j's
      first output slot is ``floor(g[j-1]) + 1`` (the scatter-side
      inversion of :func:`systematic_invert_cdf_window`); since shard
      weight totals concentrate around 1/D, a source's first slot lands
      near its own index — each shard scatters its covered sources' ROWS
      into a local buffer spanning its own slot window plus a ``fringe``
      of C slots on each side.
    * The two C-row fringes ride ONE ``ppermute`` each to the neighbor
      shards (O(C) bytes instead of O(N); every slot has exactly one
      covered writer globally, so merging is a validity select).
    * Slot ``p*n_local`` may be covered by a source with no writer in any
      fringe (a long run from a far shard). Its covering source index
      ``j0_p = #{j: g[j] < p*n_local}`` is an exact integer ``psum`` of
      local counts, and the (D, row) seed-row table is one tiny masked
      ``psum`` — runs of any length are then forward-filled locally.
    * A source whose first slot falls OUTSIDE its shard's fringe window
      (extreme cross-shard weight imbalance) flips the returned overflow
      flag (an exact psum, identical on every shard); the caller falls
      back to the all-gather path for that step via ``lax.cond``.

    Bitwise equality with ``all_particles[systematic_invert_cdf_window(
    all_cdf, ...)]`` (pinned in tests): the g arithmetic consumes the same
    floats (the boundary ``g[j-1]`` crosses shards by value via a scalar
    ppermute, never recomputed), ownership resolution is equivalent
    (the max-index scatter winner is always the covering source), and the
    row forward-fill mirrors :func:`systematic_resample_rows`.

    Returns ``(rows (n_local, ...), overflow () bool)``.
    """
    n_local = particles.shape[0]
    d = num_shards
    c = int(min(max(fringe, 1), n_local))
    shard = jax.lax.axis_index(axis)

    g = num_total * global_cdf_local - u0  # this shard's g segment
    # previous shard's LAST g value, by value (shard 0 is overridden below)
    g_prev_last = jax.lax.ppermute(
        g[-1], axis, [(i, i + 1) for i in range(d - 1)]
    )
    prev_floor = jnp.concatenate(
        [jnp.floor(g_prev_last)[None], jnp.floor(g[:-1])]
    ).astype(jnp.int32)
    # global source 0's first slot is DEFINED as 0 (matching
    # systematic_invert_cdf_window's leading zero), independent of g
    prev_floor = jnp.where(
        (shard == 0) & (jnp.arange(n_local) == 0), -1, prev_floor
    )
    floors = jnp.floor(g).astype(jnp.int32)
    covered = floors > prev_floor  # covers >= 1 slot; unique writer/slot

    first_slot = prev_floor + 1  # global slot index
    buf_len = n_local + 2 * c
    fb = first_slot - (shard * n_local - c)  # buffer coordinate
    in_buf = (fb >= 0) & (fb < buf_len)
    overflow_local = jnp.any(covered & ~in_buf)
    target = jnp.where(covered & in_buf, fb, buf_len)  # buf_len -> dropped
    buf_rows = (
        jnp.zeros((buf_len,) + particles.shape[1:], particles.dtype)
        .at[target]
        .set(particles, mode="drop")
    )
    buf_valid = (
        jnp.zeros((buf_len,), jnp.bool_).at[target].set(True, mode="drop")
    )

    # fringe exchange: my LEFT fringe belongs to shard p-1's slot window,
    # my RIGHT fringe to shard p+1's. Missing links zero-fill (invalid).
    perm_up = [(i, i + 1) for i in range(d - 1)]  # data moves p -> p+1
    perm_dn = [(i + 1, i) for i in range(d - 1)]  # data moves p -> p-1
    from_left_rows = jax.lax.ppermute(buf_rows[n_local + c:], axis, perm_up)
    from_left_valid = jax.lax.ppermute(buf_valid[n_local + c:], axis, perm_up)
    from_right_rows = jax.lax.ppermute(buf_rows[:c], axis, perm_dn)
    from_right_valid = jax.lax.ppermute(buf_valid[:c], axis, perm_dn)

    rows = buf_rows[c:c + n_local]
    valid = buf_valid[c:c + n_local]
    # exactly one covered writer exists per slot globally, so the merge is
    # a pure select on the received validity
    sel_l = from_left_valid.reshape((c,) + (1,) * (rows.ndim - 1))
    rows = rows.at[:c].set(jnp.where(sel_l, from_left_rows, rows[:c]))
    valid = valid.at[:c].set(valid[:c] | from_left_valid)
    sel_r = from_right_valid.reshape((c,) + (1,) * (rows.ndim - 1))
    rows = rows.at[n_local - c:].set(
        jnp.where(sel_r, from_right_rows, rows[n_local - c:])
    )
    valid = valid.at[n_local - c:].set(valid[n_local - c:] | from_right_valid)

    # seed slot p*n_local with its covering source's row: j0 by exact
    # integer psum, the row by a masked psum of the owning shard's row
    boundaries = jnp.arange(d, dtype=jnp.float32) * n_local
    counts_local = jnp.sum(
        (g[:, None] < boundaries[None, :]).astype(jnp.int32), axis=0
    )
    j0 = jnp.clip(jax.lax.psum(counts_local, axis), 0, num_total - 1)  # (D,)
    local_idx = j0 - shard * n_local
    mine = (local_idx >= 0) & (local_idx < n_local)
    contrib = jnp.where(
        mine.reshape((d,) + (1,) * (particles.ndim - 1)),
        particles[jnp.clip(local_idx, 0, n_local - 1)],
        jnp.zeros((), particles.dtype),
    )
    seeds = jax.lax.psum(contrib, axis)  # (D, ...) on every shard
    rows = rows.at[0].set(jax.lax.dynamic_index_in_dim(
        seeds, shard, keepdims=False
    ))
    valid = valid.at[0].set(True)

    _, filled = _last_valid_scan(valid, rows)
    overflow = jax.lax.psum(overflow_local.astype(jnp.int32), axis) > 0
    return filled, overflow


def resample_indices(
    key: jax.Array,
    log_weights: jnp.ndarray,
    method: str = "systematic",
    num_samples: int | None = None,
) -> jnp.ndarray:
    if method == "systematic":
        return systematic_resample_indices(key, log_weights, num_samples)
    if method == "multinomial":
        return multinomial_resample_indices(key, log_weights, num_samples)
    raise ValueError(f"Unknown resample method: {method!r}")


def resample_rows(
    key: jax.Array,
    log_weights: jnp.ndarray,
    particles: jnp.ndarray,
    method: str = "systematic",
    num_samples: int | None = None,
) -> jnp.ndarray:
    """Resampled proposal rows; gather-free for the systematic default."""
    if method == "systematic":
        return systematic_resample_rows(key, log_weights, particles, num_samples)
    idx = resample_indices(key, log_weights, method, num_samples)
    return particles[idx]
