"""Tests for the fused LUT likelihood behind ``raycast_method="lut_pallas"``
(ops/pallas_lut.py).

The addressing and the likelihood are pinned against a numpy oracle that
replicates the static bin decomposition (b0 + k*j + e_j over the padded
row) with exact erf (reference likelihood contract, reference
src/particle_filter.cpp:506-583), over every LUT layout the filters use.
"""

import math

import numpy as np
import pytest
from scipy.special import erf as scipy_erf

import jax.numpy as jnp

from monte_carlo_localization_tpu.mapping.range_lut import lut_dtype
from monte_carlo_localization_tpu.ops.pallas_lut import (
    beam_geometry,
    beam_lanes,
    build_lut_query_fn,
    entries_per_subrow,
    lut_address,
    required_row_stride,
    suggest_theta_bins,
)

Z_HIT, Z_SHORT, Z_MAX, Z_RAND = 0.80, 0.05, 0.05, 0.10
SIGMA = 8.0
INV_SQUASH = 1.0 / 2.2
RES = 0.05

BEAMS_60 = np.linspace(-2.35, 2.35, 60).astype(np.float32)
BEAMS = {
    16: np.linspace(-2.35, 2.35, 16).astype(np.float32),
    60: BEAMS_60,
    1080: np.linspace(-0.75 * np.pi, 0.75 * np.pi, 1080).astype(np.float32),
}
DTYPES = {"u8": 120, "u16": 600}  # max_range_px -> u8 / u16 LUT


def _make_lut(rng, n_rows, row_stride, t_bins, max_range_px):
    """Random padded LUT with proper wraparound tail (entry b = bin b%T)."""
    base = rng.integers(0, max_range_px + 1, size=(n_rows, t_bins)).astype(
        lut_dtype(max_range_px)
    )
    reps = -(-row_stride // t_bins)
    return np.tile(base, (1, reps))[:, :row_stride].copy()


def _np_loglik(lut2d, row, b0, oob, q, obs_px, max_range_px):
    """Numpy twin of the likelihood over given addresses, exact erf, f64.
    ``obs_px`` is (F, R): one scan per contiguous group of N/F particles."""
    m = float(max_range_px)
    f, r = obs_px.shape
    d = lut2d[row[:, None], b0[:, None] + q[None, :]].astype(np.float64)
    d = np.minimum(d, m)
    obs = np.repeat(np.minimum(obs_px, m), len(row) // f, axis=0)
    gauss_coef = Z_HIT / (SIGMA * math.sqrt(2 * math.pi))
    z = obs - d
    p = gauss_coef * np.exp(-(z * z) / (2 * SIGMA * SIGMA))
    p = p + np.where(obs < d, 2 * Z_SHORT * (d - obs) / np.maximum(d, 1.0), 0)
    p = p + np.where(obs >= m, Z_MAX, 0.0)
    p = p + np.where(obs < m, Z_RAND / m, 0.0)
    sq2 = math.sqrt(2.0) * SIGMA
    gauss_sum = 0.5 * (
        scipy_erf((m - d + 0.5) / sq2) - scipy_erf((-d - 0.5) / sq2)
    )
    norm = (
        Z_HIT * gauss_sum
        + np.where(d > 0, Z_SHORT * (d + 1.0), 0.0)
        + Z_MAX
        + Z_RAND
    )
    logp = np.log(np.maximum(p, 1e-35)) - np.log(norm)
    return np.where(oob, -1e4, INV_SQUASH * logp.sum(axis=1))


def _np_address(particles, beams, t_bins, *, height, width, origin_x=0.0,
                origin_y=0.0):
    """Single-map dense addressing in numpy (f32 like the device)."""
    base, _, _ = beam_geometry(beams, t_bins)
    gx = ((particles[:, 0] - np.float32(origin_x)) / RES).astype(np.int32)
    gy = ((particles[:, 1] - np.float32(origin_y)) / RES).astype(np.int32)
    oob = (gx < 0) | (gx >= width) | (gy < 0) | (gy >= height)
    row = np.clip(gy, 0, height - 1) * width + np.clip(gx, 0, width - 1)
    b0 = np.round(particles[:, 2] * np.float32(t_bins / (2 * math.pi)))
    b0 = (b0.astype(np.int64) + base) % t_bins
    return row, b0, oob


def _oracle_logw(lut2d, particles, obs_px, beams, t_bins, max_range_px, *,
                 height, width, origin_x=0.0, origin_y=0.0):
    row, b0, oob = _np_address(particles, beams, t_bins, height=height,
                               width=width, origin_x=origin_x,
                               origin_y=origin_y)
    _, q = beam_lanes(beams, t_bins)
    return _np_loglik(lut2d, row, b0, oob, q, np.atleast_2d(obs_px),
                      max_range_px)


def _build(beams, num_particles, *, height, width, max_range_px=120,
           t_bins=None, **kw):
    t = t_bins or suggest_theta_bins(beams)
    dtype = lut_dtype(max_range_px)
    stride = required_row_stride(t, beams, itemsize=dtype.itemsize)
    query = build_lut_query_fn(
        t, beams, num_particles,
        height=height, width=width, resolution=RES,
        origin_x=0.0, origin_y=0.0, max_range_px=max_range_px,
        row_stride=stride,
        z_hit=Z_HIT, z_short=Z_SHORT, z_max=Z_MAX, z_rand=Z_RAND,
        sigma_hit=SIGMA, inv_squash=INV_SQUASH, lut_dtype=dtype, **kw,
    )
    return query, t, stride


def _particles(rng, n, height, width, kind="random"):
    if kind == "out_of_map":  # map is only width*RES m wide
        x = rng.uniform(-2.0, width * RES + 2.0, n)
        y = rng.uniform(-2.0, height * RES + 2.0, n)
    else:
        x = rng.uniform(0.01, width * RES - 0.01, n)
        y = rng.uniform(0.01, height * RES - 0.01, n)
    if kind == "wraparound":  # b0 near T: the read window crosses the pad
        theta = rng.uniform(2 * math.pi - 0.3, 2 * math.pi + 0.3, n)
    else:
        theta = rng.uniform(-2 * math.pi, 2 * math.pi, n)
    return np.stack([x, y, theta], 1).astype(np.float32)


def _run_case(rng, beams, n, height=24, width=32, t_bins=None,
              kind="random", max_range_px=120):
    query, t, stride = _build(
        beams, n, height=height, width=width, t_bins=t_bins,
        max_range_px=max_range_px,
    )
    lut2d = _make_lut(rng, height * width, stride, t, max_range_px)
    particles = _particles(rng, n, height, width, kind)
    obs_px = rng.uniform(0, max_range_px, len(beams)).astype(np.float32)
    got = np.asarray(
        query(jnp.asarray(lut2d.reshape(-1)), jnp.asarray(particles),
              jnp.asarray(obs_px))
    )
    want = _oracle_logw(lut2d, particles, obs_px.astype(np.float64), beams,
                        t, max_range_px, height=height, width=width)
    return got, want


def _assert_close(got, want):
    """Per particle |d| <= 1e-4 |ref| + 1e-3 with the same best particle:
    f32 sums over <= 1080 beams against the f64 oracle."""
    err = np.abs(np.asarray(got, np.float64) - want)
    tol = 1e-4 * np.abs(want) + 1e-3
    assert (err <= tol).all(), (err.max(), err[err > tol][:5])
    assert np.argmax(got) == np.argmax(want)


class TestGeometryHelpers:
    def test_suggest_theta_bins_near_target(self):
        # downsampled 60-beam scan must keep fine angular quantization by
        # using k bins per beam step, not degrade to one bin per beam
        t = suggest_theta_bins(BEAMS_60)
        assert 1000 <= t <= 2000
        base, k, e = beam_geometry(BEAMS_60, t)
        assert k >= 2
        # full-res 1080-beam scan lands on k=1
        t2 = suggest_theta_bins(BEAMS[1080])
        assert beam_geometry(BEAMS[1080], t2)[1] == 1

    def test_beam_geometry_reconstructs_bins(self):
        for t in (79, 160, 1439):
            base, k, e = beam_geometry(BEAMS_60, t)
            delta = 2 * math.pi / t
            bins = np.round(BEAMS_60.astype(np.float64) / delta).astype(int)
            rec = base + k * np.arange(len(BEAMS_60)) + e
            np.testing.assert_array_equal(rec, bins)
            assert e.min() == 0

    def test_window_and_stride_invariants(self):
        """Any read window [b0, b0 + span) with b0 < T fits one physical
        row, and the stride is a whole number of 512 B storage tiles."""
        for itemsize in (1, 2):
            eps = entries_per_subrow(itemsize)
            for t in (79, suggest_theta_bins(BEAMS_60)):
                s = required_row_stride(t, BEAMS_60, itemsize)
                assert s % eps == 0
                _, q = beam_lanes(BEAMS_60, t)
                assert (t - 1) + int(q.max()) < s

    def test_window_exceeding_t_rejected(self):
        # tiny T: the beam span no longer fits a single circle row
        with pytest.raises(ValueError):
            required_row_stride(32, BEAMS_60)


class TestKernelParity:
    def test_random_particles_60_beams(self):
        rng = np.random.default_rng(0)
        got, want = _run_case(rng, BEAMS_60, 64)
        _assert_close(got, want)

    def test_wraparound_bins(self):
        """Headings that put b0 near T (window crosses the wraparound pad)."""
        rng = np.random.default_rng(1)
        got, want = _run_case(rng, BEAMS_60, 48, kind="wraparound")
        _assert_close(got, want)

    def test_every_residual_shift_exercised(self):
        """A beam set whose residuals span several distinct (monotone)
        shifts: spacing slightly wider than one bin accumulates e = 0..4."""
        rng = np.random.default_rng(2)
        t = suggest_theta_bins(BEAMS_60)
        delta = 2 * math.pi / t
        beams = (np.arange(60) * delta * 1.07 - 2.0).astype(np.float32)
        base, k, e = beam_geometry(beams, t)
        assert k == 1
        assert len(set(e.tolist())) >= 3, "case must exercise >2 shifts"
        got, want = _run_case(rng, beams, 32, t_bins=t)
        _assert_close(got, want)

    def test_non_injective_beams_rejected(self):
        """Non-monotone residuals would merge two beams onto one bin —
        the builder must reject instead of silently miscomputing."""
        t = 79  # one bin per beam step: adjacent beams can collide
        delta = 2 * math.pi / t
        beams = BEAMS_60.copy()
        beams[7] += 1.4 * delta  # push beam 7 onto beam 8's bin
        beams[8] -= 0.4 * delta
        base, k, e = beam_geometry(beams, t)
        assert len(set((k * np.arange(60) + e).tolist())) < 60
        with pytest.raises(ValueError):
            _build(beams, 16, height=8, width=8, t_bins=t)

    def test_out_of_map_particles(self):
        rng = np.random.default_rng(3)
        got, want = _run_case(rng, BEAMS_60, 48, kind="out_of_map")
        oob = got == -1e4
        assert oob.any(), "case must include out-of-map particles"
        _assert_close(got, want)

    def test_block_boundary_and_padding(self):
        """Identical particles anywhere in an odd-sized batch produce
        identical log-weights; different ones do not."""
        rng = np.random.default_rng(4)
        n, block = 45, 16
        query, t, stride = _build(BEAMS_60, n, height=24, width=32)
        lut2d = _make_lut(rng, 24 * 32, stride, t, 120)
        one = np.array([0.7, 0.6, 1.1], np.float32)
        particles = np.tile(one, (n, 1))
        particles[:block] = np.array([0.3, 0.2, -0.4], np.float32)
        obs = rng.uniform(0, 120, 60).astype(np.float32)
        got = np.asarray(
            query(jnp.asarray(lut2d.reshape(-1)), jnp.asarray(particles),
                  jnp.asarray(obs))
        )
        assert np.allclose(got[block:], got[block], atol=0), (
            "same particle in different blocks must agree exactly"
        )
        assert not np.isclose(got[0], got[block])

    def test_heavy_duplicate_windows(self):
        """Converged-cloud shape: most particles share one cell+heading
        (so most read windows are identical), in shuffled order, spanning
        blocks — oracle parity must hold."""
        rng = np.random.default_rng(6)
        n, height, width = 64, 24, 32
        query, t, stride = _build(BEAMS_60, n, height=height,
                                        width=width)
        lut2d = _make_lut(rng, height * width, stride, t, 120)
        particles = np.empty((n, 3), np.float32)
        # keep poses OFF cell-boundary multiples of the 0.05 resolution
        particles[:] = np.array([0.71, 0.63, 1.1], np.float32)
        particles[5] = [0.32, 0.21, -0.4]
        particles[23] = [1.12, 0.94, 2.0]
        particles[24] = [1.12, 0.94, 2.0]
        particles[49] = [0.22, 1.03, 0.1]
        rng.shuffle(particles)
        obs = rng.uniform(0, 120, 60).astype(np.float32)
        got = np.asarray(
            query(jnp.asarray(lut2d.reshape(-1)), jnp.asarray(particles),
                  jnp.asarray(obs))
        )
        want = _oracle_logw(lut2d, particles, obs.astype(np.float64),
                            BEAMS_60, t, 120, height=height, width=width)
        _assert_close(got, want)

    def test_1080_beam_headline_geometry(self):
        rng = np.random.default_rng(5)
        got, want = _run_case(rng, BEAMS[1080], 16, height=16, width=16)
        _assert_close(got, want)

    def test_row_stride_too_small_rejected(self):
        t = suggest_theta_bins(BEAMS_60)
        need = required_row_stride(t, BEAMS_60)
        with pytest.raises(ValueError):
            build_lut_query_fn(
                t, BEAMS_60, 16, height=8, width=8, resolution=RES,
                origin_x=0.0, origin_y=0.0, max_range_px=100,
                row_stride=need - 512,
                z_hit=Z_HIT, z_short=Z_SHORT, z_max=Z_MAX, z_rand=Z_RAND,
                sigma_hit=SIGMA, inv_squash=INV_SQUASH,
            )

    def test_bad_block_divisor_rejected(self):
        """The particles of a fleet query split into equal member blocks:
        a count that does not divide over the members is rejected."""
        t = suggest_theta_bins(BEAMS_60)
        with pytest.raises(ValueError):
            build_lut_query_fn(
                t, BEAMS_60, 17, height=8, width=8, resolution=RES,
                origin_x=0.0, origin_y=0.0, max_range_px=100,
                row_stride=required_row_stride(t, BEAMS_60),
                z_hit=Z_HIT, z_short=Z_SHORT, z_max=Z_MAX, z_rand=Z_RAND,
                sigma_hit=SIGMA, inv_squash=INV_SQUASH,
                num_members=4,
            )


class TestKernelParityU16:
    """Long-range maps (max_range_px > 254) use a u16 LUT: 256 entries per
    512 B storage tile instead of 512. Same oracle, other element type."""

    def test_random_particles_u16(self):
        rng = np.random.default_rng(10)
        got, want = _run_case(rng, BEAMS_60, 64, max_range_px=600)
        _assert_close(got, want)

    def test_wraparound_bins_u16(self):
        rng = np.random.default_rng(11)
        got, want = _run_case(rng, BEAMS_60, 48, kind="wraparound",
                              max_range_px=600)
        _assert_close(got, want)

    def test_1080_beams_u16(self):
        rng = np.random.default_rng(12)
        got, want = _run_case(rng, BEAMS[1080], 16, height=16, width=16,
                              max_range_px=300)
        _assert_close(got, want)

    def test_bad_stride_rejected_u16(self):
        """Too-small and non-256-multiple strides must fail the u16 guards
        (u16 tiles hold 256 entries, so alignment is finer than u8)."""
        t = suggest_theta_bins(BEAMS_60)
        s_u16 = required_row_stride(t, BEAMS_60, itemsize=2)
        assert s_u16 % 256 == 0

        def build(stride):
            return build_lut_query_fn(
                t, BEAMS_60, 16, height=8, width=8, resolution=RES,
                origin_x=0.0, origin_y=0.0, max_range_px=600,
                row_stride=stride,
                z_hit=Z_HIT, z_short=Z_SHORT, z_max=Z_MAX, z_rand=Z_RAND,
                sigma_hit=SIGMA, inv_squash=INV_SQUASH,
                lut_dtype=np.uint16,
            )

        with pytest.raises(ValueError):
            build(s_u16 - 256)  # below the required stride
        with pytest.raises(ValueError):
            build(s_u16 + 128)  # not a multiple of the tile

    def test_long_range_filter_end_to_end(self, beams60, make_scan):
        """A lut_pallas ParticleFilter on a max_range_px>254 map localizes:
        the u16 LUT is selected automatically and the weighted pose lands
        at the true pose."""
        from monte_carlo_localization_tpu.config import MCLConfig
        from monte_carlo_localization_tpu.filter import ParticleFilter
        from monte_carlo_localization_tpu.mapping import random_obstacle_world

        gm = random_obstacle_world(
            height=96, width=96, num_obstacles=12, seed=7,
            resolution=0.05, max_range_meters=20.0,  # 400 px > 254 -> u16
        )
        assert gm.max_range_px > 254
        pose = np.array([2.4, 2.4, 0.5], np.float32)
        scan = make_scan(gm, pose, beams60)
        pf = ParticleFilter(
            gm, MCLConfig(max_particles=256, raycast_method="lut_pallas")
        )
        pf.set_beam_angles(beams60)
        assert np.asarray(pf.grid_map.range_lut).dtype == np.uint16
        state = pf.init_pose(pose, seed=0)
        state, est = pf.step(state, np.zeros(3, np.float32), scan)
        est = np.asarray(est)
        assert np.linalg.norm(est[:2] - pose[:2]) < 0.3, est


@pytest.mark.parametrize("kind", ["random", "wraparound", "out_of_map"])
@pytest.mark.parametrize("num_beams", [16, 60, 1080])
@pytest.mark.parametrize("dtype", ["u8", "u16"])
def test_likelihood_matches_oracle(dtype, num_beams, kind):
    """The lut_pallas query against the numpy oracle: element type x beam
    count x particle placement."""
    rng = np.random.default_rng(100 + num_beams)
    beams = BEAMS[num_beams]
    n = 21 if num_beams == 1080 else 37
    mr = DTYPES[dtype]
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, lut_dtype(mr).itemsize)
    h, w = 12, 16
    lut2d = _make_lut(rng, h * w, stride, t, mr)
    particles = _particles(rng, n, h, w, kind)
    obs = rng.uniform(0, mr, num_beams).astype(np.float32)
    query, _, _ = _build(beams, n, height=h, width=w, max_range_px=mr)
    got = np.asarray(query(jnp.asarray(lut2d), jnp.asarray(particles),
                           jnp.asarray(obs)))
    want = _oracle_logw(lut2d, particles, obs.astype(np.float64), beams, t,
                        mr, height=h, width=w)
    _assert_close(got, want)
    if kind == "out_of_map":
        assert (want == -1e4).any()
        np.testing.assert_array_equal(got == -1e4, want == -1e4)


def _layout_case(rng, layout, mr):
    """(query kwargs, lut2d, particles, obs (F, R), numpy row/b0/oob) for
    one LUT layout on small random maps."""
    beams = BEAMS_60
    t = suggest_theta_bins(beams)
    dt = lut_dtype(mr)
    stride = required_row_stride(t, beams, dt.itemsize)
    tiles = stride // entries_per_subrow(dt.itemsize)
    base, _, _ = beam_geometry(beams, t)
    npm, f = 24, 4
    n = npm * f
    theta = rng.uniform(-2 * math.pi, 2 * math.pi, n).astype(np.float32)
    b0 = (np.round(theta * np.float32(t / (2 * math.pi))).astype(np.int64)
          + base) % t
    obs = rng.uniform(0, mr, (f, len(beams))).astype(np.float32)
    build = dict(t_bins=t, row_stride=stride, lut_dtype=dt)
    if layout in ("compact", "fleet_shared"):
        h, w = 10, 14
        x = rng.uniform(-0.2, w * RES + 0.2, n)
        y = rng.uniform(-0.2, h * RES + 0.2, n)
        parts = np.stack([x, y, theta], 1).astype(np.float32)
        gx = (parts[:, 0] / RES).astype(np.int32)
        gy = (parts[:, 1] / RES).astype(np.int32)
        oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
        cell = np.clip(gy, 0, h - 1) * w + np.clip(gx, 0, w - 1)
        if layout == "compact":
            k_rows = 40
            row_map = rng.integers(0, k_rows, h * w).astype(np.int32)
            lut2d = _make_lut(rng, k_rows, stride, t, mr)
            kw = dict(row_map=jnp.asarray(row_map))
            return (dict(build, height=h, width=w, num_members=1), kw,
                    lut2d, parts, obs[:1],
                    (row_map[cell], b0, oob))
        lut2d = _make_lut(rng, h * w, stride, t, mr)
        return (dict(build, height=h, width=w, num_members=f), {}, lut2d,
                parts, obs, (cell, b0, oob))
    # heterogeneous: two maps of different true shapes, 4 members
    dims = np.array([[9, 13], [12, 8]], np.int32)
    origins = (np.array([-0.3, 1.1], np.float32),
               np.array([0.4, -0.7], np.float32))
    map_of = np.array([1, 0, 0, 1], np.int32)
    mi = map_of[np.arange(n) // npm]
    hm, wm = dims[mi, 0], dims[mi, 1]
    x = origins[0][mi] + rng.uniform(-0.1, 1.1, n) * wm * RES
    y = origins[1][mi] + rng.uniform(-0.1, 1.1, n) * hm * RES
    parts = np.stack([x, y, theta], 1).astype(np.float32)
    gx = ((parts[:, 0] - origins[0][mi]) / np.float32(RES)).astype(np.int32)
    gy = ((parts[:, 1] - origins[1][mi]) / np.float32(RES)).astype(np.int32)
    oob = (gx < 0) | (gx >= wm) | (gy < 0) | (gy >= hm)
    cell = np.clip(gy, 0, hm - 1) * wm + np.clip(gx, 0, wm - 1)
    cells = dims[:, 0] * dims[:, 1]
    kw = dict(member_base=0, origins=tuple(map(jnp.asarray, origins)),
              map_of=jnp.asarray(map_of), dims=jnp.asarray(dims))
    if layout == "hetero_tight":
        rows_per_map = cells
        local = cell
    else:  # hetero_compact: per-map row maps into per-map compact blocks
        rows_per_map = np.array([15, 11])
        rmaps = [rng.integers(0, k, c).astype(np.int32)
                 for k, c in zip(rows_per_map, cells)]
        rm_bases = np.array([0, cells[0]], np.int32)
        local = np.concatenate(rmaps)[rm_bases[mi] + cell]
        kw.update(row_map=jnp.asarray(np.concatenate(rmaps)),
                  row_map_bases=jnp.asarray(rm_bases))
    row_base = np.array([0, rows_per_map[0]])
    kw["lut_bases"] = jnp.asarray((row_base * tiles).astype(np.int32))
    lut2d = _make_lut(rng, int(rows_per_map.sum()), stride, t, mr)
    return (dict(build, height=12, width=13, num_members=f,
                 per_member_maps=True), kw, lut2d, parts, obs,
            (row_base[mi] + local, b0, oob))


@pytest.mark.parametrize("dtype", ["u8", "u16"])
@pytest.mark.parametrize(
    "layout", ["compact", "fleet_shared", "hetero_tight", "hetero_compact"]
)
def test_layouts_match_oracle(layout, dtype):
    """Every fleet LUT layout, both element types: the query == the numpy
    oracle over numpy addressing."""
    rng = np.random.default_rng(7)
    mr = DTYPES[dtype]
    build, kw, lut2d, parts, obs, (row, b0, oob) = _layout_case(
        rng, layout, mr
    )
    t = build.pop("t_bins")
    query = build_lut_query_fn(
        t, BEAMS_60, len(parts), resolution=RES, origin_x=0.0, origin_y=0.0,
        max_range_px=mr, z_hit=Z_HIT, z_short=Z_SHORT, z_max=Z_MAX,
        z_rand=Z_RAND, sigma_hit=SIGMA, inv_squash=INV_SQUASH, **build,
    )
    got = np.asarray(query(jnp.asarray(lut2d.reshape(-1)),
                           jnp.asarray(parts), jnp.asarray(obs), **kw))
    _, q = beam_lanes(BEAMS_60, t)
    want = _np_loglik(lut2d, row, b0, oob, q, obs.astype(np.float64), mr)
    _assert_close(got, want)


@pytest.mark.parametrize(
    "layout", ["dense", "compact", "hetero_tight", "hetero_compact",
               "hetero_padded"]
)
def test_lut_address_matches_numpy(layout):
    """The one addressing function against numpy, per layout."""
    rng = np.random.default_rng(8)
    t = suggest_theta_bins(BEAMS_60)
    stride = required_row_stride(t, BEAMS_60, 1)
    common = dict(t_bins=t, base=beam_geometry(BEAMS_60, t)[0],
                  resolution=RES, row_stride=stride, subrow_entries=512)
    if layout in ("dense", "compact"):
        h, w = 10, 14
        parts = _particles(rng, 50, h, w, "out_of_map")
        row_np, b0_np, oob_np = _np_address(parts, BEAMS_60, t, height=h,
                                            width=w)
        kw = {}
        if layout == "compact":
            rm = rng.integers(0, 30, h * w).astype(np.int32)
            kw["row_map"] = jnp.asarray(rm)
            row_np = rm[row_np]
        row, b0, oob = lut_address(jnp.asarray(parts), height=h, width=w,
                                   origin_x=0.0, origin_y=0.0, **common, **kw)
    elif layout == "hetero_padded":
        # stacked maps padded to a common (H, W): block i starts at i*H*W
        h, w, f, npm = 10, 14, 3, 16
        origins = (np.array([0.0, -1.0, 2.0], np.float32),
                   np.array([0.5, 0.0, -0.5], np.float32))
        mi = 1 + np.arange(f * npm) // npm  # member_base=1 of 4 members
        mi = np.array([2, 0, 1, 2])[mi]     # map_of
        parts = _particles(rng, f * npm, h, w, "out_of_map")
        parts[:, 0] += origins[0][mi]
        parts[:, 1] += origins[1][mi]
        gx = ((parts[:, 0] - origins[0][mi]) / np.float32(RES)).astype(np.int32)
        gy = ((parts[:, 1] - origins[1][mi]) / np.float32(RES)).astype(np.int32)
        oob_np = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
        row_np = mi * h * w + np.clip(gy, 0, h - 1) * w + np.clip(gx, 0, w - 1)
        _, b0_np, _ = _np_address(parts, BEAMS_60, t, height=h, width=w)
        row, b0, oob = lut_address(
            jnp.asarray(parts), height=h, width=w, origin_x=0.0,
            origin_y=0.0, num_members=f, per_member_maps=True,
            member_base=1, origins=tuple(map(jnp.asarray, origins)),
            map_of=jnp.asarray([2, 0, 1, 2]), **common,
        )
    else:
        build, kw, _, parts, _, (row_np, b0_np, oob_np) = _layout_case(
            rng, layout, 120
        )
        row, b0, oob = lut_address(
            jnp.asarray(parts), height=build["height"],
            width=build["width"], origin_x=0.0, origin_y=0.0,
            num_members=build["num_members"], per_member_maps=True,
            **common, **kw,
        )
    np.testing.assert_array_equal(np.asarray(oob), oob_np)
    np.testing.assert_array_equal(np.asarray(row), row_np)
    np.testing.assert_array_equal(np.asarray(b0), b0_np)


class TestFilterIntegration:
    def test_lut_pallas_filter_matches_lut_filter(self, clutter_map, beams60,
                                                  make_scan):
        """End-to-end: a lut_pallas ParticleFilter's query on the real map
        LUT agrees exactly with the numpy oracle, and ranks particles like
        the XLA lut+analytic path."""
        from monte_carlo_localization_tpu.config import MCLConfig
        from monte_carlo_localization_tpu.filter import ParticleFilter
        from monte_carlo_localization_tpu.filter.core import expected_pose
        from monte_carlo_localization_tpu.ops.raycast import lut_expected_px

        n = 256
        pose = np.array([10.0, 10.0, 0.5], np.float32)
        scan = make_scan(clutter_map, pose, beams60)
        pf = ParticleFilter(
            clutter_map,
            MCLConfig(
                max_particles=n, raycast_method="lut_pallas",
                z_hit=Z_HIT, z_short=Z_SHORT, z_max=Z_MAX, z_rand=Z_RAND,
                sigma_hit=SIGMA, squash_factor=1.0 / INV_SQUASH,
            ),
        )
        pf.set_beam_angles(beams60)
        state = pf.init_pose(pose, seed=0)
        particles = np.asarray(state.particles)
        obs_px = pf.sensor.to_pixel_index(jnp.asarray(scan)).astype(
            jnp.float32
        )
        # XLA lut twin on the SAME padded LUT and theta bins
        d_px = lut_expected_px(
            pf.grid_map, jnp.asarray(particles), jnp.asarray(beams60)
        )
        logp = pf.sensor.log_prob_analytic(obs_px[None, :], d_px)
        want = np.asarray(pf.sensor.inv_squash_factor * logp.sum(axis=1))
        gm = pf.grid_map
        got = np.asarray(
            pf._pallas_query(gm.range_lut, jnp.asarray(particles), obs_px)
        )
        # (a) against the same-decomposition oracle on the real map LUT
        lut2d = np.asarray(gm.range_lut).reshape(-1, gm.lut_row_stride)
        exact = _oracle_logw(
            lut2d, particles, np.asarray(obs_px, np.float64),
            np.asarray(beams60), gm.lut_theta_bins, gm.max_range_px,
            height=gm.height, width=gm.width,
            origin_x=float(gm.origin_x), origin_y=float(gm.origin_y),
        )
        _assert_close(got, exact)
        # (b) the XLA lut path quantizes the ray angle differently
        # (round(a+b) vs round(a)+round(b): one theta bin), which near
        # range discontinuities legitimately moves individual
        # log-weights — so compare ranking and pose, not values
        c = np.corrcoef(got, want)[0, 1]
        assert c > 0.9, f"lut_pallas vs XLA lut path corr {c}"
        pa = np.asarray(expected_pose(jnp.asarray(particles), jnp.asarray(got)))
        pb = np.asarray(expected_pose(jnp.asarray(particles), jnp.asarray(want)))
        assert np.linalg.norm(pa[:2] - pose[:2]) < 0.25, pa
        assert np.linalg.norm(pb[:2] - pose[:2]) < 0.25, pb
