import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from monte_carlo_localization_tpu.config import MCLConfig
from monte_carlo_localization_tpu.mapping import box_world
from monte_carlo_localization_tpu.parallel import (
    FleetFilter,
    ShardedParticleFilter,
    stack_maps,
)

needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def true_pose():
    return np.array([10.0, 10.0, 0.5], np.float32)


@pytest.fixture(scope="module")
def scan60(clutter_map, beams60, true_pose):
    from tests.conftest import synth_scan

    return synth_scan(clutter_map, true_pose, beams60)


class TestFleet:
    def test_fleet_converges_no_mesh(self, clutter_map, beams60, scan60, true_pose):
        ff = FleetFilter(
            clutter_map,
            fleet_size=4,
            config=MCLConfig(max_particles=400, raycast_method="sphere"),
            beam_angles=beams60,
        )
        state = ff.init_pose(np.tile(true_pose, (4, 1)), seed=0)
        for _ in range(8):
            state, poses = ff.step(
                state, np.zeros((4, 3)), np.tile(scan60, (4, 1))
            )
        err = np.linalg.norm(np.asarray(poses)[:, :2] - true_pose[:2], axis=1)
        assert (err < 0.15).all()

    def test_fleet_step_many_matches_steps(
        self, clutter_map, beams60, scan60, true_pose
    ):
        """step_many(K) is bitwise the same chain as K sequential steps
        (same fleet_step under lax.scan — the dispatch-amortized replay
        path must not change the filter)."""
        k, f = 3, 2
        ff = FleetFilter(
            clutter_map,
            fleet_size=f,
            config=MCLConfig(max_particles=128, raycast_method="sphere"),
            beam_angles=beams60,
        )
        actions = np.tile([0.05, 0.0, 0.01], (f, 1)).astype(np.float32)
        scans = np.tile(scan60, (f, 1))

        s1 = ff.init_pose(np.tile(true_pose, (f, 1)), seed=0)
        seq_poses = []
        for _ in range(k):
            s1, p = ff.step(s1, actions, scans)
            seq_poses.append(np.asarray(p))

        s2 = ff.init_pose(np.tile(true_pose, (f, 1)), seed=0)
        s2, poses = ff.step_many(
            s2, np.tile(actions, (k, 1, 1)), np.tile(scans, (k, 1, 1))
        )
        np.testing.assert_array_equal(np.asarray(poses), np.stack(seq_poses))
        np.testing.assert_array_equal(
            np.asarray(s2.particles), np.asarray(s1.particles)
        )

    def test_members_independent(self, clutter_map, beams60, scan60, true_pose):
        """Different keys per member -> different particle clouds."""
        ff = FleetFilter(
            clutter_map,
            fleet_size=3,
            config=MCLConfig(max_particles=200, raycast_method="sphere"),
            beam_angles=beams60,
        )
        state = ff.init_pose(np.tile(true_pose, (3, 1)), seed=0)
        state, _ = ff.step(state, np.zeros((3, 3)), np.tile(scan60, (3, 1)))
        p = np.asarray(state.particles)
        assert not np.allclose(p[0], p[1])

    @needs_8
    def test_fleet_sharded_over_mesh(self, clutter_map, beams60, scan60, true_pose):
        mesh = Mesh(np.array(jax.devices()[:8]), ("fleet",))
        ff = FleetFilter(
            clutter_map,
            fleet_size=8,
            config=MCLConfig(max_particles=256, raycast_method="sphere"),
            beam_angles=beams60,
            mesh=mesh,
        )
        state = ff.init_pose(np.tile(true_pose, (8, 1)), seed=1)
        assert "fleet" in str(state.particles.sharding)
        for _ in range(6):
            state, poses = ff.step(
                state, np.zeros((8, 3)), np.tile(scan60, (8, 1))
            )
        err = np.linalg.norm(np.asarray(poses)[:, :2] - true_pose[:2], axis=1)
        assert (err < 0.2).all()

    def test_heterogeneous_maps(self, clutter_map, beams60, scan60, true_pose):
        from tests.conftest import synth_scan

        m2 = box_world(height=400, width=400, origin=(-3.0, -2.0, 0.0))
        bm = stack_maps([clutter_map, m2])
        p2 = np.array([3.0, 3.0, 0.1], np.float32)
        scan2 = synth_scan(m2, p2, beams60)
        ff = FleetFilter(
            bm, fleet_size=2, config=MCLConfig(max_particles=400, raycast_method="sphere"),
            beam_angles=beams60,
        )
        state = ff.init_pose(np.stack([true_pose, p2]), seed=2)
        for _ in range(8):
            state, poses = ff.step(
                state, np.zeros((2, 3)), np.stack([scan60, scan2])
            )
        poses = np.asarray(poses)
        assert np.linalg.norm(poses[0, :2] - true_pose[:2]) < 0.15
        assert np.linalg.norm(poses[1, :2] - p2[:2]) < 0.2

    def test_stack_maps_mismatch(self, clutter_map):
        bad = box_world(resolution=0.1)
        with pytest.raises(ValueError):
            stack_maps([clutter_map, bad])

    def test_batched_global_init_uniformity(self, clutter_map):
        """Padded free-cell tables must not bias sampling (num_free leaf)."""
        m2 = box_world(height=100, width=100)  # far fewer free cells
        bm = stack_maps([clutter_map, m2])
        ff = FleetFilter(
            bm, fleet_size=2,
            config=MCLConfig(max_particles=4000, raycast_method="sphere")
        )
        state = ff.init_global(seed=3)
        p = np.asarray(state.particles)
        # member 1 particles must all lie inside its small 5m x 5m box
        assert p[1, :, 0].max() < 5.1 and p[1, :, 1].max() < 5.1
        # and spread across it (not clumped at the padded duplicate cell)
        assert p[1, :, 0].std() > 0.8


class TestSharded:
    @needs_8
    def test_sharded_matches_quality(self, clutter_map, beams60, scan60, true_pose):
        spf = ShardedParticleFilter(
            clutter_map,
            MCLConfig(max_particles=16000, seed=0, raycast_method="sphere"),
            beam_angles=beams60,
        )
        assert spf.num_devices == 8
        state = spf.init_global(seed=1)
        for _ in range(20):
            state, pose = spf.step(state, np.zeros(3), scan60)
        assert np.linalg.norm(np.asarray(pose)[:2] - true_pose[:2]) < 0.15

    @needs_8
    def test_sharded_weights_normalized_globally(self, clutter_map, beams60, scan60):
        spf = ShardedParticleFilter(
            clutter_map,
            MCLConfig(max_particles=800, raycast_method="sphere"),
            beam_angles=beams60,
        )
        state = spf.init_global(seed=2)
        state, pose = spf.step(state, np.zeros(3), scan60)
        w = np.asarray(state.weights())
        assert w.shape == (800,)
        assert abs(w.sum() - 1.0) < 1e-4

    def test_uneven_particles_rejected(self, clutter_map):
        n_dev = len(jax.devices())
        if n_dev == 1:
            pytest.skip("needs multiple devices")
        with pytest.raises(ValueError):
            ShardedParticleFilter(
                clutter_map, MCLConfig(max_particles=n_dev * 100 + 1)
            )

    def test_bad_sharded_resample_rejected(self, clutter_map):
        with pytest.raises(ValueError, match="sharded_resample"):
            ShardedParticleFilter(
                clutter_map,
                MCLConfig(max_particles=len(jax.devices()) * 8,
                          sharded_resample="ring"),
            )


def _resample_twins(particles_np, logw_np, d, fringe, u0=0.377):
    """Run the bucketed ancestor exchange AND the all-gather window
    inversion on the SAME shard-local CDF segments under one shard_map —
    the bitwise reference pair for the distributed resampler."""
    from jax.sharding import PartitionSpec as P

    from monte_carlo_localization_tpu.ops.resample import (
        distributed_systematic_resample_rows,
        systematic_invert_cdf_window,
    )

    mesh = Mesh(np.array(jax.devices()[:d]), ("p",))
    n = len(particles_np)
    n_local = n // d

    def local(particles, log_w, u0v):
        shard = jax.lax.axis_index("p")
        m = jax.lax.pmax(jnp.max(log_w), "p")
        w_local = jnp.exp(log_w - m)
        z = jax.lax.psum(jnp.sum(w_local), "p")
        w = w_local / z
        local_cdf = jnp.cumsum(w)
        totals = jax.lax.all_gather(local_cdf[-1], "p")
        offset = jnp.where(jnp.arange(d) < shard, totals, 0.0).sum()
        gcl = local_cdf + offset
        rows_b, overflow = distributed_systematic_resample_rows(
            particles, gcl, u0v, n, "p", d, fringe
        )
        all_particles = jax.lax.all_gather(particles, "p").reshape(n, -1)
        all_cdf = jax.lax.all_gather(gcl, "p").reshape(-1)
        src = systematic_invert_cdf_window(
            all_cdf, u0v, n, shard * n_local, n_local
        )
        return rows_b, all_particles[src], overflow

    f = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("p"), P("p"), P()),
            out_specs=(P("p"), P("p"), P()),
            check_vma=False,
        )
    )
    rows_b, rows_ref, overflow = f(
        jnp.asarray(particles_np), jnp.asarray(logw_np), jnp.float32(u0)
    )
    return np.asarray(rows_b), np.asarray(rows_ref), bool(overflow)


class TestBucketedResample:
    """The bucketed distributed systematic resampler (SURVEY §7 hard-part
    6; VERDICT round-2 item 1): O(fringe + D) bytes instead of the
    full N x 3 particle all_gather, bitwise equal to the all-gather
    window inversion, with an exact overflow flag that falls back."""

    @needs_8
    def test_balanced_weights_bitwise_no_overflow(self):
        rng = np.random.default_rng(0)
        n = 1024
        particles = rng.normal(size=(n, 3)).astype(np.float32)
        logw = rng.normal(scale=1.0, size=n).astype(np.float32)
        rows_b, rows_ref, overflow = _resample_twins(
            particles, logw, d=8, fringe=64
        )
        assert not overflow, "balanced weights must stay within the fringe"
        np.testing.assert_array_equal(rows_b, rows_ref)

    @needs_8
    def test_moderate_imbalance_bitwise(self):
        """Shard-correlated weight imbalance (2x across the mesh) shifts
        shard boundaries by ~N * cumulative-imbalance (~100 slots here) —
        a full-window fringe still routes every ancestor without the
        fallback, bitwise equal to the all-gather inversion."""
        rng = np.random.default_rng(1)
        n, d = 1024, 8
        particles = rng.normal(size=(n, 3)).astype(np.float32)
        shard_of = np.arange(n) // (n // d)
        logw = (0.1 * shard_of + rng.normal(scale=0.5, size=n)).astype(
            np.float32
        )
        rows_b, rows_ref, overflow = _resample_twins(
            particles, logw, d=d, fringe=n // d
        )
        assert not overflow
        np.testing.assert_array_equal(rows_b, rows_ref)

    @needs_8
    def test_extreme_imbalance_flags_overflow(self):
        """All the weight on the last shard: its sources cover every
        output slot, far outside any fringe — the exact psum flag must
        fire on every shard (the caller then falls back)."""
        rng = np.random.default_rng(2)
        n, d = 512, 8
        particles = rng.normal(size=(n, 3)).astype(np.float32)
        logw = np.full(n, -100.0, np.float32)
        logw[-(n // d):] = 0.0
        _, _, overflow = _resample_twins(particles, logw, d=d, fringe=8)
        assert overflow

    @needs_8
    def test_degenerate_single_source(self):
        """One particle owns ALL the weight (post-kidnap collapse): with a
        full-window fringe the run is seeded+forward-filled correctly."""
        rng = np.random.default_rng(3)
        n, d = 256, 8
        particles = rng.normal(size=(n, 3)).astype(np.float32)
        logw = np.full(n, -100.0, np.float32)
        logw[37] = 0.0
        rows_b, rows_ref, overflow = _resample_twins(
            particles, logw, d=d, fringe=n // d
        )
        if not overflow:
            np.testing.assert_array_equal(rows_b, rows_ref)
        # every output row must be source 37 regardless of path
        np.testing.assert_array_equal(
            rows_ref, np.tile(particles[37], (n, 1))
        )
        np.testing.assert_array_equal(rows_b, rows_ref)

    @needs_8
    def test_sharded_filter_bucketed_matches_allgather_bitwise(
        self, clutter_map, beams60, scan60
    ):
        """End-to-end: ShardedParticleFilter with the default bucketed
        resampler evolves bit-identically to the all-gather compat mode
        over several steps."""
        states, poses = [], []
        for mode in ("bucketed", "allgather"):
            spf = ShardedParticleFilter(
                clutter_map,
                MCLConfig(
                    max_particles=800, raycast_method="sphere",
                    sharded_resample=mode,
                ),
                beam_angles=beams60,
            )
            state = spf.init_global(seed=5)
            ps = []
            for _ in range(4):
                state, pose = spf.step(state, np.zeros(3), scan60)
                ps.append(np.asarray(pose))
            states.append(state)
            poses.append(np.stack(ps))
        np.testing.assert_array_equal(poses[0], poses[1])
        np.testing.assert_array_equal(
            np.asarray(states[0].particles), np.asarray(states[1].particles)
        )
        np.testing.assert_array_equal(
            np.asarray(states[0].log_weights),
            np.asarray(states[1].log_weights),
        )

    @needs_8
    def test_sharded_filter_fallback_cond_bitwise(
        self, clutter_map, beams60, scan60
    ):
        """A crafted extreme-imbalance state with a 1-slot fringe trips
        the in-step lax.cond fallback; the step must still match the
        all-gather filter bitwise."""
        import dataclasses

        states = []
        for mode, fringe in (("bucketed", 1), ("allgather", 0)):
            spf = ShardedParticleFilter(
                clutter_map,
                MCLConfig(
                    max_particles=800, raycast_method="sphere",
                    sharded_resample=mode, sharded_fringe=fringe,
                ),
                beam_angles=beams60,
            )
            state = spf.init_global(seed=6)
            lw = np.full(800, -80.0, np.float32)
            lw[700:] = 0.0  # all mass on the last shard
            state = dataclasses.replace(
                state,
                log_weights=jax.device_put(
                    jnp.asarray(lw), state.log_weights.sharding
                ),
            )
            state, pose = spf.step(state, np.zeros(3), scan60)
            states.append((np.asarray(state.particles), np.asarray(pose)))
        np.testing.assert_array_equal(states[0][0], states[1][0])
        np.testing.assert_array_equal(states[0][1], states[1][1])

    @needs_8
    def test_sharded_step_many_matches_steps(
        self, clutter_map, beams60, scan60
    ):
        """ShardedParticleFilter.step_many(K) is bitwise K chained steps
        (the dispatch-amortized replay path, VERDICT round-2 item 8)."""
        k = 3
        actions = np.tile([0.05, 0.0, 0.01], (k, 1)).astype(np.float32)
        scans = np.tile(scan60, (k, 1))

        def build():
            return ShardedParticleFilter(
                clutter_map,
                MCLConfig(max_particles=800, raycast_method="sphere"),
                beam_angles=beams60,
            )

        spf = build()
        s1 = spf.init_global(seed=7)
        seq = []
        for i in range(k):
            s1, p = spf.step(s1, actions[i], scans[i])
            seq.append(np.asarray(p))
        s2 = spf.init_global(seed=7)
        s2, poses = spf.step_many(s2, actions, scans)
        np.testing.assert_array_equal(np.asarray(poses), np.stack(seq))
        np.testing.assert_array_equal(
            np.asarray(s2.particles), np.asarray(s1.particles)
        )


class TestGraftEntry:
    def test_entry_compiles_tiny(self):
        """entry() returns a jittable fn; run it at tiny shapes via the
        same flagship builder."""
        import __graft_entry__ as ge

        fn, args = ge._flagship(num_particles=64, num_beams=16, map_hw=120)
        out_state, pose = jax.jit(fn)(*args)
        assert np.isfinite(np.asarray(pose)).all()

    def test_entry_production_path_is_the_pallas_kernel(self):
        """entry() defaults to the lut_pallas production step on a REAL
        reference map (VERDICT round-3 item 3) — run it at reduced shapes
        (interpret mode on CPU)."""
        import __graft_entry__ as ge

        fn, args = ge._flagship_pallas(num_particles=128, num_beams=60)
        out_state, pose = jax.jit(fn)(*args)
        assert np.isfinite(np.asarray(pose)).all()
        # the map really is the kernel-ready reference asset
        gm = args[4]
        assert gm.range_lut is not None

    @needs_8
    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)


class TestShardedLut:
    @needs_8
    def test_sharded_lut_light(self, clutter_map, beams60, scan60):
        """LUT backend under explicit-collectives sharding (kept light: the
        8-virtual-devices-on-one-core CPU stand-in trips XLA's stuck-
        collective watchdog if any shard's first gather runs too long)."""
        spf = ShardedParticleFilter(
            clutter_map,
            MCLConfig(max_particles=800, lut_theta_bins=180),
            beam_angles=beams60,
        )
        state = spf.init_global(seed=2)
        for _ in range(2):
            state, pose = spf.step(state, np.zeros(3), scan60)
        assert np.isfinite(np.asarray(pose)).all()

    def test_lut_pallas_fleet_mesh_rules(self, clutter_map, beams60):
        # a 2-D fleet x particle mesh cannot run the kernel (it is not
        # auto-partitionable over the particle axis) -> reject up front
        mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("fleet", "p"))
        with pytest.raises(ValueError, match="lut_pallas"):
            FleetFilter(
                clutter_map,
                fleet_size=2,
                config=MCLConfig(max_particles=64, raycast_method="lut_pallas"),
                beam_angles=beams60,
                mesh=mesh1,
                particle_axis="p",
            )
        # fleet size not divisible over the mesh -> reject
        mesh8 = Mesh(np.array(jax.devices()[:8]), ("fleet",))
        if len(jax.devices()) >= 8:
            with pytest.raises(ValueError, match="lut_pallas"):
                FleetFilter(
                    clutter_map,
                    fleet_size=12,
                    config=MCLConfig(
                        max_particles=64, raycast_method="lut_pallas"
                    ),
                    beam_angles=beams60,
                    mesh=mesh8,
                )

    def test_fleet_pallas_heterogeneous_maps(self, beams60, make_scan):
        """lut_pallas on a stacked heterogeneous fleet: per-member LUTs
        concatenate and the member index folds into the window address;
        per-member origins are applied at query time."""
        from monte_carlo_localization_tpu.mapping import (
            box_world,
            random_obstacle_world,
        )
        from monte_carlo_localization_tpu.parallel import stack_maps

        m1 = random_obstacle_world(height=96, width=96, num_obstacles=8,
                                   seed=14)
        m2 = box_world(height=96, width=96, origin=(-3.0, -2.0, 0.0))
        bm = stack_maps([m1, m2])
        p1 = np.array([2.4, 2.4, 0.5], np.float32)
        p2 = np.array([-0.9, 0.1, 0.1], np.float32)
        s1 = make_scan(m1, p1, beams60)
        s2 = make_scan(m2, p2, beams60)
        ff = FleetFilter(
            bm, fleet_size=2,
            config=MCLConfig(max_particles=256,
                             raycast_method="lut_pallas"),
            beam_angles=beams60,
        )
        assert ff._pallas
        state = ff.init_pose(np.stack([p1, p2]), seed=2)
        for _ in range(4):
            state, poses = ff.step(
                state, np.zeros((2, 3)), np.stack([s1, s2])
            )
        poses = np.asarray(poses)
        assert np.linalg.norm(poses[0, :2] - p1[:2]) < 0.25
        assert np.linalg.norm(poses[1, :2] - p2[:2]) < 0.25
        # global init on the tight-LUT hetero fleet (regression: the flat
        # concatenated range_lut has no member axis 0 for init's vmap —
        # the LUT leaves must be stripped before mapping)
        gs = ff.init_global(seed=5)
        parts = np.asarray(gs.particles)
        assert parts.shape == (2, 256, 3)
        # member 2's map origin is (-3, -2): its samples reach x < 0;
        # member 1's (origin 0, 0) all stay x >= 0
        assert parts[0, :, 0].min() >= -0.01
        assert parts[1, :, 0].min() < 0.0

    def test_member_lut_not_reused_by_with_range_lut(self):
        """A tight per-member LUT (flat buffer + lut_member_base) must NOT
        satisfy with_range_lut's memo check: only the Pallas member-base
        addressing understands that layout, so the stacked layout is
        rebuilt and the stale bases dropped (a padded LUT read through
        tight bases would silently return the wrong map's rows)."""
        from monte_carlo_localization_tpu.mapping import box_world
        from monte_carlo_localization_tpu.parallel import stack_maps

        bm = stack_maps([
            box_world(height=48, width=48),
            box_world(height=48, width=48, origin=(-1.0, -1.0, 0.0)),
        ])
        t = 64
        tight = bm.with_member_luts(t, t, t)
        assert tight.lut_member_base is not None
        assert np.asarray(tight.range_lut).ndim == 1
        stacked = tight.with_range_lut(t, row_stride=t)
        assert stacked.lut_member_base is None
        assert np.asarray(stacked.range_lut).ndim == 2  # (M, H*W*stride)

    def test_fleet_map_assignment_shares_lut_blocks(self, beams60, make_scan):
        """map_assignment: 6 cars over 2 stacked maps — the LUT holds 2
        blocks (not 6) and every car localizes on ITS assigned circuit."""
        from monte_carlo_localization_tpu.mapping import (
            box_world,
            random_obstacle_world,
        )
        from monte_carlo_localization_tpu.parallel import stack_maps

        m0 = random_obstacle_world(height=96, width=96, num_obstacles=8,
                                   seed=14)
        m1 = box_world(height=96, width=96, origin=(-3.0, -2.0, 0.0))
        bm = stack_maps([m0, m1])
        asg = np.array([0, 1, 0, 1, 0, 1], np.int32)
        p0 = np.array([2.4, 2.4, 0.5], np.float32)
        p1 = np.array([-0.9, 0.1, 0.1], np.float32)
        s0 = make_scan(m0, p0, beams60)
        s1 = make_scan(m1, p1, beams60)
        ff = FleetFilter(
            bm, fleet_size=6,
            config=MCLConfig(max_particles=128,
                             raycast_method="lut_pallas"),
            beam_angles=beams60,
            map_assignment=asg,
        )
        # the attached LUT covers exactly the 2 stacked maps
        lut_entries = int(np.prod(np.asarray(ff.map.range_lut).shape))
        assert lut_entries == 2 * 96 * 96 * ff.map.lut_row_stride
        poses0 = np.stack([p0 if a == 0 else p1 for a in asg])
        scans = np.stack([s0 if a == 0 else s1 for a in asg])
        state = ff.init_pose(poses0, seed=2)
        for _ in range(4):
            state, poses = ff.step(state, np.zeros((6, 3)), scans)
        poses = np.asarray(poses)
        err = np.linalg.norm(poses[:, :2] - poses0[:, :2], axis=1)
        assert err.max() < 0.25, err
        # global init samples each member from ITS map's free space
        gs = ff.init_global(seed=3)
        parts = np.asarray(gs.particles)
        # members on map 1 (origin -3,-2) must include x < 0 samples;
        # members on map 0 (origin 0,0) must all be x >= 0
        assert parts[0, :, 0].min() >= -0.01
        assert parts[1, :, 0].min() < 0.0

    def test_fleet_map_assignment_validation(self, clutter_map, beams60):
        from monte_carlo_localization_tpu.mapping import box_world
        from monte_carlo_localization_tpu.parallel import stack_maps

        bm = stack_maps([box_world(height=64, width=64),
                         box_world(height=64, width=64)])
        with pytest.raises(ValueError, match="map_assignment requires"):
            FleetFilter(
                bm, fleet_size=4,
                config=MCLConfig(max_particles=64, raycast_method="lut"),
                beam_angles=beams60,
                map_assignment=np.array([0, 1, 0, 1]),
            )
        with pytest.raises(ValueError, match="in \\[0, 2\\)"):
            FleetFilter(
                bm, fleet_size=4,
                config=MCLConfig(max_particles=64,
                                 raycast_method="lut_pallas"),
                beam_angles=beams60,
                map_assignment=np.array([0, 1, 2, 1]),
            )
        with pytest.raises(ValueError, match="pass map_assignment"):
            FleetFilter(
                bm, fleet_size=4,  # 2 maps, 4 members, no assignment
                config=MCLConfig(max_particles=64,
                                 raycast_method="lut_pallas"),
                beam_angles=beams60,
            )

    @needs_8
    def test_fleet_pallas_hetero_over_mesh(self, beams60, make_scan):
        """Heterogeneous fleet sharded over an 8-device mesh: each shard's
        member_base is traced (axis_index), so every member must still hit
        ITS OWN map's LUT block and origins."""
        from monte_carlo_localization_tpu.mapping import (
            box_world,
            random_obstacle_world,
        )
        from monte_carlo_localization_tpu.parallel import stack_maps

        f = 8
        maps, poses0, scans = [], [], []
        for i in range(f):
            if i % 2 == 0:
                m = random_obstacle_world(height=64, width=64,
                                          num_obstacles=5, seed=20 + i)
                p = np.array([1.6, 1.6, 0.3 * i], np.float32)
            else:
                m = box_world(height=64, width=64,
                              origin=(-1.0 * i, 0.5, 0.0))
                p = np.array([1.6 - 1.0 * i, 1.7, 0.2], np.float32)
            maps.append(m)
            poses0.append(p)
            scans.append(make_scan(m, p, beams60))
        bm = stack_maps(maps)
        mesh = Mesh(np.array(jax.devices()[:8]), ("fleet",))
        ff = FleetFilter(
            bm, fleet_size=f,
            config=MCLConfig(max_particles=128,
                             raycast_method="lut_pallas"),
            beam_angles=beams60,
            mesh=mesh,
        )
        assert ff._pallas
        poses0 = np.stack(poses0)
        state = ff.init_pose(poses0, seed=3)
        actions = np.zeros((f, 3), np.float32)
        scans = np.stack(scans)
        for _ in range(3):
            state, poses = ff.step(state, actions, scans)
        poses = np.asarray(poses)
        err = np.linalg.norm(poses[:, :2] - poses0[:, :2], axis=1)
        assert err.max() < 0.3, err

    @needs_8
    def test_fleet_pallas_over_mesh(self, beams60, make_scan):
        """1-D fleet mesh + lut_pallas: each shard runs the flattened-fleet
        kernel on its local members against the replicated LUT; members
        localize independently with their own scans."""
        from monte_carlo_localization_tpu.mapping import random_obstacle_world

        gm = random_obstacle_world(height=96, width=96, num_obstacles=10,
                                   seed=13)
        mesh = Mesh(np.array(jax.devices()[:8]), ("fleet",))
        f = 16
        ff = FleetFilter(
            gm,
            fleet_size=f,
            config=MCLConfig(max_particles=128,
                             raycast_method="lut_pallas"),
            beam_angles=beams60,
            mesh=mesh,
        )
        assert ff._pallas
        poses0 = np.tile(np.array([2.4, 2.4, 0.5], np.float32), (f, 1))
        poses0[8:] = np.array([1.2, 1.5, -0.7], np.float32)
        scans = np.stack([
            make_scan(gm, poses0[i], beams60) for i in range(f)
        ])
        state = ff.init_pose(poses0, seed=1)
        actions = np.zeros((f, 3), np.float32)
        for _ in range(3):
            state, poses = ff.step(state, actions, scans)
        poses = np.asarray(poses)
        err = np.linalg.norm(poses[:, :2] - poses0[:, :2], axis=1)
        assert err.max() < 0.3, err

    @needs_8
    def test_sharded_pallas_kernel_per_shard(self, beams60, make_scan):
        """lut_pallas under explicit-collectives sharding: each shard runs
        the fused kernel on its local slice of the particle axis against a
        replicated padded LUT (kept light for the 8-virtual-device CPU
        stand-in — small map, 2 steps, interpret-mode kernel)."""
        from monte_carlo_localization_tpu.mapping import random_obstacle_world

        gm = random_obstacle_world(
            height=96, width=96, num_obstacles=10, seed=11
        )
        true_pose = np.array([2.4, 2.4, 0.5], np.float32)
        scan = make_scan(gm, true_pose, beams60)
        spf = ShardedParticleFilter(
            gm,
            MCLConfig(max_particles=800, raycast_method="lut_pallas"),
            beam_angles=beams60,
        )
        assert spf._pallas_query is not None
        state = spf.init_global(seed=2)
        for _ in range(2):
            state, pose = spf.step(state, np.zeros(3), scan)
        assert np.isfinite(np.asarray(pose)).all()
        w = np.asarray(state.weights())
        assert abs(w.sum() - 1.0) < 1e-4


class TestFleetPallas:
    def test_fleet_pallas_localizes_per_member_scans(
        self, clutter_map, beams60, make_scan
    ):
        """Single-device shared-map fleet on the fused Pallas kernel:
        members with DIFFERENT true poses (distinct scans) must each
        converge to their own pose."""
        f, n = 2, 256
        poses_true = np.array(
            [[10.0, 10.0, 0.5], [6.0, 14.0, -1.0]], np.float32
        )
        scans = np.stack(
            [make_scan(clutter_map, p, beams60) for p in poses_true]
        )
        ff = FleetFilter(
            clutter_map,
            fleet_size=f,
            config=MCLConfig(max_particles=n, raycast_method="lut_pallas"),
            beam_angles=beams60,
        )
        assert ff._pallas
        state = ff.init_pose(poses_true, seed=1)
        actions = np.zeros((f, 3), np.float32)
        for _ in range(6):
            state, est = ff.step(state, actions, scans)
        est = np.asarray(est)
        for i in range(f):
            err = np.linalg.norm(est[i, :2] - poses_true[i, :2])
            assert err < 0.25, (i, err, est[i], poses_true[i])

    def test_fleet_pallas_hetero_compact_luts(self, beams60, make_scan,
                                              monkeypatch):
        """Giant-map heterogeneous fleets (stacked dense per-member LUTs
        beyond MCL_LUT_DENSE_MAX) now reach the Pallas path through
        ROW-COMPACTED tight per-member blocks (VERDICT round-2 item 3):
        member cells map through lut_row_map[lut_row_map_base[m] + cell]
        to block-local compact rows before the lut_member_base subrow
        offset. Results must match the dense hetero path exactly."""
        from monte_carlo_localization_tpu.mapping import (
            box_world,
            random_obstacle_world,
        )

        # short max_range + a big empty box so the larger map has
        # genuinely FAR cells (clearance beyond max_range + margin) that
        # share the constant far row — real compaction, not just the
        # indirection. The pose sits near a corner so its 3 m beams still
        # see walls.
        m0 = box_world(height=200, width=200, max_range_meters=3.0)
        m1 = box_world(height=48, width=72, origin=(-1.5, -1.0, 0.0),
                       max_range_meters=3.0)
        p0 = np.array([1.0, 1.2, 0.5], np.float32)
        p1 = np.array([0.3, 0.4, 0.1], np.float32)
        scans = np.stack([make_scan(m0, p0, beams60),
                          make_scan(m1, p1, beams60)])
        poses0 = np.stack([p0, p1])
        actions = np.zeros((2, 3), np.float32)

        def run():
            bm = stack_maps([m0, m1])
            ff = FleetFilter(
                bm, fleet_size=2,
                config=MCLConfig(max_particles=128,
                                 raycast_method="lut_pallas"),
                beam_angles=beams60,
            )
            state = ff.init_pose(poses0, seed=2)
            for _ in range(3):
                state, poses = ff.step(state, actions, scans)
            return ff, np.asarray(poses), np.asarray(state.log_weights)

        ff_dense, poses_d, logw_d = run()
        assert ff_dense.map.lut_row_map is None

        monkeypatch.setenv("MCL_LUT_DENSE_MAX", "1")  # force compaction
        ff_comp, poses_c, logw_c = run()
        gm = ff_comp.map
        assert gm.lut_row_map is not None
        assert gm.lut_row_map_base is not None
        np.testing.assert_array_equal(
            np.asarray(gm.lut_row_map_base), [0, 200 * 200]
        )
        # real compaction: far cells of the big map share row 0, so the
        # compact buffer is strictly smaller than the dense tight layout
        assert (
            np.asarray(gm.range_lut).size
            < np.asarray(ff_dense.map.range_lut).size
        )
        assert int(np.asarray(gm.lut_row_map)[: 200 * 200].max()) + 1 \
            < 200 * 200
        # identical filtering: same windows -> bitwise-equal weights/poses
        np.testing.assert_array_equal(logw_c, logw_d)
        np.testing.assert_array_equal(poses_c, poses_d)
        err = np.linalg.norm(poses_c[:, :2] - poses0[:, :2], axis=1)
        assert err.max() < 0.25, err

    def test_fleet_pallas_tight_mixed_shape_luts(self, beams60, make_scan):
        """Mixed-shape hetero fleet: LUT blocks are TIGHT (each map at its
        true area, not padded to the common max shape) and every member
        still localizes on its own map. Padded-to-common hetero LUTs blew
        up to 1.9 GiB on an icra-class 4-map set; the tight layout stores
        each map at its own area."""
        from monte_carlo_localization_tpu.mapping import (
            box_world,
            random_obstacle_world,
        )

        m0 = random_obstacle_world(height=96, width=96, num_obstacles=8,
                                   seed=14)
        m1 = box_world(height=48, width=72, origin=(-1.5, -1.0, 0.0))
        bm = stack_maps([m0, m1])
        assert bm.member_dims is not None
        np.testing.assert_array_equal(
            np.asarray(bm.member_dims), [[96, 96], [48, 72]]
        )
        ff = FleetFilter(
            bm, fleet_size=2,
            config=MCLConfig(max_particles=128,
                             raycast_method="lut_pallas"),
            beam_angles=beams60,
        )
        stride = ff.map.lut_row_stride or ff.map.lut_theta_bins
        lut_entries = int(np.prod(np.asarray(ff.map.range_lut).shape))
        assert lut_entries == (96 * 96 + 48 * 72) * stride  # tight, not
        # 2 * 96 * 96 * stride (padded common shape)
        itemsize = np.asarray(ff.map.range_lut).dtype.itemsize
        eps = 512 // itemsize  # LUT entries per 512 B subrow
        np.testing.assert_array_equal(
            np.asarray(ff.map.lut_member_base),
            [0, 96 * 96 * (stride // eps)],
        )
        p0 = np.array([2.4, 2.4, 0.5], np.float32)
        p1 = np.array([0.3, 0.4, 0.1], np.float32)
        scans = np.stack([make_scan(m0, p0, beams60),
                          make_scan(m1, p1, beams60)])
        state = ff.init_pose(np.stack([p0, p1]), seed=2)
        for _ in range(4):
            state, poses = ff.step(state, np.zeros((2, 3)), scans)
        poses = np.asarray(poses)
        assert np.linalg.norm(poses[0, :2] - p0[:2]) < 0.25
        assert np.linalg.norm(poses[1, :2] - p1[:2]) < 0.25
        # a particle beyond the SMALL map's true extent (but inside the
        # padded common shape) must be out of bounds for member 1
        from monte_carlo_localization_tpu.filter.core import (
            build_pallas_likelihood,
        )

        gmap, query = build_pallas_likelihood(
            bm, np.asarray(beams60), ff.config, 2 * 128, num_members=2
        )
        parts = np.tile(np.array([2.9, 2.9, 0.0], np.float32), (256, 1))
        obs = np.full((2, len(beams60)), 10.0, np.float32)
        logw = np.asarray(query(
            gmap.range_lut, jnp.asarray(parts), jnp.asarray(obs),
            member_base=0, origins=(gmap.origin_x, gmap.origin_y),
            dims=gmap.member_dims, lut_bases=gmap.lut_member_base,
        ))
        # (2.9, 2.9) is inside m0 (0..4.8 m) but past m1's 72*0.05=3.6 m
        # width from origin -1.5 -> grid x = 88 >= 72: OOB sentinel
        assert np.all(logw[:128] > -1e4)
        assert np.all(logw[128:] == -1e4)

    def test_fleet_pallas_matches_lut_fleet(self, clutter_map, beams60,
                                            make_scan):
        """Pose estimates from the Pallas fleet track the XLA lut fleet."""
        f, n = 2, 256
        pose = np.array([10.0, 10.0, 0.5], np.float32)
        scans = np.tile(make_scan(clutter_map, pose, beams60), (f, 1))
        actions = np.zeros((f, 3), np.float32)

        outs = []
        for method in ("lut_pallas", "lut"):
            ff = FleetFilter(
                clutter_map,
                fleet_size=f,
                config=MCLConfig(max_particles=n, raycast_method=method),
                beam_angles=beams60,
            )
            state = ff.init_pose(np.tile(pose, (f, 1)), seed=3)
            for _ in range(4):
                state, est = ff.step(state, actions, scans)
            outs.append(np.asarray(est))
        assert np.linalg.norm(outs[0][:, :2] - outs[1][:, :2], axis=1).max() < 0.2
