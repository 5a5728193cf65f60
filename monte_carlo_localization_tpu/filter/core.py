"""The fused MCL step — one jitted device dispatch per correction.

The reference runs resample -> motion -> sensor -> normalize as four
sequential phases with per-phase timers and an O(N*R*max_range_px) OpenMP
ray-cast loop in the middle (reference src/particle_filter.cpp:652-694).
Here the whole correction is ONE XLA computation:

    resample (cumsum + scatter/cummax inversion, or categorical) [reference :657-665]
 -> motion (vectorized arc update + jax.random noise)       [reference :449-503]
 -> likelihood (sphere-marching ray cast + log-LUT gather)  [reference :506-650]
 -> weight normalization in log space                       [reference :679-686]
 -> weighted-mean pose with circular-mean heading           [reference :696-716]

XLA fuses the elementwise phases; there are no host round-trips inside a
step. RNG is counter-based: the state carries one key that is split per
phase each step.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.config import MCLConfig, resolve_raycast_method
from monte_carlo_localization_tpu.filter.init import initialize_global, initialize_pose
from monte_carlo_localization_tpu.mapping.grid_map import GridMap
from monte_carlo_localization_tpu.models.motion import motion_model
from monte_carlo_localization_tpu.models.sensor import SensorModel
from monte_carlo_localization_tpu.ops.raycast import cast_rays
from monte_carlo_localization_tpu.ops.resample import resample_indices


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MCLState:
    """Filter state carried between steps (a pytree; donate-friendly)."""

    particles: jnp.ndarray  # (N, 3) [x, y, theta]
    log_weights: jnp.ndarray  # (N,) unnormalized logits
    key: jax.Array  # PRNG key threaded through steps
    # log mean measurement likelihood of the latest correction, captured
    # BEFORE the max-shift normalization below (the shifted log_weights
    # only measure concentration relative to the best particle). This is
    # the w_avg signal of Augmented MCL; 0 until the first correction.
    log_quality: jnp.ndarray = field(
        default_factory=lambda: jnp.float32(0.0)
    )

    @property
    def num_particles(self) -> int:
        return self.particles.shape[0]

    def weights(self) -> jnp.ndarray:
        return jax.nn.softmax(self.log_weights)


def expected_pose(particles: jnp.ndarray, log_weights: jnp.ndarray) -> jnp.ndarray:
    """Weighted mean x/y + circular mean heading (reference :696-716)."""
    w = jax.nn.softmax(log_weights)
    x = jnp.sum(w * particles[:, 0])
    y = jnp.sum(w * particles[:, 1])
    s = jnp.sum(w * jnp.sin(particles[:, 2]))
    c = jnp.sum(w * jnp.cos(particles[:, 2]))
    return jnp.stack([x, y, jnp.arctan2(s, c)])


def sensor_update(
    particles: jnp.ndarray,
    observed_m: jnp.ndarray,
    beam_angles: jnp.ndarray,
    grid_map: GridMap,
    sensor: SensorModel,
    raycast_method: str = "sphere",
    sphere_march_iters: int = 48,
    sensor_mode: str = "analytic",
) -> jnp.ndarray:
    """Log likelihood per particle from the downsampled scan.

    Builds N*R queries — ray angle = particle theta + beam angle, origin at
    the particle (particles live in the LASER frame; no lidar offset is
    applied to queries, matching reference :526-535) — casts them in one
    batch, and reduces the log-LUT over beams.
    """
    n = particles.shape[0]
    r = beam_angles.shape[0]
    if raycast_method == "lut" and sensor_mode == "analytic":
        # fused fast path: gather expected ranges in PIXEL units directly
        # from the LUT (no (N*R,3) query matrix, no meter round-trip) and
        # evaluate the analytic beam model on them
        from monte_carlo_localization_tpu.ops.raycast import (
            lut_expected_px,
        )

        d_px = lut_expected_px(grid_map, particles, beam_angles)
        obs_px = sensor.to_pixel_index(observed_m).astype(jnp.float32)
        logp = sensor.log_prob_analytic(obs_px[None, :], d_px)
        return sensor.inv_squash_factor * jnp.sum(logp, axis=-1)
    qx = jnp.broadcast_to(particles[:, 0:1], (n, r))
    qy = jnp.broadcast_to(particles[:, 1:2], (n, r))
    qa = particles[:, 2:3] + beam_angles[None, :]
    queries = jnp.stack(
        [qx.reshape(-1), qy.reshape(-1), qa.reshape(-1)], axis=1
    )
    ranges = cast_rays(
        grid_map, queries, method=raycast_method, num_iters=sphere_march_iters
    ).reshape(n, r)
    return sensor.log_likelihood(observed_m, ranges, mode=sensor_mode)


def mcl_step(
    state: MCLState,
    action: jnp.ndarray,
    observed_m: jnp.ndarray,
    beam_angles: jnp.ndarray,
    grid_map: GridMap,
    sensor: SensorModel,
    *,
    resample_method: str = "systematic",
    raycast_method: str = "sphere",
    sphere_march_iters: int = 48,
    sensor_mode: str = "analytic",
    motion_dispersion: tuple[float, float, float] = (0.05, 0.025, 0.25),
    exact_dt_heuristic: bool = True,
    likelihood_fn=None,
    inject_fraction=None,
) -> tuple[MCLState, jnp.ndarray]:
    """One full MCL correction. Returns (new_state, inferred_pose).

    Mirrors the reference MCL() phase order exactly (resample from the OLD
    weights, then motion, then sensor; the returned pose is computed from
    the NEW particles and NEW weights, reference :777-778).

    ``inject_fraction`` (Augmented MCL, Probabilistic Robotics §8.3; the
    reference README:66-69 describes auto re-localization aspirationally
    but ships none): a traced scalar in [0, 1] — each particle is replaced
    by a fresh uniform free-space draw with that probability, AFTER motion
    and BEFORE the likelihood (the injected hypotheses are scored by the
    current scan in the same correction). The static ``None`` default
    compiles the injection code out entirely, keeping the default step
    bitwise identical (the extra RNG splits would otherwise shift every
    downstream stream).
    """
    if inject_fraction is None:
        key, k_resample, k_motion = jax.random.split(state.key, 3)
    else:
        key, k_resample, k_motion, k_inj, k_mask = jax.random.split(
            state.key, 5
        )

    idx = resample_indices(k_resample, state.log_weights, method=resample_method)
    proposal = state.particles[idx]

    proposal = motion_model(
        k_motion,
        proposal,
        action,
        dispersion_x=motion_dispersion[0],
        dispersion_y=motion_dispersion[1],
        dispersion_theta=motion_dispersion[2],
        exact_dt_heuristic=exact_dt_heuristic,
    )

    if inject_fraction is not None:
        n = proposal.shape[0]
        injected, _ = initialize_global(
            k_inj, grid_map, n, dtype=proposal.dtype
        )
        replace = jax.random.uniform(k_mask, (n,)) < inject_fraction
        proposal = jnp.where(replace[:, None], injected, proposal)

    if likelihood_fn is not None:
        # custom fused likelihood (the lut_pallas query); the map is
        # threaded through as an argument so multi-GB LUT buffers never
        # become constants embedded in the compiled program
        log_w = likelihood_fn(proposal, observed_m, grid_map)
    else:
        log_w = sensor_update(
            proposal,
            observed_m,
            beam_angles,
            grid_map,
            sensor,
            raycast_method=raycast_method,
            sphere_march_iters=sphere_march_iters,
            sensor_mode=sensor_mode,
        )
    # absolute quality before the shift: log(mean_i w_i) — the Augmented-
    # MCL w_avg in log space (linear space underflows at 1080 beams)
    log_quality = jax.nn.logsumexp(log_w) - jnp.log(log_w.shape[0] * 1.0)
    # normalize in log space (softmax downstream); subtract max for stability
    log_w = log_w - jax.lax.stop_gradient(jnp.max(log_w))

    new_state = MCLState(
        particles=proposal, log_weights=log_w, key=key,
        log_quality=log_quality.astype(jnp.float32),
    )
    pose = expected_pose(proposal, log_w)
    return new_state, pose


def build_pallas_likelihood(
    grid_map: GridMap,
    beam_angles: np.ndarray,
    cfg: MCLConfig,
    num_particles: int,
    num_members: int = 1,
):
    """Attach the row-padded range LUT to the map and build the fused
    likelihood query (ops/pallas_lut.py). Returns (grid_map_with_lut,
    query).

    Giant maps (estimated dense LUT > MCL_LUT_DENSE_MAX, default 2 GiB)
    use the row-compacted LUT: cells beyond max_range share one constant
    far row via a per-cell row map.
    """
    from monte_carlo_localization_tpu.mapping.range_lut import lut_dtype
    from monte_carlo_localization_tpu.ops.pallas_lut import (
        build_lut_query_fn,
        entries_per_subrow,
        required_row_stride,
        suggest_theta_bins,
    )

    dtype = lut_dtype(grid_map.max_range_px)  # u8 <= 254 px, u16 beyond
    beams_np = np.asarray(beam_angles)
    t = suggest_theta_bins(beams_np)
    stride = required_row_stride(t, beams_np, itemsize=dtype.itemsize)
    num_maps = (
        grid_map.occupancy.shape[0] if grid_map.occupancy.ndim == 3 else 1
    )
    if num_maps > 1 and grid_map.member_dims is not None:
        # tight per-member blocks: memory is the sum of TRUE map areas,
        # not M x padded common shape (with_member_luts)
        dims = np.asarray(grid_map.member_dims, np.int64)
        dense_bytes = int(
            (dims[:, 0] * dims[:, 1]).sum() * stride * dtype.itemsize
        )
    else:
        dense_bytes = (
            num_maps * grid_map.height * grid_map.width
            * stride * dtype.itemsize
        )
    max_dense = int(os.environ.get("MCL_LUT_DENSE_MAX", 2 << 30))
    tile = entries_per_subrow(dtype.itemsize)
    if dense_bytes > max_dense:
        if num_maps > 1:
            # giant-map heterogeneous fleet: row-compacted TIGHT
            # per-member blocks, composed addressing (row_map_bases +
            # lut_bases) in the query
            grid_map = grid_map.with_member_compact_luts(t, stride, tile)
        else:
            grid_map = grid_map.with_compact_range_lut(t, stride)
    elif num_maps == 1:
        grid_map = grid_map.with_range_lut(t, row_stride=stride)
    else:
        # multi-map fleets build TIGHT per-member LUT blocks on the host
        # (native C++ when available, disk-cached): padding every block
        # to the common shape multiplies memory by the shape spread
        grid_map = grid_map.with_member_luts(t, stride, tile)
    query = build_lut_query_fn(
        grid_map.lut_theta_bins,
        beams_np,
        num_particles,
        height=grid_map.height,
        width=grid_map.width,
        resolution=grid_map.resolution,
        # batched maps pass per-member origins at query time instead
        origin_x=0.0 if num_maps > 1 else float(grid_map.origin_x),
        origin_y=0.0 if num_maps > 1 else float(grid_map.origin_y),
        max_range_px=grid_map.max_range_px,
        row_stride=stride,
        z_hit=cfg.z_hit,
        z_short=cfg.z_short,
        z_max=cfg.z_max,
        z_rand=cfg.z_rand,
        sigma_hit=cfg.sigma_hit,
        inv_squash=cfg.inv_squash_factor,
        num_members=num_members,
        lut_dtype=dtype,
        per_member_maps=num_maps > 1,
    )
    return grid_map, query


class ParticleFilter:
    """High-level single-filter facade: owns map, config, sensor model and
    the jitted step. The host-side analogue of the reference node's MCL
    surface, without any I/O (see monte_carlo_localization_tpu.runtime for
    the dual-rate loop)."""

    def __init__(
        self,
        grid_map: GridMap,
        config: MCLConfig | None = None,
        beam_angles: np.ndarray | None = None,
    ):
        self.config = config or MCLConfig()
        # "auto" resolves per platform (config.resolve_raycast_method); an
        # auto-selected lut_pallas may later fall back to "lut" if the
        # beam geometry is unsupported.
        self._auto_raycast = self.config.raycast_method == "auto"
        if self._auto_raycast:
            self.config = self.config.replace(
                raycast_method=resolve_raycast_method("auto")
            )
        if self.config.raycast_method not in ("sphere", "dda", "lut", "lut_pallas"):
            raise ValueError(
                f"Unknown raycast method: {self.config.raycast_method!r}"
            )
        if self.config.resample_method not in ("systematic", "multinomial"):
            raise ValueError(
                f"Unknown resample method: {self.config.resample_method!r}"
            )
        if self.config.sensor_model_mode not in ("analytic", "table"):
            raise ValueError(
                f"Unknown sensor model mode: {self.config.sensor_model_mode!r}"
            )
        if self.config.reinit_mode not in ("reinit", "inject"):
            raise ValueError(
                f"Unknown reinit mode: {self.config.reinit_mode!r}"
            )
        if self.config.raycast_method == "lut":
            grid_map = grid_map.with_range_lut(self.config.lut_theta_bins)
        # lut_pallas attaches its LUT in set_beam_angles: its static lane
        # layout needs T matched to the beam increment
        self.grid_map = grid_map
        self.sensor = SensorModel.create(
            max_range_px=grid_map.max_range_px,
            resolution=grid_map.resolution,
            z_hit=self.config.z_hit,
            z_short=self.config.z_short,
            z_max=self.config.z_max,
            z_rand=self.config.z_rand,
            sigma_hit=self.config.sigma_hit,
            squash_factor=self.config.squash_factor,
        )
        self.beam_angles = (
            jnp.asarray(beam_angles, dtype=jnp.float32)
            if beam_angles is not None
            else None
        )
        self._rebuild_step()

    def _rebuild_step(self) -> None:
        cfg = self.config
        likelihood_fn = None
        if cfg.raycast_method == "lut_pallas" and self.beam_angles is not None:
            try:
                self.grid_map, query = build_pallas_likelihood(
                    self.grid_map, self.beam_angles, cfg, cfg.max_particles
                )
            except ValueError as e:
                if not self._auto_raycast:
                    raise
                # auto-selected on a beam geometry the static lane layout
                # cannot serve (a beam span past one circle of theta bins,
                # or two beams on one bin): degrade to the XLA lut path
                import warnings

                warnings.warn(
                    "auto raycast: lut_pallas unsupported here "
                    f"({e}); falling back to 'lut'",
                    stacklevel=2,
                )
                self.config = cfg = cfg.replace(raycast_method="lut")
                self.grid_map = self.grid_map.with_range_lut(
                    cfg.lut_theta_bins
                )
            else:
                sensor = self.sensor
                self._pallas_query = query  # exposed for tests/diagnostics

                def likelihood_fn(particles, observed_m, gmap):
                    obs_px = sensor.to_pixel_index(observed_m).astype(
                        jnp.float32
                    )
                    return query(
                        gmap.range_lut, particles, obs_px,
                        row_map=gmap.lut_row_map,
                    )

        step_fn = partial(
            mcl_step,
            resample_method=cfg.resample_method,
            raycast_method=cfg.raycast_method,
            sphere_march_iters=cfg.sphere_march_iters,
            sensor_mode=cfg.sensor_model_mode,
            motion_dispersion=(
                cfg.motion_dispersion_x,
                cfg.motion_dispersion_y,
                cfg.motion_dispersion_theta,
            ),
            exact_dt_heuristic=cfg.exact_dt_heuristic,
            likelihood_fn=likelihood_fn,
        )
        self._step = jax.jit(step_fn, donate_argnums=(0,))

        # Augmented-MCL twin of _step with a traced injection fraction —
        # a SEPARATE jit (traced lazily, costs nothing unless used) so the
        # default step stays bitwise identical (see mcl_step's note)
        def step_inject_fn(state, action, obs, beams, gmap, sensor, frac):
            return step_fn(
                state, action, obs, beams, gmap, sensor,
                inject_fraction=frac,
            )

        self._step_inject = jax.jit(step_inject_fn, donate_argnums=(0,))

        def steps_fn(state, actions, scans, beams, gmap, sensor):
            def body(s, inp):
                a, o = inp
                s2, pose = step_fn(s, a, o, beams, gmap, sensor)
                return s2, pose

            return jax.lax.scan(
                body, state, (actions, scans),
                unroll=max(1, cfg.scan_unroll),
            )

        self._step_many = jax.jit(steps_fn, donate_argnums=(0,))

    def set_beam_angles(self, beam_angles: np.ndarray) -> None:
        """Lazy beam setup, the analogue of lidarCB's first-scan branch
        (reference :297-313). Rebuilds the jitted step when the fused
        lut_pallas likelihood is active (its geometry is static per beam
        set)."""
        self.beam_angles = jnp.asarray(beam_angles, dtype=jnp.float32)
        if self.config.raycast_method == "lut_pallas":
            self._rebuild_step()

    def init_global(self, seed: int | None = None) -> MCLState:
        key = jax.random.key(self.config.seed if seed is None else seed)
        key, sub = jax.random.split(key)
        particles, log_w = initialize_global(
            sub, self.grid_map, self.config.max_particles
        )
        return MCLState(particles=particles, log_weights=log_w, key=key)

    def init_pose(self, pose, seed: int | None = None) -> MCLState:
        key = jax.random.key(self.config.seed if seed is None else seed)
        key, sub = jax.random.split(key)
        particles, log_w = initialize_pose(sub, pose, self.config.max_particles)
        return MCLState(particles=particles, log_weights=log_w, key=key)

    def step(
        self, state: MCLState, action, observed_m, inject_fraction=None
    ) -> tuple[MCLState, jnp.ndarray]:
        """One MCL correction (async dispatch; block on the pose if needed).

        ``inject_fraction``: optional Augmented-MCL random-particle
        injection probability for THIS correction (a traced scalar — no
        recompile when it changes); ``None`` runs the plain step.
        """
        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")
        args = (
            state,
            jnp.asarray(action, dtype=jnp.float32),
            jnp.asarray(observed_m, dtype=jnp.float32),
            self.beam_angles,
            self.grid_map,
            self.sensor,
        )
        if inject_fraction is None:
            return self._step(*args)
        return self._step_inject(*args, jnp.float32(inject_fraction))

    def log_quality(self, state: MCLState) -> float:
        """log mean (squashed) measurement likelihood of the latest
        correction — the ``w_avg`` signal of Augmented MCL (Probabilistic
        Robotics §8.3), captured inside ``mcl_step`` before the max-shift
        weight normalization (the shifted ``log_weights`` only measure
        concentration relative to the best particle, which RISES when every
        particle is equally wrong). Used by the runtime's auto
        re-localization monitor."""
        return float(state.log_quality)

    def step_many(
        self, state: MCLState, actions, observed_m
    ) -> tuple[MCLState, jnp.ndarray]:
        """K sequential MCL corrections in ONE device dispatch.

        ``actions`` is (K, 3) and ``observed_m`` is (K, R) — one
        (action, scan) pair per correction, chained via ``lax.scan`` so the
        whole sequence runs on-device with no per-step dispatch latency.
        Returns (state_after_K, poses (K, 3)). This is the throughput path
        for trace replay and benchmarking; ``step`` is the low-latency
        one-correction path the dual-rate runtime uses.
        """
        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")
        return self._step_many(
            state,
            jnp.asarray(actions, dtype=jnp.float32),
            jnp.asarray(observed_m, dtype=jnp.float32),
            self.beam_angles,
            self.grid_map,
            self.sensor,
        )

    def profile_phases(self, state: MCLState, action, observed_m, iters: int = 20):
        """Per-phase timing breakdown, the analogue of the reference's
        TimingStats printout (reference src/utils.cpp:105-125).

        The production step is ONE fused XLA computation, so phases are
        timed here as separate sub-jitted dispatches — the split is
        diagnostic, not the production schedule. Returns a populated
        :class:`~monte_carlo_localization_tpu.utils.timing.TimingStats`.
        """
        import time

        from monte_carlo_localization_tpu.utils.timing import TimingStats

        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set")
        cfg = self.config
        action = jnp.asarray(action, jnp.float32)
        obs = jnp.asarray(observed_m, jnp.float32)

        resample_j = jax.jit(
            lambda key, lw, p: p[
                resample_indices(key, lw, method=cfg.resample_method)
            ]
        )
        motion_j = jax.jit(
            lambda key, p: motion_model(
                key,
                p,
                action,
                dispersion_x=cfg.motion_dispersion_x,
                dispersion_y=cfg.motion_dispersion_y,
                dispersion_theta=cfg.motion_dispersion_theta,
                exact_dt_heuristic=cfg.exact_dt_heuristic,
            )
        )
        if cfg.raycast_method == "lut_pallas" and getattr(
            self, "_pallas_query", None
        ) is not None:
            # time the production lut_pallas query. The LUT (and row
            # map) are passed as jit ARGUMENTS — a captured constant
            # would embed the multi-GB buffer in the compiled program
            # (see mcl_step's likelihood_fn note)
            query, sensor_sm, gmap = self._pallas_query, self.sensor, self.grid_map
            obs_px = sensor_sm.to_pixel_index(obs).astype(jnp.float32)
            if gmap.lut_row_map is not None:
                kern_j = jax.jit(
                    lambda lut, rm, p: query(lut, p, obs_px, row_map=rm)
                )
                sensor_j = partial(kern_j, gmap.range_lut, gmap.lut_row_map)
            else:
                kern_j = jax.jit(lambda lut, p: query(lut, p, obs_px))
                sensor_j = partial(kern_j, gmap.range_lut)
        else:
            # the map is a jit ARGUMENT, as in the production step — a
            # captured constant embeds e.g. the 'lut' backend's multi-GB
            # range LUT in the compiled program
            sense_j = jax.jit(
                lambda gmap, p: sensor_update(
                    p,
                    obs,
                    self.beam_angles,
                    gmap,
                    self.sensor,
                    raycast_method=cfg.raycast_method,
                    sphere_march_iters=cfg.sphere_march_iters,
                    sensor_mode=cfg.sensor_model_mode,
                )
            )
            sensor_j = partial(sense_j, self.grid_map)

        def timed(fn, *a, attr, stats):
            out = fn(*a)
            jax.block_until_ready(out)  # warm
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*a)
            jax.block_until_ready(out)
            setattr(
                stats, attr, getattr(stats, attr) + (time.perf_counter() - t0) * 1e3
            )
            return out

        stats = TimingStats()
        key, k1, k2 = jax.random.split(state.key, 3)
        prop = timed(
            resample_j, k1, state.log_weights, state.particles,
            attr="resampling_time", stats=stats,
        )
        prop = timed(motion_j, k2, prop, attr="motion_model_time", stats=stats)
        timed(sensor_j, prop, attr="sensor_model_time", stats=stats)

        # time the fused step without donation effects: rebuild state copies
        s0 = MCLState(
            particles=jnp.array(state.particles),
            log_weights=jnp.array(state.log_weights),
            key=key,
        )
        out = self._step(s0, action, obs, self.beam_angles, self.grid_map, self.sensor)
        jax.block_until_ready(out[1])
        t0 = time.perf_counter()
        s_i = out[0]
        for _ in range(iters):
            s_i, pose = self._step(
                s_i, action, obs, self.beam_angles, self.grid_map, self.sensor
            )
        jax.block_until_ready(pose)
        stats.total_mcl_time = (time.perf_counter() - t0) * 1e3
        stats.measurement_count = iters
        # phase accumulators were measured over `iters` runs each too
        return stats
