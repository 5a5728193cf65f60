"""Giant-N global localization: ONE filter with its particle axis sharded
across a device mesh (SURVEY.md §2.1 rows 4/"context parallelism").

The reference caps at a few thousand particles because its OpenMP ray
loop is O(N*R*max_range_px) on one CPU (reference
src/particle_filter.cpp:586-650). Here 100k+ particles spread over chips:

* motion + ray casting + likelihood are local to each shard (zero
  communication — particles are independent),
* weight normalization is a global logsumexp via ``psum``,
* systematic resampling needs the global CDF: shard weight totals are
  exchanged with one tiny ``all_gather`` (D scalars) to place each
  shard's cumsum in the global prefix, and ancestor rows cross shards
  through the BUCKETED exchange
  (:func:`~..ops.resample.distributed_systematic_resample_rows`): each
  shard scatters its covered sources' rows into its own slot window plus
  a C-row fringe, the fringes ride one ``ppermute`` per neighbor, and
  per-destination seed rows arrive via a tiny psum — O(C + D) bytes per
  step instead of the O(N) full particle-matrix ``all_gather`` (SURVEY
  §7 hard-part 6). Pathological cross-shard weight imbalance (a covered
  source landing beyond the fringe) trips an exact psum flag and the
  step falls back to the all-gather path via ``lax.cond`` — results are
  bitwise identical either way (pinned in tests/test_parallel.py).
* the pose estimate is a psum-weighted mean + circular mean.

Everything runs inside ONE ``shard_map``-decorated jitted step;
``step_many`` chains K such steps per dispatch via ``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from monte_carlo_localization_tpu.config import MCLConfig
from monte_carlo_localization_tpu.filter.core import MCLState, sensor_update
from monte_carlo_localization_tpu.filter.init import initialize_global
from monte_carlo_localization_tpu.mapping.grid_map import GridMap
from monte_carlo_localization_tpu.models.motion import motion_model
from monte_carlo_localization_tpu.models.sensor import SensorModel
from monte_carlo_localization_tpu.ops.resample import (
    distributed_systematic_resample_rows,
    systematic_invert_cdf_window,
)


class ShardedParticleFilter:
    """One MCL filter with particles sharded over mesh axis ``axis``."""

    def __init__(
        self,
        grid_map: GridMap,
        config: MCLConfig | None = None,
        mesh: Mesh | None = None,
        axis: str = "p",
        beam_angles: np.ndarray | None = None,
    ):
        self.config = config or MCLConfig()
        from monte_carlo_localization_tpu.config import resolve_raycast_method
        from monte_carlo_localization_tpu.parallel.fleet import (
            _validate_parallel_config,
        )

        self.config = self.config.replace(
            raycast_method=resolve_raycast_method(self.config.raycast_method)
        )

        _validate_parallel_config(
            self.config, "ShardedParticleFilter", allow_pallas=True
        )
        self.map = grid_map
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), (axis,))
        self.mesh = mesh
        self.axis = axis
        self.num_devices = mesh.shape[axis]
        if self.config.max_particles % self.num_devices != 0:
            raise ValueError(
                f"max_particles ({self.config.max_particles}) must divide "
                f"evenly over {self.num_devices} devices"
            )
        if self.config.sharded_resample not in ("bucketed", "allgather"):
            raise ValueError(
                f"Unknown sharded_resample: {self.config.sharded_resample!r}"
            )
        n_local = self.config.max_particles // self.num_devices
        # fringe capacity of the bucketed ancestor exchange: how far (in
        # slots) a source's first output slot may stray from its own shard
        # window before the step falls back to the all-gather path. The
        # misalignment is driven by cross-shard weight imbalance, which
        # resampling itself re-balances every step; n_local/8 (floor 64)
        # absorbs ordinary imbalance while keeping the exchange O(C).
        self._fringe = self.config.sharded_fringe or max(64, n_local // 8)
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
            None if beam_angles is None else jnp.asarray(beam_angles, jnp.float32)
        )
        if self.config.raycast_method == "lut":
            self.map = grid_map.with_range_lut(self.config.lut_theta_bins)
        # lut_pallas attaches its LUT in set_beam_angles (kernel geometry
        # is static per beam set), exactly as the single-filter facade does
        self._pallas_query = None
        self._build_step()

    def _build_step(self):
        cfg = self.config
        axis = self.axis
        n_total = cfg.max_particles

        pallas_query = None
        if cfg.raycast_method == "lut_pallas":
            if self.beam_angles is None:
                return  # deferred until set_beam_angles
            from monte_carlo_localization_tpu.filter.core import (
                build_pallas_likelihood,
            )

            # the query runs PER SHARD inside shard_map: its static
            # particle count is the local slice, and the (padded) LUT is a
            # replicated operand every shard reads from its own copy of
            self.map, pallas_query = build_pallas_likelihood(
                self.map, np.asarray(self.beam_angles), cfg,
                n_total // self.num_devices,
            )
            self._pallas_query = pallas_query
        sensor_sm = self.sensor

        def local_step(particles, log_w, key, action, scan, beams, gmap, sensor):
            """Runs on each shard: particles (n_local, 3), log_w (n_local,)."""
            n_local = particles.shape[0]
            shard = jax.lax.axis_index(axis)
            # The same key enters every shard and the same evolved key
            # leaves (replicated out_spec); only per-shard SUBkeys fold in
            # the shard index to decorrelate noise across shards.
            key, k_resample, k_motion = jax.random.split(key, 3)
            k_motion = jax.random.fold_in(k_motion, shard)

            # ---- distributed systematic resampling ----
            # global softmax: max and sum via collectives
            m_local = jnp.max(log_w)
            m = jax.lax.pmax(m_local, axis)
            w_local = jnp.exp(log_w - m)
            z = jax.lax.psum(jnp.sum(w_local), axis)
            w = w_local / z  # globally normalized weights, local slice

            local_cdf = jnp.cumsum(w)
            shard_total = local_cdf[-1]
            totals = jax.lax.all_gather(shard_total, axis)  # (D,)
            offset = jnp.where(
                jnp.arange(self.num_devices) < shard, totals, 0.0
            ).sum()
            global_cdf_local = local_cdf + offset  # this shard's CDF segment

            # systematic resampling uses ONE global u0: k_resample is not
            # folded, so every shard draws the identical value
            u0 = jax.random.uniform(k_resample, ())

            def full_gather(_):
                """All-gather fallback/compat path: fetch the full particle
                matrix (N x 3) and CDF, invert this shard's slot window.
                O(N) bytes — the bucketed path's overflow escape and
                the ``sharded_resample='allgather'`` compatibility mode."""
                all_particles = jax.lax.all_gather(
                    particles, axis
                ).reshape(n_total, 3)
                all_cdf = jax.lax.all_gather(
                    global_cdf_local, axis
                ).reshape(-1)
                # scatter-side CDF inversion, as in the single-device
                # resampler (ops/resample.py)
                src = systematic_invert_cdf_window(
                    all_cdf, u0, n_total, shard * n_local, n_local
                )
                return all_particles[src]

            if cfg.sharded_resample == "bucketed" and self.num_devices > 1:
                # bucketed ancestor exchange: O(fringe + D) bytes
                # (SURVEY §7 hard-part 6); bitwise equal to full_gather
                rows_b, overflow = distributed_systematic_resample_rows(
                    particles, global_cdf_local, u0, n_total, axis,
                    self.num_devices, self._fringe,
                )
                proposal = jax.lax.cond(
                    overflow, full_gather, lambda _: rows_b, None
                )
            else:
                proposal = full_gather(None)

            # ---- motion (local) ----
            proposal = motion_model(
                k_motion,
                proposal,
                action,
                dispersion_x=cfg.motion_dispersion_x,
                dispersion_y=cfg.motion_dispersion_y,
                dispersion_theta=cfg.motion_dispersion_theta,
                exact_dt_heuristic=cfg.exact_dt_heuristic,
            )

            # ---- likelihood (local) ----
            if pallas_query is not None:
                obs_px = sensor_sm.to_pixel_index(scan).astype(jnp.float32)
                log_w_new = pallas_query(
                    gmap.range_lut, proposal, obs_px,
                    row_map=gmap.lut_row_map,
                )
            else:
                log_w_new = sensor_update(
                    proposal,
                    scan,
                    beams,
                    gmap,
                    sensor,
                    raycast_method=cfg.raycast_method,
                    sphere_march_iters=cfg.sphere_march_iters,
                    sensor_mode=cfg.sensor_model_mode,
                )
            # absolute measurement quality BEFORE the max shift: the global
            # log mean likelihood (Augmented-MCL w_avg), via a distributed
            # logsumexp — matches ParticleFilter's log_quality signal
            mq = jax.lax.pmax(jnp.max(log_w_new), axis)
            zq = jax.lax.psum(jnp.sum(jnp.exp(log_w_new - mq)), axis)
            log_quality = mq + jnp.log(zq) - jnp.log(float(n_total))
            log_w_new = log_w_new - jax.lax.pmax(jnp.max(log_w_new), axis)

            # ---- pose estimate (global) ----
            wn_local = jnp.exp(log_w_new)
            zn = jax.lax.psum(jnp.sum(wn_local), axis)
            wn = wn_local / zn
            px = jax.lax.psum(jnp.sum(wn * proposal[:, 0]), axis)
            py = jax.lax.psum(jnp.sum(wn * proposal[:, 1]), axis)
            ps = jax.lax.psum(jnp.sum(wn * jnp.sin(proposal[:, 2])), axis)
            pc = jax.lax.psum(jnp.sum(wn * jnp.cos(proposal[:, 2])), axis)
            pose = jnp.stack([px, py, jnp.arctan2(ps, pc)])

            return proposal, log_w_new, key, pose, log_quality

        mesh = self.mesh
        pspec = P(axis)
        rspec = P()

        sharded = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(pspec, pspec, rspec, rspec, rspec, rspec, rspec, rspec),
            out_specs=(pspec, pspec, rspec, rspec, rspec),
            check_vma=False,
        )

        def step(state: MCLState, action, scan, beams, gmap, sensor):
            particles, log_w, key, pose, log_q = sharded(
                state.particles, state.log_weights, state.key, action, scan,
                beams, gmap, sensor,
            )
            # every shard returns the same key evolution; keep shard 0's
            return MCLState(
                particles=particles, log_weights=log_w, key=key,
                log_quality=log_q.astype(jnp.float32),
            ), pose

        self._step = jax.jit(step, donate_argnums=(0,))

        def steps_fn(state, actions, scans, beams, gmap, sensor):
            def body(s, inp):
                a, o = inp
                s2, pose = step(s, a, o, beams, gmap, sensor)
                return s2, pose

            # same scan-loop-overhead amortization as the single filter
            # (MCLConfig.scan_unroll)
            return jax.lax.scan(
                body, state, (actions, scans),
                unroll=max(1, self.config.scan_unroll),
            )

        self._step_many = jax.jit(steps_fn, donate_argnums=(0,))

    def log_quality(self, state: MCLState) -> float:
        """Global log mean measurement likelihood of the latest correction
        (Augmented-MCL w_avg) — same contract as ParticleFilter.log_quality."""
        return float(state.log_quality)

    def init_global(self, seed: int = 0) -> MCLState:
        key = jax.random.key(seed)
        key, sub = jax.random.split(key)
        particles, log_w = initialize_global(
            sub, self.map, self.config.max_particles
        )
        return self.place_state(
            MCLState(particles=particles, log_weights=log_w, key=key)
        )

    def place_state(self, state: MCLState) -> MCLState:
        """Re-place an MCLState onto this filter's mesh: particle-axis
        leaves shard over ``axis``, scalars/key replicate. Used by
        ``init_global`` and by checkpoint restore
        (``runtime.checkpoint.load_state(path, place=spf.place_state)``) —
        a checkpoint written on one mesh resumes on another."""
        if state.num_particles != self.config.max_particles:
            raise ValueError(
                f"state holds {state.num_particles} particles, filter "
                f"expects {self.config.max_particles}"
            )
        sh = NamedSharding(self.mesh, P(self.axis))
        return MCLState(
            particles=jax.device_put(jnp.asarray(state.particles), sh),
            log_weights=jax.device_put(jnp.asarray(state.log_weights), sh),
            key=state.key,
            log_quality=state.log_quality,
        )

    def set_beam_angles(self, beam_angles: np.ndarray) -> None:
        self.beam_angles = jnp.asarray(beam_angles, dtype=jnp.float32)
        if self.config.raycast_method == "lut_pallas":
            self._build_step()

    def step(self, state: MCLState, action, scan):
        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")
        return self._step(
            state,
            jnp.asarray(action, dtype=jnp.float32),
            jnp.asarray(scan, dtype=jnp.float32),
            self.beam_angles,
            self.map,
            self.sensor,
        )

    def step_many(self, state: MCLState, actions, scans):
        """K sequential sharded corrections in ONE device dispatch.

        ``actions`` is (K, 3), ``scans`` is (K, R); the K steps chain via
        ``lax.scan`` exactly like the single-filter replay path
        (filter/core.py ParticleFilter.step_many), so trace replay on a
        sharded filter stops paying per-dispatch host latency. Bitwise
        equal to K calls of :meth:`step` (pinned in tests/test_parallel.py).
        Returns (state_after_K, poses (K, 3)).
        """
        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")
        return self._step_many(
            state,
            jnp.asarray(actions, dtype=jnp.float32),
            jnp.asarray(scans, dtype=jnp.float32),
            self.beam_angles,
            self.map,
            self.sensor,
        )
