"""Fleet parallelism: many independent MCL instances on a device mesh.

The reference runs exactly one filter per process (one node = one car).
The engine batches F independent filters — e.g. 64 cars x 4000
particles — as ONE vmapped, jitted step, and shards the fleet axis across
devices with `jax.sharding` (embarrassingly parallel: zero collectives;
SURVEY.md §2.1 row 3).

Different cars may run on DIFFERENT maps: maps are stacked into one
batched pytree (padded to a common shape with occupied borders, which
preserves ray-cast semantics since rays already stop at obstacles/borders)
and the map becomes a vmapped argument.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from monte_carlo_localization_tpu.config import MCLConfig, resolve_raycast_method
from monte_carlo_localization_tpu.filter.core import MCLState, expected_pose, mcl_step
from monte_carlo_localization_tpu.filter.init import initialize_global, initialize_pose
from monte_carlo_localization_tpu.mapping.grid_map import GridMap, OCC_OCCUPIED
from monte_carlo_localization_tpu.models.sensor import SensorModel


def _validate_parallel_config(
    cfg: MCLConfig, who: str, allow_pallas: bool = False
) -> None:
    """Fail fast at construction, not at jit-trace time, on config values
    the batched/sharded filters can't serve (mirrors ParticleFilter's own
    validation)."""
    if cfg.raycast_method == "lut_pallas" and not allow_pallas:
        raise ValueError(
            f"{who} supports raycast_method='lut_pallas' (shared or "
            "heterogeneous maps) only without a particle mesh axis, and "
            "with fleet_size divisible over a 1-D fleet mesh; use 'lut'"
        )
    if cfg.raycast_method not in ("sphere", "dda", "lut", "lut_pallas"):
        raise ValueError(f"Unknown raycast method: {cfg.raycast_method!r}")
    if cfg.resample_method not in ("systematic", "multinomial"):
        raise ValueError(f"Unknown resample method: {cfg.resample_method!r}")
    if cfg.sensor_model_mode not in ("analytic", "table"):
        raise ValueError(f"Unknown sensor model mode: {cfg.sensor_model_mode!r}")


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FleetState:
    """Batched filter state: leading axis = fleet member."""

    particles: jnp.ndarray  # (F, N, 3)
    log_weights: jnp.ndarray  # (F, N)
    keys: jax.Array  # (F,) PRNG keys

    @property
    def fleet_size(self) -> int:
        return self.particles.shape[0]


def stack_maps(maps: Sequence[GridMap]) -> GridMap:
    """Stack maps into one batched GridMap (leading fleet axis on ALL leaves).

    Grids are padded bottom/right to the common max shape: occupancy pads
    as OCCUPIED and clearance pads as 0, so padded space behaves exactly
    like the map border the ray casters already stop at. free_cells pads
    by repeating the first cell; global init stays uniform because it
    samples with the per-map ``num_free`` bound (a traced leaf).
    Per-map origins are leaves, so heterogeneous origins are fine.
    """
    if not maps:
        raise ValueError("need at least one map")
    res = maps[0].resolution
    mrp = maps[0].max_range_px
    for m in maps:
        if abs(m.resolution - res) > 1e-9 or m.max_range_px != mrp:
            raise ValueError(
                "fleet maps must share resolution and max_range_px "
                f"({m.name}: res {m.resolution} vs {res}, max_range_px "
                f"{m.max_range_px} vs {mrp} — note an f32-fuzzed "
                "resolution like 0.05000000075 truncates max_range_px "
                "differently than exact 0.05)"
            )
    h = max(m.height for m in maps)
    w = max(m.width for m in maps)
    k = max(m.num_free_cells for m in maps)

    def pad_grid(a, fill, mh, mw):
        a = np.asarray(a)
        out = np.full((mh, mw), fill, dtype=a.dtype)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    free_cells = np.zeros((len(maps), k, 2), dtype=np.int32)
    for i, m in enumerate(maps):
        fc = np.asarray(m.free_cells)
        free_cells[i, : fc.shape[0]] = fc
        free_cells[i, fc.shape[0] :] = fc[0]

    return GridMap(
        occupancy=jnp.asarray(
            np.stack([pad_grid(m.occupancy, OCC_OCCUPIED, h, w) for m in maps])
        ),
        occupied=jnp.asarray(
            np.stack([pad_grid(m.occupied, True, h, w) for m in maps])
        ),
        permissible=jnp.asarray(
            np.stack([pad_grid(m.permissible, False, h, w) for m in maps])
        ),
        clearance=jnp.asarray(
            np.stack([pad_grid(m.clearance, 0.0, h, w) for m in maps])
        ),
        free_cells=jnp.asarray(free_cells),
        num_free=jnp.asarray([int(m.num_free) for m in maps], dtype=jnp.int32),
        origin_x=jnp.asarray([float(m.origin_x) for m in maps], jnp.float32),
        origin_y=jnp.asarray([float(m.origin_y) for m in maps], jnp.float32),
        origin_yaw=jnp.asarray([float(m.origin_yaw) for m in maps], jnp.float32),
        resolution=res,
        max_range_px=mrp,
        max_range_meters=maps[0].max_range_meters,
        name="fleet:" + ",".join(m.name for m in maps),
        # true pre-padding shapes, so the lut_pallas path can build TIGHT
        # per-member LUT blocks (GridMap.with_member_luts) instead of
        # padding every member's LUT to the common max shape
        member_dims=jnp.asarray(
            [[m.height, m.width] for m in maps], jnp.int32
        ),
    )


def is_batched_map(grid_map: GridMap) -> bool:
    return grid_map.occupancy.ndim == 3


def _global_put(x, sharding: NamedSharding):
    """Place host-computed data onto a sharding that may span processes.

    ``jax.device_put`` rejects shardings with non-addressable devices
    (the multi-host fleet mesh, parallel/multihost.py); every process
    holds the SAME full host value (deterministic init from one seed), so
    each can materialize exactly its addressable shards via the callback
    path. Single-process meshes keep the plain device_put fast path.
    """
    if all(d.process_index == 0 for d in sharding.device_set):
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(
        x.shape, sharding, lambda idx: x[idx]
    )


class FleetFilter:
    """F independent filters as one jitted step, sharded over a mesh axis.

    All members share one config and (for now) one map geometry batch; a
    heterogeneous-origin fleet passes per-member origins at construction
    via ``stack_maps``.
    """

    def __init__(
        self,
        grid_map: GridMap,
        fleet_size: int,
        config: MCLConfig | None = None,
        beam_angles: np.ndarray | None = None,
        mesh: Mesh | None = None,
        fleet_axis: str = "fleet",
        particle_axis: str | None = None,
        map_assignment: np.ndarray | None = None,
    ):
        """With ``particle_axis`` set (2-D mesh), each member's particle
        axis is additionally sharded — XLA inserts the resampling gathers
        (the pjit path; the explicit-collectives path is
        ShardedParticleFilter).

        ``map_assignment`` (F,) int: member -> map index into a stacked
        ``grid_map`` of M maps, letting many cars share each circuit's
        LUT (64 cars over 4 maps stores 4 LUT blocks, not 64). Requires
        ``raycast_method='lut_pallas'`` (the XLA paths vmap the map per
        member and would duplicate it)."""
        self.config = config or MCLConfig()
        self.config = self.config.replace(
            raycast_method=resolve_raycast_method(self.config.raycast_method)
        )
        # the fused lut_pallas query serves the fleet as one big flattened
        # particle batch with per-member scans (obs blocks indexed by
        # member); heterogeneous fleets concatenate per-member LUTs and
        # fold the member index into the window address. With a 1-D fleet
        # mesh the same structure runs PER SHARD inside shard_map (members
        # are independent — zero collectives), each shard holding F/D
        # members against a replicated LUT. A 2-D fleet x particle mesh
        # stays on the XLA paths (the query is not auto-partitionable
        # over its particle axis).
        pallas_ok = (
            self.config.raycast_method == "lut_pallas"
            and particle_axis is None
            and (mesh is None or fleet_size % mesh.shape[fleet_axis] == 0)
        )
        _validate_parallel_config(
            self.config, "FleetFilter", allow_pallas=pallas_ok
        )
        self.map_assignment = None
        if map_assignment is not None:
            asg = np.asarray(map_assignment, np.int32)
            if not (pallas_ok and is_batched_map(grid_map)):
                raise ValueError(
                    "map_assignment requires raycast_method='lut_pallas' "
                    "and a stacked (batched) grid_map"
                )
            if asg.shape != (fleet_size,):
                raise ValueError(
                    f"map_assignment must be ({fleet_size},), got {asg.shape}"
                )
            num_maps = grid_map.occupancy.shape[0]
            if asg.min() < 0 or asg.max() >= num_maps:
                raise ValueError(
                    f"map_assignment values must be in [0, {num_maps})"
                )
            self.map_assignment = asg
        elif is_batched_map(grid_map) and grid_map.occupancy.shape[0] != fleet_size:
            raise ValueError(
                f"stacked grid_map has {grid_map.occupancy.shape[0]} maps "
                f"for fleet_size={fleet_size}; pass map_assignment to share "
                "maps between members"
            )
        self.map = grid_map
        self.fleet_size = fleet_size
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
        self.mesh = mesh
        self.fleet_axis = fleet_axis
        self.particle_axis = particle_axis
        self._pallas = pallas_ok
        self._build_step()

    def _build_step(self) -> None:
        grid_map = self.map
        mesh = self.mesh
        fleet_axis = self.fleet_axis
        particle_axis = self.particle_axis
        cfg = self.config

        if self._pallas and self.beam_angles is not None:
            self._build_pallas_step()
            return

        if cfg.raycast_method == "lut":
            grid_map = grid_map.with_range_lut(cfg.lut_theta_bins)
            self.map = grid_map
        step = partial(
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
        )

        map_axis = 0 if is_batched_map(grid_map) else None

        def fleet_step(state: FleetState, actions, scans, beams, gmap, sensor):
            def one(particles, logw, key, action, scan, gm):
                s = MCLState(particles=particles, log_weights=logw, key=key)
                s2, pose = step(s, action, scan, beams, gm, sensor)
                return s2.particles, s2.log_weights, s2.key, pose

            p, lw, keys, poses = jax.vmap(
                one, in_axes=(0, 0, 0, 0, 0, map_axis)
            )(state.particles, state.log_weights, state.keys, actions, scans, gmap)
            return FleetState(particles=p, log_weights=lw, keys=keys), poses

        if mesh is not None:
            fs = NamedSharding(mesh, P(fleet_axis))
            pspec = (
                P(fleet_axis, particle_axis) if particle_axis else P(fleet_axis)
            )
            state_sh = FleetState(
                particles=NamedSharding(mesh, pspec),
                log_weights=NamedSharding(mesh, pspec),
                keys=NamedSharding(mesh, P(fleet_axis)),
            )
            repl = NamedSharding(mesh, P())
            # a batched map shards along the fleet axis with the filters;
            # a shared map replicates to every device
            map_sh = fs if map_axis == 0 else repl
            self._step = jax.jit(
                fleet_step,
                in_shardings=(state_sh, fs, fs, repl, map_sh, repl),
                out_shardings=(state_sh, fs),
                donate_argnums=(0,),
            )
        else:
            self._step = jax.jit(fleet_step, donate_argnums=(0,))
        self._build_step_many(fleet_step)

    def _build_pallas_step(self) -> None:
        """Fused-likelihood path: the lut_pallas query runs over the
        flattened (members*N, 3) particle batch with per-member scans;
        resample/motion/pose stay per-member via vmap. On a 1-D fleet mesh
        the identical local step runs per shard inside shard_map (F/D
        members each, replicated LUT, no collectives)."""
        from monte_carlo_localization_tpu.filter.core import (
            build_pallas_likelihood,
        )
        from monte_carlo_localization_tpu.models.motion import motion_model
        from monte_carlo_localization_tpu.ops.resample import resample_indices

        cfg = self.config
        mesh = self.mesh
        f = self.fleet_size
        n = cfg.max_particles
        local_f = f if mesh is None else f // mesh.shape[self.fleet_axis]
        hetero = is_batched_map(self.map)
        map_of = (
            None
            if self.map_assignment is None
            else jnp.asarray(self.map_assignment)
        )
        self.map, query = build_pallas_likelihood(
            self.map, np.asarray(self.beam_angles), cfg, local_f * n,
            num_members=local_f,
        )
        sensor_sm = self.sensor
        fa = self.fleet_axis

        def local_step(particles, logw, keys, actions, scans, gmap):
            """(local_f, N, ...) in, (local_f, ...) out — one shard's (or
            the whole single-device fleet's) correction."""

            def propose(particles_m, logw_m, key, action):
                key, kr, km = jax.random.split(key, 3)
                idx = resample_indices(kr, logw_m, method=cfg.resample_method)
                prop = motion_model(
                    km,
                    particles_m[idx],
                    action,
                    dispersion_x=cfg.motion_dispersion_x,
                    dispersion_y=cfg.motion_dispersion_y,
                    dispersion_theta=cfg.motion_dispersion_theta,
                    exact_dt_heuristic=cfg.exact_dt_heuristic,
                )
                return prop, key

            prop, keys = jax.vmap(propose)(particles, logw, keys, actions)
            obs_px = sensor_sm.to_pixel_index(scans).astype(jnp.float32)
            shard0 = (
                jax.lax.axis_index(fa) * local_f if mesh is not None else 0
            )

            kw = {}
            if hetero:
                kw = dict(
                    member_base=shard0,
                    origins=(gmap.origin_x, gmap.origin_y),
                    map_of=map_of,
                    # tight per-member LUT layout (None -> padded)
                    dims=gmap.member_dims,
                    lut_bases=gmap.lut_member_base,
                    # compact per-member blocks (giant maps) compose a
                    # row-map indirection before the block base
                    row_map_bases=gmap.lut_row_map_base,
                )
            logw = query(
                gmap.range_lut,
                prop.reshape(local_f * n, 3),
                obs_px,
                row_map=gmap.lut_row_map,
                **kw,
            ).reshape(local_f, n)
            logw = logw - jax.lax.stop_gradient(
                jnp.max(logw, axis=1, keepdims=True)
            )
            poses = jax.vmap(expected_pose)(prop, logw)
            return prop, logw, keys, poses

        if mesh is not None:
            local_step = jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(P(fa), P(fa), P(fa), P(fa), P(fa), P()),
                out_specs=(P(fa), P(fa), P(fa), P(fa)),
                check_vma=False,
            )

        def fleet_step(state: FleetState, actions, scans, beams, gmap, sensor):
            del beams, sensor  # geometry/model are baked into the query
            p, lw, keys, poses = local_step(
                state.particles, state.log_weights, state.keys, actions,
                scans, gmap,
            )
            return FleetState(particles=p, log_weights=lw, keys=keys), poses

        self._step = jax.jit(fleet_step, donate_argnums=(0,))
        self._build_step_many(fleet_step)

    def _build_step_many(self, fleet_step) -> None:
        """K chained fleet corrections per dispatch (`lax.scan` over the
        fleet step) — the same dispatch-amortizing throughput path the
        single filter's ``step_many`` provides. With a mesh, shardings
        propagate from the operands (the (K, F, ...) scan inputs shard
        along their fleet axis like the per-step arguments)."""

        def fleet_steps(state, actions, scans, beams, gmap, sensor):
            def body(s, inp):
                a, o = inp
                s2, poses = fleet_step(s, a, o, beams, gmap, sensor)
                return s2, poses

            return jax.lax.scan(body, state, (actions, scans))

        self._step_many = jax.jit(fleet_steps, donate_argnums=(0,))

    def set_beam_angles(self, beam_angles: np.ndarray) -> None:
        self.beam_angles = jnp.asarray(beam_angles, dtype=jnp.float32)
        if self._pallas:
            self._build_step()

    def _place(self, state: FleetState) -> FleetState:
        if self.mesh is None:
            return state
        fs = NamedSharding(self.mesh, P(self.fleet_axis))
        psh = NamedSharding(
            self.mesh,
            P(self.fleet_axis, self.particle_axis)
            if self.particle_axis
            else P(self.fleet_axis),
        )
        return FleetState(
            particles=_global_put(state.particles, psh),
            log_weights=_global_put(state.log_weights, psh),
            keys=_global_put(state.keys, fs),
        )

    def init_global(self, seed: int = 0) -> FleetState:
        keys = jax.random.split(jax.random.key(seed), self.fleet_size + 1)
        n = self.config.max_particles
        # Init only samples free cells — the LUT leaves are dead weight here,
        # and the tight concatenated layout (flat range_lut + lut_member_base)
        # has no member axis 0 for the vmap below to map over.
        gmap = replace(
            self.map, range_lut=None, lut_row_map=None, lut_member_base=None,
            lut_row_map_base=None,
        )
        if self.map_assignment is not None:
            # expand the M-map batch to one entry per member for the init vmap
            asg = jnp.asarray(self.map_assignment)
            gmap = jax.tree.map(lambda x: x[asg], gmap)
        map_axis = 0 if is_batched_map(gmap) else None

        def one(key, gm):
            return initialize_global(key, gm, n)

        particles, logw = jax.vmap(one, in_axes=(0, map_axis))(keys[1:], gmap)
        return self._place(
            FleetState(
                particles=particles,
                log_weights=logw,
                keys=jax.random.split(keys[0], self.fleet_size),
            )
        )

    def init_pose(self, poses: np.ndarray, seed: int = 0) -> FleetState:
        """poses: (F, 3) per-member seed poses."""
        poses = jnp.asarray(poses, dtype=jnp.float32)
        keys = jax.random.split(jax.random.key(seed), self.fleet_size + 1)
        n = self.config.max_particles

        def one(key, pose):
            return initialize_pose(key, pose, n)

        particles, logw = jax.vmap(one)(keys[1:], poses)
        return self._place(
            FleetState(
                particles=particles,
                log_weights=logw,
                keys=jax.random.split(keys[0], self.fleet_size),
            )
        )

    def step(
        self, state: FleetState, actions, scans
    ) -> tuple[FleetState, jnp.ndarray]:
        """actions: (F, 3); scans: (F, R). Returns (state, poses (F, 3))."""
        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")
        return self._step(
            state,
            jnp.asarray(actions, dtype=jnp.float32),
            jnp.asarray(scans, dtype=jnp.float32),
            self.beam_angles,
            self.map,
            self.sensor,
        )

    def step_many(
        self, state: FleetState, actions, scans
    ) -> tuple[FleetState, jnp.ndarray]:
        """K sequential fleet corrections in ONE device dispatch.

        ``actions`` is (K, F, 3) and ``scans`` is (K, F, R) — one
        per-member (action, scan) batch per correction, chained via
        ``lax.scan``. Returns (state_after_K, poses (K, F, 3)).

        Useful for replaying K recorded ticks in one call; whether it
        also raises throughput depends on how far one fleet step already
        amortizes its own dispatch (PERF.md)."""
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
