"""Smoke test of the engine's main path on one NVIDIA GPU.

Runs the filters through the entry points a user calls, at the sizes
users run, and checks what comes out:

1. device: the card's name and power limit, JAX version, XLA_FLAGS, the
   compile-cache directory, and which LUT builder ran (native or numpy);
2. headline: ``ParticleFilter`` (raycast "auto") on Spielberg, 4000
   particles x 1080 beams, seeded at a free pose with a scan from the
   DDA oracle; 20 per-dispatch steps and step_many chains of 50; pose
   error < 0.15 m; the step's compiled memory; and the likelihood on the
   card against a host evaluation of the same sum, on particles whose
   LUT rows lie past 2^31 entries;
3. long range: basement_fixed at 25.6 m (a u16 LUT past 2^31 entries),
   4000 x 1080: the likelihood against the host twin, pose error < 0.15 m;
4. golden trace: ``cli replay`` of config #1's recorded trace through
   ``MCLNode``; rmse_xy_m < 0.12 m;
5. config #4 (100k particles x 60 beams, global init on basement_fixed:
   finite, normalized weights) and config #5 (a 64-car fleet over four
   maps with ``map_assignment``: every member within its drift bound).

``--four`` runs only the multi-card paths on four cards, each with what
it is compared with: ``ShardedParticleFilter`` at 1M particles over a
1-D mesh (bucketed vs all-gather resampling bitwise on a crafted
overflow state; convergence) and ``FleetFilter`` with 64 members over a
1-D fleet mesh against the same fleet on one card.

Exits non-zero, printing no result, without a GPU or if any phase
fails. The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MAPS = REPO / "maps"

# BASELINE configs (bench.py CONFIG_MAPS)
HEADLINE_MAP = "Spielberg_map.yaml"
CONFIG1_MAP = "map_1753950572.yaml"
CONFIG4_MAP = "basement_fixed.map.yaml"
CONFIG5_MAPS = ["map_1753950572.yaml", "icra_2_clean.yaml", "first_map.yaml",
                "new_map1.yaml"]
GOLDEN_TRACE = "traces/config1_map_1753950572.npz"


def log(msg: str) -> None:
    print(msg, flush=True)


def beams_of(num_beams: int) -> np.ndarray:
    """A 270-degree scan of ``num_beams`` beams (the bench's geometry)."""
    inc = 1.5 * np.pi / max(num_beams - 1, 1)
    return (-0.75 * np.pi + np.arange(num_beams) * inc).astype(np.float32)


def free_pose(gm, heading: float = 0.3) -> np.ndarray:
    """The free cell nearest the centroid of free space, at its center."""
    free = np.asarray(gm.free_cells[: int(gm.num_free)])
    row, col = free.mean(axis=0)
    i = np.argmin((free[:, 0] - row) ** 2 + (free[:, 1] - col) ** 2)
    return np.array([(free[i, 1] + 0.5) * gm.resolution + float(gm.origin_x),
                     (free[i, 0] + 0.5) * gm.resolution + float(gm.origin_y),
                     heading], np.float32)


def oracle_scan(gm, pose, beams) -> np.ndarray:
    """The scan a perfect lidar at ``pose`` sees (reference-exact DDA)."""
    import jax.numpy as jnp

    from monte_carlo_localization_tpu.ops.raycast import cast_rays_dda

    q = np.stack([np.full(len(beams), pose[0]), np.full(len(beams), pose[1]),
                  pose[2] + beams], 1).astype(np.float32)
    return np.asarray(cast_rays_dda(gm, jnp.asarray(q)))


def load(name: str, max_range: float = 12.0):
    from monte_carlo_localization_tpu.mapping import load_map

    return load_map(MAPS / name, max_range_meters=max_range)


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


# ---- phases ----------------------------------------------------------------

def phase_device() -> dict:
    import jax

    from monte_carlo_localization_tpu import native
    from monte_carlo_localization_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from monte_carlo_localization_tpu.utils.platform import (
        card_name_and_power_limit,
    )

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    return dict(
        card=card_name_and_power_limit(), jax=jax.__version__,
        platform=dev.platform, device_kind=dev.device_kind,
        device_count=len(jax.devices()),
        xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=str(cache),
        lut_builder="native (g++)" if native.available() else "numpy",
    )


def check_likelihood(pf, beams, num_particles=1024, seed=0) -> dict:
    """The filter's ``lut_pallas`` query, compiled for the card, against a
    numpy evaluation of the same sum on the host (exact ``math.erf``).
    A quarter of the particles sit in the cells whose LUT rows come last
    (past 2^31 entries on a multi-GB LUT), some outside the map; headings
    span two turns (window wrap-around). Per particle |d| <= 1e-4 |ref| +
    1e-3 (f32 sums over <= 1080 beams in another order), same argmax."""
    import math

    import jax
    import jax.numpy as jnp

    from monte_carlo_localization_tpu.ops.pallas_lut import beam_lanes

    gm, sensor = pf.grid_map, pf.sensor
    stride = gm.lut_row_stride or gm.lut_theta_bins
    lut2d = gm.range_lut.reshape(-1, stride)
    h, w, res = gm.height, gm.width, gm.resolution
    ox, oy = np.float32(gm.origin_x), np.float32(gm.origin_y)
    rng = np.random.default_rng(seed)
    n_last = num_particles // 4
    if gm.lut_row_map is not None:
        row_of_cell = np.asarray(gm.lut_row_map)
        last = np.argsort(row_of_cell, kind="stable")[-n_last:]
    else:
        row_of_cell = None
        last = np.arange(h * w - n_last, h * w)
    cy, cx = np.divmod(last, w)
    n_rand = num_particles - n_last
    x = np.concatenate([(cx + 0.5) * res + ox,
                        rng.uniform(ox - 5.0, ox + w * res + 5.0, n_rand)])
    y = np.concatenate([(cy + 0.5) * res + oy,
                        rng.uniform(oy - 5.0, oy + h * res + 5.0, n_rand)])
    theta = rng.uniform(-2 * np.pi, 2 * np.pi, num_particles)
    parts = np.stack([x, y, theta], 1).astype(np.float32)
    m = sensor.max_range_px
    obs = rng.integers(0, m + 1, len(beams)).astype(np.float32)
    query = jax.jit(lambda lut, rm, p, o: pf._pallas_query(
        lut, p, o, row_map=rm))
    got = np.asarray(query(gm.range_lut, gm.lut_row_map, jnp.asarray(parts),
                           jnp.asarray(obs)))

    # host twin: numpy addressing, rows fetched from the card, f64 model
    t = gm.lut_theta_bins
    base, q = beam_lanes(beams, t)
    gx = ((parts[:, 0] - ox) / np.float32(res)).astype(np.int32)
    gy = ((parts[:, 1] - oy) / np.float32(res)).astype(np.int32)
    oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
    cell = np.clip(gy, 0, h - 1) * w + np.clip(gx, 0, w - 1)
    row = cell if row_of_cell is None else row_of_cell[cell]
    b0 = np.round(parts[:, 2] * np.float32(t / (2 * math.pi)))
    b0 = (b0.astype(np.int64) + base) % t
    rows, inv = np.unique(row, return_inverse=True)
    fetched = np.asarray(jnp.take(lut2d, jnp.asarray(rows), axis=0))
    d = np.minimum(fetched[inv[:, None], b0[:, None] + q[None, :]]
                   .astype(np.float64), m)
    r = obs.astype(np.float64)[None, :]
    sig = sensor.sigma_hit
    p = sensor.z_hit / (sig * math.sqrt(2 * math.pi)) * np.exp(
        -((r - d) ** 2) / (2 * sig * sig))
    p += np.where(r < d, 2 * sensor.z_short * (d - r) / np.maximum(d, 1.0), 0)
    p += np.where(r >= m, sensor.z_max, 0.0) + np.where(
        r < m, sensor.z_rand / m, 0.0)
    erf = np.vectorize(math.erf)
    sq2 = math.sqrt(2.0) * sig
    norm = (sensor.z_hit * 0.5 * (erf((m - d + 0.5) / sq2)
                                  - erf((-d - 0.5) / sq2))
            + np.where(d > 0, sensor.z_short * (d + 1.0), 0.0)
            + sensor.z_max + sensor.z_rand)
    logp = np.log(np.maximum(p, 1e-35)) - np.log(norm)
    want = np.where(oob, -1e4, sensor.inv_squash_factor * logp.sum(axis=1))
    err = np.abs(got.astype(np.float64) - want)
    tol = 1e-4 * np.abs(want) + 1e-3
    if not ((err <= tol).all() and np.argmax(got) == np.argmax(want)):
        raise AssertionError(
            f"lut_pallas vs host twin: max |d| {err.max()}, "
            f"{int((err > tol).sum())} particles past tolerance")
    return dict(particles=num_particles, max_abs_err=float(err.max()),
                out_of_map=int(oob.sum()), last_row=int(row.max()),
                lut_rows=int(lut2d.shape[0]), lut_entries=int(lut2d.size))


def phase_headline(map_name=HEADLINE_MAP, num_particles=4000,
                   num_beams=1080, dispatch_steps=20, chain=50, chains=2,
                   tol_m=0.15) -> dict:
    """ParticleFilter(auto): per-dispatch steps, then chained steps, from
    a seed at the true pose with a zero-motion oracle scan."""
    import jax

    from monte_carlo_localization_tpu.config import MCLConfig
    from monte_carlo_localization_tpu.filter import ParticleFilter

    gm = load(map_name)
    beams = beams_of(num_beams)
    pose = free_pose(gm)
    scan = oracle_scan(gm, pose, beams)
    t0 = time.perf_counter()
    pf = ParticleFilter(gm, MCLConfig(max_particles=num_particles))
    pf.set_beam_angles(beams)
    setup_s = time.perf_counter() - t0
    zero = np.zeros(3, np.float32)
    state = pf.init_pose(pose, seed=1)
    (state, est), first_s = _timed(lambda: pf.step(state, zero, scan))
    t0 = time.perf_counter()
    for _ in range(dispatch_steps - 1):
        state, est = pf.step(state, zero, scan)
    jax.block_until_ready(est)
    dispatch_ms = (time.perf_counter() - t0) / (dispatch_steps - 1) * 1e3
    actions = np.zeros((chain, 3), np.float32)
    scans = np.tile(scan, (chain, 1))
    (state, poses), first_chain_s = _timed(
        lambda: pf.step_many(state, actions, scans))
    t0 = time.perf_counter()
    for _ in range(chains):
        state, poses = pf.step_many(state, actions, scans)
    jax.block_until_ready(poses)
    chained_ms = (time.perf_counter() - t0) / (chains * chain) * 1e3
    err = float(np.hypot(*(np.asarray(poses)[-1, :2] - pose[:2])))
    if not err < tol_m:
        raise AssertionError(f"headline pose error {err:.4f} m >= {tol_m}")
    mem = pf._step.lower(
        state, zero, scan, pf.beam_angles, pf.grid_map, pf.sensor
    ).compile().memory_analysis()
    likelihood = (check_likelihood(pf, beams)
                  if pf.config.raycast_method == "lut_pallas" else None)
    return dict(
        map=map_name, particles=num_particles, beams=num_beams,
        method=pf.config.raycast_method, lut_bytes=int(
            pf.grid_map.range_lut.size * pf.grid_map.range_lut.itemsize),
        setup_s=round(setup_s, 2), first_step_s=round(first_s, 2),
        first_chain_s=round(first_chain_s, 2),
        dispatch_ms_per_update=dispatch_ms, chained_ms_per_update=chained_ms,
        pose_err_m=err, peak_bytes_in_use=peak_bytes(),
        step_memory=None if mem is None else dict(
            argument_bytes=mem.argument_size_in_bytes,
            temp_bytes=mem.temp_size_in_bytes,
            output_bytes=mem.output_size_in_bytes),
        likelihood_vs_host=likelihood,
    )


def phase_long_range(map_name=CONFIG4_MAP, max_range=25.6,
                     num_particles=4000, num_beams=1080, steps=10,
                     tol_m=0.15) -> dict:
    """A long-range u16 LUT: basement_fixed at 25.6 m (row-compacted,
    past 2^31 entries), 4000 x 1080 — the likelihood against the host
    twin, then a few corrections from a seed at the true pose."""
    import jax

    from monte_carlo_localization_tpu.config import MCLConfig
    from monte_carlo_localization_tpu.filter import ParticleFilter

    gm = load(map_name, max_range=max_range)
    beams = beams_of(num_beams)
    pose = free_pose(gm)
    scan = oracle_scan(gm, pose, beams)
    t0 = time.perf_counter()
    pf = ParticleFilter(gm, MCLConfig(max_particles=num_particles))
    pf.set_beam_angles(beams)
    setup_s = time.perf_counter() - t0
    likelihood = (check_likelihood(pf, beams)
                  if pf.config.raycast_method == "lut_pallas" else None)
    state = pf.init_pose(pose, seed=2)
    actions = np.zeros((steps, 3), np.float32)
    (state, poses), first_s = _timed(
        lambda: pf.step_many(state, actions, np.tile(scan, (steps, 1))))
    err = float(np.hypot(*(np.asarray(poses)[-1, :2] - pose[:2])))
    if not err < tol_m:
        raise AssertionError(f"long-range pose error {err:.4f} m >= {tol_m}")
    lut = pf.grid_map.range_lut
    return dict(map=map_name, max_range_m=max_range,
                particles=num_particles, beams=num_beams,
                method=pf.config.raycast_method, lut_dtype=str(lut.dtype),
                lut_bytes=int(lut.size * lut.itemsize),
                setup_s=round(setup_s, 2), first_chain_s=round(first_s, 2),
                pose_err_m=err, likelihood_vs_host=likelihood,
                peak_bytes_in_use=peak_bytes())


def phase_replay(map_name=CONFIG1_MAP, trace=GOLDEN_TRACE,
                 num_particles=4000, bound_m=0.12) -> dict:
    """The golden trace through MCLNode via the CLI, chained."""
    from monte_carlo_localization_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["replay", "--map", str(MAPS / map_name),
                       "--trace", str(REPO / trace), "--particles",
                       str(num_particles), "--chained", "--init", "truth"])
    wall_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli replay returned {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    rmse = out["rmse_xy_m"]
    if rmse is None or not rmse < bound_m:
        raise AssertionError(f"golden-trace rmse_xy_m {rmse} >= {bound_m}")
    return dict(out, wall_s=round(wall_s, 2))


def phase_global(map_name=CONFIG4_MAP, num_particles=100_000, num_beams=60,
                 chain=5) -> dict:
    """Config #4: a uniform global seed over basement_fixed, a few
    chained corrections; the weights stay finite and normalized."""
    import jax

    from monte_carlo_localization_tpu.config import MCLConfig
    from monte_carlo_localization_tpu.filter import ParticleFilter

    gm = load(map_name)
    beams = beams_of(num_beams)
    scan = oracle_scan(gm, free_pose(gm), beams)
    t0 = time.perf_counter()
    pf = ParticleFilter(gm, MCLConfig(max_particles=num_particles))
    pf.set_beam_angles(beams)
    setup_s = time.perf_counter() - t0
    state = pf.init_global(seed=3)
    actions = np.zeros((chain, 3), np.float32)
    scans = np.tile(scan, (chain, 1))
    (state, poses), first_s = _timed(
        lambda: pf.step_many(state, actions, scans))
    (state, poses), steady_s = _timed(
        lambda: pf.step_many(state, actions, scans))
    w = np.asarray(jax.nn.softmax(state.log_weights))
    if not (np.isfinite(np.asarray(state.log_weights)).all()
            and np.isfinite(np.asarray(poses)).all()
            and abs(float(w.sum()) - 1.0) < 1e-3):
        raise AssertionError("config #4: non-finite or unnormalized weights")
    return dict(map=map_name, particles=num_particles, beams=num_beams,
                method=pf.config.raycast_method, setup_s=round(setup_s, 2),
                first_chain_s=round(first_s, 2),
                chained_ms_per_update=steady_s / chain * 1e3,
                weight_sum=float(w.sum()), peak_bytes_in_use=peak_bytes())


def fleet_case(maps, fleet_size, num_particles, num_beams=60, mesh=None,
               method="auto"):
    """A fleet over ``maps`` (members assigned round-robin), each member
    seeded at its map's free pose with that map's oracle scan.
    Returns (filter, poses0 (F, 3), scans (F, R))."""
    from monte_carlo_localization_tpu.config import MCLConfig
    from monte_carlo_localization_tpu.parallel import FleetFilter, stack_maps

    beams = beams_of(num_beams)
    asg = np.arange(fleet_size, dtype=np.int32) % len(maps)
    map_poses = [free_pose(m) for m in maps]
    map_scans = [oracle_scan(m, p, beams) for m, p in zip(maps, map_poses)]
    ff = FleetFilter(stack_maps(maps), fleet_size=fleet_size,
                     config=MCLConfig(max_particles=num_particles,
                                      raycast_method=method),
                     beam_angles=beams, mesh=mesh, map_assignment=asg)
    return (ff, np.stack([map_poses[a] for a in asg]),
            np.stack([map_scans[a] for a in asg]))


def phase_fleet(map_names=CONFIG5_MAPS, fleet_size=64, num_particles=4000,
                steps=5, tol_m=0.25, method="auto") -> dict:
    """Config #5: the heterogeneous 64-car fleet, a few corrections."""
    import jax

    maps = [load(n) for n in map_names]
    t0 = time.perf_counter()
    ff, poses0, scans = fleet_case(maps, fleet_size, num_particles,
                                   method=method)
    setup_s = time.perf_counter() - t0
    zero = np.zeros((fleet_size, 3), np.float32)
    state = ff.init_pose(poses0, seed=1)
    (state, est), first_s = _timed(lambda: ff.step(state, zero, scans))
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, est = ff.step(state, zero, scans)
    jax.block_until_ready(est)
    step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    err = np.linalg.norm(np.asarray(est)[:, :2] - poses0[:, :2], axis=1)
    if not (np.isfinite(err).all() and err.max() < tol_m):
        raise AssertionError(f"config #5: member error {err.max():.4f} m")
    return dict(maps=map_names, fleet=fleet_size, particles=num_particles,
                method=ff.config.raycast_method, setup_s=round(setup_s, 2),
                first_step_s=round(first_s, 2), fleet_step_ms=step_ms,
                max_member_err_m=float(err.max()),
                peak_bytes_in_use=peak_bytes())


def phase_four(num_devices=4, sharded_particles=1_000_000, fleet_size=64,
               fleet_particles=4000, map_name=CONFIG1_MAP,
               fleet_maps=CONFIG5_MAPS, tol_m=0.25, method="auto") -> dict:
    """The multi-card paths over a 1-D mesh of ``num_devices`` devices,
    each beside what it is compared with."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from monte_carlo_localization_tpu.config import MCLConfig
    from monte_carlo_localization_tpu.parallel import ShardedParticleFilter

    devices = np.array(jax.devices()[:num_devices])
    if len(devices) != num_devices:
        raise RuntimeError(f"need {num_devices} devices, have "
                           f"{len(jax.devices())}")
    out = {}
    gm = load(map_name)
    beams = beams_of(60)
    pose = free_pose(gm)
    scan = oracle_scan(gm, pose, beams)
    mesh = Mesh(devices, ("p",))
    zero = np.zeros(3, np.float32)

    # sharded cloud: bucketed vs all-gather resampling, bitwise, on a
    # crafted state whose mass sits on the last shard (fringe overflow)
    n = sharded_particles
    results = []
    for mode, fringe in (("bucketed", 1), ("allgather", 0)):
        spf = ShardedParticleFilter(
            gm, MCLConfig(max_particles=n, raycast_method=method,
                          sharded_resample=mode, sharded_fringe=fringe),
            mesh=mesh, beam_angles=beams)
        st = spf.init_global(seed=4)
        lw = np.full(n, -80.0, np.float32)
        lw[n - n // num_devices:] = 0.0
        st = dataclasses.replace(st, log_weights=jax.device_put(
            jnp.asarray(lw), st.log_weights.sharding))
        st, p = spf.step(st, zero, scan)
        results.append((np.asarray(st.particles), np.asarray(p)))
    if not ((results[0][0] == results[1][0]).all()
            and (results[0][1] == results[1][1]).all()):
        raise AssertionError("bucketed fringe-overflow fallback diverged "
                             "from the all-gather filter")
    out["sharded_overflow_bitwise"] = True

    # sharded cloud: global localization converges
    spf = ShardedParticleFilter(
        gm, MCLConfig(max_particles=n, raycast_method=method), mesh=mesh,
        beam_angles=beams)
    st = spf.init_global(seed=5)
    actions = np.zeros((10, 3), np.float32)
    scans = np.tile(scan, (10, 1))
    (st, poses), first_s = _timed(lambda: spf.step_many(st, actions, scans))
    (st, poses), steady_s = _timed(lambda: spf.step_many(st, actions, scans))
    err = float(np.hypot(*(np.asarray(poses)[-1, :2] - pose[:2])))
    w_sum = float(np.asarray(st.weights()).sum())
    out.update(sharded_particles=n, sharded_method=spf.config.raycast_method,
               sharded_pose_err_m=err, sharded_weight_sum=w_sum,
               sharded_first_chain_s=round(first_s, 2),
               sharded_chained_ms_per_update=steady_s / 10 * 1e3)
    log("sharded: " + json.dumps(out))
    if not (err < tol_m and abs(w_sum - 1.0) < 1e-3):
        raise AssertionError(f"sharded {n}: pose error {err:.4f} m, "
                             f"weight sum {w_sum}")

    # fleet over a 1-D fleet mesh against the same fleet on one card. The
    # two programs may round the motion update differently by an ulp,
    # which moves a rare particle across a cell or bin edge (and its
    # log-weight by several units), so the bound is on the share of
    # particles within tolerance, beside the poses
    maps = [load(m) for m in fleet_maps]
    res = {}
    for name, fmesh in (("mesh", Mesh(devices, ("fleet",))), ("one", None)):
        ff, poses0, fscans = fleet_case(maps, fleet_size, fleet_particles,
                                        mesh=fmesh, method=method)
        fz = np.zeros((fleet_size, 3), np.float32)
        fst = ff.init_pose(poses0, seed=1)
        for _ in range(3):
            fst, est = ff.step(fst, fz, fscans)
        res[name] = (np.asarray(fst.particles), np.asarray(fst.log_weights),
                     np.asarray(est))
    (p_m, lw_m, est_m), (p_1, lw_1, est_1) = res["mesh"], res["one"]
    within = np.abs(lw_m - lw_1) <= 1e-4 * np.abs(lw_1) + 1e-3
    pose_err = float(np.abs(est_m - est_1).max())
    member_err = np.linalg.norm(est_m[:, :2] - poses0[:, :2], axis=1)
    fleet = dict(fleet=fleet_size, fleet_identical_particles=float(
        (p_m == p_1).all(axis=-1).mean()),
        fleet_logw_within_tol=float(within.mean()),
        fleet_mesh_vs_one_pose_err=pose_err,
        fleet_max_member_err_m=float(member_err.max()))
    log("fleet mesh vs one card: " + json.dumps(fleet))
    if not (within.mean() >= 0.99 and pose_err < 1e-3
            and member_err.max() < tol_m):
        raise AssertionError(f"fleet mesh vs one card disagree: {fleet}")
    out.update(fleet)
    return out


def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception as e:  # report every phase, then fail the run
            import traceback

            traceback.print_exc()
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s:"
                f" {type(e).__name__}: {e}")
            ok = False
            continue
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
            + json.dumps(res, default=str))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh paths")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    device = phase_device()
    log(f"card: {device['card']}")
    log("phase device: " + json.dumps(device))
    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [("headline", phase_headline),
                  ("long_range", phase_long_range), ("replay", phase_replay),
                  ("config4", phase_global), ("config5", phase_fleet)]
    if not run_phases(phases):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
