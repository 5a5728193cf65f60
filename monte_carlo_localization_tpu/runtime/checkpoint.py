"""Filter state checkpoint / resume — single filter, fleet, and sharded.

The reference keeps all state in memory and loses it on restart
(SURVEY.md §5: "Checkpoint / resume: None") — re-localization requires a
manual global or RViz re-init. This engine adds a small npz-based
checkpoint: particles, log-weights, RNG key state, iteration counter and
the host tracker anchors, so a node can resume tracking exactly where it
stopped.

Three state families round-trip:

* :func:`save_state` / :func:`load_state` — the single-filter ``MCLState``
  (+ host tracker anchors). ``load_state(place=...)`` re-places the
  restored arrays onto a mesh, so a ``ShardedParticleFilter`` resumes
  with its particle-axis sharding intact
  (``load_state(p, place=spf.place_state)``).
* :func:`save_fleet_state` / :func:`load_fleet_state` — the batched
  ``FleetState`` (one checkpoint for the whole fleet, per-member RNG
  keys included); ``load_fleet_state(p, fleet=ff)`` re-places onto the
  fleet's mesh/shardings via ``FleetFilter._place``.

Checkpoints are host npz files (``np.asarray`` gathers sharded leaves),
so a checkpoint written on an 8-chip mesh restores onto any mesh shape —
the placement callback owns the re-sharding.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.filter.core import MCLState

_VERSION = 1
_FLEET_VERSION = 1


def save_state(
    path: str | Path,
    state: MCLState,
    *,
    iters: int = 0,
    inferred_pose: np.ndarray | None = None,
    tracker=None,
    extra: dict | None = None,
) -> None:
    """Write a filter checkpoint (atomic replace)."""
    path = Path(path)
    arrays = dict(
        version=np.asarray(_VERSION),
        particles=np.asarray(state.particles),
        log_weights=np.asarray(state.log_weights),
        key_data=np.asarray(jax.random.key_data(state.key)),
        log_quality=np.asarray(state.log_quality),
        iters=np.asarray(iters),
    )
    if inferred_pose is not None:
        arrays["inferred_pose"] = np.asarray(inferred_pose)
    if tracker is not None:
        snap = tracker.snapshot()
        arrays["tracker_active"] = np.asarray(tracker.active)
        arrays["tracker_reference_pose"] = np.asarray(tracker._reference_pose)
        arrays["tracker_reference_odom"] = np.asarray(tracker._reference_odom)
        arrays["tracker_velocity"] = np.asarray(snap.velocity)
        arrays["tracker_angular_velocity"] = np.asarray(snap.angular_velocity)
        arrays["tracker_from_seed"] = np.asarray(
            tracker.pose_initialized_from_seed
        )
        arrays["tracker_ref_odom_pending"] = np.asarray(
            tracker._reference_odom_pending
        )
        if snap.pose is not None:
            arrays["tracker_pose"] = snap.pose
        if snap.last_odom_pose is not None:
            arrays["tracker_last_odom"] = snap.last_odom_pose
        if snap.last_stamp is not None:
            arrays["tracker_last_stamp"] = np.asarray(snap.last_stamp)
    if extra:
        for k, v in extra.items():
            arrays[f"extra_{k}"] = np.asarray(v)
    tmp = path.with_name(path.name + ".tmp")
    np.savez_compressed(tmp, **arrays)
    tmp_actual = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    tmp_actual.replace(path)


def load_state(path: str | Path, tracker=None, place=None):
    """Read a checkpoint -> (MCLState, meta dict). Restores the tracker
    anchors in place when one is passed. ``place`` (optional callable
    ``MCLState -> MCLState``) re-places the restored arrays — pass
    ``ShardedParticleFilter.place_state`` to resume a sharded filter with
    its mesh sharding intact."""
    z = np.load(Path(path), allow_pickle=False)
    if int(z["version"]) != _VERSION:
        raise ValueError(f"Unsupported checkpoint version {int(z['version'])}")
    key = jax.random.wrap_key_data(jnp.asarray(z["key_data"]))
    state = MCLState(
        particles=jnp.asarray(z["particles"]),
        log_weights=jnp.asarray(z["log_weights"]),
        key=key,
        log_quality=(
            jnp.asarray(z["log_quality"], dtype=jnp.float32)
            if "log_quality" in z
            else jnp.float32(0.0)
        ),
    )
    meta = {"iters": int(z["iters"])}
    if "inferred_pose" in z:
        meta["inferred_pose"] = z["inferred_pose"]
    if tracker is not None and "tracker_active" in z:
        with tracker._lock:
            tracker.active = bool(z["tracker_active"])
            tracker._reference_pose = z["tracker_reference_pose"].copy()
            tracker._reference_odom = z["tracker_reference_odom"].copy()
            if "tracker_velocity" in z:
                tracker.velocity = float(z["tracker_velocity"])
                tracker.angular_velocity = float(z["tracker_angular_velocity"])
            if "tracker_from_seed" in z:
                tracker.pose_initialized_from_seed = bool(z["tracker_from_seed"])
            if "tracker_ref_odom_pending" in z:
                tracker._reference_odom_pending = bool(
                    z["tracker_ref_odom_pending"]
                )
            elif tracker.active and "tracker_last_odom" not in z:
                # older checkpoint anchored before any odometry: rebase the
                # delta at the first post-resume message
                tracker._reference_odom_pending = True
            if "tracker_pose" in z:
                tracker._odom_pose = z["tracker_pose"].copy()
            if "tracker_last_odom" in z:
                tracker._last_odom_pose = z["tracker_last_odom"].copy()
            if "tracker_last_stamp" in z:
                tracker._last_stamp = float(z["tracker_last_stamp"])
    extra = {
        k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
    }
    if extra:
        meta["extra"] = extra
    if place is not None:
        state = place(state)
    return state, meta


def save_fleet_state(
    path: str | Path,
    state,
    *,
    iters: int = 0,
    poses: np.ndarray | None = None,
    extra: dict | None = None,
) -> None:
    """Write a FleetState checkpoint (atomic replace).

    ``state`` is a ``parallel.fleet.FleetState`` — mesh-sharded leaves
    gather to host via ``np.asarray``, so one file captures the whole
    fleet regardless of how it was sharded. ``poses`` optionally records
    the latest (F, 3) pose table.
    """
    path = Path(path)
    arrays = dict(
        fleet_version=np.asarray(_FLEET_VERSION),
        particles=np.asarray(state.particles),
        log_weights=np.asarray(state.log_weights),
        keys_data=np.asarray(jax.random.key_data(state.keys)),
        iters=np.asarray(iters),
    )
    if poses is not None:
        arrays["poses"] = np.asarray(poses)
    if extra:
        for k, v in extra.items():
            arrays[f"extra_{k}"] = np.asarray(v)
    tmp = path.with_name(path.name + ".tmp")
    np.savez_compressed(tmp, **arrays)
    tmp_actual = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    tmp_actual.replace(path)


def load_fleet_state(path: str | Path, fleet=None):
    """Read a fleet checkpoint -> (FleetState, meta dict).

    With ``fleet`` (a ``FleetFilter``) the restored state is re-placed
    onto the fleet's mesh/shardings (``FleetFilter._place``) — a
    checkpoint written on one mesh restores onto another, including the
    multi-host fleet (each process materializes its addressable shards).
    """
    from monte_carlo_localization_tpu.parallel.fleet import FleetState

    z = np.load(Path(path), allow_pickle=False)
    if "fleet_version" not in z:
        raise ValueError(
            f"{path} is not a fleet checkpoint (single-filter checkpoints "
            "load with load_state)"
        )
    if int(z["fleet_version"]) != _FLEET_VERSION:
        raise ValueError(
            f"Unsupported fleet checkpoint version {int(z['fleet_version'])}"
        )
    state = FleetState(
        particles=jnp.asarray(z["particles"]),
        log_weights=jnp.asarray(z["log_weights"]),
        keys=jax.random.wrap_key_data(jnp.asarray(z["keys_data"])),
    )
    if fleet is not None:
        if state.fleet_size != fleet.fleet_size:
            raise ValueError(
                f"checkpoint holds {state.fleet_size} members, fleet has "
                f"{fleet.fleet_size}"
            )
        state = fleet._place(state)
    meta = {"iters": int(z["iters"])}
    if "poses" in z:
        meta["poses"] = z["poses"]
    extra = {
        k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
    }
    if extra:
        meta["extra"] = extra
    return state, meta
