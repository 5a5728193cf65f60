"""Typed configuration for the MCL engine.

Accepts the reference's ``mcl_config.yaml`` schema verbatim — including the
ROS2 ``particle_filter: ros__parameters:`` nesting and the vestigial keys the
reference node never reads (``range_method``, ``theta_discretization``,
``rangelib_variant``, ``fine_timing``, frame names; see
reference config/mcl_config.yaml:34-36,53-58).

Parameter names, defaults and semantics mirror the reference's declarations
(reference src/particle_filter.cpp:23-47).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

# Keys the reference YAML carries but the node never declares/reads
# (reference config/mcl_config.yaml:13,34-36,53-58). We accept and ignore them.
VESTIGIAL_KEYS = frozenset(
    {
        "range_method",
        "theta_discretization",
        "rangelib_variant",
        "fine_timing",
        "map_frame",
        "base_frame",
        "laser_frame",
        "sim_mode",
    }
)


@dataclass(frozen=True)
class MCLConfig:
    """All engine parameters. Defaults match reference src/particle_filter.cpp:23-47."""

    # --- core ---
    angle_step: int = 18  # lidar downsample stride
    max_particles: int = 2000
    max_viz_particles: int = 60
    squash_factor: float = 2.2  # likelihood ^= 1/squash_factor
    max_range: float = 12.0  # meters
    max_pose_range: float = 10000.0  # |x|,|y| bound for pose validity
    delay_compensation_factor: float = 1.5

    # --- sensor model (4-component beam model) ---
    z_hit: float = 0.80
    z_short: float = 0.01
    z_max: float = 0.07
    z_rand: float = 0.12
    sigma_hit: float = 8.0  # in PIXELS (the reference LUT is in px units)

    # --- motion model noise (std-dev, per step) ---
    motion_dispersion_x: float = 0.05
    motion_dispersion_y: float = 0.025
    motion_dispersion_theta: float = 0.25

    # --- robot geometry ---
    lidar_offset_x: float = 0.0
    lidar_offset_y: float = 0.0
    wheelbase: float = 0.325  # declared but unused in propagation, as in reference

    # --- runtime / io ---
    scan_topic: str = "/scan"
    odom_topic: str = "/odom"
    publish_odom: bool = True
    viz: bool = True
    timer_frequency: float = 100.0  # Hz of the host update loop

    # --- engine knobs (new) ---
    use_parallel_raycasting: bool = True  # kept for config compat; engine is always batched
    num_threads: int = 0  # used by the native host raycaster (0 = auto)
    # "auto" (default: resolved per platform by resolve_raycast_method) |
    # "lut_pallas" (fused LUT likelihood over row-padded LUT windows —
    # ops/pallas_lut.py; serves every fleet LUT layout) | "lut"
    # (precomputed, one gather/query) | "sphere" (EDT marching, no
    # precompute) | "dda" (reference-exact oracle).
    raycast_method: str = "auto"
    sphere_march_iters: int = 48  # fixed sphere-marching trip count
    lut_theta_bins: int = 1440  # angle quantization of the "lut" backend (0.25 deg)
    sensor_model_mode: str = "analytic"  # "analytic" (gather-free) | "table" (reference LUT)
    # distributed resampling of ShardedParticleFilter: "bucketed" (default
    # — covered ancestor rows cross shards through fringe ppermutes + a
    # tiny seed psum, O(fringe + D) bytes/step between devices; falls back to the
    # all-gather path via lax.cond if a source lands beyond the fringe) |
    # "allgather" (compat: full N x 3 particle + N-CDF all_gather, O(N)
    # bytes — the SURVEY §7 hard-part-6 anti-pattern, kept as the
    # fallback/bitwise-reference path).
    sharded_resample: str = "bucketed"
    # fringe capacity (slots per side) of the bucketed exchange; 0 = auto
    # (max(64, n_local // 8)). Larger fringes tolerate more cross-shard
    # weight imbalance before the all-gather fallback fires, at O(fringe)
    # extra bytes between devices.
    sharded_fringe: int = 0
    resample_method: str = "systematic"  # "systematic" | "multinomial" (reference compat)
    exact_dt_heuristic: bool = True  # reproduce reference dt reconstruction (:452-471)
    # pipeline live corrections: dispatch without blocking, harvest poses
    # as the device finishes them (the anchor refresh is then a few
    # dispatches stale — the staleness delay compensation already models).
    # Decouples the correction rate from the device->host round trip;
    # replay()/replay_chained() ignore it.
    async_correction: bool = False
    # max corrections in flight before the harvest blocks (not yet
    # measured on a GPU; ROADMAP speed item 6 re-picks it)
    async_depth: int = 4
    # micro-chunked live corrections (async path only): buffer K ticks of
    # (action, scan) and dispatch them as ONE step_many(K) — the per-
    # dispatch host->device overhead then amortizes over K corrections,
    # trading <= K-1 ticks of extra pose latency (the anchor's staleness
    # compensation measures and corrects the delay exactly). 1 = off.
    live_chunk: int = 1
    # lax.scan unroll factor for the step_many chains. Earlier hardware
    # measured unrolling neutral (PERF.md); default 1, since unrolling
    # multiplies compile time.
    scan_unroll: int = 1
    dtype: str = "float32"
    seed: int = 0

    # --- automatic re-localization (new; the reference's README describes
    # convergence-based auto-init aspirationally but ships no detector —
    # kidnapped-robot recovery there is human-triggered via /clicked_point).
    # Augmented-MCL style monitor (Probabilistic Robotics §8.3): short- and
    # long-horizon EMAs of the per-correction measurement quality; a
    # sustained collapse of fast/slow triggers a global re-init.
    # Default OFF — measured decision (BENCHES.md kidnap table, 2026-08-20):
    # reference parity (recovery there is operator-triggered), and in
    # symmetric corridors a triggered re-init can abandon a CORRECT lock.
    # Flip ON for unattended operation: closed-loop recovery measured at
    # 10/15 kidnaps, median 12.5 updates, zero false positives with these
    # thresholds. ---
    auto_reinit: bool = False
    # recovery action once the monitor fires: "reinit" = full global
    # re-initialization (all-or-nothing — measured 10/15 kidnap recovery
    # but 2/15 re-locks into a mirrored mode it can never escape and false
    # alarms abandon a CORRECT track); "inject" = true Augmented MCL
    # (Probabilistic Robotics §8.3): replace a max(0, 1 - w_fast/w_slow)
    # fraction of particles with uniform free-space draws EACH correction
    # — preserves the current track on false alarms and continuously seeds
    # escape hypotheses in symmetric environments (the mirrored-mode
    # class full re-init cannot fix). See BENCHES.md kidnap table.
    reinit_mode: str = "reinit"
    reinit_alpha_slow: float = 0.05  # long-horizon EMA rate (w_slow)
    reinit_alpha_fast: float = 0.40  # short-horizon EMA rate (w_fast)
    reinit_ratio_threshold: float = 0.25  # trigger when w_fast/w_slow stays below
    reinit_patience: int = 10  # consecutive bad corrections before re-init
    reinit_min_iters: int = 30  # corrections before the monitor arms
    reinit_cooldown: int = 50  # corrections to hold off after a re-init
    # "inject" mode: fraction = clip(gain * (1 - w_fast/w_slow), 0, max).
    # The cap keeps a sudden quality collapse from wiping the whole
    # posterior in one step (recovery needs a few corrections of evidence
    # accumulation either way); the gain scales the textbook fraction.
    reinit_inject_max: float = 0.3
    reinit_inject_gain: float = 1.0

    # --- map (from the map_server section / launch arg) ---
    map_name: str = "sibal1"
    map_dir: str = ""

    @property
    def inv_squash_factor(self) -> float:
        return 1.0 / self.squash_factor

    def max_range_px(self, resolution: float) -> int:
        """MAX_RANGE_PX = max_range / map_resolution (reference :195)."""
        return int(self.max_range / resolution)

    def replace(self, **kw: Any) -> "MCLConfig":
        return dataclasses.replace(self, **kw)


def resolve_raycast_method(method: str, backend: str | None = None) -> str:
    """Resolve ``"auto"`` to the likelihood path for the platform.

    ``cpu``: the XLA ``"lut"`` path. ``gpu``: ``"lut_pallas"``, the fused
    row-window LUT likelihood, which serves every fleet LUT layout
    (PERF.md records how it was chosen on an H100). Any other platform
    raises
    (``utils.platform.backend_platform``). Explicit methods pass through
    unchanged. The engine falls back from an auto-selected ``lut_pallas``
    to ``"lut"`` only on an unsupported beam geometry (see
    ``ParticleFilter._rebuild_step``)."""
    if method != "auto":
        return method
    from monte_carlo_localization_tpu.utils.platform import on_accelerator

    return "lut_pallas" if on_accelerator(backend) else "lut"


_FIELD_NAMES = {f.name for f in dataclasses.fields(MCLConfig)}

# Keys in the engine that don't exist in the reference YAML get engine defaults;
# reference YAML keys that have no engine field must be vestigial or error.
_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(MCLConfig) if f.type in ("bool", bool)
}


def _coerce(name: str, value: Any) -> Any:
    """Coerce YAML scalars to the dataclass field types."""
    for f in dataclasses.fields(MCLConfig):
        if f.name != name:
            continue
        ftype = f.type if isinstance(f.type, str) else f.type.__name__
        if ftype == "int":
            return int(value)
        if ftype == "float":
            return float(value)
        if ftype == "bool":
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            return bool(value)
        if ftype == "str":
            return str(value)
    return value


def config_from_dict(params: Mapping[str, Any], strict: bool = False) -> MCLConfig:
    """Build an :class:`MCLConfig` from a flat parameter mapping.

    Unknown keys are tolerated like the reference node tolerates vestigial
    YAML keys; with ``strict=True``, unknown non-vestigial keys raise.
    """
    kw: dict[str, Any] = {}
    for key, value in params.items():
        if key in _FIELD_NAMES:
            kw[key] = _coerce(key, value)
        elif key in VESTIGIAL_KEYS:
            continue
        elif strict:
            raise KeyError(f"Unknown MCL config key: {key!r}")
    return MCLConfig(**kw)


def load_config(path: str | Path, strict: bool = False) -> MCLConfig:
    """Load a config YAML in the reference's schema.

    Handles both the nested ROS2 layout::

        particle_filter:
          ros__parameters:
            max_particles: 2000
            ...
        map_server:
          ros__parameters:
            map: 'sibal1'

    and a flat ``key: value`` layout. Needs PyYAML (the ``config`` extra).
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    params: dict[str, Any] = {}
    if "particle_filter" in raw and isinstance(raw["particle_filter"], dict):
        params.update(raw["particle_filter"].get("ros__parameters", {}) or {})
    else:
        params.update({k: v for k, v in raw.items() if k not in ("map_server",)})

    map_section = raw.get("map_server", {})
    if isinstance(map_section, dict):
        ros_params = map_section.get("ros__parameters", map_section)
        if isinstance(ros_params, dict) and "map" in ros_params:
            params["map_name"] = ros_params["map"]

    return config_from_dict(params, strict=strict)
