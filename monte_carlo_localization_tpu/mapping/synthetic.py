"""Synthetic test worlds.

The reference validates only against shipped map assets (reference maps/);
this engine additionally generates parametric worlds so tests and
benchmarks are self-contained and oracle-checkable.
"""

from __future__ import annotations

import numpy as np

from monte_carlo_localization_tpu.mapping.grid_map import (
    GridMap,
    OCC_FREE,
    OCC_OCCUPIED,
    map_from_occupancy,
)


def box_world(
    height: int = 200,
    width: int = 300,
    wall: int = 3,
    resolution: float = 0.05,
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_range_meters: float = 12.0,
) -> GridMap:
    """Empty rectangular room with solid walls."""
    occ = np.full((height, width), OCC_FREE, dtype=np.int8)
    occ[:wall, :] = OCC_OCCUPIED
    occ[-wall:, :] = OCC_OCCUPIED
    occ[:, :wall] = OCC_OCCUPIED
    occ[:, -wall:] = OCC_OCCUPIED
    return map_from_occupancy(
        occ, resolution, origin, max_range_meters, name="box_world"
    )


def corridor_world(
    height: int = 120,
    width: int = 600,
    corridor_half_width: int = 20,
    resolution: float = 0.05,
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_range_meters: float = 12.0,
) -> GridMap:
    """Long corridor — the degenerate geometry for longitudinal localization."""
    occ = np.full((height, width), OCC_OCCUPIED, dtype=np.int8)
    mid = height // 2
    occ[mid - corridor_half_width : mid + corridor_half_width, 2:-2] = OCC_FREE
    return map_from_occupancy(
        occ, resolution, origin, max_range_meters, name="corridor_world"
    )


def random_obstacle_world(
    height: int = 400,
    width: int = 400,
    num_obstacles: int = 40,
    obstacle_size: int = 12,
    resolution: float = 0.05,
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_range_meters: float = 12.0,
    seed: int = 0,
) -> GridMap:
    """Walled room with random rectangular obstacles (rich range structure)."""
    rng = np.random.default_rng(seed)
    occ = np.full((height, width), OCC_FREE, dtype=np.int8)
    occ[:3, :] = OCC_OCCUPIED
    occ[-3:, :] = OCC_OCCUPIED
    occ[:, :3] = OCC_OCCUPIED
    occ[:, -3:] = OCC_OCCUPIED
    for _ in range(num_obstacles):
        h = int(rng.integers(3, obstacle_size))
        w = int(rng.integers(3, obstacle_size))
        r = int(rng.integers(10, height - 10 - h))
        c = int(rng.integers(10, width - 10 - w))
        occ[r : r + h, c : c + w] = OCC_OCCUPIED
    return map_from_occupancy(
        occ, resolution, origin, max_range_meters, name="random_obstacle_world",
    )
