"""Fleet localization example: 16 cars on the sibal1 circuit at once.

The reference is one ROS node per car; here a whole fleet is ONE vmapped
MCL step (SURVEY.md §2.1 "multi-instance parallelism"), and on the
`lut_pallas` backend the fleet likelihood runs as fused Pallas kernel
launches over the flattened particle batch — per-member scans are routed
to each particle block by the kernel's BlockSpec index map.

Run from the repo root:

    python examples/fleet_racing.py                 # GPU if available
    JAX_PLATFORM_NAME=cpu python examples/fleet_racing.py
"""

import os
import sys
from pathlib import Path

import numpy as np

if os.environ.get("JAX_PLATFORM_NAME") == "cpu":
    # make the documented CPU prefix binding: merely changing the default
    # backend still initializes every plugin, and an unreachable
    # accelerator plugin hangs the process during discovery
    import jax

    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # allow running without pip install -e .
    sys.path.insert(0, str(REPO))

from monte_carlo_localization_tpu import MCLConfig
from monte_carlo_localization_tpu.mapping import load_map
from monte_carlo_localization_tpu.ops.raycast import cast_rays_dda
from monte_carlo_localization_tpu.parallel import FleetFilter

FLEET = 16
BEAMS = 60
PARTICLES = 1000

gm = load_map(REPO / "maps" / "sibal1.yaml")
print(f"map {gm.name}: {gm.height}x{gm.width} @ {gm.resolution} m/px")

beams = np.linspace(-2.35, 2.35, BEAMS).astype(np.float32)
ff = FleetFilter(
    gm,
    fleet_size=FLEET,
    config=MCLConfig(max_particles=PARTICLES, raycast_method="lut_pallas"),
    beam_angles=beams,
)

# spread the cars over the FLEET most-cleared free cells (grid stride)
free = np.asarray(gm.free_cells[: int(gm.num_free)])
clear = np.asarray(gm.clearance)[free[:, 0], free[:, 1]]
order = np.argsort(clear)[::-1]
cells = free[order[:: max(1, len(order) // FLEET)][:FLEET]]
true_poses = np.stack(
    [
        cells[:, 1] * gm.resolution + float(gm.origin_x),
        cells[:, 0] * gm.resolution + float(gm.origin_y),
        np.linspace(0, 2 * np.pi, FLEET, endpoint=False),
    ],
    axis=1,
).astype(np.float32)

# each car sees its own perfect scan at its own pose (DDA oracle)
queries = np.concatenate(
    [
        np.stack(
            [np.full(BEAMS, p[0]), np.full(BEAMS, p[1]), p[2] + beams], axis=1
        )
        for p in true_poses
    ]
)
scans = np.asarray(cast_rays_dda(gm, jnp.asarray(queries))).reshape(FLEET, BEAMS)

# every car starts with a loose cloud around a noisy guess
rng = np.random.default_rng(0)
guesses = true_poses + rng.normal(0, [0.3, 0.3, 0.2], true_poses.shape).astype(
    np.float32
)
state = ff.init_pose(guesses, seed=1)

actions = np.zeros((FLEET, 3), np.float32)
for i in range(15):
    state, poses = ff.step(state, actions, scans)

poses = np.asarray(poses)
err = np.linalg.norm(poses[:, :2] - true_poses[:, :2], axis=1)
print(f"after 15 corrections: mean err {err.mean():.3f} m, "
      f"max {err.max():.3f} m over {FLEET} cars")
assert err.max() < 0.3, "a car failed to localize"
print("fleet OK")
