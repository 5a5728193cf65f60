"""Minimal end-to-end example: global localization on a real reference map.

Run from the repo root (or after `pip install -e .`):

    python examples/localize_on_map.py                 # GPU if available
    JAX_PLATFORM_NAME=cpu python examples/localize_on_map.py

Loads the recorded real-sensor SLAM map the reference ships, synthesizes a
perfect 60-beam scan at a known pose with the DDA oracle, seeds 4000
particles uniformly over free space, and runs fused MCL corrections until
the cloud converges on the true pose.
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

from monte_carlo_localization_tpu import MCLConfig, ParticleFilter
from monte_carlo_localization_tpu.mapping import load_map
from monte_carlo_localization_tpu.ops.raycast import cast_rays_dda

gm = load_map(REPO / "maps" / "map_1753950572.yaml")
print(f"map {gm.name}: {gm.height}x{gm.width} @ {gm.resolution} m/px")

pf = ParticleFilter(gm, MCLConfig(max_particles=4000, raycast_method="lut"))
beams = np.linspace(-2.35, 2.35, 60).astype(np.float32)
pf.set_beam_angles(beams)

# pick a well-cleared free cell as the true pose
free = np.asarray(gm.free_cells[: int(gm.num_free)])
clear = np.asarray(gm.clearance)[free[:, 0], free[:, 1]]
cell = free[np.argmax(clear)]
true_pose = np.array(
    [
        cell[1] * gm.resolution + float(gm.origin_x),
        cell[0] * gm.resolution + float(gm.origin_y),
        0.3,
    ],
    np.float32,
)
q = np.stack(
    [np.full(60, true_pose[0]), np.full(60, true_pose[1]), true_pose[2] + beams],
    axis=1,
)
scan = np.asarray(cast_rays_dda(gm, jnp.asarray(q)))

state = pf.init_global(seed=0)
for i in range(30):
    state, pose = pf.step(state, np.zeros(3), scan)
    if i % 5 == 4:
        p = np.asarray(pose)
        err = np.linalg.norm(p[:2] - true_pose[:2])
        print(f"iter {i + 1:2d}: pose=({p[0]:.3f}, {p[1]:.3f}, {p[2]:.3f}) "
              f"err={err * 100:.1f} cm")

err = np.linalg.norm(np.asarray(pose)[:2] - true_pose[:2])
assert err < 0.15, f"did not converge: {err} m"
print("converged OK")
