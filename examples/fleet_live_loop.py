"""Fleet ROBOT-LOOP example: 8 cars with per-member dual-rate tracking.

`examples/fleet_racing.py` drives the raw FleetFilter step API; this
example runs the full robot loop instead — `runtime.FleetNode` carries
one odometry tracker per member (the reference's 100-200 Hz anchor+delta
dead reckoner, per car), per-member scan ingest, and one fused fleet
correction per tick, all scheduled by the unchanged `LiveRunner` wall
timer. An odometry pump thread feeds every member at high rate while the
loop ticks, exactly the dual-rate split a deployment would run.

Run from the repo root:

    python examples/fleet_live_loop.py                  # GPU if available
    JAX_PLATFORM_NAME=cpu python examples/fleet_live_loop.py
"""

import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

if os.environ.get("JAX_PLATFORM_NAME") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from monte_carlo_localization_tpu import MCLConfig
from monte_carlo_localization_tpu.mapping import load_map
from monte_carlo_localization_tpu.ops.raycast import cast_rays_dda
from monte_carlo_localization_tpu.runtime import (
    CallbackSink,
    FleetNode,
    LiveRunner,
)

FLEET = 8
BEAMS = 60


def main() -> int:
    gm = load_map(REPO / "maps" / "sibal1.yaml")
    beams = np.linspace(-2.35, 2.35, BEAMS).astype(np.float32)
    rng = np.random.default_rng(0)

    # true poses: spread the cars around the circuit's free space
    free = np.asarray(gm.free_cells[: int(gm.num_free)])
    picks = free[rng.choice(len(free), FLEET, replace=False)]
    poses = np.stack(
        [
            (picks[:, 1] + 0.5) * gm.resolution + float(gm.origin_x),
            (picks[:, 0] + 0.5) * gm.resolution + float(gm.origin_y),
            rng.uniform(-np.pi, np.pi, FLEET),
        ],
        axis=1,
    ).astype(np.float32)

    node = FleetNode(
        gm,
        fleet_size=FLEET,
        config=MCLConfig(
            max_particles=1024,
            raycast_method="lut",  # swap to "lut_pallas" on a GPU
            angle_step=1,
            timer_frequency=50.0,
            async_correction=True,
        ),
        rng_seed=0,
    )

    # synthesize each car's scan at its true pose and feed the node
    for m in range(FLEET):
        p = poses[m]
        q = np.stack(
            [np.full(BEAMS, p[0]), np.full(BEAMS, p[1]), p[2] + beams], 1
        ).astype(np.float32)
        scan = np.asarray(cast_rays_dda(gm, jnp.asarray(q)))
        node.on_scan(m, scan, beam_angles=beams)
        node.on_odometry(m, *p, 0.0, 0.0, stamp=0.0)
    node.initialize_pose(poses)

    corrections = [0]
    node.add_sink(CallbackSink(
        lambda top, t, pay: corrections.__setitem__(0, corrections[0] + 1),
        topics=("fleet_pose",),
    ))

    # warm up: tick until the first harvest lands (pays the jit compile
    # so the timed live window below measures the steady loop)
    t_warm = time.perf_counter()
    while node.update() is None:
        if time.perf_counter() - t_warm > 600.0:
            raise RuntimeError("warmup never harvested")

    stop = threading.Event()

    def odom_pump():  # 200 Hz odometry per member, from another thread
        while not stop.is_set():
            for m in range(FLEET):
                node.on_odometry(m, *poses[m], 0.0, 0.0)
            time.sleep(0.005)

    pump = threading.Thread(target=odom_pump, daemon=True)
    pump.start()
    t0 = time.perf_counter()
    with LiveRunner(node) as runner:
        time.sleep(3.0)
    stop.set()
    pump.join(timeout=2.0)
    dt = time.perf_counter() - t0

    cur = node.current_poses()
    err = np.linalg.norm(cur[:, :2] - poses[:, :2], axis=1)
    rate = runner.corrections / dt
    print(
        f"{FLEET}-car fleet live loop: {runner.corrections} fleet "
        f"corrections in {dt:.1f}s ({rate:.1f}/s = "
        f"{rate * FLEET:.0f} member-corrections/s), "
        f"{runner.skipped} ticks skipped"
    )
    print("per-member tracked pose error (m):", np.round(err, 3))
    assert err.max() < 0.5, "a member lost its lock"
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
