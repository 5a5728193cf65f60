"""Multi-host (DCN) fleet scale-out — SURVEY §2.1 "cross-device
collectives" row and §5 "distributed communication backend".

The reference is a single-process C++ node (reference
src/particle_filter.cpp:19-170); its only inter-process hops are ROS DDS
pub/sub and the one-shot GetMap service (:173-230). This module is the
scale-out story beyond one host — pick a mesh, put the high-frequency
axes on the fast links, let the compiler insert the collectives:

* **Fleet members are independent filters**, so the fleet axis is the
  ONLY axis that crosses hosts and the per-step computation needs ZERO
  cross-host collectives: each host holds ``F / num_hosts`` members'
  particle state, their scans, and a replicated map LUT. The mesh is
  1-D ``("fleet",)`` over ALL global devices in process-major order, so
  a member's state never leaves its host.
* **DCN carries only control-plane bytes**: program/compile coordination
  (jax.distributed) plus small fleet-level summaries — the (F, 3) pose
  table via :func:`gather_poses`, kilobytes per call, invoked at the
  consumer's rate (viz/metrics), not per step.
* **A single giant filter stays within one host's cards**
  (:class:`~monte_carlo_localization_tpu.parallel.sharded.ShardedParticleFilter`):
  its per-step ``psum``/``all_gather`` would be DCN-latency-bound across
  hosts. Scale particle count within a host, fleet count across hosts.

Verification on this repo's single-host hardware: ``python -m
monte_carlo_localization_tpu.parallel.multihost --dryrun N`` spawns N
REAL OS processes on the CPU backend, each owning one device, connected
through ``jax.distributed`` exactly like N hosts over DCN — the
collective-free fleet step and the pose-table gather execute under the
true multi-process runtime (tests/test_multihost.py pins it).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

__all__ = [
    "init_multihost",
    "multihost_mesh",
    "MultiHostFleet",
    "run_dryrun",
]


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-host runtime (idempotent).

    Pass the coordinator's ``host:port``, the process count and this
    process's rank explicitly (the CPU dryrun, a GPU cluster), mirroring
    ``jax.distributed.initialize``; nothing on a plain GPU host tells JAX
    of a cluster.
    """
    import jax

    # NOTE: must not touch the backend (jax.devices/process_count) before
    # initialize() — is_initialized() is the only safe probe here
    if jax.distributed.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        # single-host fallback: nothing to join; the mesh below then
        # spans only local devices and the API surface stays identical
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def multihost_mesh(fleet_axis: str = "fleet"):
    """A 1-D mesh over every device of every process, process-major.

    Process-major order is the load-bearing property: a block-sharded
    fleet axis then assigns each host a CONTIGUOUS run of members, so
    member state stays host-local and the step needs no DCN traffic.
    ``jax.devices()`` already enumerates devices process-major (all of
    process 0, then process 1, ...), which this relies on.
    """
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (fleet_axis,))


class MultiHostFleet:
    """A :class:`~monte_carlo_localization_tpu.parallel.fleet.FleetFilter`
    sharded across hosts over DCN.

    Thin by design — the fleet step itself is the single-host FleetFilter
    running per shard (members are independent; shard_map with zero
    collectives); this class owns the multi-host concerns:

    * the process-major global mesh (:func:`multihost_mesh`),
    * which member slice THIS host owns (:attr:`local_members`),
    * feeding per-host scans/actions into global arrays
      (:meth:`scatter_local` — process-local data, no replication), and
    * the DCN summary collective (:meth:`gather_poses`).
    """

    def __init__(self, grid_map, fleet_size, config=None, beam_angles=None):
        import jax

        from monte_carlo_localization_tpu.parallel.fleet import FleetFilter

        self.mesh = multihost_mesh()
        n_dev = self.mesh.devices.size
        if fleet_size % n_dev:
            raise ValueError(
                f"fleet_size={fleet_size} must divide over {n_dev} devices"
            )
        self.fleet = FleetFilter(
            grid_map,
            fleet_size=fleet_size,
            config=config,
            beam_angles=beam_angles,
            mesh=self.mesh,
        )
        self.fleet_size = fleet_size
        self.process_index = jax.process_index()
        self.process_count = jax.process_count()
        per_host = fleet_size // self.process_count
        self.local_members = range(
            self.process_index * per_host, (self.process_index + 1) * per_host
        )

    # -- state/init pass through to the sharded FleetFilter --
    def init_pose(self, poses, seed=0):
        return self.fleet.init_pose(poses, seed=seed)

    def init_global(self, seed=0):
        return self.fleet.init_global(seed=seed)

    def set_beam_angles(self, beam_angles):
        self.fleet.set_beam_angles(beam_angles)

    def scatter_local(self, local_rows: np.ndarray):
        """Build a fleet-sharded global array from THIS host's rows only.

        ``local_rows`` is ``(F / process_count, ...)`` — the scans or
        actions of this host's members. No cross-host copy happens: each
        process contributes exactly the shard its devices hold. This is
        the data path a real deployment uses (each host ingests its own
        robots' sensors); the replicated ``step(actions, scans)`` path
        also works when every host computes the full table.
        """
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(self.mesh, P(self.fleet.fleet_axis))
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(local_rows)
        )

    def step(self, state, actions, scans):
        """One fleet correction. ``actions``/``scans`` may be global
        arrays from :meth:`scatter_local` or full host-replicated numpy
        tables (every process passing identical data)."""
        return self.fleet.step(state, actions, scans)

    def gather_poses(self, poses) -> np.ndarray:
        """The (F, 3) global pose table on EVERY host — the one DCN
        collective of the design (kilobytes, at the metrics/viz rate)."""
        from jax.experimental import multihost_utils

        local = np.concatenate(
            [np.asarray(s.data) for s in sorted(
                poses.addressable_shards, key=lambda s: s.index[0].start or 0
            )]
        )
        gathered = multihost_utils.process_allgather(local)
        return np.asarray(gathered).reshape(self.fleet_size, -1)


# ---------------------------------------------------------------------------
# dryrun: N real OS processes over the jax.distributed runtime (CPU backend)
# ---------------------------------------------------------------------------


def _dryrun_child() -> int:
    """One simulated 'host': joins the cluster, owns fleet members,
    feeds process-local scans, steps, and checks the gathered table."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    coord = os.environ["MCL_MH_COORD"]
    nproc = int(os.environ["MCL_MH_NPROC"])
    pid = int(os.environ["MCL_MH_PID"])
    init_multihost(coord, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()

    # Form the Gloo CPU-collectives context NOW, while every process is
    # freshly synchronized by the jax.distributed join barrier. Context
    # init is the one 30 s cliff in the cross-process CPU transport (a
    # hardcoded GetKeyValue timeout inside XLA); left lazy it fires at
    # the FIRST collective — gather_poses, AFTER each process has
    # independently compiled three fleet-step programs — so on a loaded
    # single-vCPU host the peer skew at that point can exceed 30 s
    # ("Gloo context initialization failed: DEADLINE_EXCEEDED", observed
    # once in-suite). An established context waits minutes per op, so
    # post-barrier compile skew no longer matters.
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("mcl-multihost-dryrun-start")

    import jax.numpy as jnp

    from monte_carlo_localization_tpu.config import MCLConfig
    from monte_carlo_localization_tpu.mapping import box_world
    from monte_carlo_localization_tpu.ops.raycast import cast_rays_sphere

    gm = box_world(height=120, width=160)
    beams = np.linspace(-np.pi / 2, np.pi / 2, 12, dtype=np.float32)
    members_per_host = 2
    fleet_size = members_per_host * nproc
    # the PRODUCTION Pallas LUT kernel runs per host shard (interpret mode
    # on the CPU backend — same code path the real chip compiles), so the
    # true multi-process jax.distributed runtime exercises the flagship
    # likelihood, not just the XLA gather fallback. Shapes stay tiny: the
    # interpreted kernel is ~ms per 32-particle member step.
    mh = MultiHostFleet(
        gm,
        fleet_size=fleet_size,
        config=MCLConfig(
            max_particles=32, raycast_method="lut_pallas",
            lut_theta_bins=180,
        ),
        beam_angles=beams,
    )

    # every member sits at a distinct true pose; each host synthesizes
    # scans ONLY for its own members (the process-local ingest path).
    # Offsets stay OFF multiples of the 0.05 m resolution (f32 vs f64
    # floor to different cells on cell boundaries).
    truths = np.stack(
        [
            np.array([3.013 + 0.15 * m, 2.517 + 0.1 * m, 0.1 * m],
                     np.float32)
            for m in range(fleet_size)
        ]
    )
    local_scans = []
    for m in mh.local_members:
        p = truths[m]
        q = np.stack(
            [np.full(len(beams), p[0]), np.full(len(beams), p[1]),
             p[2] + beams], 1,
        ).astype(np.float32)
        local_scans.append(np.asarray(cast_rays_sphere(gm, jnp.asarray(q))))
    scans = mh.scatter_local(np.stack(local_scans))
    actions = mh.scatter_local(
        np.zeros((members_per_host, 3), np.float32)
    )

    state = mh.init_pose(truths, seed=4)
    for _ in range(3):
        state, poses = mh.step(state, actions, scans)
    table = mh.gather_poses(poses)

    assert table.shape == (fleet_size, 3), table.shape
    assert np.isfinite(table).all(), table
    err = np.linalg.norm(table[:, :2] - truths[:, :2], axis=1)
    assert err.max() < 0.5, f"fleet diverged across hosts: {err}"
    print(f"process {pid}/{nproc}: pose table ok, max err {err.max():.3f} m",
          flush=True)
    return 0


def run_dryrun(num_processes: int = 2, timeout_s: float = 300.0) -> None:
    """Spawn ``num_processes`` real OS processes joined via
    jax.distributed (the actual DCN runtime path) and run the multi-host
    fleet step + pose gather. Raises on any failure.

    CPU-only by design: every process is pinned to the CPU backend with
    one device, so the dryrun never opens a card (on a GPU host N
    processes would each reserve most of its memory)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    import re

    # each simulated host owns exactly ONE device: scrub any inherited
    # virtual-device-count flag (the test suite forces 8 for the
    # single-process mesh tests)
    xla_flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+", "",
        os.environ.get("XLA_FLAGS", ""),
    ).strip()
    procs = []
    for pid in range(num_processes):
        env = dict(
            os.environ,
            MCL_MH_COORD=coord,
            MCL_MH_NPROC=str(num_processes),
            MCL_MH_PID=str(pid),
            MCL_MH_CHILD="1",
            JAX_PLATFORM_NAME="cpu",
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=xla_flags,
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m",
                 "monte_carlo_localization_tpu.parallel.multihost"],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs, fails = [], []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            fails.append((pid, "timeout", out))
            continue
        outs.append(out)
        if p.returncode != 0:
            fails.append((pid, f"rc={p.returncode}", out))
    if fails:
        detail = "\n".join(
            f"--- process {pid} ({why}) ---\n{out[-2000:]}"
            for pid, why, out in fails
        )
        raise RuntimeError(f"multihost dryrun failed:\n{detail}")
    print("".join(outs), end="")
    print(f"MULTIHOST DRYRUN OK ({num_processes} processes)")


if __name__ == "__main__":
    if os.environ.get("MCL_MH_CHILD"):
        sys.exit(_dryrun_child())
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", type=int, default=2, metavar="N",
                    help="number of simulated hosts (OS processes)")
    args = ap.parse_args()
    run_dryrun(args.dryrun)
