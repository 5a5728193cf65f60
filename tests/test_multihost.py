"""Multi-host (DCN) fleet scale-out dryrun — SURVEY §2.1 cross-device row.

Spawns REAL OS processes joined through ``jax.distributed`` (the same
runtime path N hosts use over the data-center network), shards a fleet over the global
process-major mesh, feeds process-LOCAL scans, steps, and gathers the
global pose table on every host. The reference has no multi-process
story at all (single node, DDS pub/sub only — reference
src/particle_filter.cpp:133-148); this pins the repo's scale-out design
end-to-end without multi-host hardware.
"""

import numpy as np
import pytest

from monte_carlo_localization_tpu.parallel.multihost import (
    MultiHostFleet,
    multihost_mesh,
    run_dryrun,
)


def test_multihost_dryrun_two_processes():
    """Two simulated hosts: cluster join, zero-collective sharded step
    running the PRODUCTION Pallas LUT kernel per shard (interpret mode),
    process-local scatter, DCN pose gather — all under the true
    multi-process runtime."""
    run_dryrun(2, timeout_s=480.0)


def test_multihost_dryrun_three_processes():
    """Odd-sized cluster: 3 processes x 1 device each, same production
    kernel per shard — pins that nothing in the mesh/scatter/gather logic
    assumes a power-of-two host count."""
    run_dryrun(3, timeout_s=540.0)


def test_multihost_api_single_process_fallback():
    """Off-cluster the same API runs on the local (virtual 8-device)
    mesh: fleet sharded over all devices, scatter_local degenerates to
    the full table, gather_poses returns every member."""
    import jax

    from monte_carlo_localization_tpu.config import MCLConfig
    from monte_carlo_localization_tpu.mapping import box_world

    gm = box_world(height=120, width=160)
    beams = np.linspace(-np.pi / 2, np.pi / 2, 12).astype(np.float32)
    n_dev = len(jax.devices())
    mh = MultiHostFleet(
        gm,
        fleet_size=2 * n_dev,
        config=MCLConfig(
            max_particles=64, raycast_method="lut", lut_theta_bins=180
        ),
        beam_angles=beams,
    )
    assert mh.mesh.devices.size == n_dev
    assert list(mh.local_members) == list(range(2 * n_dev))

    from tests.conftest import synth_scan

    truths = np.stack(
        [
            np.array([3.013 + 0.15 * m, 2.517 + 0.1 * m, 0.1 * m],
                     np.float32)
            for m in range(2 * n_dev)
        ]
    )
    scans = mh.scatter_local(
        np.stack([synth_scan(gm, p, beams) for p in truths])
    )
    actions = mh.scatter_local(np.zeros((2 * n_dev, 3), np.float32))
    state = mh.init_pose(truths, seed=4)
    for _ in range(3):
        state, poses = mh.step(state, actions, scans)
    table = mh.gather_poses(poses)
    assert table.shape == (2 * n_dev, 3)
    err = np.linalg.norm(table[:, :2] - truths[:, :2], axis=1)
    assert err.max() < 0.5, err


def test_multihost_mesh_is_process_major():
    """The load-bearing mesh property: devices enumerate process-major so
    block-sharded members stay host-local."""
    import jax

    mesh = multihost_mesh()
    assert mesh.devices.ndim == 1
    assert [d.id for d in mesh.devices] == sorted(d.id for d in jax.devices())


def test_multihost_fleet_size_must_divide():
    import jax

    from monte_carlo_localization_tpu.config import MCLConfig
    from monte_carlo_localization_tpu.mapping import box_world

    with pytest.raises(ValueError, match="divide"):
        MultiHostFleet(
            box_world(height=60, width=80),
            fleet_size=len(jax.devices()) + 1,
            config=MCLConfig(max_particles=32, raycast_method="lut",
                             lut_theta_bins=90),
        )
