"""Test configuration: force the XLA CPU backend with 8 virtual devices.

The engine's code paths run under XLA CPU; the virtual device mesh
exercises the multi-device sharding logic without a card. What only the
card can show is checked by chip_smoke.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"


@pytest.fixture(scope="session")
def box_map():
    from monte_carlo_localization_tpu.mapping import box_world

    return box_world()


@pytest.fixture(scope="session")
def clutter_map():
    from monte_carlo_localization_tpu.mapping import random_obstacle_world

    return random_obstacle_world(seed=3)


@pytest.fixture(scope="session")
def beams60():
    return np.linspace(-2.35, 2.35, 60).astype(np.float32)


def synth_scan(grid_map, pose, beams):
    """Synthesize a perfect scan at a pose with the DDA oracle."""
    import jax.numpy as jnp

    from monte_carlo_localization_tpu.ops.raycast import cast_rays_dda

    r = len(beams)
    q = np.stack(
        [np.full(r, pose[0]), np.full(r, pose[1]), pose[2] + beams], axis=1
    ).astype(np.float32)
    return np.asarray(cast_rays_dda(grid_map, jnp.asarray(q)))


@pytest.fixture(scope="session")
def make_scan():
    return synth_scan

