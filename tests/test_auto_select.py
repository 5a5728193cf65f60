"""Raycast-backend auto-selection (config default "auto").

"auto" resolves per platform: the XLA lut path on the CPU, the fused
lut_pallas likelihood on a GPU, and an error on any other platform. An
auto-selected lut_pallas degrades to "lut" only on an unsupported beam
geometry (ValueError) — while an EXPLICIT lut_pallas request still fails
loudly, and no other error is swallowed.
"""

import numpy as np
import pytest

from monte_carlo_localization_tpu.config import (
    MCLConfig,
    resolve_raycast_method,
)
from monte_carlo_localization_tpu.filter import ParticleFilter


def test_resolve_auto_by_backend():
    assert resolve_raycast_method("auto", backend="cpu") == "lut"
    assert resolve_raycast_method("auto", backend="gpu") == "lut_pallas"
    # explicit methods pass through untouched
    for m in ("lut", "lut_pallas", "sphere", "dda"):
        assert resolve_raycast_method(m, backend="gpu") == m
        assert resolve_raycast_method(m, backend="cpu") == m


@pytest.mark.parametrize("platform", ["rocm", "METAL", "interpreter"])
def test_resolve_auto_refuses_unknown_platform(platform):
    """No quiet default: an unsupported platform raises."""
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        resolve_raycast_method("auto", backend=platform)


def test_default_config_is_auto():
    assert MCLConfig().raycast_method == "auto"


def test_filter_resolves_auto_on_cpu(box_map):
    # the test suite forces the CPU backend, so auto must pick "lut"
    pf = ParticleFilter(box_map, MCLConfig(max_particles=64))
    assert pf.config.raycast_method == "lut"
    assert pf._auto_raycast
    # an explicitly requested method is never auto-downgraded
    pf2 = ParticleFilter(
        box_map, MCLConfig(max_particles=64, raycast_method="sphere")
    )
    assert not pf2._auto_raycast


def test_auto_kernel_falls_back_on_bad_geometry(box_map, make_scan):
    """An auto-selected lut_pallas on an unsupported beam set degrades to
    'lut' with a warning instead of raising, and the filter still steps."""
    pf = ParticleFilter(box_map, MCLConfig(max_particles=64, angle_step=1))
    # simulate the GPU resolution of "auto" (the CPU suite resolved "lut")
    pf.config = pf.config.replace(raycast_method="lut_pallas")
    assert pf._auto_raycast
    bad_beams = np.array([0.0, 0.0, 0.1, 0.2], np.float32)  # duplicate beam
    with pytest.warns(UserWarning, match="falling back to 'lut'"):
        pf.set_beam_angles(bad_beams)
    assert pf.config.raycast_method == "lut"
    pose = np.array([2.3, 2.7, 0.4], np.float32)
    scan = make_scan(box_map, pose, bad_beams)
    state = pf.init_pose(pose, seed=0)
    state, est = pf.step(state, np.zeros(3, np.float32), scan)
    assert np.isfinite(np.asarray(est)).all()


def test_explicit_kernel_raises_on_bad_geometry(box_map):
    """Explicit raycast_method='lut_pallas' must fail loudly — no silent
    downgrade the user didn't ask for."""
    pf = ParticleFilter(
        box_map,
        MCLConfig(max_particles=64, raycast_method="lut_pallas"),
    )
    bad_beams = np.array([0.0, 0.0, 0.1, 0.2], np.float32)
    with pytest.raises(ValueError):
        pf.set_beam_angles(bad_beams)


def test_auto_kernel_falls_back_on_runtime_error(box_map, monkeypatch):
    """The auto fallback is for the documented geometry ValueError only: a
    RuntimeError from the builder (a missing native compact-LUT builder,
    a lowering failure) propagates even for an AUTO-selected lut_pallas,
    instead of silently running another path under its name."""
    import monte_carlo_localization_tpu.filter.core as core

    def boom(*a, **k):
        raise RuntimeError("compact u16 range LUT needs the native builder")

    monkeypatch.setattr(core, "build_pallas_likelihood", boom)
    pf = ParticleFilter(box_map, MCLConfig(max_particles=64, angle_step=1))
    pf.config = pf.config.replace(raycast_method="lut_pallas")
    assert pf._auto_raycast
    with pytest.raises(RuntimeError, match="native builder"):
        pf.set_beam_angles(np.array([0.0, 0.1, 0.2, 0.3], np.float32))
    assert pf.config.raycast_method == "lut_pallas"


def test_explicit_kernel_reraises_runtime_error(box_map, monkeypatch):
    import monte_carlo_localization_tpu.filter.core as core

    def boom(*a, **k):
        raise RuntimeError("native builder unavailable")

    monkeypatch.setattr(core, "build_pallas_likelihood", boom)
    pf = ParticleFilter(
        box_map, MCLConfig(max_particles=64, raycast_method="lut_pallas")
    )
    with pytest.raises(RuntimeError):
        pf.set_beam_angles(np.array([0.0, 0.1, 0.2, 0.3], np.float32))
