"""tpu-mcl — an accelerator-native Monte Carlo Localization engine.

A brand-new JAX/XLA/Pallas framework with the capabilities of the F1TENTH
``particle_filter_cpp`` reference (AE-HYU/monte_carlo_localization), designed
for an accelerator rather than ported:

* the full MCL correction (resample -> motion -> sensor likelihood -> pose
  estimate) is ONE fused jitted step — a single device dispatch,
* the lidar beam likelihood ray-marches every particle x beam against a
  per-map Euclidean distance transform (sphere marching) instead of the
  reference's per-cell DDA loops (reference: src/particle_filter.cpp:611-650),
* weights live in log-space (the reference multiplies 60 doubles,
  src/particle_filter.cpp:564-579 — at 1080 beams fp32 would underflow),
* resampling is systematic (cumsum + scatter/cummax CDF inversion) with a multinomial
  compatibility mode matching the reference (src/particle_filter.cpp:657-665),
* fleets of independent filters vmap/shard over a device mesh, and a single
  giant filter can shard its particle axis with jax collectives.

The dual-rate architecture of the reference is preserved: high-rate odometry
dead-reckoning with delay compensation runs on host
(:mod:`monte_carlo_localization_tpu.runtime`) while the MCL correction runs
as one device step (:mod:`monte_carlo_localization_tpu.filter`).
"""

from monte_carlo_localization_tpu.config import MCLConfig, load_config
from monte_carlo_localization_tpu.mapping import GridMap, load_map
from monte_carlo_localization_tpu.filter import MCLState, ParticleFilter

__version__ = "0.1.0"

__all__ = [
    "MCLConfig",
    "load_config",
    "GridMap",
    "load_map",
    "MCLState",
    "ParticleFilter",
    "__version__",
]
