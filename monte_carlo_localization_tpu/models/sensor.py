"""Precomputed 4-component beam sensor model.

Rebuilds the reference's sensor-model LUT (reference
src/particle_filter.cpp:233-292) as one vectorized table construction, and
its per-particle likelihood product (reference :506-583) as a log-space
gather + reduction:

* table[r, d] = P(observed range r px | expected range d px), a
  (max_range_px+1)^2 matrix mixing
    - z_hit  * Gaussian(r; d, sigma_hit px)
    - z_short* 2 (d - r) / d            for r < d
    - z_max  * 1[r == max_range_px]
    - z_rand / max_range_px             for r < max_range_px
  column-normalized over r for each d — numerically identical to the
  reference's double-precision build (computed in f64, stored f32).

* likelihood: the reference multiplies ~60 probabilities per particle in
  double and then squashes with ^(1/squash_factor) (reference :564-579).
  At 1080 beams in f32 that product underflows, so the engine works in
  log space: log w_i = inv_squash * sum_j log table[obs_j, exp_ij].
  Weights are carried as logits and normalized by softmax/logsumexp —
  identical semantics up to floating point.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

_LOG_TINY = 1e-35  # guards log(0) for impossible table entries


def build_sensor_table(
    max_range_px: int,
    z_hit: float = 0.80,
    z_short: float = 0.01,
    z_max: float = 0.07,
    z_rand: float = 0.12,
    sigma_hit: float = 8.0,
) -> np.ndarray:
    """Column-normalized (W, W) mixture table, W = max_range_px + 1.

    Exactly reproduces reference src/particle_filter.cpp:248-287 (f64 math).
    Rows index the observed range r, columns the expected range d.
    """
    w = max_range_px + 1
    r = np.arange(w, dtype=np.float64)[:, None]  # observed
    d = np.arange(w, dtype=np.float64)[None, :]  # expected
    z = r - d

    table = z_hit * np.exp(-(z * z) / (2.0 * sigma_hit * sigma_hit)) / (
        sigma_hit * np.sqrt(2.0 * np.pi)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        short = 2.0 * z_short * (d - r) / d
    table += np.where((r < d) & (d > 0), short, 0.0)
    table[max_range_px, :] += z_max
    table[: max_range_px, :] += z_rand / max_range_px

    norm = table.sum(axis=0, keepdims=True)
    norm = np.where(norm > 0, norm, 1.0)
    return (table / norm).astype(np.float32)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SensorModel:
    """Device-resident sensor model: the log LUT plus static geometry."""

    log_table: jnp.ndarray  # (W, W) float32, log of the normalized mixture
    max_range_px: int = field(metadata=dict(static=True))
    resolution: float = field(metadata=dict(static=True))
    inv_squash_factor: float = field(metadata=dict(static=True))
    # mixture coefficients (static) for the analytic closed-form path
    z_hit: float = field(default=0.80, metadata=dict(static=True))
    z_short: float = field(default=0.01, metadata=dict(static=True))
    z_max: float = field(default=0.07, metadata=dict(static=True))
    z_rand: float = field(default=0.12, metadata=dict(static=True))
    sigma_hit: float = field(default=8.0, metadata=dict(static=True))

    @classmethod
    def create(
        cls,
        max_range_px: int,
        resolution: float,
        z_hit: float = 0.80,
        z_short: float = 0.01,
        z_max: float = 0.07,
        z_rand: float = 0.12,
        sigma_hit: float = 8.0,
        squash_factor: float = 2.2,
    ) -> "SensorModel":
        table = build_sensor_table(max_range_px, z_hit, z_short, z_max, z_rand, sigma_hit)
        return cls(
            log_table=jnp.asarray(np.log(np.maximum(table, _LOG_TINY))),
            max_range_px=max_range_px,
            resolution=resolution,
            inv_squash_factor=1.0 / squash_factor,
            z_hit=z_hit,
            z_short=z_short,
            z_max=z_max,
            z_rand=z_rand,
            sigma_hit=sigma_hit,
        )

    def to_pixel_index(self, ranges_m: jnp.ndarray) -> jnp.ndarray:
        """meters -> rounded, clipped pixel index (reference :545-575).

        The reference first clips the FLOAT px value at max_range_px, then
        rounds — so e.g. 240.4 px clips to 240 before rounding. NaN/inf
        scan returns (real lidar emits them) clip to the max bin.
        Rounding is floor(x + 0.5): half-away-from-zero on these
        non-negative values, matching the reference's std::round/roundf
        (jnp.round is half-to-EVEN, which puts exact half-pixel ranges in
        a different bin than the C++ node).
        """
        px = ranges_m / self.resolution
        px = jnp.nan_to_num(
            px, nan=float(self.max_range_px), posinf=float(self.max_range_px), neginf=0.0
        )
        px = jnp.clip(px, 0.0, float(self.max_range_px))
        return jnp.floor(px + 0.5).astype(jnp.int32)

    def log_likelihood(
        self,
        observed_m: jnp.ndarray,
        expected_m: jnp.ndarray,
        mode: str = "analytic",
    ) -> jnp.ndarray:
        """Per-particle squashed log likelihood.

        Args:
          observed_m: (R,) downsampled scan in meters (shared by particles).
          expected_m: (..., R) ray-cast ranges in meters per particle.
          mode: "table" gathers from the precomputed LUT (bit-faithful to the
            reference); "analytic" evaluates the same normalized mixture in
            closed form — zero table gathers, elementwise math only.
        Returns:
          (...,) log weights: inv_squash * sum_j log P(obs_j | exp_.j).
        """
        if mode == "table":
            w = self.max_range_px + 1
            obs_idx = self.to_pixel_index(observed_m)  # (R,)
            exp_idx = self.to_pixel_index(expected_m)  # (..., R)
            flat = self.log_table.reshape(-1)
            logp = flat[obs_idx * w + exp_idx]  # broadcast gather, (..., R)
            return self.inv_squash_factor * jnp.sum(logp, axis=-1)
        if mode != "analytic":
            raise ValueError(f"Unknown sensor mode: {mode!r}")
        obs_px = self.to_pixel_index(observed_m).astype(jnp.float32)
        exp_px = self.to_pixel_index(expected_m).astype(jnp.float32)
        logp = self.log_prob_analytic(obs_px, exp_px)
        return self.inv_squash_factor * jnp.sum(logp, axis=-1)

    def log_prob_analytic(self, r_px: jnp.ndarray, d_px: jnp.ndarray) -> jnp.ndarray:
        """log P(observed r | expected d) for INTEGER pixel bins, closed form.

        Recomputes exactly what build_sensor_table puts in table[r, d]
        (reference src/particle_filter.cpp:248-287) without touching memory:
        the unnormalized mixture is evaluated directly, and the per-column
        normalizer (a function of d alone) uses the exact z_short/z_max/
        z_rand sums plus a continuity-corrected Gaussian-sum approximation
        (midpoint/erf; |error| < 1e-3 relative at sigma >= 2 px, validated
        against the table in tests).
        """
        m = jnp.float32(self.max_range_px)
        z = r_px - d_px
        inv2s2 = 1.0 / (2.0 * self.sigma_hit * self.sigma_hit)
        gauss_coef = 1.0 / (self.sigma_hit * jnp.sqrt(2.0 * jnp.pi))
        p = self.z_hit * gauss_coef * jnp.exp(-(z * z) * inv2s2)
        p = p + jnp.where(
            r_px < d_px,
            2.0 * self.z_short * (d_px - r_px) / jnp.maximum(d_px, 1.0),
            0.0,
        )
        p = p + jnp.where(r_px >= m, self.z_max, 0.0)
        p = p + jnp.where(r_px < m, self.z_rand / m, 0.0)

        # normalizer over r = 0..m for this d
        sq2 = jnp.sqrt(jnp.float32(2.0)) * self.sigma_hit
        gauss_sum = 0.5 * (
            jax.scipy.special.erf((m - d_px + 0.5) / sq2)
            - jax.scipy.special.erf((-d_px - 0.5) / sq2)
        )
        norm = (
            self.z_hit * gauss_sum
            + jnp.where(d_px > 0, self.z_short * (d_px + 1.0), 0.0)
            + self.z_max
            + self.z_rand  # m bins of z_rand / m
        )
        return jnp.log(jnp.maximum(p, _LOG_TINY)) - jnp.log(norm)
