"""What the backend JAX runs on can do, asked in one place.

The engine runs on two platforms: ``cpu`` (tests, hosts without a card)
and ``gpu`` (an NVIDIA card). Every decision that depends on the platform
— which likelihood path ``raycast_method="auto"`` takes, whether a LUT is
built on the device or on the host — goes through
:func:`backend_platform`, which refuses any other platform instead of
guessing what it can run.
"""

from __future__ import annotations

SUPPORTED_PLATFORMS = ("cpu", "gpu")


def backend_platform(platform: str | None = None) -> str:
    """The default backend's platform (``"cpu"`` or ``"gpu"``).

    ``platform`` overrides the lookup (for callers that already know it).
    Raises ``RuntimeError`` on any platform the engine does not support."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: the engine runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}"
        )
    return platform


def on_accelerator(platform: str | None = None) -> bool:
    """True when the default backend is a GPU (device-side LUT builds,
    compiled kernels); False on the CPU."""
    return backend_platform(platform) == "gpu"


def card_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), one line per card joined by
    ``"; "``; ``"not available"`` when ``nvidia-smi`` cannot be run.
    Every device number is reported beside it: a card capped below its
    maximum power runs slower under load."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())
