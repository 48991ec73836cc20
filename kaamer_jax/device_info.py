"""What the measuring scripts (bench.py, chip_smoke.py) record about the
device they ran on, and the check that it is a GPU."""

from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """The first JAX device as {platform, kind, count}; exits non-zero when
    it is not a GPU (a measurement never falls back to another backend)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this script measures the GPU only")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one card per line, as the tool prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
