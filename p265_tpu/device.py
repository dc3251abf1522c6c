"""The GPU the decoder runs on: a hard check for it, and the card's name and
power limit as nvidia-smi reports them (times mean little without both)."""
from __future__ import annotations

import subprocess
import sys

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def require_gpu(count: int = 1) -> list:
    """The JAX devices, or exit non-zero when they are not `count` GPUs."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"no GPU: JAX platform is {devs[0].platform}")
    if len(devs) < count:
        sys.exit(f"{count} GPUs needed, JAX sees {len(devs)}")
    return devs


def smi_line() -> str:
    """The card's `name, power limit` line from nvidia-smi (first card)."""
    out = subprocess.run(SMI_QUERY, check=True, capture_output=True,
                         text=True, timeout=60).stdout
    return next(line.strip() for line in out.splitlines() if line.strip())


def parse_smi(line: str) -> tuple[str, str]:
    """`NVIDIA H100 80GB HBM3, 700.00 W` -> (name, power limit)."""
    name, sep, limit = line.rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"not a `name, power.limit` line: {line!r}")
    return name.strip(), limit.strip()
