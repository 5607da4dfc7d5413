"""What every cell shares: the arithmetic of its end-to-end numbers, the
device line, the check that no JAX module is loaded, and the result line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pbrlab_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's, Flax's or the JAX package's. `pbrlab_tpu_torch`
    begins with `pbrlab_tpu` and is not one of them."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))


def nearest_rank(values, q):
    """The q-quantile (0 < q <= 1) of all values by nearest rank: the
    smallest value with at least q of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def power_limit():
    """The card's power limit in W as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def device_line(torch, count, peak_bytes):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": power_limit()}


def emit(result, numbers):
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output (`checks` comes last
    in it)."""
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    for name, (value, limit) in numbers.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
