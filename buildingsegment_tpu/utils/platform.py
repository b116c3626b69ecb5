"""The one place that looks at the backend platform.

Every op that has more than one implementation asks :func:`op_impl`
which one to run.  ``cpu`` always gets the plain XLA form; ``gpu`` gets
the hand-written kernel where one is kept (:data:`GPU_KERNELS`) and the
plain XLA form everywhere else.  Any other platform is an error: this
package has no kernels or tuning for it, and a silent fallback would
hide that.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import jax

__all__ = ["GPU_KERNELS", "backend_platform", "card_line", "op_impl"]

#: ops whose GPU implementation is a hand-written kernel, and its route.
#: An op missing here runs its plain XLA form on every platform.
GPU_KERNELS = {"stats_sweep": "triton"}

_SUPPORTED = ("cpu", "gpu")


def backend_platform(platform: Optional[str] = None) -> str:
    """The default device's platform (``"cpu"`` or ``"gpu"``) — the
    ``jax.default_device`` in effect, else the first device; raises for
    any other."""
    if platform is None:
        dev = jax.config.jax_default_device
        if dev is None:
            platform = jax.devices()[0].platform
        else:
            platform = dev if isinstance(dev, str) else dev.platform
    if platform not in _SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: this package runs on "
            f"{' or '.join(_SUPPORTED)}"
        )
    return platform


def op_impl(op: str, platform: Optional[str] = None) -> str:
    """Implementation of ``op`` on ``platform`` (default: the backend's):
    the kernel route from :data:`GPU_KERNELS` on a GPU, else ``"xla"``."""
    if backend_platform(platform) == "gpu":
        return GPU_KERNELS.get(op, "xla")
    return "xla"


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (a card may be capped below its rated power and then runs slower,
    so every measurement carries this line)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
