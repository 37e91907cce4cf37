"""Device-placement helpers.

Key generation and table construction include many small eager ops, each
of which would compile and dispatch separately on the accelerator. That
host-side math runs pinned to the CPU backend (``host_math``), and finished
key material is shipped to the accelerator once (``to_accelerator``).
"""

from __future__ import annotations

import subprocess
from contextlib import contextmanager

import jax


def cpu_device():
    # local_devices, not devices: in a multi-controller run jax.devices()
    # leads with process 0's devices, which are non-addressable elsewhere
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return jax.local_devices()[0]


def accelerator_device():
    """The default local compute device (the GPU when present, else CPU)."""
    return jax.local_devices()[0]


@contextmanager
def host_math():
    """Run eager jnp math on the CPU backend (fast dispatch, no
    accelerator compiles)."""
    with jax.default_device(cpu_device()):
        yield


def require_gpu():
    """JAX's first device, which must be a GPU: measurement paths never
    fall back to the CPU. Raises SystemExit naming what JAX found instead."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this path runs only on a GPU"
        )
    return dev


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them (a
    child process that stays off JAX), one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def to_accelerator(tree):
    """Move a pytree of arrays to the accelerator in one transfer each."""
    dev = accelerator_device()
    return jax.device_put(tree, dev)
