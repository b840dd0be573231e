"""The accelerator a measurement runs on: find a GPU or refuse, and name it.

A time taken on XLA's CPU backend says nothing about the card, so every
script that prints a device number calls `require_gpu` first and labels its
numbers with `card_label`.
"""

from __future__ import annotations

import subprocess
from typing import List


def require_gpu() -> List:
    """All JAX devices, when the first is a GPU; otherwise exit non-zero
    with a message naming what JAX found."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX found platform={devs[0].platform!r} "
            f"kind={devs[0].device_kind!r} count={len(devs)}"
        )
    return devs


def card_label() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them, one card
    per line. Runs nvidia-smi as a child process, which opens no JAX
    client."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()
