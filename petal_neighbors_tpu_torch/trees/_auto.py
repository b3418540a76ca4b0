"""The builder's automatic choice (the JAX package's ``trees/_auto.py``,
with its crossover of 131,072 points).

The level-synchronous device build beats the host build at scale: 0.11 s
against 3.8 s for 1M x 2 f32 points on an H100 (chip_smoke.py, phase
``ball_device_build``); below about 10^5 points transfers and launches
dominate.  In the port the index's device decides: a CUDA index at
``n >= DEVICE_BUILD_MIN_N`` takes the device build, with no availability
probe (the device was resolved, and a missing card raised, when the index
was made)."""

from __future__ import annotations

import torch

DEVICE_BUILD_MIN_N = 131072


def use_device_build(n: int, device: torch.device) -> bool:
    """True for a CUDA index of at least ``DEVICE_BUILD_MIN_N`` points."""
    return n >= DEVICE_BUILD_MIN_N and torch.device(device).type == "cuda"
