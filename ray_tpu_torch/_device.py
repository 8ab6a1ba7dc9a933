"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    Only ``cuda`` and ``cpu`` are accepted. Asking for CUDA on a machine
    without a GPU raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (expected cuda or cpu)")
