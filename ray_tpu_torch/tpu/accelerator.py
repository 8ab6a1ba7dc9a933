"""GPU accelerator manager: card detection, visibility and resources.

Port of ray_tpu/tpu/accelerator.py, at the reference's relative path so
that each module of the port sits where its counterpart does (the
package's name keeps its origin; the accelerator is an NVIDIA GPU).
``GPUAcceleratorManager`` is the counterpart of ``TPUAcceleratorManager``:
``accelerator_name``, ``num_chips``, ``node_resources``, ``node_labels``
and ``set_visible_chips``, plus ``accelerator_type`` (the card's name).

The reference's TPU-slice metadata has no GPU meaning and no counterpart:
``pod_type``, ``topology``, ``worker_id``, ``slice_name``,
``num_hosts_in_slice``, the synthetic ``TPU-{pod}-head`` resource and the
GCE metadata lookups.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

_VISIBLE_ENV = "CUDA_VISIBLE_DEVICES"


class GPUAcceleratorManager:
    """Static methods mirroring the reference's accelerator manager."""

    @staticmethod
    def accelerator_name() -> str:
        return "GPU"

    @staticmethod
    def num_chips() -> int:
        """Cards visible to this process: the entries of
        CUDA_VISIBLE_DEVICES up to the first invalid one (as CUDA reads
        it; set and empty hides every card), else
        ``torch.cuda.device_count()``. Creates no CUDA context."""
        visible = os.environ.get(_VISIBLE_ENV)
        if visible is not None:
            n = 0
            for entry in visible.split(","):
                entry = entry.strip()
                if not entry or entry.startswith("-"):
                    break
                n += 1
            return n
        return torch.cuda.device_count()

    @classmethod
    def accelerator_type(cls) -> Optional[str]:
        """The first visible card's name, e.g. 'NVIDIA H100 80GB HBM3';
        None without a card."""
        if not cls.num_chips() or not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(0)

    @classmethod
    def node_resources(cls) -> Dict[str, float]:
        """Resources this host contributes: ``{"GPU": cards}``."""
        n = cls.num_chips()
        return {"GPU": float(n)} if n else {}

    @classmethod
    def node_labels(cls) -> Dict[str, str]:
        """Accelerator labels: the kind and, where a card is visible, its
        name."""
        out: Dict[str, str] = {}
        if cls.num_chips():
            out["accelerator-type"] = "GPU"
            name = cls.accelerator_type()
            if name:
                out["gpu-type"] = name
        return out

    @staticmethod
    def set_visible_chips(chip_ids: List[int]) -> Dict[str, str]:
        """Env vars confining a worker to specific cards. (A rank of a
        training world is pinned with ``torch.cuda.set_device`` instead,
        every card visible, so that NCCL sees the peers' cards: the Train
        backend does so.)"""
        return {_VISIBLE_ENV: ",".join(str(c) for c in chip_ids)}
