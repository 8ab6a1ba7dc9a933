"""Training backends: per-worker process-group setup.

Port of ray_tpu/train/backend.py. ``BackendConfig`` and ``Backend`` are
copies (hooks run inside each worker around the training function). The
counterpart of ``JaxConfig``/``_JaxBackend``, which form the
jax.distributed world on every worker, is ``TorchConfig``/
``_TorchBackend``: every worker pins its card and joins a
``torch.distributed`` world, which the port's mesh
(``parallel.mesh.build_mesh``) then spans and the collective groups
(``collective``) run over. The runtime's worker group builds any config
by duck typing (``config.backend_cls()(config).on_start(ctx)``), so these
classes need no base from the reference.

Divergences from the reference's own ``TorchConfig`` (its gloo group for
torch models on TPU hosts): "nccl" is taken, and is the default; a world
of one still forms its group (the collective group and the mesh's
reductions need one, where JAX runs standalone).
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .._device import resolve_device


class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks run inside each worker actor around the training function."""

    def __init__(self, config: Optional[BackendConfig] = None):
        self.config = config

    def on_start(self, worker_ctx: Dict[str, Any]) -> None:
        """worker_ctx: {world_rank, world_size, master_addr, master_port,
        local_rank, num_workers}."""

    def on_shutdown(self) -> None:
        pass


class TorchConfig(BackendConfig):
    """The torch.distributed world of the workers: ``backend`` "nccl"
    (one CUDA card a worker, ``use_gpu=True``) or "gloo" (CPU tensors,
    ``use_gpu=False``, the form the CPU tests use); rendezvous and every
    collective bounded by ``init_timeout_s``."""

    def __init__(self, backend: str = "nccl", use_gpu: bool = True,
                 init_timeout_s: float = 120.0):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"torch backend {backend!r} is not one of "
                             f"'nccl', 'gloo'")
        if backend == "nccl" and not use_gpu:
            raise ValueError("the nccl backend runs on GPUs: use_gpu=True")
        self.backend = backend
        self.use_gpu = use_gpu
        self.init_timeout_s = init_timeout_s

    def backend_cls(self):
        return _TorchBackend


class _TorchBackend(Backend):
    """Forms the torch.distributed world on every worker:
    ``init_process_group(backend, init_method='tcp://master:port', rank,
    world_size, timeout)``, after pinning the worker to
    ``cuda:local_rank`` with every card left visible (the counterpart of
    ``_JaxBackend._pin_local_devices``; hiding the other cards with
    CUDA_VISIBLE_DEVICES would cost NCCL its peer-to-peer paths). A
    missing card or a failed rendezvous raises; nothing falls back to
    gloo or the CPU."""

    def __init__(self, config: TorchConfig):
        self.config = config
        self._initialized = False

    def on_start(self, worker_ctx: Dict[str, Any]) -> None:
        """``worker_ctx`` has the reference's keys; ``init_method`` (a
        ``file://`` path on a file system every worker shares) may stand
        in for ``master_addr``/``master_port``."""
        cfg = self.config
        kwargs = {}
        if cfg.use_gpu:
            resolve_device("cuda")
            device = torch.device("cuda", worker_ctx["local_rank"])
            torch.cuda.set_device(device)
            kwargs["device_id"] = device
        init_method = worker_ctx.get("init_method") or (
            f"tcp://{worker_ctx['master_addr']}:"
            f"{worker_ctx['master_port']}")
        dist.init_process_group(
            backend=cfg.backend, init_method=init_method,
            rank=worker_ctx["world_rank"],
            world_size=worker_ctx["world_size"],
            timeout=datetime.timedelta(seconds=cfg.init_timeout_s),
            **kwargs)
        self._initialized = True

    def on_shutdown(self) -> None:
        if self._initialized:
            dist.destroy_process_group()
            self._initialized = False
