"""The port's Train backend and GPU accelerator manager, and the port's
backend hosted by the JAX package's runtime.

``TorchConfig("gloo", use_gpu=False)`` forms gloo worlds of spawned
processes (the port's ``_TorchBackend``, as the reference's ``_JaxBackend``
forms jax.distributed ones); ``TorchConfig("nccl")`` needs a card and
raises without one, falling back to nothing. One test runs the port's
``transformer_train_loop`` under ``ray_tpu.train.DataParallelTrainer``
with the port's config as its ``backend_config``: the worker group builds
it by duck typing (``ray_tpu/train/worker_group.py:70-71``), and its
losses must equal the same loop's in spawned ranks.
"""

import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.tpu import GPUAcceleratorManager
from ray_tpu_torch.train import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.backend import _TorchBackend
from test_torch_collective import spawn_ranks

LOOP = {"preset": "tiny", "mesh": {"fsdp": 2}, "steps": 3, "batch": 4,
        "seq": 16, "seed": 3}
FIT_S = 180


def test_torch_config_takes_nccl_and_gloo_only():
    assert TorchConfig().backend == "nccl" and TorchConfig().use_gpu
    assert TorchConfig().backend_cls() is _TorchBackend
    assert BackendConfig().backend_cls() is Backend
    for bad in (dict(backend="mpi"), dict(backend="nccl", use_gpu=False)):
        with pytest.raises(ValueError):
            TorchConfig(**bad)


def test_nccl_without_a_card_raises_and_forms_no_world():
    backend = TorchConfig("nccl").backend_cls()(TorchConfig("nccl"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.on_start(dict(world_rank=0, world_size=1, local_rank=0,
                              master_addr="localhost", master_port=1))
    assert not dist.is_initialized()
    backend.on_shutdown()


def _world(rank, world):
    """What a rank sees of the world the backend formed, and of a mesh
    built in it."""
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec(dp=-1))
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    return dict(world=dist.get_world_size(), rank=dist.get_rank(),
                backend=dist.get_backend(), sum=float(t),
                mesh=(mesh.world, mesh.rank,
                      mesh.world_group() is dist.group.WORLD,
                      mesh.local_positions(), mesh.shape["dp"],
                      str(mesh.devices.flat[mesh.local_positions()[0]])))


@pytest.mark.parametrize("world", [1, 2])
def test_gloo_backend_forms_the_world_a_mesh_spans(world, tmp_path):
    got = spawn_ranks(_world, world, tmp_path)
    for r, g in enumerate(got):
        assert (g["world"], g["rank"], g["backend"]) == (world, r, "gloo")
        assert g["sum"] == world * (world + 1) / 2
        assert g["mesh"] == (world, r, True, [r], world, "cpu")


def test_gpu_accelerator_manager_reads_cuda_visible_devices(monkeypatch):
    m = GPUAcceleratorManager
    assert m.accelerator_name() == "GPU"
    for visible, n in (("0,1,2", 3), ("", 0), ("3", 1), ("1,-1,2", 1),
                       ("GPU-8f6a,GPU-11c2", 2)):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        assert m.num_chips() == n
        assert m.node_resources() == ({"GPU": float(n)} if n else {})
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    # No card in this process: the name is unknown, the kind is not.
    assert m.accelerator_type() is None
    assert m.node_labels() == {"accelerator-type": "GPU"}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert m.num_chips() == torch.cuda.device_count()
    assert m.set_visible_chips([0, 2]) == {"CUDA_VISIBLE_DEVICES": "0,2"}


def _loop(rank, world, config):
    from ray_tpu_torch.train.examples.transformer_example import (
        transformer_train_loop)
    return transformer_train_loop(config)


def test_port_backend_under_the_reference_trainer(ray_start_regular,
                                                  tmp_path):
    from ray_tpu.train import DataParallelTrainer, RunConfig, ScalingConfig
    spawned = spawn_ranks(_loop, 2, tmp_path, LOOP)
    assert spawned[0] == spawned[1]

    def loop(config):
        # Sent to the runtime's workers by value (the test module is not
        # importable there).
        from ray_tpu import train
        from ray_tpu_torch.train.examples.transformer_example import (
            transformer_train_loop)
        transformer_train_loop(config, report=train.report)

    trainer = DataParallelTrainer(
        loop, train_loop_config=LOOP,
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        backend_config=TorchConfig("gloo", use_gpu=False),
        run_config=RunConfig(name="port_backend",
                             storage_path=str(tmp_path / "results")))
    box = {}
    fit = threading.Thread(target=lambda: box.update(r=trainer.fit()),
                           daemon=True)
    fit.start()
    fit.join(timeout=FIT_S)
    assert not fit.is_alive(), f"fit() still running after {FIT_S} s"
    result = box["r"]
    assert result.error is None, result.error
    assert result.metrics_history == spawned[0]
    losses = [m["loss"] for m in spawned[0]]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
