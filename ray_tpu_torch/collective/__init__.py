"""ray_tpu_torch.collective: collective communication on process groups.

Port of ray_tpu/collective: the same public names, with the port's
``TorchCollectiveGroup`` (NCCL or gloo) in place of ``XlaCollectiveGroup``
and the host group's KV store passed in (``set_runtime``, ``DictKV``,
``StoreKV``).
"""

from .collective import (allgather, allreduce, barrier, broadcast,
                         create_collective_group, destroy_collective_group,
                         get_collective_group_size, get_rank,
                         init_collective_group, is_group_initialized,
                         recv, reduce, reducescatter, send, set_runtime,
                         DictKV, GroupManager, HostCollectiveGroup, StoreKV,
                         TorchCollectiveGroup)

__all__ = [
    "allgather", "allreduce", "barrier", "broadcast",
    "create_collective_group", "destroy_collective_group",
    "get_collective_group_size", "get_rank", "init_collective_group",
    "is_group_initialized", "recv", "reduce", "reducescatter", "send",
    "set_runtime", "DictKV", "GroupManager", "HostCollectiveGroup",
    "StoreKV", "TorchCollectiveGroup",
]
