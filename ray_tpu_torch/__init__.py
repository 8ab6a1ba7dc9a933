"""ray_tpu_torch: the PyTorch + CUDA port of ray_tpu's compute path.

Plain tensor code is PyTorch; every Pallas kernel of ray_tpu on a ported
path is a kernel written by hand for NVIDIA Hopper (sm_90a) under
``ops/csrc``. The package imports neither JAX nor ray_tpu.

Entry points (``LLMEngine``, ``init_params``, ``forward``) take an explicit
``device`` that defaults to ``"cuda"`` and raise when no GPU is present;
pass ``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
