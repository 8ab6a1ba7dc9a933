"""The accelerator layer of the port: ``GPUAcceleratorManager``
(accelerator.py). ``tpu/slices.py`` of the reference (slice reservation
through the runtime's placement groups) is runtime code and not ported."""

from .accelerator import GPUAcceleratorManager

__all__ = ["GPUAcceleratorManager"]
