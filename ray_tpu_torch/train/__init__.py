"""The port's Train layer: the process-group backend (backend.py) and the
flagship training loop (examples/transformer_example.py). The runtime's
trainer, controller and worker group are runtime code and not ported:
they host these classes by duck typing."""

from .backend import Backend, BackendConfig, TorchConfig

__all__ = ["Backend", "BackendConfig", "TorchConfig"]
