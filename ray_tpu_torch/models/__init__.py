"""Model zoo of the port: the Llama-style decoder (transformer.py) and its
training step, on one device or a dp x fsdp x tp mesh (train_step.py)."""

from .train_step import (TrainStepBundle, from_jax_state, make_eval_step,
                         make_optimizer, make_train_step)
from .transformer import (PRESETS, TransformerConfig, forward,
                          from_jax_params, init_params, loss_fn)

__all__ = ["PRESETS", "TransformerConfig", "forward", "from_jax_params",
           "init_params", "loss_fn", "TrainStepBundle", "from_jax_state",
           "make_eval_step", "make_optimizer", "make_train_step"]
