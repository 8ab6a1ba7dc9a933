"""Model zoo of the port: the Llama-style decoder (transformer.py) and its
training step, on one device or a pp x dp x fsdp x tp mesh
(train_step.py), and the Mixture-of-Experts layer with expert parallelism
(moe.py)."""

from .moe import (MoEConfig, init_moe_params, moe_layer, moe_logical_axes,
                  moe_params_from_jax, moe_rows)
from .train_step import (TrainStepBundle, from_jax_state, make_eval_step,
                         make_optimizer, make_train_step)
from .transformer import (PRESETS, TransformerConfig, forward,
                          from_jax_params, init_params, loss_fn)

__all__ = ["PRESETS", "TransformerConfig", "forward", "from_jax_params",
           "init_params", "loss_fn", "TrainStepBundle", "from_jax_state",
           "make_eval_step", "make_optimizer", "make_train_step",
           "MoEConfig", "init_moe_params", "moe_layer", "moe_logical_axes",
           "moe_params_from_jax", "moe_rows"]
