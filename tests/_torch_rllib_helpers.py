"""Helpers shared by the rllib parity tests of the port
(tests/test_torch_rllib_*.py): reference params, the whole-batch
comparison of runner outputs, and the runtime protocol over ray_tpu."""

import jax
import numpy as np

import ray_tpu
from ray_tpu.rllib import RLModuleSpec as JaxRLModuleSpec

SPEC = dict(obs_dim=4, num_actions=2, hiddens=(64, 64))
# Values of the module (logp, value, the truncation bonus) against JAX's:
# f32 through three layers summed in another order.
VALUE_TOL = 1e-5


def jax_params(seed, decisive=False, spec=SPEC):
    params = jax.tree.map(np.asarray, JaxRLModuleSpec(**spec).build().init(
        jax.random.key(seed)))
    if decisive:
        # Logit gaps of ~1e6: argmax(logits + Gumbel) is the argmax of
        # the logits in both packages (an f32 Gumbel draw lies in
        # [-4.5, 16.7]).
        params["pi"][-1] = {"w": params["pi"][-1]["w"] * 1e6,
                            "b": params["pi"][-1]["b"]}
    return params


def same(got: dict, want: dict, close=()):
    """Every field of ``got`` equal to ``want``'s (dtype and shape too),
    the fields in ``close`` within VALUE_TOL."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert g == w, k
        elif k in close:
            np.testing.assert_allclose(g, w, atol=VALUE_TOL, rtol=0,
                                       err_msg=k)
        else:
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                               w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


class RayTpuRuntime:
    """The runtime protocol (ray_tpu_torch/rllib/_runtime.py) over
    ray_tpu's actors and object store; every wait bounded at 60 s."""

    BOUND_S = 60.0

    def _bound(self, timeout):
        return self.BOUND_S if timeout is None else min(timeout,
                                                        self.BOUND_S)

    def remote(self, cls, num_cpus=1, resources=None):
        return ray_tpu.remote(cls).options(num_cpus=num_cpus,
                                           resources=resources).remote

    def put(self, value):
        return ray_tpu.put(value)

    def get(self, refs, timeout=None):
        return ray_tpu.get(refs, timeout=self._bound(timeout))

    def wait(self, refs, num_returns=1, timeout=None):
        return ray_tpu.wait(refs, num_returns=num_returns,
                            timeout=self._bound(timeout))

    def kill(self, handle):
        ray_tpu.kill(handle)
