"""The free-standing ring and Ulysses attention on meshes over several
processes (gloo ranks on the CPU) against the JAX package's ``shard_map``
programs.

Each mesh spans a gloo world of spawned processes formed by the port's
Train backend: sp=2 and sp=4 (one shard a rank, and two on two ranks),
dp=2 x sp=2 (the batch over ``batch_axes``) and sp=2 x tp=2 (the heads
over ``heads_axis``), on four ranks and on two. Every rank passes the
whole q, k and v and gets back its box of pieces; the parent joins the
boxes and runs JAX's ``ring_attention``/``ulysses_attention`` on the same
``MeshSpec`` of the conftest's CPU devices with the same seeded numpy
inputs. The gradient is that of sum(out * w) for a seeded cotangent w,
each rank taking its box of w; the ranks' input gradients (disjoint
boxes) are summed and held against ``jax.grad``'s. f32 throughout, 1e-4,
the bound of ``tests/test_torch_ring_attention.py``.

The spawned ranks import this module, so it imports JAX and the JAX
package only inside fixtures.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention
from ray_tpu_torch.parallel import AXES, MeshSpec, build_mesh
from test_torch_collective import spawn_ranks

TOL = dict(rtol=1e-4, atol=1e-4)
# name: (mesh, world)
RUNS = {"sp2": (dict(sp=2), 2), "sp4": (dict(sp=4), 4),
        "sp4-2ranks": (dict(sp=4), 2), "dp2xsp2": (dict(dp=2, sp=2), 4),
        "dp2xsp2-2ranks": (dict(dp=2, sp=2), 2),
        "sp2xtp2": (dict(sp=2, tp=2), 4),
        "sp2xtp2-2ranks": (dict(sp=2, tp=2), 2)}
NAMES = list(RUNS)
SHAPE = dict(B=2, S=32, Hq=8, Hkv=4, D=16)
STRATEGIES = ("ring", "ulysses")


def _inputs(seed=0):
    """q, k, v and the cotangent w, seeded numpy f32."""
    rng = np.random.default_rng(seed)
    B, S, Hq, Hkv, D = (SHAPE[k] for k in ("B", "S", "Hq", "Hkv", "D"))
    return (rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hq, D)).astype(np.float32))


def _box(mesh, positions):
    """The (rows, sequence, query heads) slices of ``positions``' pieces
    under the default ``batch_axes`` (dp, fsdp) and ``heads_axis`` (tp)."""
    shape = mesh.shape
    nb = shape["dp"] * shape["fsdp"]
    B, S, Hq = SHAPE["B"], SHAPE["S"], SHAPE["Hq"]
    at = [dict(zip(AXES, mesh.coords()[i])) for i in positions]
    bs = [c["dp"] * shape["fsdp"] + c["fsdp"] for c in at]
    js, hs = [c["sp"] for c in at], [c["tp"] for c in at]

    def run(idx, total, n):
        return slice(min(idx) * total // n, (max(idx) + 1) * total // n)
    return (run(bs, B, nb), run(js, S, shape["sp"]),
            run(hs, Hq, shape["tp"]))


def _ranks(rank, world, names):
    """Each layout of ``names`` under ring and Ulysses: this rank's box,
    its output and the gradients of its share of sum(out * w)."""
    q, k, v, w = _inputs()
    out = {}
    for name in names:
        mesh = build_mesh(MeshSpec(**RUNS[name][0]))
        box = _box(mesh, mesh.local_positions())
        kv_box = box[:2] + (slice(box[2].start * SHAPE["Hkv"] // SHAPE["Hq"],
                                  box[2].stop * SHAPE["Hkv"] // SHAPE["Hq"]),)
        for strategy in STRATEGIES:
            fn = ring_attention if strategy == "ring" else ulysses_attention
            ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
            o = fn(*ts, mesh)
            (o * torch.from_numpy(w[box])).sum().backward()
            out[name, strategy] = dict(
                box=box, kv_box=kv_box, out=o.detach().numpy(),
                grads=[t.grad.numpy() for t in ts])
    if world == 4:
        # Ulysses over sp=4 with 2 kv heads: every rank refuses before any
        # exchange.
        t = torch.from_numpy(q)
        try:
            ulysses_attention(t, t[:, :, :2], t[:, :, :2],
                              build_mesh(MeshSpec(sp=4)))
        except ValueError as e:
            out["raised"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: every rank's results}, one spawn per world."""
    return {world: spawn_ranks(
        _ranks, world, tmp_path_factory.mktemp(f"world{world}"),
        [n for n in NAMES if RUNS[n][1] == world])
        for world in sorted({w for _, w in RUNS.values()})}


@pytest.fixture(scope="module")
def jax_side():
    """{(name, strategy): (out, (dq, dk, dv))} from JAX's shard_map
    programs on the same meshes of the conftest's CPU devices."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops import ring_attention as jax_ring
    from ray_tpu.ops import ulysses_attention as jax_ulysses
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    q, k, v, w = map(jnp.asarray, _inputs())
    out = {}
    for spec in {tuple(sorted(s.items())) for s, _ in RUNS.values()}:
        spec = dict(spec)
        jmesh = jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[
            :MeshSpec(**spec).n_devices])
        for strategy in STRATEGIES:
            fn = jax_ring if strategy == "ring" else jax_ulysses

            @jax.jit
            def run(q, k, v, fn=fn, jmesh=jmesh):
                o, back = jax.vjp(lambda *a: fn(*a, jmesh), q, k, v)
                return o, back(w)
            o, grads = run(q, k, v)
            for name in NAMES:
                if RUNS[name][0] == spec:
                    out[name, strategy] = (np.asarray(o),
                                           [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_rank_pieces_match_jax(name, strategy, ranks, jax_side):
    """The ranks' boxes tile the output, each equal to JAX's there."""
    got = [r[name, strategy] for r in ranks[RUNS[name][1]]]
    want, _ = jax_side[name, strategy]
    covered = np.zeros(want.shape, bool)
    for g in got:
        assert g["out"].shape == want[g["box"]].shape
        np.testing.assert_allclose(g["out"], want[g["box"]], **TOL)
        covered[g["box"]] = True
    assert covered.all()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_rank_gradients_sum_to_jax(name, strategy, ranks, jax_side):
    """Each rank's input gradients are its share of sum(out * w): nonzero
    only in its box of the sequence and batch, and summed over the ranks
    they are JAX's."""
    got = [r[name, strategy] for r in ranks[RUNS[name][1]]]
    _, want = jax_side[name, strategy]
    for x, jgrad in enumerate(want):
        total = sum(g["grads"][x] for g in got)
        np.testing.assert_allclose(total, jgrad, **TOL)
        for g in got:
            box = g["box"] if x == 0 else g["kv_box"]
            outside = g["grads"][x].copy()
            outside[box] = 0
            assert not outside.any()


def test_ulysses_across_ranks_needs_heads_divisible_by_sp(ranks):
    """As in one process and in JAX: head counts must divide by the sp
    size."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops import ulysses_attention as jax_ulysses
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    for r in ranks[4]:
        assert "divisible by the sp size 4" in r["raised"]
    q = jnp.zeros((1, 32, 8, 16))
    with pytest.raises(Exception):
        jax_ulysses(q, q[:, :, :2], q[:, :, :2], jax_build_mesh(
            JaxMeshSpec(sp=4), devices=jax.devices()[:4]))
