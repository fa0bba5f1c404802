"""pysfm_tpu.utils.struct: frozen dataclasses registered as pytrees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysfm_tpu import dist
from pysfm_tpu.pipeline import synthetic
from pysfm_tpu.problem import cm
from pysfm_tpu.solver.lm import LMStats, _CMState
from pysfm_tpu.utils import struct


def _problem():
    return synthetic.make_scene(3, 20, noise_px=0.5, seed=0).problem


def _stats():
    z = jnp.zeros(3)
    return LMStats(
        costs=z, lams=z, accepted=z > 0, grad_inf=z, step_norms=z,
        n_iters=jnp.asarray(0), lam_next=z[0], nu_next=z[0],
        cg_iters=jnp.zeros(3, jnp.int32), dc_next=jnp.zeros((3, 6)),
    )


BUILDERS = {
    "BundleProblem": _problem,
    "CMProblem": lambda: cm.from_problem(_problem()),
    "ShardedProblem": lambda: dist.shard_problem(_problem(), 2),
    "ShardedCMProblem": lambda: dist.shard_cm_problem(
        cm.from_problem(_problem()), 2
    ),
    "LMStats": _stats,
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_flatten_unflatten_roundtrip(name):
    obj = BUILDERS[name]()
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    data = [
        f.name for f in dataclasses.fields(obj)
        if f.metadata.get("pytree_node", True)
    ]
    # One leaf per array field, in declaration order.
    assert len(leaves) == len(data)
    for leaf, field_name in zip(leaves, data):
        assert leaf is getattr(obj, field_name)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for f in dataclasses.fields(obj):
        assert getattr(back, f.name) is getattr(obj, f.name)


def test_static_fields_live_in_the_treedef():
    p = _problem()
    q = p.replace(robust="huber")
    leaves_p, tree_p = jax.tree_util.tree_flatten(p)
    leaves_q, tree_q = jax.tree_util.tree_flatten(q)
    assert "gaussian" not in [str(x) for x in leaves_p]
    assert tree_p != tree_q
    assert jax.tree_util.tree_unflatten(tree_q, leaves_p).robust == "huber"


def test_replace_is_a_copy_and_instances_are_frozen():
    p = _problem()
    X2 = p.X + 1.0
    q = p.replace(X=X2)
    assert q.X is X2 and p.X is not X2 and q.R is p.R
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.X = X2


def test_static_field_change_retraces():
    traces = []

    @jax.jit
    def cost(p):
        traces.append(p.robust)
        return jnp.sum(p.X)

    p = _problem()
    cost(p)
    cost(p.replace(X=p.X * 2.0))            # same structure: no retrace
    cost(p.replace(robust="cauchy"))        # static change: retrace
    assert traces == ["gaussian", "cauchy"]


def test_pytreenode_subclass_is_a_registered_dataclass():
    class Node(struct.PyTreeNode):
        a: jnp.ndarray
        tag: str = struct.field(pytree_node=False, default="x")

    n = Node(a=jnp.ones(2))
    assert dataclasses.is_dataclass(Node)
    assert jax.tree_util.tree_leaves(n)[0] is n.a
    doubled = jax.tree_util.tree_map(lambda v: 2 * v, n)
    assert doubled.tag == "x"
    np.testing.assert_array_equal(np.asarray(doubled.a), [2.0, 2.0])
    fields = [f.name for f in dataclasses.fields(_CMState)]
    assert fields[:2] == ["prob", "lam"] and fields[-1] == "eqs"
