"""The port's abstract states and inputs (``repro_torch.launch.specs``)
against the JAX package's ``jax.eval_shape`` trees.

For every registered arch and the four shapes: ``shape_applicable``
equals the reference's, and ``abstract_params``, ``abstract_train_state``
and ``input_specs`` have the reference's keys and, leaf by leaf, its
shapes and dtypes, all on the meta device (no storage).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.launch import specs as jspecs
from repro.optim import ec4t as jec4t
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import specs as tspecs
from repro_torch.optim import ec4t as tec4t


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _port_leaf(leaf):
    assert isinstance(leaf, torch.Tensor) and leaf.device.type == "meta"
    return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")


def _ref_leaf(leaf):
    return tuple(leaf.shape), str(np.dtype(leaf.dtype))


def _same(ref_tree, port_tree):
    ref, port = dict(_flat(ref_tree)), dict(_flat(port_tree))
    assert sorted(ref) == sorted(port)
    diff = {k: (_ref_leaf(ref[k]), _port_leaf(port[k])) for k in ref
            if _ref_leaf(ref[k]) != _port_leaf(port[k])}
    assert diff == {}
    return len(ref)


@pytest.mark.parametrize("arch", list_configs())
def test_abstract_trees_match_reference(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jparams = jspecs.abstract_params(jcfg)
    tparams = tspecs.abstract_params(tcfg)
    assert _same(jparams, tparams) > 0
    # the reference's abstract_train_state, from the params just built
    _same(jax.eval_shape(jec4t.init_train_state, jparams),
          tec4t.init_train_state(tparams))
    for shape in jspecs.SHAPES:
        assert tspecs.shape_applicable(tcfg, shape) == \
            jspecs.shape_applicable(jcfg, shape)
        _same(jspecs.input_specs(jcfg, shape),
              tspecs.input_specs(tcfg, shape))


def test_shapes_are_the_references():
    assert tspecs.SHAPES == jspecs.SHAPES


def test_abstract_train_state_allocates_nothing():
    state = tspecs.abstract_train_state(tget_config("smollm-360m"))
    leaves = [t for _, t in _flat(state)]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 1e9      # params, m and v


def test_abstract_keeps_shapes_and_dtypes():
    tree = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": (torch.ones(2, dtype=torch.int32), 5)}
    out = tspecs.abstract(tree)
    assert out["a"].device.type == "meta"
    assert (out["a"].shape, out["a"].dtype) == ((3, 4), torch.bfloat16)
    assert out["b"][0].dtype == torch.int32 and out["b"][1] == 5
