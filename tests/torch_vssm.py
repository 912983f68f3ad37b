"""JAX params for the port's CPU parity tests of the classifier, the SS2D
options and the FLOP counters, made from a seeded port init.

A jitted JAX init of a small VSSM costs 6-8 s of compile and an eager one
~40 s, so the JAX side takes the port's weights instead: ``jax.eval_shape``
of the JAX init gives its tree, and ``flax_params_to_state_dict`` of a tree
whose leaves hold their own element indices says where each torch element
comes from. The two trees must name the same elements one to one, so this
also holds the converter's map for every module it meets."""

import numpy as np

import jax

import torch

from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.models import init_parameters

# fp32: the same maths in other orders (tests/test_torch_model.py).
FP32_REL = 1e-4


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def port_init(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    init_parameters(module, torch.Generator().manual_seed(seed))
    return module.eval()


def jax_params_from_port(jax_module, init_args, port_module) -> dict:
    """The JAX module's params tree with ``port_module``'s weights."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *init_args)["params"]
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    sizes = [int(np.prod(s.shape)) for s in leaves]
    if sum(sizes) >= 2**24:  # indices ride through float32
        raise ValueError("too many parameters to index in float32")
    starts = np.cumsum([0] + sizes)
    index_tree = jax.tree_util.tree_unflatten(treedef, [
        np.arange(a, a + n, dtype=np.float32).reshape(s.shape)
        for a, n, s in zip(starts, sizes, leaves)])
    where = flax_params_to_state_dict(index_tree)
    state = port_module.state_dict()
    if set(where) != set(state):
        raise KeyError(f"trees differ: only JAX {sorted(set(where) - set(state))}, "
                       f"only port {sorted(set(state) - set(where))}")
    flat = np.full(int(starts[-1]), np.nan, np.float32)
    for key, idx in where.items():
        if idx.shape != state[key].shape:
            raise ValueError(f"{key}: JAX {tuple(idx.shape)} vs port {tuple(state[key].shape)}")
        flat[idx.numpy().astype(np.int64).ravel()] = state[key].numpy().ravel()
    if np.isnan(flat).any():
        raise ValueError("some JAX parameters have no port counterpart")
    return jax.tree_util.tree_unflatten(treedef, [
        flat[a:a + n].reshape(s.shape) for a, n, s in zip(starts, sizes, leaves)])
