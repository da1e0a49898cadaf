"""Load the reference package's flax parameter trees into the port's modules.

`load_jax_params(model, params, batch_stats)` takes the trees as nested
dicts of numpy arrays, as `model.init(...)` of `dgn_tpu` gives them
(`layer_i/pretrans/FCLayer_0/kernel`, `layer_i/batchnorm_h/scale`,
`embedding_h/embedding`, `MLP_layer/Linear_j/kernel`, and batch_stats
`layer_i/batchnorm_h/{mean,var}`).  The port's modules carry the same names
and layouts (kernels [in, out]), so the mapping is by name: a torch entry
`a.b.c` reads the flax path `a/b/c`, where the reference's parameter-holder
level `FCLayer_0` has no torch counterpart.  Every entry must match in both
directions, with equal shapes, or this raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DROPPED = ("FCLayer_0",)


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax tree -> {"a/b/c": array}, FCLayer_0 levels dropped."""
    out = {}
    for k, v in tree.items():
        if k in _DROPPED:
            out.update(flatten(v, prefix))
        elif isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def flax_path(torch_name: str) -> str:
    """The port's parameter or buffer name -> its key in the flattened flax
    tree (FCLayer_0 levels dropped)."""
    return torch_name.replace(".", "/")


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping) -> None:
    """Copy flax params and batch_stats into `model` in place."""
    flat = {**flatten(params), **flatten(batch_stats)}
    state = model.state_dict()
    want = {flax_path(name): name for name in state}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing in flax {missing}, "
                       f"missing in torch {extra}")
    new = {}
    for path, name in want.items():
        value = flat[path]
        if tuple(value.shape) != tuple(state[name].shape):
            raise ValueError(f"{path}: flax shape {value.shape} != torch "
                             f"shape {tuple(state[name].shape)}")
        new[name] = torch.as_tensor(np.array(value, copy=True),
                                    dtype=state[name].dtype)
    model.load_state_dict(new)
