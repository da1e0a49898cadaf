"""Load the reference package's flax parameter trees into the port's modules.

`load_jax_params(model, params, batch_stats)` takes the trees as nested
dicts of numpy arrays, as `model.init(...)` of `dgn_tpu` gives them
(`layer_i/pretrans/FCLayer_0/kernel`, `layer_i/batchnorm_h/scale`,
`embedding_h/embedding`, the edge encoder's `embedding_e/embedding`,
`embedding_e/{kernel,bias}` or `embedding_e/bond/emb_i`,
`MLP_layer/Linear_j/kernel`, and batch_stats
`layer_i/batchnorm_h/{mean,var}`), or of dgn_tpu's COLLAB model
(train/link_pred.py: the same tree under `backbone/`, without MLP_layer,
beside `predictor/Linear_j/{kernel,bias}`), or of the dense path's
`DenseDGNLayer` and `DenseDGNTower` (`DenseDGNTower_t/MLP_0/...` for the
pretrans, `MLP_1` for the posttrans, the mixing `FCLayer_0`).  The port's
modules carry the same names
and layouts (kernels [in, out]), so the mapping is by name: a torch entry
`a.b.c` reads the flax path `a/b/c`.  One level has no torch counterpart:
the reference's LinearParams holds its kernel and bias in a child
`FCLayer_0` that is its only child, where the port's LinearParams holds
them itself.  So a `FCLayer_0` that is the only child of its parent and
holds exactly {kernel, bias} is dropped; one with siblings (an MLP's
`FCLayer_0`, `FCLayer_1`, ..., as a per-edge pretrans of 2 layers has) or
with other entries is kept.  A one-layer MLP (the per-edge pretrans at
pretrans_layers = 1) has the same sole `FCLayer_0` and maps onto the
port's LinearParams.  The same level is dropped from the port's names
(`flax_paths`), so a one-layer `nn.MLP` of the port (the dense tower's
MLP_0 and MLP_1) meets the flax one-layer MLP.  Every
entry must match in both directions, with equal shapes, or this raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_HOLDER = "FCLayer_0"


def flatten(tree: Mapping, prefix: str = "",
            leaf=np.asarray) -> Dict[str, np.ndarray]:
    """Nested flax tree -> {"a/b/c": leaf(array)}, LinearParams holder
    levels (a sole child FCLayer_0 of exactly {kernel, bias}) dropped."""
    out = {}
    for k, v in tree.items():
        if k == _HOLDER and len(tree) == 1 and isinstance(v, Mapping) \
                and set(v) == {"kernel", "bias"}:
            out.update(flatten(v, prefix, leaf))
        elif isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


def flax_path(torch_name: str) -> str:
    """The port's parameter or buffer name -> its flax path, before the
    holder level is dropped (flax_paths drops it)."""
    return torch_name.replace(".", "/")


def flax_paths(names) -> Dict[str, str]:
    """{torch name: key in the flattened flax tree} for the port's state
    names, with the holder level dropped as flatten drops it."""
    tree: Dict = {}
    for name in names:
        *parents, last = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = name
    return {name: path for path, name in
            flatten(tree, leaf=lambda v: v).items()}


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping) -> None:
    """Copy flax params and batch_stats into `model` in place."""
    flat = {**flatten(params), **flatten(batch_stats)}
    state = model.state_dict()
    want = {path: name for name, path in flax_paths(state).items()}
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
