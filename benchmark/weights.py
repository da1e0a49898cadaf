"""Initial weights drawn from the seed: one torch.rand call on the device
for every parameter together, then each leaf mapped to its range by the
last part of its name: a kernel [in, out] U(+-1/sqrt(in)), an embedding
table U(+-sqrt(3)) (unit variance), a batch-norm scale 1 + U(+-0.1), any
other vector (biases) U(+-0.1).  No leaf is constant, so every one moves
in training.  Both sides get these same tensors."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def draw(spec: List[Tuple[str, tuple]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    sizes = [math.prod(shape) for _, shape in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape), n in zip(spec, sizes):
        x = u[at:at + n].reshape(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            x = x / math.sqrt(shape[0])
        elif leaf == "embedding":
            x = x * math.sqrt(3.0)
        elif leaf == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def load_into(model: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    """Copy w into the model's parameters; the names and shapes must be
    exactly the model's."""
    params = dict(model.named_parameters())
    if set(params) != set(w):
        raise ValueError("the model's parameters are not the reference's: "
                         f"only in the model {sorted(set(params) - set(w))}, "
                         f"only in the reference {sorted(set(w) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(w[name].shape):
                raise ValueError(f"{name}: the model's shape {tuple(p.shape)} "
                                 f"is not {tuple(w[name].shape)}")
            p.copy_(w[name])
