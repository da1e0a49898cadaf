"""Checkpoint / resume (counterpart of `dgn_tpu/train/checkpoint.py`).

One snapshot per saved epoch: `ckpt_{epoch:06d}.npz` with every array of
the run's state, and a `.json` sidecar with the epoch, the array count
(`n_leaves`) and the plateau scheduler's state {lr, best, num_bad}, so a
resumed run continues the same lr trajectory.  The arrays are the model's
`state_dict()` in its order (parameters and batch-norm running stats),
then, per parameter in the optimizer's order, Adam's first and second
moments and its step count.  Writes are atomic (a temporary file, then
`os.replace`), and only the newest `keep` snapshots stay.

As in dgn_tpu, no random state is saved: a resumed run's dropout,
augmentation and train-loader shuffle streams start again from the seed
(in dgn_tpu the same holds for its loader's numpy shuffle).  A resumed run
therefore trains on other masks and another batch order than an
uninterrupted one would.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

_ADAM_KEYS = ("exp_avg", "exp_avg_sq", "step")


def _leaves(trainer) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every array a snapshot holds, in file order; a
    parameter without Adam state yet (no step taken) gets zero moments and
    step 0, which is the state Adam's first step starts from."""
    out = list(trainer.model.state_dict().items())
    params = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        st = trainer.optimizer.state.get(p, {})
        for key in _ADAM_KEYS:
            if key in st:
                t = st[key]
            elif key == "step":
                t = torch.tensor(0.0)
            else:
                t = torch.zeros_like(p)
            out.append((f"adam.{i}.{key}", t))
    return out


class Checkpointer:
    """Directory of ckpt_{epoch:06d}.npz(.json); keeps the newest `keep`
    and saves every `every`-th epoch."""

    def __init__(self, directory: str, keep: int = 3, every: int = 1):
        self.dir = directory
        self.keep = keep
        self.every = max(1, every)
        os.makedirs(directory, exist_ok=True)

    def _base(self, epoch: int) -> str:
        return os.path.join(self.dir, f"ckpt_{epoch:06d}")

    def save(self, epoch: int, trainer) -> Optional[str]:
        """Snapshot the trainer (model, Adam, scheduler) as of the end of
        `epoch`; returns the .npz path, or None when this epoch is skipped."""
        if epoch % self.every != 0:
            return None
        leaves = _leaves(trainer)
        arrays = {name: t.detach().cpu().numpy() for name, t in leaves}
        s = trainer.scheduler
        # json writes inf as the (python-readable) literal Infinity
        meta = {"epoch": int(epoch), "n_leaves": len(leaves),
                "scheduler": {"lr": s.lr, "best": float(s.best),
                              "num_bad": s.num_bad}}
        base = self._base(epoch)
        np.savez(base + ".tmp.npz", **arrays)
        os.replace(base + ".tmp.npz", base + ".npz")
        with open(base + ".tmp.json", "w") as f:
            json.dump(meta, f)
        os.replace(base + ".tmp.json", base + ".json")
        self._rotate()
        return base + ".npz"

    def _rotate(self) -> None:
        for ep in self.list()[:-self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(self._base(ep) + ext)
                except FileNotFoundError:
                    pass

    def list(self) -> List[int]:
        """Epochs with a complete snapshot (its sidecar written last)."""
        eps = []
        for fn in os.listdir(self.dir):
            if fn.startswith("ckpt_") and fn.endswith(".json") \
                    and fn[5:11].isdigit() and len(fn) == 16:
                eps.append(int(fn[5:11]))
        return sorted(eps)

    def latest_epoch(self) -> Optional[int]:
        snaps = self.list()
        return snaps[-1] if snaps else None

    def restore(self, trainer, epoch: Optional[int] = None) -> int:
        """Load the newest (or the given epoch's) snapshot into the trainer,
        onto the devices its model and optimizer live on, and restore its
        scheduler.  Raises ValueError when the snapshot's array count or an
        array's shape does not fit the trainer's model.  Returns the epoch
        to continue from."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        base = self._base(epoch)
        with open(base + ".json") as f:
            meta = json.load(f)
        leaves = _leaves(trainer)
        if meta["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} arrays, the trainer "
                f"expects {len(leaves)}: the architecture changed since the "
                "snapshot")
        with np.load(base + ".npz") as data:
            arrays = {}
            for i, (name, t) in enumerate(leaves):
                if name not in data.files:
                    raise ValueError(f"array {i} ({name}) is missing from "
                                     "the checkpoint")
                arr = data[name]
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(
                        f"array {i} ({name}): checkpoint shape "
                        f"{arr.shape} != the trainer's {tuple(t.shape)}")
                arrays[name] = torch.from_numpy(arr)
        model = trainer.model
        model.load_state_dict({k: arrays[k] for k in model.state_dict()})
        opt = trainer.optimizer
        state = {i: {key: arrays[f"adam.{i}.{key}"] for key in _ADAM_KEYS}
                 for i in range(sum(len(g["params"])
                                    for g in opt.param_groups))}
        # load_state_dict moves the moments onto each parameter's device
        # and keeps the step count where Adam keeps it
        opt.load_state_dict({"state": state,
                             "param_groups": opt.state_dict()["param_groups"]})
        # a captured train step reads the state tensors just replaced
        forget = getattr(trainer, "forget_step_graphs", None)
        if forget is not None:
            forget()
        s = meta["scheduler"]
        trainer.scheduler.lr = s["lr"]
        trainer.scheduler.best = float(s["best"])
        trainer.scheduler.num_bad = s["num_bad"]
        return meta["epoch"] + 1
