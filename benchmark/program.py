"""The program under test, set up as a user sets it up, for one cell and
one seed: the cell's inputs made from the seed, the config built through
dgn_tpu_torch.config from the cell's configuration and traffic files, the
program's precision settings, dgn_tpu_torch.run.prepare with
datasets.load_dataset handing it those inputs, the benchmark's weights
loaded into the model; then the warm-up epoch, whose first steps are the
ones the reference follows, and what the reference needs of them."""
from __future__ import annotations

import gc
import time

from . import counts
from .inputs import make_splits
from .window import Window, micro_batches, run_window

CHECKED_STEPS = 3


def build_config(cell, seed: int):
    from dgn_tpu_torch.config import load_config
    flags = dict(cell.traffic.get("flags", {}))
    flags["seed"] = seed
    return load_config(str(cell.config_file), flags)


def to_dataset(cell, splits):
    from dgn_tpu_torch.data.datasets import DatasetSplits
    from dgn_tpu_torch.graph import GraphData

    def conv(g):
        return GraphData(num_nodes=g.num_nodes, src=g.src, dst=g.dst,
                         node_feat=g.node_feat, eig=g.eig,
                         edge_feat=g.edge_feat, label=g.label)

    return DatasetSplits(cell.config["dataset"],
                         *[[conv(g) for g in splits[s]]
                           for s in ("train", "val", "test")],
                         meta=dict(cell.traffic["meta"]))


def prepare(cfg, ds, device: str):
    """The program's own set-up, with its dataset loader handing it ds."""
    from dgn_tpu_torch import run as entry
    from dgn_tpu_torch.data import datasets
    entry._precision()
    calls = []
    original = datasets.load_dataset

    def load(name, dp):
        calls.append(name)
        return ds

    datasets.load_dataset = load
    try:
        out = entry.prepare(cfg, device=device)
    finally:
        datasets.load_dataset = original
    if calls != [cfg.dataset]:
        raise RuntimeError("prepare did not take its data from "
                           f"datasets.load_dataset (calls: {calls})")
    return out


class FirstSteps:
    """trainer.train_step, recording the first n steps: each loss, the
    first gradient as Adam took it (exp_avg / (1 - beta1) after one step)
    and the parameters after the n-th step."""

    def __init__(self, trainer, n: int):
        self.trainer, self.n = trainer, n
        self.inner = trainer.train_step
        self.losses, self.grad, self.after = [], None, None

    def __call__(self, gb, aug=None):
        loss, scores = self.inner(gb, aug)
        k = len(self.losses)
        if k >= self.n:
            return loss, scores
        self.losses.append(float(loss))
        opt = self.trainer.optimizer
        named = list(self.trainer.model.named_parameters())
        if k == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            self.grad = {}
            for name, p in named:
                m = opt.state.get(p, {}).get("exp_avg")
                self.grad[name] = (p.new_zeros(p.shape).cpu() if m is None
                                   else (m / (1.0 - beta1)).cpu())
        if k == self.n - 1:
            self.after = {name: p.detach().cpu().clone() for name, p in named}
        return loss, scores


def dropout_pads(batches, sizes):
    """(n_pad, rows) of each packed batch: the padded node count, and the
    row of each real node, graph after graph in the batch's graph order,
    each graph's nodes in order.  For a batch of micro-batches (sizes: a
    tuple of their node-count lists) a tuple of those, one per
    micro-batch, in micro-batch order."""
    out = []
    for batch, want in zip(batches, sizes):
        if isinstance(want, tuple):
            parts = micro_batches(batch)
            if len(parts) != len(want):
                raise RuntimeError("the packed batch does not hold the "
                                   "loader's documented micro-batches")
            out.append(tuple(_pads(gb, w) for gb, w in zip(parts, want)))
        else:
            out.append(_pads(batch, want))
    return out


def _pads(gb, want):
    """(n_pad, rows) of one packed batch whose graphs hold want nodes."""
    import numpy as np
    import torch
    mask = gb.node_mask.numpy()
    graph = gb.node_graph.numpy()
    real = np.nonzero(mask)[0]
    rows = real[np.argsort(graph[real], kind="stable")]
    have = np.bincount(graph[real], minlength=len(want))[:len(want)]
    if have.tolist() != list(want):
        raise RuntimeError("the packed batch's graphs are not in the "
                           "loader's documented order")
    return len(mask), torch.as_tensor(rows, dtype=torch.int64)


def block_stats(batches):
    """(real edges, covered pairs) of each block-layout micro-batch (each
    forward pass builds the adjacency of its own)."""
    import numpy as np
    out = []
    for gb in (gb for b in batches for gb in micro_batches(b)):
        if gb.mxu is None:
            continue
        m = gb.edge_mask.numpy()
        s = gb.src.numpy()[m].astype(np.int64) // counts.TILE
        d = gb.dst.numpy()[m].astype(np.int64) // counts.TILE
        out.append((int(m.sum()), len(np.unique((d << 32) | s))))
    return out


def micro_batch_option(cell):
    """The configuration's micro_batches: the traffic's flag, else the
    configuration file's "data" block, else the program's default
    "auto"."""
    flags = cell.traffic.get("flags", {})
    if "micro_batches" in flags:
        return flags["micro_batches"]
    return cell.config.get("data", {}).get("micro_batches", "auto")


def effective(cell):
    """(net_params, params) of the configuration with the traffic's flags
    for those keys laid over them, as the program's config takes them."""
    flags = cell.traffic.get("flags", {})
    net = dict(cell.config["net_params"])
    params = dict(cell.config["params"])
    for k, v in flags.items():
        if k in net:
            net[k] = v
        elif k in params:
            params[k] = v
    return net, params


class CellRun:
    """One cell and seed set up on device."""

    def __init__(self, cell, seed: int, device: str, log=print):
        self.cell, self.seed, self.device, self.log = cell, seed, device, log
        self.net, self.params = effective(cell)
        t = time.perf_counter()
        self.splits = make_splits(cell.traffic["data"], seed)
        t = self._stage("inputs", t)
        from . import weights as W
        from .reference import dgn as ref_dgn
        from .reference import tasks as ref_tasks
        self.cfg = build_config(cell, seed)
        self.task = self.cfg.task
        ref_tasks.find(self.task)       # a task with no reference: refused
        _, self.model, _, self.trainer, loaders = prepare(
            self.cfg, to_dataset(cell, self.splits), device)
        self.loader = loaders["train"]
        t = self._stage("prepare", t)
        w0 = W.draw(ref_dgn.param_spec(self.net, self.task,
                                       cell.traffic["meta"]), seed, device)
        W.load_into(self.model, w0)
        self.w0 = {k: v.cpu() for k, v in w0.items()}
        self._stage("weights", t)
        self.first = self.warm = None

    def _stage(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.log(f"benchmark: set-up {name} {now - t:.3f} s")
        return now

    def warm_up(self) -> None:
        """One epoch, through train_epoch, recording the first steps."""
        t = time.perf_counter()
        self.first = FirstSteps(self.trainer, CHECKED_STEPS)
        self.trainer.train_step = self.first
        self.warm = Window()
        self.warm.keep_batches = CHECKED_STEPS
        run_window(self.trainer, self.loader, self.warm)
        del self.trainer.train_step
        if len(self.first.losses) < CHECKED_STEPS:
            raise RuntimeError("the warm-up epoch ran fewer steps than "
                               "are checked")
        self._stage("warm-up epoch", t)

    def readings(self) -> dict:
        """The program's: each checked step's loss, the first gradient as
        Adam took it, each parameter's change after the last step."""
        f = self.first
        return {"losses": f.losses, "grad": f.grad,
                "change": {k: f.after[k] - self.w0[k] for k in self.w0}}

    def reference_case(self) -> dict:
        """What the reference follows: the checked steps' graphs in the
        loader's documented order (each step's micro-batches, where the
        configuration has them), where dropout draws (n_pad, rows), the
        train split's mean log degree."""
        from .reference import dgn as ref_dgn
        from .reference import follow as ref_follow
        block = self.cfg.data.layout in ("auto", "mxu")
        graphs = ref_follow.first_batches(
            self.splits["train"], self.seed, self.params["batch_size"],
            CHECKED_STEPS, block, micro_batch_option(self.cell))

        def sizes(step):
            if isinstance(step, tuple):
                return tuple([g.num_nodes for g in p] for p in step)
            return [g.num_nodes for g in step]

        pads = None
        if self.net.get("dropout", 0.0) > 0:
            pads = dropout_pads(self.warm.batches, [sizes(b) for b in graphs])
        return {"batches": graphs, "pads": pads,
                "avg_log": ref_dgn.avg_log_degree(self.splits["train"])}

    def follow(self, case: dict, **kw) -> dict:
        from .reference import follow as ref_follow
        return ref_follow.follow(case["batches"], self.w0, self.net,
                                 self.task, self.params, case["avg_log"],
                                 self.device, pads=case["pads"],
                                 seed=self.seed, **kw)

    def free(self) -> None:
        """Drop the program's model, optimizer and loaders."""
        import torch
        self.model = self.trainer = self.loader = self.first = None
        if self.warm is not None:
            self.warm.batches = []
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
