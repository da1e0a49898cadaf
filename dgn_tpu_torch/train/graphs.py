"""The single-device train step replayed from CUDA graphs.

On the block layout one train step of a DGN net is several hundred small
device operations, and issuing them from Python (the forward pass, the
autograd engine, Adam) takes the host far longer than the card takes to
run them.  The Trainer (train/trainer.py) therefore captures its step once
as three CUDA graphs in one memory pool, captured and replayed in this
order:

  forward    the forward pass and the loss, on the captured input batch;
  backward   loss.backward(), which writes the parameters' .grad tensors;
  optimizer  Adam's step (optim.adam_l2(graphed=True): capturable, its
             learning rate a device tensor that set_learning_rate fills).

Signature.  A batch's signature is the shape and dtype of every tensor of
its GraphBatch and of its MXULayout, the layout's integers (n_pairs,
n_node_blocks, n_graph_blocks, ...) and the edge context's family set (the
net's aggregators): a capture holds the kernels of one signature.  The
first step of a signature runs eagerly; the second is captured, then
replayed; every later step of it copies the host batch into the captured
input tensors (`copy_`) and replays.  A trainer holds one captured
signature, the loader's pads; a batch of any other (an escape repack) runs
eagerly.

Where.  The trainer builds the graphs where its steps draw no random
numbers (dropout and input dropout 0, no augmentation) and sum no
gradients over ranks (_reduce_grads not overridden); a step replays only a
single block-layout GraphBatch with no edge context or halo attached and no
augmentation draws handed in.  Every other step is eager.

Gradients.  The backward graph is captured with every .grad None, so the
captured backward writes new .grad tensors in the pool and each replay
overwrites them; replays never set them to None.  An eager step of a
trainer that holds graphs zeroes them in place and accumulates into them,
so they stay the tensors the captured Adam reads.

Counters (observe.py).  `step.graph_captures` and `step.graph_replays`
here, `step.eager` in the trainer's eager step.  The kernels' launch
counters count executions: a capture runs nothing, so what it added is
taken back, and each replay adds what its graph recorded.  The copies into
the captured inputs count in `h2d.copies` and `h2d.bytes`.

The graphs come from a factory, factory(kind) -> an object with
capture(fn, pool) -> pool and replay(): CudaGraph on a CUDA device; the
CPU tests hand in a stand-in that re-runs fn.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .. import observe
from ..graph import GraphBatch

KINDS = ("forward", "backward", "optimizer")


def signature(gb, families=()) -> Optional[tuple]:
    """The batch's signature (module docstring), or None where the batch
    cannot be replayed: a list of micro-batches, the flat layout, an edge
    context or a halo attached."""
    if not isinstance(gb, GraphBatch) or gb.mxu is None \
            or gb.edge_ctx is not None or gb.halo is not None:
        return None
    return (_shapes(gb, ("mxu", "edge_ctx", "halo")), _shapes(gb.mxu, ()),
            tuple(families))


def _shapes(obj, skip) -> tuple:
    """Each field's (shape, dtype) where it holds a tensor, else its
    value."""
    out = []
    for f in dataclasses.fields(obj):
        if f.name not in skip:
            v = getattr(obj, f.name)
            out.append((tuple(v.shape), v.dtype)
                       if isinstance(v, torch.Tensor) else v)
    return tuple(out)


class CudaGraph:
    """One torch.cuda.CUDAGraph: capture records fn's launches on torch's
    capture stream, replay launches them on the current stream."""

    def __init__(self, kind: str):
        # kind (one of KINDS) is the factory's argument; every graph of the
        # step is captured alike
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable[[], None], pool=None):
        """Capture fn, allocating from pool (a new one when None); returns
        the pool, for the next graph of the step."""
        with torch.cuda.graph(self.graph, pool=pool):
            fn()
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()


def default_factory(device) -> Optional[Callable[[str], object]]:
    """CudaGraph on a CUDA device; None (no graphs) elsewhere."""
    return CudaGraph if torch.device(device).type == "cuda" else None


class StepGraphs:
    """The captured step of one trainer: the signature it was captured for,
    its input batch on the device, its three graphs and what each
    launches, and the step's outputs (`out`: "loss" and "scores", rewritten
    by each replay of the forward graph)."""

    def __init__(self, factory: Callable[[str], object]):
        self.factory = factory
        self.seen = set()               # signatures stepped eagerly so far
        self.sig = None
        self.static: Optional[GraphBatch] = None
        self.graphs: Dict[str, object] = {}
        self.launches: Dict[str, Dict[str, int]] = {}
        self.out: Dict[str, torch.Tensor] = {}

    @property
    def held(self) -> bool:
        return self.sig is not None

    def route(self, sig) -> str:
        """"eager", "capture" or "replay" for a step of signature sig (None:
        a batch that cannot be replayed)."""
        if sig is None:
            return "eager"
        if self.held:
            return "replay" if sig == self.sig else "eager"
        if sig in self.seen:
            return "capture"
        self.seen.add(sig)
        return "eager"

    def capture(self, sig, static: GraphBatch,
                fns: Dict[str, Callable[[], None]]) -> None:
        """Capture fns[kind] for each of KINDS, in order, into one pool, for
        the batches of signature sig; static is the input batch on the
        device that fns read."""
        pool = None
        for kind in KINDS:
            before = observe.launch_counts()
            graph = self.factory(kind)
            pool = graph.capture(fns[kind], pool)
            recorded = {k: n - before[k]
                        for k, n in observe.launch_counts().items()
                        if n != before[k]}
            observe.add_launches({k: -n for k, n in recorded.items()})
            self.graphs[kind], self.launches[kind] = graph, recorded
        self.sig, self.static, self.seen = sig, static, set()
        observe.count("step.graph_captures")

    def load(self, gb: GraphBatch) -> None:
        """Copy the host batch gb into the captured input tensors."""
        for dst, src in ((self.static, gb), (self.static.mxu, gb.mxu)):
            for f in dataclasses.fields(src):
                v = getattr(src, f.name)
                if isinstance(v, torch.Tensor):
                    observe.copy_into(getattr(dst, f.name), v)

    def replay(self, kind: str) -> None:
        self.graphs[kind].replay()
        observe.add_launches(self.launches[kind])
