"""The rank side of tests/test_torch_halo.py: functions that spawned ranks
run (parallel/launch.spawn); it holds no test.  Imports torch and the port
only, never JAX or dgn_tpu, and runs torch on one thread.

Each job is a dict; `run_jobs` runs a list of them in one process group
and returns one result per job, so the tests pay for one spawn."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.convert import load_jax_params
from dgn_tpu_torch.models import MODEL_FACTORIES, DGNConfig
from dgn_tpu_torch.parallel import (EdgeParallelTrainer, PartitionedLoader,
                                    make_mesh, partition_batch)
from dgn_tpu_torch.train.trainer import TrainParams

from test_torch_parallel_ranks import piped_and_serial


def build(job, bn_axis="ep"):
    """The job's port model and loss, its weights dgn_tpu's (flax trees of
    numpy arrays)."""
    cfg = DGNConfig(**job["net"], bn_axis=bn_axis)
    classes = (job["n_classes"],) if job["task"] == "sbm" else ()
    model, loss = MODEL_FACTORIES[job["task"]](
        cfg, *classes, torch.Generator().manual_seed(0))
    load_jax_params(model, job["params"], job["batch_stats"])
    return model, loss


def keep_grads(trainer) -> dict:
    """A dict that each train_step of trainer fills with {parameter name:
    gradient (numpy)} where Adam takes them: after _reduce_grads (the sum
    over the ranks), before the optimizer step."""
    grads, reduce = {}, trainer._reduce_grads

    def reduce_and_keep():
        reduce()
        grads.update({k: p.grad.detach().cpu().numpy().copy()
                      for k, p in trainer.model.named_parameters()})

    trainer._reduce_grads = reduce_and_keep
    return grads


class MissingExchangeBackward(torch.autograd.Function):
    """A planted fault, standing in for graph._AllToAll: the same exchange
    forward, but a backward that keeps each halo row's cotangent on the
    rank that read it instead of sending it back to the row's owner."""

    @staticmethod
    def forward(ctx, x, group):
        return tgraph.exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _trainer(job, mesh):
    model, loss_fn = build(job)
    return EdgeParallelTrainer(model, loss_fn, TrainParams(**job["train"]),
                               mesh, task=job["task"])


def _step_job(job, mesh):
    """This rank's shard of job["graphs"]: the eval forward (running
    statistics), then one train step, whose gradients are kept where Adam
    takes them.  With job["fault"] the halo exchange is
    MissingExchangeBackward for the step."""
    trainer = _trainer(job, mesh)
    gb = partition_batch(job["graphs"], mesh.size, mesh.rank,
                         g_pad=job["g_pad"], layout=job["layout"])
    eval_scores, eval_loss = trainer.eval_step(gb)
    grads = keep_grads(trainer)
    sound = tgraph._AllToAll
    if job.get("fault"):
        tgraph._AllToAll = MissingExchangeBackward
    try:
        loss, scores = trainer.train_step(gb)
    finally:
        tgraph._AllToAll = sound
    return {"loss": float(loss), "scores": scores.numpy(), "grads": grads,
            "eval_loss": float(eval_loss), "eval_scores": eval_scores.numpy()}


def _exchange_job(job, mesh):
    """The boundary-only exchange against the all-gather fallback on this
    rank's shard of job["graphs"]: the refreshed rows, and the gradients
    that flow back to the own rows of one random cotangent, both ways, on
    the rows an edge reads.  The pad halo slots, which no edge reads, are
    left out: the two routes fill them from different rows."""
    gb = partition_batch(job["graphs"], mesh.size, mesh.rank,
                         layout=job["layout"])
    spec = gb.halo
    src = gb.src[gb.edge_mask]
    n_halo = int(torch.unique(src[src >= spec.n_local]).numel())
    rng = np.random.default_rng(100 + mesh.rank)
    h = torch.tensor(rng.normal(size=(gb.num_nodes_padded, 5)),
                     dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(gb.num_nodes_padded, 5)),
                     dtype=torch.float32)
    w[spec.n_local + n_halo:] = 0.0
    out = {}
    for name, s in (("plan", spec), ("gather", tgraph.HaloSpec(
            spec.halo_shard, spec.halo_local, n_local=spec.n_local))):
        x = h.clone().requires_grad_()
        y = tgraph.halo_refresh(x, s)
        (w * y).sum().backward()
        out[name] = (y.detach().numpy()[:spec.n_local + n_halo],
                     x.grad.numpy())
    return {"rows": out, "owners": sorted(set(
        spec.halo_shard[:n_halo].tolist())),
        "s_max": int(spec.send_idx.shape[1]), "n_local": spec.n_local}


def _epoch_job(job, mesh):
    """One train_epoch over a shuffled PartitionedLoader and one evaluate
    over a fixed one, and the same through serial_epoch
    (test_torch_parallel_ranks.piped_and_serial)."""
    def loader(shuffle):
        return PartitionedLoader(job["graphs"], job["batch_size"], mesh.size,
                                 rank=mesh.rank, shuffle=shuffle,
                                 seed=job["train"]["seed"],
                                 layout=job["layout"])

    _, out = piped_and_serial(lambda: _trainer(job, mesh), loader)
    return dict(out, train=out["piped", "train"], eval=out["piped", "eval"])


JOBS = {"step": _step_job, "exchange": _exchange_job, "epoch": _epoch_job}


def run_jobs(rank: int, n: int, init_method: str, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=n,
                            rank=rank)
    try:
        mesh = make_mesh(n, device="cpu")
        return [JOBS[job["kind"]](job, mesh) for job in jobs]
    finally:
        dist.destroy_process_group()
