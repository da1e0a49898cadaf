"""The rank side of tests/test_torch_parallel.py: functions that spawned
ranks run (parallel/launch.spawn); it holds no test.  Imports torch and the
port only, never JAX or dgn_tpu, and runs torch on one thread.

Each job is a dict; `run_jobs` runs a list of them in one process group
and returns one result per job, so a test pays for one spawn."""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from dgn_tpu_torch import nn as tnn
from dgn_tpu_torch.convert import load_jax_params
from dgn_tpu_torch.models import MODEL_FACTORIES, DGNConfig
from dgn_tpu_torch.parallel import (DataParallelTrainer, StackedLoader,
                                    make_mesh)
from dgn_tpu_torch.train.trainer import TrainParams


def build(job, bn_axis="dp"):
    """The job's port model and loss, its weights dgn_tpu's (flax trees of
    numpy arrays)."""
    cfg = DGNConfig(**job["net"], bn_axis=bn_axis)
    model, loss = MODEL_FACTORIES[job["task"]](
        cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, job["params"], job["batch_stats"])
    return model, loss


def _state(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


class MissingCrossRankBackward:
    """A planted fault, standing in for nn._AllReduceSum: the sum over the
    ranks by a bare all_reduce, whose backward passes on this rank's
    cotangent alone and so loses the other ranks' batch-norm terms."""

    @staticmethod
    def apply(x, group):
        total = x.detach().clone()
        dist.all_reduce(total, group=group)
        return x + (total - x.detach())


def _step_job(job, mesh):
    """One DataParallelTrainer step on this rank's shard of super-batch
    job["batch"] of a StackedLoader; with job["fault"], sync batch norm's
    all-reduce is MissingCrossRankBackward for the step.  The gradients
    are taken where Adam takes them: averaged over the ranks, before the
    optimizer step."""
    model, loss_fn = build(job)
    trainer = DataParallelTrainer(model, loss_fn, TrainParams(**job["train"]),
                                  mesh, task=job["task"])
    loader = StackedLoader(job["graphs"], job["per_device"], mesh.size,
                           rank=mesh.rank, n_pad=job["n_pad"],
                           e_pad=job["e_pad"], layout=job["layout"])
    for i, gb in enumerate(loader):
        if i == job["batch"]:
            break
    grads = keep_grads(trainer)
    sound = tnn._AllReduceSum
    if job.get("fault"):
        tnn._AllReduceSum = MissingCrossRankBackward
    try:
        loss, scores = trainer.train_step(gb)
    finally:
        tnn._AllReduceSum = sound
    view, all_scores = trainer.gather_shards(gb, scores)
    return {"loss": float(loss), "state": _state(trainer.model),
            "grads": grads, "scores": all_scores,
            "view": {k: v.numpy() for k, v in vars(view).items()}}


def keep_grads(trainer) -> dict:
    """A dict that each train_step of trainer fills with {parameter name:
    gradient (numpy)} where Adam takes them: after _reduce_grads (the
    average over the ranks), before the optimizer step."""
    grads, reduce = {}, trainer._reduce_grads

    def reduce_and_keep():
        reduce()
        grads.update({k: p.grad.detach().cpu().numpy().copy()
                      for k, p in trainer.model.named_parameters()})

    trainer._reduce_grads = reduce_and_keep
    return grads


COLLECTIVES = ("all_reduce", "all_gather", "all_to_all_single", "broadcast")


@contextlib.contextmanager
def recording_collectives():
    """A list that collects, in order, every torch.distributed collective
    this rank issues inside the block: (name, reduce op, the shape, dtype
    and sum of the tensor the rank sends)."""
    calls, saved = [], {name: getattr(dist, name) for name in COLLECTIVES}

    def recorded(name, fn):
        def call(*args, **kwargs):
            sent = args[1] if name in ("all_gather", "all_to_all_single") \
                else args[0]
            calls.append((name, str(kwargs.get("op", "")), tuple(sent.shape),
                          str(sent.dtype), sent.detach().double().sum().item()))
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, recorded(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def serial_epoch(trainer, loader, train: bool):
    """The metrics of one train epoch (train) or evaluation of a rank
    trainer, from a loop that reads each step back before the next batch
    is packed: the data-parallel trainer's gather_shards, the
    edge-parallel one's loss view."""
    from dgn_tpu_torch.parallel import DataParallelTrainer
    from dgn_tpu_torch.train.trainer import _MetricAccumulator
    acc = _MetricAccumulator(trainer.task)
    for gb in loader:
        if train:
            loss, scores = trainer.train_step(gb)
        else:
            scores, loss = trainer.eval_step(gb)
        if isinstance(trainer, DataParallelTrainer):
            view, host = trainer.gather_shards(gb, scores)
        else:
            view, host = trainer._view, scores.cpu().numpy()
        acc.add(view, host, float(loss))
    return acc.result()


def piped_and_serial(make_trainer, loader):
    """One train_epoch (over loader(True)) and one evaluate (over
    loader(False)) of a rank trainer, and the same through serial_epoch on
    a second trainer made alike: each side's metrics and collectives, and
    the first's _last_throughput and trainer."""
    out = {}
    for side in ("piped", "serial"):
        trainer = make_trainer()
        for split, train in (("train", True), ("eval", False)):
            with recording_collectives() as calls:
                if side == "serial":
                    m = serial_epoch(trainer, loader(train), train)
                elif train:
                    m = trainer.train_epoch(loader(train))
                else:
                    m = trainer.evaluate(loader(train))
            out[side, split] = m
            out[side, split, "calls"] = calls
        if side == "piped":
            out["throughput"], first = trainer._last_throughput, trainer
    return first, out


def _epoch_job(job, mesh):
    """One train_epoch and one evaluate, each over a StackedLoader of
    job["graphs"] (the train one shuffled), and the same through
    serial_epoch (piped_and_serial)."""
    def make_trainer():
        model, loss_fn = build(job)
        return DataParallelTrainer(model, loss_fn,
                                   TrainParams(**job["train"]), mesh,
                                   task=job["task"])

    def loader(shuffle):
        return StackedLoader(job["graphs"], job["per_device"], mesh.size,
                             rank=mesh.rank, shuffle=shuffle,
                             seed=job["train"]["seed"], n_pad=job["n_pad"],
                             e_pad=job["e_pad"], layout=job["layout"])

    trainer, out = piped_and_serial(make_trainer, loader)
    return dict(out, train=out["piped", "train"], eval=out["piped", "eval"],
                state=_state(trainer.model))


JOBS = {"step": _step_job, "epoch": _epoch_job}


def run_jobs(rank: int, n: int, init_method: str, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=n,
                            rank=rank)
    try:
        mesh = make_mesh(n, device="cpu")
        return [JOBS[job["kind"]](job, mesh) for job in jobs]
    finally:
        dist.destroy_process_group()


def fail_or_hang(rank: int, n: int, init_method: str, mode: str):
    """Rank 1 raises ("fail") or sleeps past any deadline ("hang"); rank 0
    returns at once."""
    import time
    if rank == 1:
        if mode == "fail":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(600)
    return rank
