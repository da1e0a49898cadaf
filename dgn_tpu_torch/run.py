"""Experiment entry point: `python -m dgn_tpu_torch.run --config ... [flags]`.

Counterpart of `dgn_tpu/run.py` for what this package covers: the ZINC,
SBM, superpixel, HIV and PCBA tasks on the block layout (`--layout mxu`,
or `auto`) or the flat one (`--layout flat`), and COLLAB link prediction,
one device.  Pipeline: config (JSON + CLI overlay) -> dataset (synthetic
when no data_dir) -> avg_d degree stats over train -> per-task derived
config -> model -> Trainer (Adam + ReduceLROnPlateau, seeded) -> epoch loop
with val/test eval, min-lr and max_time stops -> final report (MAE for
ZINC, accuracy for SBM and superpixels, ROC-AUC for HIV, AP for PCBA).  A
batch above 1024 graphs runs as micro-batches (`resolve_micro_batches`),
as the PCBA config's 2048 does; `--n_buckets K` batches by size bucket
(data/loader.py BucketedLoader).  `--data_dir` reads the reference's
dataset files (docs/DATA.md), `--cache_dir` keeps their eigenvectors on
disk.  `--dataset COLLAB` takes `run_collab`:
one graph packed flat once, LinkPredTrainer, Hits@K (without the recipe
flags below, as in dgn_tpu).

The training recipe of dgn_tpu/run.py:224-347:
  * `run_one` trains one seed and writes `out_dir/metrics.jsonl` (one
    "epoch" record per epoch, observe.MetricStream);
  * `--checkpoint DIR` snapshots the trainer after every epoch
    (train/checkpoint.py), and with `--resume` the run restores the newest
    snapshot there and continues after its epoch;
  * `--seeds 41,42,...` (`run_seeds`) runs `run_one` once per seed, each in
    `out_dir/seed<s>` and `DIR/seed<s>`, and prints the reference's table
    row: `TEST <METRIC>: mean ± std (n/N seeds)` (np.std) and a
    `[dgn_tpu_torch] SEEDS {...}` line;
  * `--trace_spans` turns the span recorder of observe.py on for the run,
    and each epoch record then carries the train epoch's spans and
    counters per step (`spans`), which tools/report.py prints.
`--compute_dtype bfloat16` or `float16` runs the block layout's edge stage
on operands rounded to that dtype with float32 accumulation, as dgn_tpu
does (models/dgn_net.py).

Data parallelism (dgn_tpu/run.py:113-145,236-247; parallel/): `--n_devices
N` (N > 1) spawns N ranks on this host, rank r on `cuda:r` over NCCL, or N
gloo ranks on the CPU with `--device cpu`; fewer visible GPUs than N is an
error, never a fall-back to the CPU.  `--multihost` makes this process one
rank of a world that other processes join (parallel/mesh.init_multihost).
Each rank runs `prepare`'s dp branch: batch norm synced over the ranks
(bn_axis "dp"), shards of max(batch_size // N, 1) graphs at pads for that
shard size, a StackedLoader per split, a DataParallelTrainer; as in
dgn_tpu, micro-batches and `--n_buckets` do not apply there.  Rank 0 alone
prints, writes metrics.jsonl and saves checkpoints; every rank restores.
`--partition ep` (edge parallelism, dgn_tpu/run.py:113-126) takes the same
ranks through `prepare`'s ep branch instead: batch norm synced over the
ranks (bn_axis "ep"), every batch of batch_size graphs cut across the
ranks (parallel/halo.py PartitionedLoader: this rank's nodes, the edges
into them and a halo), an EdgeParallelTrainer.  With one device
(`--n_devices 1`, the default) `--partition ep` trains on one device as
dgn_tpu does; as one rank of a mesh (`--multihost`, or a mesh handed to
`_run_rank`) it runs the ep branch at any rank count, one included.

The model runs on the GPU (`--device cuda`, the default) unless the caller
asks for the CPU (`--device cpu`); without a GPU and without that request
the run stops with an error instead of running on the CPU.  At start the run
turns TF32 off for matmuls and convolutions
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False) and reduced-precision reductions off for bfloat16 and float16
matmuls (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
= allow_fp16_reduced_precision_reduction = False): the reference
accumulates in float32, and so does this port.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch


def resolve_device(device: str) -> torch.device:
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dgn_tpu_torch.run: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return torch.device(device)


def resolve_micro_batches(micro_batches, batch_size: int) -> int:
    """The micro-batch count of a step, as dgn_tpu/run.py:147-149 resolves
    it: "auto" keeps each packed unit at 1024 graphs or fewer."""
    if str(micro_batches) == "auto":
        return max(1, -(-batch_size // 1024))
    return max(1, int(micro_batches))


def resolve_layout(layout: str) -> str:
    """'auto' -> the block layout, as dgn_tpu/run.py:47-58 resolves it."""
    return "mxu" if layout == "auto" else layout


def pad_geometry(graphs, batch_size: int, layout: str = "flat"):
    """Static (n_pad, e_pad) any batch_size subset fits under the layout:
    the sum of the largest graphs (graph.bucket_sizes_for), or the block
    layout's placement estimate (graph.mxu_bucket_sizes)."""
    from .graph import bucket_sizes_for, mxu_bucket_sizes
    if layout == "mxu":
        return mxu_bucket_sizes(graphs, batch_size)[:2]
    return bucket_sizes_for(graphs, batch_size)


def check_ported(cfg) -> None:
    """Raise ValueError for run options the port does not know."""
    cfg.net_params.torch_compute_dtype()     # a compute_dtype it knows


def pos_enc_width(np_cfg, graph) -> Optional[int]:
    """The width of the positional encoding the model gets: the graph's
    stored pos_enc (ZINC), else the columns 1..P of its eig, of which there
    are min(P, k_eig - 1); None without one."""
    if np_cfg.pos_enc_dim <= 0:
        return None
    if graph.pos_enc is not None:
        return graph.pos_enc.shape[1]
    return min(np_cfg.pos_enc_dim, graph.eig.shape[1] - 1)


def build_model(task: str, np_cfg, ds, generator: torch.Generator):
    """(model, loss) from the task's factory for the dataset ds, with the
    arguments the task takes from its meta (train/tasks.py: SBM's and
    superpixels' class counts, superpixels' float node and edge feature
    widths), and the positional encoding its width from its first train
    graph."""
    from .models import MODEL_FACTORIES
    from .train import tasks
    args, kwargs = tasks.get(task).model_args(ds.meta)
    pe = pos_enc_width(np_cfg, ds.train[0])
    return MODEL_FACTORIES[task](np_cfg, *args, generator, pos_enc_in=pe,
                                 **kwargs)


def prepare(cfg, device="cuda", mesh=None, partition: str = "dp"):
    """Dataset + model + trainer + loaders, shared by run() and tests.
    `datasets.load_dataset` is looked up at call time, so a caller may
    substitute a caching loader (chip_smoke.py's share_datasets).  With a
    mesh (parallel/mesh.py), the data-parallel branch for its rank: model
    at bn_axis "dp", per-rank shards of max(batch_size // ranks, 1)
    graphs at pad_geometry's pads for that size over every split's
    graphs, a StackedLoader per split and a DataParallelTrainer on the
    mesh's device (device is then unused).  With partition "ep" and a
    mesh, the edge-parallel branch (_prepare_ep)."""
    from .data.datasets import load_dataset
    from .data.loader import BatchLoader, BucketedLoader
    from .ops.scalers import degree_stats
    from .train import tasks
    from .train.trainer import Trainer

    check_ported(cfg)
    ds = load_dataset(cfg.dataset, cfg.data)
    task = cfg.task
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in ds.train])
    # derived config from data (reference main_*.py:285-304)
    np_cfg = dataclasses.replace(cfg.net_params, avg_d=degree_stats(degs))
    np_cfg = dataclasses.replace(
        np_cfg, **tasks.get(task).derive(np_cfg, ds.meta))
    if cfg.data.pos_enc_dim > 0:
        np_cfg = dataclasses.replace(np_cfg,
                                     pos_enc_dim=cfg.data.pos_enc_dim)
    generator = torch.Generator().manual_seed(cfg.params.seed)
    bs = cfg.params.batch_size
    layout = resolve_layout(cfg.data.layout)
    if mesh is not None and partition == "ep":
        return _prepare_ep(cfg, task, np_cfg, ds, generator, mesh, layout)
    if mesh is not None:
        return _prepare_dp(cfg, task, np_cfg, ds, generator, mesh, layout)
    model, loss_fn = build_model(task, np_cfg, ds, generator)
    trainer = Trainer(model, loss_fn, cfg.params, task=task, device=device)
    if cfg.data.n_buckets > 1:
        # one tight geometry per size bucket for every split, as
        # dgn_tpu/run.py:151-156 builds them: no micro-batches, no eval
        # cache (the trainer then rebuilds each eval batch's context)
        loaders = {split: BucketedLoader(gs, batch_size=bs,
                                         n_buckets=cfg.data.n_buckets,
                                         shuffle=(split == "train"),
                                         seed=cfg.params.seed, layout=layout)
                   for split, gs in ds.splits.items()}
        return ds, model, loss_fn, trainer, loaders
    mb = resolve_micro_batches(cfg.data.micro_batches, bs)
    # shuffled train: typical/worst per cfg; unshuffled val/test: exact
    # geometry (without micro-batching), and cached so the trainer keeps
    # their edge contexts
    loaders = {split: BatchLoader(gs, batch_size=bs,
                                  shuffle=(split == "train"),
                                  seed=cfg.params.seed, layout=layout,
                                  geometry=cfg.data.geometry,
                                  cache=(split != "train"),
                                  micro_batches=mb)
               for split, gs in ds.splits.items()}
    return ds, model, loss_fn, trainer, loaders


def _prepare_dp(cfg, task, np_cfg, ds, generator, mesh, layout):
    """prepare's data-parallel branch (dgn_tpu/run.py:127-145)."""
    from .parallel import DataParallelTrainer, StackedLoader
    np_cfg = dataclasses.replace(np_cfg, bn_axis="dp")
    model, loss_fn = build_model(task, np_cfg, ds, generator)
    per_dev = max(cfg.params.batch_size // mesh.size, 1)
    n_pad, e_pad = pad_geometry(ds.train + ds.val + ds.test, per_dev, layout)
    trainer = DataParallelTrainer(model, loss_fn, cfg.params, mesh,
                                  task=task)
    loaders = {split: StackedLoader(gs, per_device_batch=per_dev,
                                    n_shards=mesh.size, rank=mesh.rank,
                                    n_pad=n_pad, e_pad=e_pad,
                                    shuffle=(split == "train"),
                                    seed=cfg.params.seed, layout=layout)
               for split, gs in ds.splits.items()}
    return ds, model, loss_fn, trainer, loaders


def _prepare_ep(cfg, task, np_cfg, ds, generator, mesh, layout):
    """prepare's edge-parallel branch (dgn_tpu/run.py:113-126): the model
    at bn_axis "ep", a PartitionedLoader per split (batches of batch_size
    graphs, graph axis padded to batch_size, this rank's shard of each)
    and an EdgeParallelTrainer.  As in dgn_tpu,
    micro-batches and --n_buckets do not apply."""
    from .parallel import EdgeParallelTrainer, PartitionedLoader
    np_cfg = dataclasses.replace(np_cfg, bn_axis="ep")
    model, loss_fn = build_model(task, np_cfg, ds, generator)
    trainer = EdgeParallelTrainer(model, loss_fn, cfg.params, mesh,
                                  task=task)
    bs = cfg.params.batch_size
    loaders = {split: PartitionedLoader(gs, batch_size=bs,
                                        n_shards=mesh.size, rank=mesh.rank,
                                        shuffle=(split == "train"),
                                        seed=cfg.params.seed, g_pad=bs,
                                        layout=layout)
               for split, gs in ds.splits.items()}
    return ds, model, loss_fn, trainer, loaders


def prepare_collab(cfg, device="cuda"):
    """COLLAB's graph, splits, model and trainer, shared by run_collab and
    tests: the DGN backbone with a linear node encoder over the graph's
    float features and avg_d from its degrees, the graph packed flat once
    (pack_graphs([g], g_pad=1): no pad node, no pad edge) and moved to the
    device once.  `datasets.load_collab` is looked up at call time, as
    prepare's load_dataset is.  Returns (gb, splits, trainer)."""
    from .data import datasets
    from .graph import pack_graphs
    from .ops.scalers import degree_stats
    from .train.link_pred import LinkPredTrainer, collab_model

    check_ported(cfg)
    g, splits, meta = datasets.load_collab(cfg.data)
    degs = np.bincount(g.dst, minlength=g.num_nodes)
    np_cfg = dataclasses.replace(cfg.net_params, node_encoder="linear",
                                 avg_d=degree_stats(degs))
    model = collab_model(np_cfg, meta["in_dim"],
                         torch.Generator().manual_seed(cfg.params.seed),
                         pos_enc_in=pos_enc_width(np_cfg, g))
    gb = pack_graphs([g], g_pad=1).to(device)
    return gb, splits, LinkPredTrainer(model, cfg.params, device=device)


def run_collab(cfg, device):
    """Link prediction (the ogbl-collab protocol, dgn_tpu/run.py:179-221):
    per epoch one pass over the train edges, Hits@K on valid and test, the
    plateau scheduler on -hits@50, test at the best valid; stops at min_lr
    or max_time."""
    t0 = time.time()
    gb, splits, trainer = prepare_collab(cfg, device)
    p = cfg.params
    print(f"[dgn_tpu_torch] data ready in {time.time() - t0:.1f}s "
          f"({gb.num_nodes_padded} nodes, {gb.num_edges_padded} edges, "
          f"{len(splits['train'])} train pairs)")
    best_val, test_at_best = -1.0, None
    for epoch in range(p.epochs):
        loss = trainer.train_epoch(gb, splits["train"], epoch)
        val = trainer.evaluate(gb, splits["valid"], splits["valid_neg"])
        test = trainer.evaluate(gb, splits["test"], splits["test_neg"])
        trainer.scheduler.step(-val["hits@50"])
        if val["hits@50"] > best_val:
            best_val, test_at_best = val["hits@50"], test
        if epoch % p.print_epoch_interval == 0:
            print(f"epoch {epoch}: loss={loss:.4f} val={val} test={test}")
        if trainer.scheduler.lr <= p.min_lr * (1 + 1e-9):
            break
        if (time.time() - t0) / 3600.0 > p.max_time:
            break
    report = {"dataset": "COLLAB", "device": str(device),
              "best_val_hits@50": best_val, "test_at_best_val": test_at_best,
              "total_time_h": (time.time() - t0) / 3600.0}
    print("[dgn_tpu_torch] FINAL " + json.dumps(report, default=float))
    return report


def _precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def _banner(cfg, device, n_devices: int = 1, partition: str = "dp") -> None:
    layout = "flat" if cfg.task == "collab" else resolve_layout(
        cfg.data.layout)
    print(f"[dgn_tpu_torch] dataset={cfg.dataset} task={cfg.task} "
          f"device={device} n_devices={n_devices} partition={partition} "
          f"layout={layout} "
          f"compute_dtype={cfg.net_params.compute_dtype or 'float32'}")


def run(argv=None):
    from .config import config_from_args

    cfg, args = config_from_args(argv)
    if args.multihost:
        return run_multihost(cfg, args)
    n_devices = args.n_devices or 1
    if n_devices > 1 and cfg.task != "collab":
        return run_data_parallel(cfg, args, n_devices)
    device = resolve_device(args.device)
    _precision()
    _banner(cfg, device)
    if cfg.task == "collab":
        return run_collab(cfg, device)
    return run_mesh(cfg, args, device)


def run_mesh(cfg, args, device, mesh=None):
    """run_seeds or run_one, on one device or as one rank of mesh."""
    if args.seeds:
        return run_seeds(cfg, args, [int(x) for x in args.seeds.split(",")],
                         device, mesh)
    return run_one(cfg, args, device, mesh)


def run_multihost(cfg, args):
    """`--multihost`: this process joins the world as one rank
    (init_multihost) and trains its shard on its local device; n_devices
    defaults to the world size, which it must equal."""
    from .parallel.mesh import init_multihost, local_device, make_mesh
    if args.device == "cuda":
        resolve_device("cuda")
    rank, world = init_multihost(args.coordinator_address,
                                 args.num_processes, args.process_id,
                                 device=args.device)
    n_devices = args.n_devices or world
    if n_devices != world:
        raise SystemExit(f"dgn_tpu_torch.run: --n_devices {n_devices} but "
                         f"the multihost world has {world} processes (one "
                         "per device)")
    print(f"[dgn_tpu_torch] multihost: process {rank}/{world}")
    device = local_device(args.device, rank)
    if cfg.task == "collab":         # one graph: no data parallelism
        _precision()
        return run_collab(cfg, device)
    return _run_rank(cfg, args, make_mesh(world, device=device))


def _run_rank(cfg, args, mesh):
    _precision()
    if mesh.rank == 0:
        _banner(cfg, mesh.device, mesh.size, args.partition)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return run_mesh(cfg, args, mesh.device, mesh)


def rank_main(rank: int, n: int, init_method: str, cfg, args, devices,
              backend: str, threads: int = 0):
    """One spawned rank of a one-host data-parallel run: joins the group
    at init_method, then trains as run() does; returns this rank's
    report."""
    import torch.distributed as dist
    from .parallel.mesh import make_mesh
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank)
    try:
        return _run_rank(cfg, args, make_mesh(n, device=devices[rank]))
    finally:
        dist.destroy_process_group()


def run_data_parallel(cfg, args, n_devices: int):
    """`--n_devices N` on one host: N spawned ranks, rank r on cuda:r
    (NCCL), or N gloo ranks on the CPU with --device cpu; returns rank
    0's report."""
    from .parallel.launch import spawn
    if args.device == "cuda":
        visible = (torch.cuda.device_count() if torch.cuda.is_available()
                   else 0)
        if visible < n_devices:
            raise SystemExit(f"dgn_tpu_torch.run: --n_devices {n_devices} "
                             f"needs {n_devices} GPUs, but {visible} are "
                             "visible (one rank per GPU; --device cpu runs "
                             "gloo ranks on the CPU)")
        devices = [f"cuda:{r}" for r in range(n_devices)]
        backend, threads = "nccl", 0
    else:
        devices = ["cpu"] * n_devices
        backend = "gloo"
        threads = max(1, torch.get_num_threads() // n_devices)
    return spawn(rank_main, n_devices,
                 (cfg, args, devices, backend, threads))[0]


def run_seeds(cfg, args, seeds, device, mesh=None):
    """The multi-seed protocol (dgn_tpu/run.py:244-286): run_one per seed,
    each with its own out_dir and checkpoint directory (a shared one would
    make --resume restore one seed's weights into the next seed's run),
    then the mean and std over the seeds that reached a best validation
    epoch, for every metric their test reports carry."""
    say = _say(mesh)
    reports = []
    for s in seeds:
        c = dataclasses.replace(
            cfg, params=dataclasses.replace(cfg.params, seed=s),
            out_dir=os.path.join(cfg.out_dir, f"seed{s}"))
        a = argparse.Namespace(**vars(args))
        if args.checkpoint:
            a.checkpoint = os.path.join(args.checkpoint, f"seed{s}")
        say(f"[dgn_tpu_torch] ==== seed {s} ====")
        reports.append(run_one(c, a, device, mesh))
    done = [r["test_at_best_val"] for r in reports if r["test_at_best_val"]]
    from .train.tasks import TASKS
    keys = set().union(*map(set, done)) if done else set()
    agg = {}
    for k in dict.fromkeys(t.metric for t in TASKS.values()):
        if k not in keys:
            continue
        vals = [t[k] for t in done if k in t]
        agg[k] = {"mean": float(np.mean(vals)), "std": float(np.std(vals))}
        say(f"[dgn_tpu_torch] TEST {k.upper()}: {np.mean(vals):.4f} "
            f"± {np.std(vals):.4f} ({len(vals)}/{len(seeds)} seeds)")
    out = {"dataset": cfg.dataset, "device": str(device), "seeds": seeds,
           "test_at_best_val": agg,
           "per_seed": [r["test_at_best_val"] for r in reports]}
    say("[dgn_tpu_torch] SEEDS " + json.dumps(out, default=float))
    return out


def _say(mesh):
    """print on one device and on rank 0; nothing on the other ranks."""
    if mesh is None or mesh.rank == 0:
        return print
    return lambda *a, **k: None


def run_one(cfg, args, device, mesh=None):
    """One seed: prepare, restore a snapshot when --resume finds one in
    --checkpoint, fit with a metrics.jsonl stream in out_dir (and a
    snapshot per epoch), then the final train/val/test evaluation.  As a
    rank of mesh, only rank 0 prints and writes the stream (and the
    trainer saves only there); every rank restores."""
    from . import observe
    from .observe import MetricStream
    from .train import tasks
    from .train.checkpoint import Checkpointer

    say = _say(mesh)
    t0 = time.time()
    ds, model, loss_fn, trainer, loaders = (
        prepare(cfg, device) if mesh is None
        else prepare(cfg, device, mesh, args.partition))
    say(f"[dgn_tpu_torch] data ready in {time.time() - t0:.1f}s "
        f"(train/val/test = {len(ds.train)}/{len(ds.val)}/{len(ds.test)})")
    n_param = sum(p.numel() for p in model.parameters())
    say(f"[dgn_tpu_torch] MODEL/Total parameters: {n_param}")
    start_epoch, checkpointer = 0, None
    if args.checkpoint:
        checkpointer = Checkpointer(args.checkpoint)
        if args.resume and checkpointer.latest_epoch() is not None:
            start_epoch = checkpointer.restore(trainer)
            say(f"[dgn_tpu_torch] resumed from epoch {start_epoch - 1}")
    stream = (MetricStream(os.path.join(cfg.out_dir, "metrics.jsonl"))
              if mesh is None or mesh.rank == 0 else None)
    try:
        with (observe.tracing() if args.trace_spans
              else contextlib.nullcontext()):
            result = trainer.fit(loaders["train"], loaders["val"],
                                 loaders["test"], checkpointer=checkpointer,
                                 start_epoch=start_epoch, stream=stream)
    finally:
        if stream is not None:
            stream.close()
    final = {split: trainer.evaluate(loaders[split])
             for split in ("train", "val", "test")}
    metric = tasks.get(cfg.task).metric
    say(f"[dgn_tpu_torch] final {metric}: " + ", ".join(
        f"{split} {final[split][metric]:.4f}" for split in final))
    report = {
        "dataset": cfg.dataset,
        "device": str(device),
        "n_devices": 1 if mesh is None else mesh.size,
        "params": n_param,
        "epochs_run": len(result["history"]),
        "best_epoch": result["best_epoch"],
        "final": final,
        "test_at_best_val": result["test_at_best"],
        "total_time_h": (time.time() - t0) / 3600.0,
    }
    say("[dgn_tpu_torch] FINAL " + json.dumps(report, default=float))
    return report


if __name__ == "__main__":
    run()
