"""1 -> N strong scaling of the train step, data against edge parallelism
(counterpart of `dgn_tpu/tools/scaling.py`).

Times the DGN train step at a fixed GLOBAL batch on N ranks, for both
multi-rank strategies of the port:

  dp  data parallelism (parallel/dp.py): the batch cut into N shards,
      gradients summed over the ranks, sync batch norm;
  ep  edge parallelism (parallel/halo.py): one batch's nodes and edges
      cut across the ranks, one boundary-only halo all-to-all per layer.

The net is the flagship ZINC one (complex, `mean dir1-dx dir1-av`, three
scalers) on synthetic molecules.  N = 1 times the one-device Trainer on
the flat layout for both, as dgn_tpu does; dp at N > 1 takes the flat
layout, ep the block layout with the interior/boundary pair split.  Each
N spawns N ranks (parallel/launch.py); every rank takes `steps` untimed
steps on its batch (the warm-up, as dgn_tpu's one untimed run of the same
length), then `steps` steps between two barriers, and rank 0's time per
step, synchronised with the device, is the row's.  Efficiency is
t_1 / (N * t_N).

Each row also carries an analytic model, exact host arithmetic:
  comm_bytes_per_step: dp, a ring all-reduce of the float32 gradients,
      2 * params * 4 * (N - 1) / N bytes through each rank; ep, per layer
      the send_idx rows out and as many in (N * S * hidden floats), forward
      and backward, plus L + 1 sums of the per-graph pools (dgn_tpu's
      formula, which comm_model reproduces);
  predicted_efficiency: t_1/N / (t_1/N + comm_bytes / link_bw), the
      no-overlap bound, only when --link_bw (bytes/s per rank) is given:
      the row then states the figure it assumed and --link_bw_source, where
      it comes from.  There is no default: dgn_tpu's 9e10 B/s is a TPU v5e
      ICI figure, not a link of this port's ranks.

Ranks: rank r on cuda:(r mod the visible GPUs) over NCCL when every rank
has a GPU of its own, else gloo ranks that share the cards (NCCL refuses
two ranks on one device), or gloo ranks on the CPU with --device cpu.  The
row names the backend and how many ranks share a card.

    python -m dgn_tpu_torch.tools.scaling --devices 1,2 [--partition dp,ep]

Prints one JSON line per (partition, ranks).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch


def _flagship(batch: int, hidden: int, L: int, bn_axis: Optional[str]):
    """(model, loss, graphs) of the flagship ZINC net on batch synthetic
    molecules (dgn_tpu/tools/scaling.py:52-68)."""
    from ..data import synthetic
    from ..models import DGNConfig, zinc_model
    from ..ops.scalers import degree_stats

    graphs = synthetic.synthetic_zinc(batch, seed=41)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    cfg = DGNConfig(hidden_dim=hidden, out_dim=hidden, L=L,
                    type_net="complex", aggregators="mean dir1-dx dir1-av",
                    scalers="identity amplification attenuation",
                    avg_d=degree_stats(degs), bn_axis=bn_axis)
    model, loss_fn = zinc_model(cfg, torch.Generator().manual_seed(41))
    return model, loss_fn, graphs


def placement(n: int, device: str):
    """(backend, [device of each rank], ranks per card, None on the CPU)
    for n ranks: NCCL when every rank has a card of its own, else gloo."""
    if device == "cpu":
        return "gloo", ["cpu"] * n, None
    visible = torch.cuda.device_count()
    if visible == 0:
        raise SystemExit("dgn_tpu_torch.tools.scaling: no CUDA device is "
                         "visible; pass --device cpu to time on the CPU")
    backend = "nccl" if n <= visible else "gloo"
    return (backend, [f"cuda:{r % visible}" for r in range(n)],
            -(-n // visible))


def _time_rank(rank: int, n: int, init_method: str, part: str, batch: int,
               hidden: int, L: int, steps: int, devices, backend: str):
    """One rank of a timing run: seconds per train step (rank 0's is
    the row's)."""
    import torch.distributed as dist

    from ..graph import bucket_sizes_for, pack_graphs
    from ..parallel import (DataParallelTrainer, EdgeParallelTrainer,
                            StackedLoader, make_mesh, partition_batch)
    from ..train.trainer import TrainParams, Trainer

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank)
    try:
        params = TrainParams(seed=41, init_lr=1e-3)
        if n == 1:
            model, loss_fn, graphs = _flagship(batch, hidden, L, None)
            n_pad, e_pad = bucket_sizes_for(graphs, batch)
            gb = pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=batch)
            trainer = Trainer(model, loss_fn, params, task="zinc",
                              device=device)
        else:
            model, loss_fn, graphs = _flagship(batch, hidden, L, part)
            mesh = make_mesh(n, device=device)
            if part == "dp":
                loader = StackedLoader(graphs, batch // n, n, rank=rank)
                gb = next(iter(loader))
                trainer = DataParallelTrainer(model, loss_fn, params, mesh,
                                              task="zinc")
            else:
                gb = partition_batch(graphs, n, rank, g_pad=batch,
                                     layout="mxu")
                trainer = EdgeParallelTrainer(model, loss_fn, params, mesh,
                                              task="zinc")

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dist.barrier()

        for _ in range(steps):
            trainer.train_step(gb)
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, _ = trainer.train_step(gb)
        sync()
        dt = time.perf_counter() - t0
        if not np.isfinite(float(loss)):
            raise RuntimeError(f"{part} at {n} ranks: non-finite loss")
        return dt / steps
    finally:
        dist.destroy_process_group()


def _measure(part: str, n: int, batch: int, hidden: int, L: int,
             steps: int, device: str, timeout: float) -> tuple:
    from ..parallel.launch import spawn
    backend, devices, share = placement(n, device)
    sec = spawn(_time_rank, n, (part, batch, hidden, L, steps, devices,
                                backend), timeout=timeout)[0]
    return sec, backend, share


def measure_dp(n: int, batch: int, hidden: int, L: int, steps: int,
               device: str = "cuda", timeout: float = 600) -> float:
    """Seconds per data-parallel train step at n ranks (rank 0's)."""
    return _measure("dp", n, batch, hidden, L, steps, device, timeout)[0]


def measure_ep(n: int, batch: int, hidden: int, L: int, steps: int,
               device: str = "cuda", timeout: float = 600) -> float:
    """Seconds per edge-parallel train step at n ranks (rank 0's)."""
    return _measure("ep", n, batch, hidden, L, steps, device, timeout)[0]


def comm_model(part: str, n: int, batch: int, hidden: int, L: int) -> int:
    """EXACT host-computed communication volume (bytes through each rank
    per train step), dgn_tpu/tools/scaling.py:160-190's formulas."""
    if n <= 1:
        return 0
    if part == "dp":
        model, _, _ = _flagship(min(batch, 8), hidden, L, None)
        n_params = sum(p.numel() for p in model.parameters())
        return int(2 * n_params * 4 * (n - 1) / n)
    if part == "ep":
        from ..parallel.halo import partition_batch
        _, _, graphs = _flagship(batch, hidden, L, None)
        pb = partition_batch(graphs, n, 0, g_pad=batch)
        s_max = int(pb.halo.send_idx.shape[-1])
        per_layer = 2 * (n * s_max * hidden * 4)       # out + in, f32
        pool = 2 * batch * hidden * 4                  # summed graph pools
        return int(L * 2 * per_layer + (L + 1) * pool)
    raise ValueError(part)


def run_scaling(partitions=("dp", "ep"), devices=(1, 2), batch: int = 128,
                hidden: int = 45, L: int = 4, steps: int = 10,
                link_bw: Optional[float] = None,
                link_bw_source: Optional[str] = None, emit=print,
                device: str = "cuda", timeout: float = 600):
    """One row per (partition, ranks): {row}, keyed by (partition, n)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dgn_tpu_torch.tools.scaling: no CUDA device is "
                         "available; pass --device cpu to time on the CPU")
    if link_bw is not None and not link_bw_source:
        raise ValueError("link_bw needs link_bw_source: where the figure "
                         "comes from")
    kind = (torch.cuda.get_device_name(0) if device == "cuda" else "cpu")
    results = {}
    for part in partitions:
        base = None
        for n in devices:
            sec, used, share = _measure(part, n, batch, hidden, L, steps,
                                        device, timeout)
            if base is None:
                base = sec
            comm = comm_model(part, n, batch, hidden, L)
            pred = None
            if link_bw is not None:
                pred = ((base / n) / (base / n + comm / link_bw)
                        if n > 1 else 1.0)
            row = {"metric": f"scaling_{part}", "n_devices": n,
                   "step_ms": sec * 1e3, "efficiency": base / (n * sec),
                   "comm_bytes_per_step": comm,
                   "predicted_efficiency": pred, "link_bw": link_bw,
                   "link_bw_source": link_bw_source,
                   "predicted_model": "no-overlap bound at link_bw",
                   "global_batch": batch, "hidden": hidden, "L": L,
                   "steps": steps, "backend": used, "device": kind,
                   "ranks_per_gpu": share}
            results[(part, n)] = row
            emit(json.dumps(row))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--partition", default="dp,ep")
    ap.add_argument("--devices", default="1,2",
                    help="rank counts, comma-separated")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=45)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--link_bw", type=float, default=None,
                    help="bytes/s per rank for predicted_efficiency; no "
                         "default (none is measured here)")
    ap.add_argument("--link_bw_source", default=None,
                    help="where --link_bw comes from (required with it)")
    a = ap.parse_args(argv)
    run_scaling(tuple(a.partition.split(",")),
                tuple(int(x) for x in a.devices.split(",")), a.batch,
                a.hidden, a.L, a.steps, link_bw=a.link_bw,
                link_bw_source=a.link_bw_source, device=a.device)


if __name__ == "__main__":
    main()
