"""Experiment entry point: `python -m dgn_tpu_torch.run --config ... [flags]`.

Counterpart of `dgn_tpu/run.py` for the slice this package covers: the ZINC
task on the block layout, one device.  Pipeline: config (JSON + CLI
overlay) -> dataset (synthetic ZINC when no data_dir) -> avg_d degree stats
over train -> model -> Trainer (Adam + ReduceLROnPlateau, seeded) -> epoch
loop with val/test eval, min-lr and max_time stops -> final report.

The model runs on the GPU (`--device cuda`, the default) unless the caller
asks for the CPU (`--device cpu`); without a GPU and without that request
the run stops with an error instead of running on the CPU.  At start the run
turns TF32 off for matmuls and convolutions
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False): the reference is float32, and so is this port.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch


def resolve_device(device: str) -> torch.device:
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dgn_tpu_torch.run: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return torch.device(device)


def check_ported(cfg) -> None:
    """Raise NotImplementedError for run options this slice lacks."""
    d = cfg.data
    if d.layout not in ("auto", "mxu"):
        raise NotImplementedError(f"layout {d.layout!r} is not ported yet "
                                  "(the block layout, mxu, is)")
    if d.n_buckets > 1:
        raise NotImplementedError("n_buckets > 1 is not ported yet")
    if str(d.micro_batches) not in ("auto", "1"):
        raise NotImplementedError("micro_batches > 1 is not ported yet")
    if cfg.net_params.compute_dtype is not None:
        raise NotImplementedError("compute_dtype (bfloat16) is not ported yet;"
                                  " the port runs float32")


def prepare(cfg, device="cuda"):
    """Dataset + model + trainer + loaders, shared by run() and tests."""
    from .data.datasets import load_dataset
    from .data.loader import BatchLoader
    from .models import MODEL_FACTORIES
    from .ops.scalers import degree_stats
    from .train.trainer import Trainer

    check_ported(cfg)
    ds = load_dataset(cfg.dataset, cfg.data)
    task = cfg.task
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in ds.train])
    np_cfg = dataclasses.replace(
        cfg.net_params, avg_d=degree_stats(degs),
        num_node_types=ds.meta["num_atom_type"],
        num_edge_types=ds.meta["num_bond_type"],
        edge_dim=cfg.net_params.edge_dim or cfg.net_params.hidden_dim)
    generator = torch.Generator().manual_seed(cfg.params.seed)
    model, loss_fn = MODEL_FACTORIES[task](np_cfg, generator)
    trainer = Trainer(model, loss_fn, cfg.params, task=task, device=device)
    bs = cfg.params.batch_size
    # shuffled train: typical/worst per cfg; unshuffled val/test: exact
    # geometry, and cached so the trainer keeps their edge contexts
    loaders = {split: BatchLoader(gs, batch_size=bs,
                                  shuffle=(split == "train"),
                                  seed=cfg.params.seed,
                                  geometry=cfg.data.geometry,
                                  cache=(split != "train"))
               for split, gs in ds.splits.items()}
    return ds, model, loss_fn, trainer, loaders


def run(argv=None):
    from .config import config_from_args

    cfg, args = config_from_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[dgn_tpu_torch] dataset={cfg.dataset} task={cfg.task} "
          f"device={device} layout=mxu")
    t0 = time.time()
    ds, model, loss_fn, trainer, loaders = prepare(cfg, device)
    print(f"[dgn_tpu_torch] data ready in {time.time() - t0:.1f}s "
          f"(train/val/test = {len(ds.train)}/{len(ds.val)}/{len(ds.test)})")
    n_param = sum(p.numel() for p in model.parameters())
    print(f"[dgn_tpu_torch] MODEL/Total parameters: {n_param}")
    result = trainer.fit(loaders["train"], loaders["val"], loaders["test"])
    report = {
        "dataset": cfg.dataset,
        "device": str(device),
        "params": n_param,
        "epochs_run": len(result["history"]),
        "best_epoch": result["best_epoch"],
        "final": {split: trainer.evaluate(loaders[split])
                  for split in ("train", "val", "test")},
        "test_at_best_val": result["test_at_best"],
        "total_time_h": (time.time() - t0) / 3600.0,
    }
    print("[dgn_tpu_torch] FINAL " + json.dumps(report, default=float))
    return report


if __name__ == "__main__":
    run()
