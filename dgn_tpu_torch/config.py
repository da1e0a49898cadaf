"""Typed experiment config with JSON + CLI overlay (counterpart of
`dgn_tpu/config.py`).

The same JSON schema as the reference package (configs/*.json): the
dataclass field names are the schema, unknown keys are rejected, and every
CLI flag that is given overrides the JSON value.  The flags are those of the
reference run script, plus `--device`.  The multi-device flags are
dgn_tpu's (dgn_tpu/config.py:238-258), with its defaults, mapped onto one
process per GPU (parallel/mesh.py): `--n_devices N` trains on N ranks of
one host (`cuda:0..N-1`, or N gloo ranks on the CPU with
`--device cpu`); `--multihost` with `--coordinator_address`,
`--num_processes` and `--process_id` makes this process one rank of a
larger world (the torchrun environment when they are omitted);
`--partition dp` is data parallelism, `ep` edge parallelism (one batch's
nodes and edges cut across the ranks, parallel/halo.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional

from .models.dgn_net import DGNConfig
from .train.trainer import TrainParams


@dataclasses.dataclass
class DataParams:
    """Dataset options the reference passes as CLI-only flags."""
    data_dir: str = ""            # root of the dataset files; "" -> synthetic
    cache_dir: str = ""           # eig disk cache (spectral.EigCache)
    pos_enc_dim: int = 0
    lap_norm: str = "none"        # none | sym | walk
    coord_eig: bool = False       # superpixels only
    proportion: float = 1.0       # superpixels only
    synthetic_size: int = 512     # graphs per split in the synthetic fallback
    layout: str = "auto"          # flat | mxu | auto (= mxu, the block one)
    n_buckets: int = 1
    geometry: str = "typical"     # pad sizing of the shuffled train loader
    micro_batches: Any = "auto"   # auto = ceil(batch_size / 1024)


@dataclasses.dataclass
class ExperimentConfig:
    model: str = "DGN"
    dataset: str = "ZINC"
    out_dir: str = "out"
    params: TrainParams = dataclasses.field(default_factory=TrainParams)
    net_params: DGNConfig = dataclasses.field(default_factory=DGNConfig)
    data: DataParams = dataclasses.field(default_factory=DataParams)

    @property
    def task(self) -> str:
        d = self.dataset.upper()
        if d in ("ZINC", "ZINC-FULL"):
            return "zinc"
        if d.startswith("SBM"):
            return "sbm"
        if d in ("MNIST", "CIFAR10"):
            return "superpixels"
        if d == "HIV":
            return "hiv"
        if d == "PCBA":
            return "pcba"
        if d == "COLLAB":
            return "collab"
        raise NotImplementedError(f"dataset {self.dataset!r} is not ported yet")


# reference net_params keys with no field here (layer_type: dgl vs dense)
IGNORED_KEYS = {"layer_type", "gpu"}


def _overlay_dataclass(obj, values: Dict[str, Any], where: str):
    names = {f.name for f in dataclasses.fields(obj)}
    unknown = set(values) - names - IGNORED_KEYS
    if unknown:
        raise KeyError(f"unknown config keys in {where}: {sorted(unknown)}")
    return dataclasses.replace(
        obj, **{k: v for k, v in values.items() if k in names})


def _map_net_params(np_json: Dict[str, Any]) -> Dict[str, Any]:
    """divide_input_first applies to layers 0..L-2 (-> divide_input),
    divide_input_last to the final layer."""
    out = dict(np_json)
    first = out.pop("divide_input_first", None)
    last = out.pop("divide_input_last", None)
    if first is not None:
        out["divide_input"] = bool(first)
    if last is not None:
        out["divide_input_last"] = bool(last)
    return out


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None
                ) -> ExperimentConfig:
    """JSON file -> ExperimentConfig, then flat CLI-style overrides."""
    cfg = ExperimentConfig()
    if path:
        with open(path) as f:
            raw = json.load(f)
        cfg = dataclasses.replace(
            cfg, model=raw.get("model", cfg.model),
            dataset=raw.get("dataset", cfg.dataset),
            out_dir=raw.get("out_dir", cfg.out_dir))
        if "params" in raw:
            cfg = dataclasses.replace(cfg, params=_overlay_dataclass(
                cfg.params, raw["params"], "params"))
        if "net_params" in raw:
            cfg = dataclasses.replace(cfg, net_params=_overlay_dataclass(
                cfg.net_params, _map_net_params(raw["net_params"]),
                "net_params"))
        if "data" in raw:
            cfg = dataclasses.replace(cfg, data=_overlay_dataclass(
                cfg.data, raw["data"], "data"))
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: ExperimentConfig,
                    overrides: Dict[str, Any]) -> ExperimentConfig:
    """Flat-namespace overrides; None values (absent flags) are skipped."""
    overrides = {k: v for k, v in overrides.items() if v is not None}
    p_names = {f.name for f in dataclasses.fields(TrainParams)}
    n_names = {f.name for f in dataclasses.fields(DGNConfig)}
    d_names = {f.name for f in dataclasses.fields(DataParams)}
    top = {"model", "dataset", "out_dir"}
    mapped = _map_net_params(overrides)
    for k in mapped:
        if k not in p_names | n_names | d_names | top:
            raise KeyError(f"unknown override {k!r}")
    cfg = dataclasses.replace(
        cfg, **{k: v for k, v in mapped.items() if k in top})
    cfg = dataclasses.replace(cfg, params=dataclasses.replace(
        cfg.params, **{k: v for k, v in mapped.items() if k in p_names}))
    cfg = dataclasses.replace(cfg, net_params=dataclasses.replace(
        cfg.net_params, **{k: v for k, v in mapped.items() if k in n_names}))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, **{k: v for k, v in mapped.items() if k in d_names}))


def _bool(s: str) -> bool:
    return s.lower() == "true"


def build_argparser() -> argparse.ArgumentParser:
    """Every flag defaults to None = "don't override"."""
    ap = argparse.ArgumentParser(description="dgn_tpu_torch experiment runner")
    ap.add_argument("--config", type=str, default=None,
                    help="JSON config (reference configs/*.json schema)")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where the model runs (default: the GPU)")
    ap.add_argument("--dataset", type=str, default=None)
    ap.add_argument("--out_dir", type=str, default=None)
    for name, typ in [("seed", int), ("epochs", int), ("batch_size", int),
                      ("init_lr", float), ("lr_reduce_factor", float),
                      ("lr_schedule_patience", int), ("min_lr", float),
                      ("weight_decay", float), ("print_epoch_interval", int),
                      ("max_time", float), ("augmentation", float),
                      ("distortion", float)]:
        ap.add_argument(f"--{name}", type=typ, default=None)
    ap.add_argument("--flip", type=_bool, default=None)
    for name, typ in [("L", int), ("hidden_dim", int), ("out_dim", int),
                      ("type_net", str), ("aggregators", str),
                      ("scalers", str), ("towers", int), ("edge_dim", int),
                      ("pretrans_layers", int), ("posttrans_layers", int),
                      ("in_feat_dropout", float), ("dropout", float),
                      ("readout", str), ("virtual_node", str)]:
        ap.add_argument(f"--{name}", type=typ, default=None)
    for name in ["residual", "edge_feat", "graph_norm", "batch_norm",
                 "divide_input_first", "divide_input_last", "decompose"]:
        ap.add_argument(f"--{name}", type=_bool, default=None)
    ap.add_argument("--data_dir", type=str, default=None,
                    help="root of the dataset files (docs/DATA.md); "
                         "synthetic data where they are absent")
    ap.add_argument("--cache_dir", type=str, default=None,
                    help="eigenvector disk cache: each (graph, k, norm) "
                         "solved once across runs")
    ap.add_argument("--pos_enc_dim", type=int, default=None)
    ap.add_argument("--lap_norm", type=str, default=None)
    ap.add_argument("--coord_eig", type=_bool, default=None)
    ap.add_argument("--proportion", type=float, default=None)
    ap.add_argument("--synthetic_size", type=int, default=None)
    ap.add_argument("--layout", type=str, default=None,
                    choices=["auto", "flat", "mxu"])
    ap.add_argument("--compute_dtype", type=str, default=None,
                    help="bfloat16 or float16: the block layout's products "
                         "on operands rounded to it, f32 accumulation "
                         "(default float32)")
    ap.add_argument("--geometry", type=str, default=None,
                    choices=["typical", "worst"])
    ap.add_argument("--n_buckets", type=int, default=None,
                    help=">1: size-bucketed batching (data/loader.py "
                         "BucketedLoader), one tight geometry per bucket")
    ap.add_argument("--micro_batches", type=str, default=None)
    # the run's recipe (run.run_one / run.run_seeds), not config fields
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="checkpoint directory: a snapshot per epoch")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest snapshot in --checkpoint")
    ap.add_argument("--seeds", type=str, default=None,
                    help="comma-separated seeds, e.g. 41,42,43,44: one run "
                         "per seed and their mean ± std")
    # data and edge parallelism (parallel/): dgn_tpu's flags and defaults
    ap.add_argument("--n_devices", type=int, default=None,
                    help="ranks (default 1): rank r on cuda:r, or gloo "
                         "ranks with --device cpu")
    ap.add_argument("--partition", type=str, default="dp",
                    choices=["dp", "ep"],
                    help="dp = batch sharding; ep = each batch's "
                         "nodes and edges cut across the ranks, with a "
                         "halo exchange per layer")
    ap.add_argument("--multihost", action="store_true",
                    help="join a multi-host world (torch.distributed) as "
                         "one rank; torchrun's environment when the three "
                         "flags below are omitted")
    ap.add_argument("--coordinator_address", type=str, default=None,
                    help="rank 0's host:port")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    return ap


RUN_FLAGS = ("config", "device", "checkpoint", "resume", "seeds",
             "n_devices", "partition", "multihost", "coordinator_address",
             "num_processes", "process_id")


def config_from_args(argv=None) -> tuple:
    ap = build_argparser()
    args = ap.parse_args(argv)
    ov = {k: v for k, v in vars(args).items() if k not in RUN_FLAGS}
    return load_config(args.config, ov), args
