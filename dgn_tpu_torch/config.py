"""Typed experiment config with JSON + CLI overlay (counterpart of
`dgn_tpu/config.py`).

The same JSON schema as the reference package (configs/*.json): the
dataclass field names are the schema, unknown keys are rejected, and every
CLI flag that is given overrides the JSON value.  The flags are those of the
reference run script as far as this slice goes, plus `--device`.
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
    data_dir: str = ""            # root holding ZINC.pkl; "" -> synthetic
    cache_dir: str = ""           # eig cache location (real-file loaders)
    pos_enc_dim: int = 0
    lap_norm: str = "none"        # none | sym | walk
    coord_eig: bool = False       # superpixels only
    proportion: float = 1.0       # superpixels only
    synthetic_size: int = 512     # graphs per split in the synthetic fallback
    layout: str = "auto"          # auto = mxu, the block layout
    n_buckets: int = 1
    geometry: str = "typical"     # pad sizing of the shuffled train loader
    micro_batches: Any = "auto"   # auto = 1: the 128-graph batch is one unit


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
    ap.add_argument("--data_dir", type=str, default=None)
    ap.add_argument("--pos_enc_dim", type=int, default=None)
    ap.add_argument("--lap_norm", type=str, default=None)
    ap.add_argument("--synthetic_size", type=int, default=None)
    ap.add_argument("--layout", type=str, default=None,
                    choices=["auto", "flat", "mxu"])
    ap.add_argument("--compute_dtype", type=str, default=None)
    ap.add_argument("--geometry", type=str, default=None,
                    choices=["typical", "worst"])
    ap.add_argument("--n_buckets", type=int, default=None)
    ap.add_argument("--micro_batches", type=str, default=None)
    return ap


def config_from_args(argv=None) -> tuple:
    ap = build_argparser()
    args = ap.parse_args(argv)
    ov = {k: v for k, v in vars(args).items() if k not in ("config", "device")}
    return load_config(args.config, ov), args
