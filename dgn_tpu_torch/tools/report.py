"""Run-report generator: metrics.jsonl -> markdown convergence summary
(a copy of `dgn_tpu/tools/report.py`, which this package may not import).

The MetricStream (observe.py) writes one JSONL record per epoch with
train/val/test metrics, lr, wall time, and throughput counters; dgn_tpu's
stream has the same record shape, so this tool reads either package's.
It condenses a stream into a convergence summary: the best-val epoch, the
final metrics, the lr steps, a sampled curve and the epoch times, and,
when the run recorded spans (`--trace_spans`), the last epoch's span table.

Usage:
    python -m dgn_tpu_torch.tools.report out/seed41/metrics.jsonl [--key mae]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def load_epochs(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "epoch":
                rows.append(rec)
    return rows


def metric_key(rows: List[dict], key: Optional[str]) -> str:
    if key:
        return key
    # runs without a val split write "val": null — fall back to train keys
    cand = [k for k in (rows[0].get("val") or rows[0]["train"])
            if k not in ("loss", "objective")]
    return cand[0] if cand else "loss"


def maximize_metric(key: str) -> bool:
    return (key in ("roc_auc", "rocauc", "ap", "acc", "f1")
            or key.startswith("hits@"))


def summarize(rows: List[dict], key: Optional[str] = None,
              curve_points: int = 12) -> dict:
    """Best-val epoch (reference best-val protocol, main_HIV.py:166-176),
    final metrics, lr trace, sampled curve, steady-state epoch seconds."""
    key = metric_key(rows, key)
    sign = -1.0 if maximize_metric(key) else 1.0
    has_val = rows[0].get("val") is not None
    best = min(rows, key=lambda r: sign * r["val"][key]) if has_val else rows[-1]
    lr_steps = []
    for prev, cur in zip(rows, rows[1:]):
        if cur["lr"] != prev["lr"]:
            lr_steps.append({"epoch": cur["epoch"], "lr": cur["lr"]})
    stride = max(1, len(rows) // curve_points)
    sampled = list(rows[::stride])
    if sampled[-1] is not rows[-1]:   # always end on the final epoch, once
        sampled.append(rows[-1])
    curve = [{"epoch": r["epoch"],
              "train": round(r["train"][key], 5),
              "val": round(r["val"][key], 5) if r.get("val") else None,
              "test": round(r["test"][key], 5) if r.get("test") else None,
              "lr": r["lr"]}
             for r in sampled]
    steady = [r["seconds"] for r in rows[1:]] or [rows[0]["seconds"]]
    spans = {"spans": rows[-1]["spans"]} if "spans" in rows[-1] else {}
    return {
        "metric": key,
        "epochs": len(rows),
        "best_epoch": best["epoch"],
        "best_val": round(best["val"][key], 5) if has_val else None,
        "test_at_best_val": round(best["test"][key], 5)
        if best.get("test") else None,
        "final": {s: round(rows[-1][s][key], 5)
                  for s in ("train", "val", "test") if rows[-1].get(s)},
        "final_lr": rows[-1]["lr"],
        "lr_steps": lr_steps,
        "curve": curve,
        "epoch_seconds_median": round(sorted(steady)[len(steady) // 2], 3),
        "epoch0_seconds_incl_compile": round(rows[0]["seconds"], 1),
        "throughput": {k: rows[-1][k] for k in
                       ("edges_per_s", "edge_padding_efficiency")
                       if k in rows[-1]},
        **spans,
    }


def to_markdown(s: dict, title: str = "") -> str:
    out = []
    if title:
        out.append(f"### {title}\n")
    out.append(f"- metric: **{s['metric']}**, epochs run: {s['epochs']}, "
               f"final lr: {s['final_lr']:.2e}")
    out.append(f"- best val: **{s['best_val']}** @ epoch {s['best_epoch']}; "
               f"test at best val: **{s['test_at_best_val']}**")
    out.append(f"- final train/val/test: "
               + " / ".join(f"{v}" for v in s["final"].values()))
    out.append(f"- median epoch: {s['epoch_seconds_median']}s "
               f"(epoch 0, warm-up and kernel builds included: "
               f"{s['epoch0_seconds_incl_compile']}s); "
               f"throughput {s['throughput']}")
    if s["lr_steps"]:
        steps = ", ".join(f"{d['lr']:.1e}@{d['epoch']}" for d in s["lr_steps"])
        out.append(f"- plateau lr steps: {steps}")
    out.append("")
    out.append("| epoch | train | val | test | lr |")
    out.append("|---|---|---|---|---|")
    for p in s["curve"]:
        out.append(f"| {p['epoch']} | {p['train']} | {p['val']} | "
                   f"{p['test']} | {p['lr']:.1e} |")
    if "spans" in s:
        out += span_table(s["spans"])
    return "\n".join(out) + "\n"


def span_table(sp: dict) -> List[str]:
    """The last epoch's spans (count, ms and self ms per step) and
    counters, as markdown lines."""
    out = ["", f"Spans of the last epoch, per step ({sp['steps']} steps):",
           "", "| span | count | ms | self ms |", "|---|---|---|---|"]
    for name, v in sp["spans"].items():
        out.append(f"| {name} | {v['count']} | {v['ms_per_step']} | "
                   f"{v['self_ms_per_step']} |")
    if sp["counters"]:
        out.append("")
        out.append("counters: " + ", ".join(
            f"{k} {v}" for k, v in sp["counters"].items()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--key", default=None)
    ap.add_argument("--title", default="")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = load_epochs(args.path)
    if not rows:
        print("no epoch records", file=sys.stderr)
        return 1
    s = summarize(rows, args.key)
    print(json.dumps(s, default=float) if args.json
          else to_markdown(s, args.title))
    return 0


if __name__ == "__main__":
    sys.exit(main())
