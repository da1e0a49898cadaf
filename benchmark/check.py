"""The comparison that decides `correct`: the program's first training
steps against the reference's, by five numbers, each with its limit
(benchmark/limits/<cell>.json):

  loss_gap        the first step's |loss_p - loss_r| / |loss_r|, from the
                  same weights on the same batch;
  loss_gap_steps  the same, the largest over the checked steps;
  grad_gap        the first gradient as Adam took it (the program's from
                  its optimizer state after one step: exp_avg / (1 -
                  beta1)), leaf by leaf: | |g_p| - |g_r| | / max(|g_r|,
                  the median leaf's |g_r|), and of those the median leaf's;
  grad_gap_worst  the same, the worst leaf's: a fault confined to one leaf
                  or one aggregator moves it and not the median;
  change_gap      each parameter's change after the last step, the same
                  measure, the median leaf's, over the leaves whose raw
                  loss gradient in the reference's first step is at least
                  a thousandth of the median leaf's (a leaf under that
                  moves under Adam by round-off alone).

The worst leaf's change (change_gap_worst) is read and shown beside them,
not compared: on sound runs it reaches the control's readings, as one
element of a small bias or norm scale flips the sign of its Adam step on
one side and not the other (PERF.md gives the readings)."""
from __future__ import annotations

import sys
from typing import Dict

import torch

NUMBERS = ("loss_gap", "loss_gap_steps", "grad_gap", "grad_gap_worst",
           "change_gap")
KEEP_SHARE = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def _gaps(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor],
          keys) -> Dict[str, float]:
    np_, nr = _norms(p), _norms(r)
    med = float(torch.tensor([nr[k] for k in r], dtype=torch.float64)
                .median())
    return {k: abs(np_[k] - nr[k]) / max(nr[k], med, 1e-30) for k in keys}


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def readings(prog: Dict, ref: Dict) -> Dict:
    """The numbers compared, the worst change and where the worst lie."""
    loss = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    grad = _gaps(prog["grad"], ref["grad"], ref["grad"])
    raw = _norms(ref["raw_grad"])
    med = _median(raw.values())
    kept = [k for k in raw if raw[k] >= KEEP_SHARE * med]
    change = _gaps(prog["change"], ref["change"], kept)
    grad_at = max(grad, key=grad.get)
    change_at = max(change, key=change.get)
    return {"loss_gap": loss[0], "grad_gap": _median(grad.values()),
            "change_gap": _median(change.values()),
            "loss_gap_steps": max(loss),
            "grad_gap_worst": grad[grad_at], "grad_at": grad_at,
            "change_gap_worst": change[change_at], "change_at": change_at,
            "left_out": sorted(set(raw) - set(kept))}


def judge(r: Dict, limits: Dict[str, float]) -> tuple:
    """(correct, {number: {"value", "limit"}}); a number that is not
    finite fails."""
    shown, ok = {}, True
    for k in NUMBERS:
        v = r[k]
        shown[k] = {"value": v, "limit": limits[k]}
        ok = ok and v == v and v <= limits[k]
    return ok, shown


def print_lines(shown: Dict, stream=sys.stderr) -> None:
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=stream)
