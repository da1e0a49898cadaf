"""The port's tools/scaling.py against dgn_tpu/tools/scaling.py.

  * comm_model, exact host arithmetic, == dgn_tpu's for dp and ep at 1, 2
    and 4 ranks at the flagship width;
  * run_scaling at toy size on gloo ranks on the CPU: one well-formed row
    per (partition, ranks), and predicted_efficiency only where a link
    bandwidth and its source are given.
"""
from __future__ import annotations

import json
import math

import pytest

from dgn_tpu.tools import scaling as jscaling

from dgn_tpu_torch.tools import scaling


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("part", ["dp", "ep"])
def test_comm_model_matches_reference(part, n):
    kw = dict(batch=32, hidden=45, L=4)
    assert scaling.comm_model(part, n, **kw) == \
        jscaling.comm_model(part, n, **kw)


KEYS = {"metric", "n_devices", "step_ms", "efficiency",
        "comm_bytes_per_step", "predicted_efficiency", "link_bw",
        "link_bw_source", "predicted_model", "global_batch", "hidden", "L",
        "steps", "backend", "device", "ranks_per_gpu"}


def test_run_scaling_rows_on_gloo_ranks():
    lines = []
    rows = scaling.run_scaling(("dp", "ep"), (1, 2), batch=8, hidden=8, L=1,
                               steps=2, device="cpu",
                               link_bw=1e9, link_bw_source="a test figure",
                               emit=lines.append, timeout=240)
    assert sorted(rows) == [("dp", 1), ("dp", 2), ("ep", 1), ("ep", 2)]
    assert [json.loads(x) for x in lines] == list(rows.values())
    for (part, n), row in rows.items():
        assert set(row) == KEYS
        assert row["metric"] == f"scaling_{part}" and row["n_devices"] == n
        assert row["backend"] == "gloo" and row["device"] == "cpu"
        assert math.isfinite(row["step_ms"]) and row["step_ms"] > 0
        assert row["comm_bytes_per_step"] == scaling.comm_model(part, n, 8,
                                                                8, 1)
        assert 0 < row["predicted_efficiency"] <= 1.0
    assert rows[("dp", 1)]["efficiency"] == 1.0
    with pytest.raises(ValueError, match="link_bw_source"):
        scaling.run_scaling(("dp",), (1,), device="cpu", link_bw=1e9)
