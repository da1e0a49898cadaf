"""The port's training recipe: checkpoint/resume, --seeds, the metric
stream and the fall-through to the final evaluation on an interrupt, each
as dgn_tpu's run and trainer do them.

  * A Checkpointer round trip on the CPU: keep-last-2 rotation, the
    scheduler restored, the model's state and Adam's moments bit for bit,
    and the restored trainer's next Adam step bit for bit equal to the
    original's (dropout 0: no random stream is saved, in either package).
  * A snapshot of another architecture raises ValueError (an array's
    shape, or their count), as dgn_tpu/train/checkpoint.py:97-107 does.
  * The entry point with --checkpoint, then --resume (tests/
    test_config_run.py:266-285's case), --seeds 41,42 (:287-299's), an
    interrupt in the second epoch, and the keys of the metrics.jsonl
    records against those of dgn_tpu's run on the same flags.
"""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from dgn_tpu_torch import run as trun
from dgn_tpu_torch.data.synthetic import synthetic_zinc
from dgn_tpu_torch.graph import mxu_bucket_sizes, pack_graphs
from dgn_tpu_torch.models import DGNConfig, zinc_model
from dgn_tpu_torch.ops.scalers import degree_stats
from dgn_tpu_torch.train.checkpoint import Checkpointer
from dgn_tpu_torch.train.trainer import TrainParams, Trainer

torch.set_num_threads(1)

TINY = ["--dataset", "ZINC", "--batch_size", "8", "--hidden_dim", "12",
        "--out_dim", "12", "--L", "2", "--synthetic_size", "24",
        "--device", "cpu"]


def _trainer(hidden=10, L=2, seed=0):
    graphs = synthetic_zinc(16, seed=3)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    cfg = DGNConfig(hidden_dim=hidden, out_dim=hidden, L=L,
                    avg_d=degree_stats(degs))
    model, loss_fn = zinc_model(cfg, torch.Generator().manual_seed(seed))
    trainer = Trainer(model, loss_fn, TrainParams(seed=41, weight_decay=1e-4),
                      task="zinc", device="cpu")
    batches = []
    for part in (graphs[:8], graphs[8:]):
        n, e, g = mxu_bucket_sizes(part, 8)
        batches.append(pack_graphs(part, n_pad=n, e_pad=e, g_pad=g,
                                   mxu_layout=True))
    return trainer, batches


def _state(trainer):
    """The model's state and Adam's moments and steps, as CPU tensors."""
    out = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for i, p in enumerate(trainer.model.parameters()):
        for k, v in trainer.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v.clone()
    return out


def test_checkpoint_round_trip(tmp_path):
    trainer, batches = _trainer()
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    for epoch, metric in enumerate((1.0, 0.9, 0.95)):
        trainer.train_step(batches[epoch % 2])
        trainer.scheduler.step(metric)
        ck.save(epoch, trainer)
    assert ck.list() == [1, 2] and ck.latest_epoch() == 2
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_000001.json", "ckpt_000001.npz", "ckpt_000002.json",
        "ckpt_000002.npz"]
    meta = json.loads((tmp_path / "ck" / "ckpt_000002.json").read_text())
    assert meta["epoch"] == 2 and meta["scheduler"] == {
        "lr": trainer.scheduler.lr, "best": 0.9, "num_bad": 1}

    fresh, _ = _trainer(seed=7)
    assert not all(torch.equal(a, b) for a, b in zip(
        fresh.model.parameters(), trainer.model.parameters()))
    assert ck.restore(fresh) == 3
    want, got = _state(trainer), _state(fresh)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    s, t = fresh.scheduler, trainer.scheduler
    assert (s.lr, s.best, s.num_bad) == (t.lr, t.best, t.num_bad)
    # the next Adam step, from the snapshot and from the live trainer
    l_a, s_a = trainer.train_step(batches[1])
    l_b, s_b = fresh.train_step(batches[1])
    assert torch.equal(l_a, l_b) and torch.equal(s_a, s_b)
    for a, b in zip(trainer.model.state_dict().values(),
                    fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    # an older snapshot by epoch
    assert ck.restore(fresh, epoch=1) == 2


@pytest.mark.parametrize("other", [dict(hidden=12), dict(L=3)],
                         ids=["shape", "count"])
def test_restore_into_another_architecture_raises(tmp_path, other):
    trainer, _ = _trainer()
    ck = Checkpointer(str(tmp_path))
    ck.save(0, trainer)
    with pytest.raises(ValueError):
        ck.restore(_trainer(**other)[0])


def test_run_checkpoint_and_resume(tmp_path):
    args = TINY + ["--checkpoint", str(tmp_path / "ck"), "--out_dir",
                   str(tmp_path / "out")]
    report = trun.run(args + ["--epochs", "2"])
    assert report["epochs_run"] == 2
    assert math.isfinite(report["final"]["val"]["mae"])
    assert Checkpointer(str(tmp_path / "ck")).list() == [0, 1]
    report2 = trun.run(args + ["--epochs", "3", "--resume"])
    assert report2["epochs_run"] == 1      # epochs 0-1 done, only 2 remains
    assert Checkpointer(str(tmp_path / "ck")).list() == [0, 1, 2]
    epochs = [json.loads(line)["epoch"] for line in
              (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert epochs == [0, 1, 2]


def test_run_seeds(tmp_path, capsys):
    r = trun.run(TINY + ["--epochs", "1", "--seeds", "41,42", "--out_dir",
                         str(tmp_path / "out"), "--checkpoint",
                         str(tmp_path / "ck")])
    assert r["seeds"] == [41, 42]
    agg = r["test_at_best_val"]["mae"]
    assert np.isfinite(agg["mean"]) and np.isfinite(agg["std"])
    maes = [t["mae"] for t in r["per_seed"]]
    assert len(maes) == 2 and maes[0] != maes[1]
    assert agg["mean"] == pytest.approx(np.mean(maes))
    assert agg["std"] == pytest.approx(np.std(maes))
    for s in (41, 42):
        assert (tmp_path / "out" / f"seed{s}" / "metrics.jsonl").is_file()
        assert Checkpointer(str(tmp_path / "ck" / f"seed{s}")).list() == [0]
    out = capsys.readouterr().out
    assert "TEST MAE: " in out and "(2/2 seeds)" in out
    assert "[dgn_tpu_torch] SEEDS {" in out


def test_interrupt_falls_through_to_the_final_evaluation(tmp_path,
                                                          monkeypatch):
    calls = []
    train_epoch = Trainer.train_epoch

    def interrupted(self, loader):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return train_epoch(self, loader)

    monkeypatch.setattr(Trainer, "train_epoch", interrupted)
    report = trun.run(TINY + ["--epochs", "3", "--out_dir", str(tmp_path)])
    assert len(calls) == 2 and report["epochs_run"] == 1
    for split in ("train", "val", "test"):
        assert math.isfinite(report["final"][split]["mae"])


def _keys(rec):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in rec.items()}


def test_metrics_records_carry_the_reference_keys(tmp_path):
    """dgn_tpu's run and the port's on the same flags: every "epoch" record
    of metrics.jsonl has the same keys, the nested metric keys included."""
    from dgn_tpu.run import run as jrun
    flags = ["--dataset", "ZINC", "--synthetic_size", "10", "--epochs", "2",
             "--batch_size", "10", "--hidden_dim", "8", "--out_dim", "8",
             "--L", "1"]
    jrun(flags + ["--out_dir", str(tmp_path / "jax")])
    trun.run(flags + ["--out_dir", str(tmp_path / "torch"), "--device",
                      "cpu"])
    recs = {}
    for side in ("jax", "torch"):
        lines = (tmp_path / side / "metrics.jsonl").read_text().splitlines()
        recs[side] = [json.loads(line) for line in lines]
        assert [r["kind"] for r in recs[side]] == ["epoch", "epoch"]
    for a, b in zip(recs["jax"], recs["torch"]):
        assert _keys(a) == _keys(b)
        assert a["epoch"] == b["epoch"]
    assert {"edges_per_s", "edge_padding_efficiency", "seconds", "lr",
            "train", "val", "test"} <= set(recs["torch"][0])
