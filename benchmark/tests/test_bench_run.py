"""A run end to end at toy size on the CPU (the card check skipped by
calling the run itself), the faults it must catch, the control, and what a
run refuses to do."""
import json
import subprocess
import sys

import pytest
import torch

from bench_toy import CELLS, ROOT, SEED, TOY_CELLS, run_toy, toy_cell


def test_refuses_to_run_without_a_card():
    """No card: no result, a non-zero exit; never a CPU number under a
    device metric."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "benchmark/bench.py", "--workload",
                        "zinc-block", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_unknown_workload_is_refused():
    p = subprocess.run([sys.executable, "benchmark/bench.py", "--workload",
                        "no-such-cell", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def test_toy_run_loads_no_jax(tmp_path):
    """After a whole toy run the process holds no module whose top-level
    name is jax, jaxlib, flax or dgn_tpu (dgn_tpu_torch is the program)."""
    script = tmp_path / "toy_run.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})\n"
        "from bench_toy import run_toy\n"
        "from benchmark.bench import forbidden_modules\n"
        "r = run_toy('zinc-block', seconds=0.3)\n"
        "print(r['correct'], forbidden_modules(),"
        " 'dgn_tpu_torch' in sys.modules)\n")
    p = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "True [] True"


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    r = run_toy("zinc-block", seconds=0.3)
    assert not r["correct"]
    assert r["check"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name,layout", [("zinc-block", ""),
                                         ("cifar10-block", "flat")])
def test_half_of_the_batch_left_out_fails(monkeypatch, name, layout):
    """The loss's mean taken over the first half of each batch's graphs."""
    from dgn_tpu_torch.train import losses

    def halved(fn):
        def wrapped(scores, targets, mask):
            real = torch.nonzero(mask).flatten()
            mask = mask.clone()
            mask[real[len(real) // 2:]] = False
            return fn(scores, targets, mask)
        return wrapped

    monkeypatch.setattr(losses, "l1_loss", halved(losses.l1_loss))
    monkeypatch.setattr(losses, "cross_entropy",
                        halved(losses.cross_entropy))
    r = run_toy(name, seconds=0.3, layout=layout)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name,layout", [
    (name, layout) for name in TOY_CELLS + ["zinc-block-micro"]
    for layout in ("", "flat")])
def test_control_fails(name, layout):
    """The reference in TF32 in the program's place, and half of each batch
    left out, each read against the float32 reference at toy size, fail
    the cell's limits."""
    from benchmark import check
    from benchmark.program import CellRun
    torch.set_num_threads(2)
    run = CellRun(toy_cell(name, layout=layout), SEED, "cpu",
                  log=lambda m: None)
    run.warm_up()
    case = run.reference_case()
    run.free()
    ref = run.follow(case)
    limits = toy_cell(name).limits
    for kw in ({"precision": "tf32"}, {"keep_graphs": 0.5}):
        ok, shown = check.judge(check.readings(run.follow(case, **kw), ref),
                                limits)
        assert not ok, (kw, shown)


def _drop_second_micro_batch(monkeypatch):
    from dgn_tpu_torch.train.trainer import Trainer
    inner = Trainer.train_step

    def first_only(self, gb, aug=None):
        return inner(self, gb[:1] if isinstance(gb, list) else gb, aug)

    monkeypatch.setattr(Trainer, "train_step", first_only)


def _equal_micro_batch_weights(monkeypatch):
    from dgn_tpu_torch.train.trainer import Trainer
    monkeypatch.setattr(Trainer, "_loss_weight", lambda self, gb: 1.0)


@pytest.mark.parametrize("fault", ["equal_weights", "second_dropped"])
def test_a_micro_batch_fault_in_the_program_fails(monkeypatch, fault):
    """zinc-block-micro's micro-batches hold 8 and 7 graphs: each loss
    scaled by 1/2 instead of w_k / sum(w), or the second micro-batch left
    out of the step, fails the check."""
    {"equal_weights": _equal_micro_batch_weights,
     "second_dropped": _drop_second_micro_batch}[fault](monkeypatch)
    r = run_toy("zinc-block-micro", seconds=0.3)
    assert not r["correct"], r["check"]


def test_batch_norm_over_the_whole_batch_fails():
    """The reference in the program's place with batch norm over the whole
    batch's nodes, not each micro-batch's, fails zinc-block-micro's
    limits."""
    from benchmark import check
    from benchmark.program import CellRun
    torch.set_num_threads(2)
    cell = toy_cell("zinc-block-micro")
    run = CellRun(cell, SEED, "cpu", log=lambda m: None)
    run.warm_up()
    case = run.reference_case()
    run.free()
    assert all(isinstance(step, tuple) and len(step) == 2
               and [len(p) for p in step] == [8, 7] for step in case["batches"])
    ref = run.follow(case)
    ok, shown = check.judge(check.readings(
        run.follow(case, whole_batch_norm=True), ref), cell.limits)
    assert not ok, shown


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    p = subprocess.run([sys.executable, "benchmark/bench.py", "--workload",
                        name, "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["kind"] == card, r["check"]
