"""dgn-pcba's step at toy size on the CPU: the program's micro-batched
PCBA step (two micro-batches of 5 and 4 graphs, NaN labels, dropout 0.3,
max and min) against the plain reference (reference/tasks/pcba.py with
reference/dgn.py), from the benchmark's seeded weights; the TF32 control,
half of each batch, and three faults planted in the program, each judged
by the cell's own limits (benchmark/limits/pcba-block.json) and by toy
limits set from readings at this size; and the pair's byte count
(extremes_bytes) against chip_smoke.py's."""
import copy
import functools
import json
import re
import statistics
import types

import numpy as np
import pytest
import torch

from bench_toy import ROOT, SEED, TOY_SPEC
from benchmark import cells, check
from benchmark.program import CellRun

SEEDS = [SEED, 7, 2**40 + 3]

# Readings at this size over 16 seeds (8 for the control), sound max /
# the least of the TF32 control / the least of the three faults:
#   loss_gap        1.71e-7 / 1.71e-7 / 2.99e-6: two ulps of a loss near
#                   ln 2 either way, so the control is not held here
#   loss_gap_steps  6.03e-7 / 7.47e-5 / 6.73e-4
#   grad_gap        3.40e-8 / 7.55e-5 / 2.28e-3
#   grad_gap_worst  1.92e-7 / 2.56e-3 / 1.85e-2
#   change_gap      5.98e-5 / 1.03e-3 / 4.47e-3
# Each limit lies near the geometric mean of the sound max and the least
# reading it must reject, 4x or more from both.
TOY_LIMITS = {"loss_gap": 1e-6, "loss_gap_steps": 1e-5, "grad_gap": 2e-6,
              "grad_gap_worst": 2e-5, "change_gap": 2.5e-4}
# the numbers every reading below must fail (loss_gap is not among them)
FAILED = {"loss_gap_steps", "grad_gap", "grad_gap_worst", "change_gap"}
# the cell's own limits, set from card readings at 1,024-graph
# micro-batches: at this size a fault fails both gradient numbers and the
# TF32 control the worst leaf's (its median leaf reads 7.55e-5 here, under
# grad_gap's 1.5e-4, as on the card, where the control's least is 4.55e-5)
CELL_LIMITS = json.loads(
    (ROOT / "benchmark" / "limits" / "pcba-block.json").read_text())
CELL_FAILED = {"equal_weights": {"grad_gap", "grad_gap_worst"},
               "second_dropped": {"grad_gap", "grad_gap_worst"},
               "nan_mask_dropped": {"grad_gap", "grad_gap_worst"},
               "tf32": {"grad_gap_worst"},
               "half_batch": {"grad_gap", "grad_gap_worst"}}


def _equal_weights(setattr_):
    """Every micro-batch's loss scaled by 1 / K, not by w_k / sum(w)."""
    from dgn_tpu_torch.train.trainer import Trainer
    setattr_(Trainer, "_loss_weight", lambda self, gb: 1.0)


def _second_dropped(setattr_):
    """The step trains on its first micro-batch alone."""
    from dgn_tpu_torch.train.trainer import Trainer
    inner = Trainer.train_step

    def first_only(self, gb, aug=None):
        return inner(self, gb[:1] if isinstance(gb, list) else gb, aug)

    setattr_(Trainer, "train_step", first_only)


def _nan_mask_dropped(setattr_):
    """Every (graph, task) entry of a real graph counted as labeled, an
    unlabeled one read as a negative: a loss that stays finite."""
    from dgn_tpu_torch.train import losses

    def unmasked(scores, labels, graph_mask):
        labels = torch.nan_to_num(labels, nan=0.0)
        return losses.bce_with_logits(
            scores, labels, graph_mask[:, None].expand_as(labels))

    setattr_(losses, "masked_bce_multitask", unmasked)


FAULTS = {"equal_weights": _equal_weights, "second_dropped": _second_dropped,
          "nan_mask_dropped": _nan_mask_dropped}


def _toy():
    # a batch of 9 deals micro-batches of 5 and 4 graphs: unequal labeled
    # counts, so that their weights matter
    c = cells.find("pcba-block", TOY_SPEC)
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic["data"]["graphs"] = {"train": 27, "val": 8, "test": 8}
    c.traffic["flags"]["batch_size"] = 9
    return c


def _follow(seed, **kw):
    """The case, the program's readings and the reference's; kw goes to
    the reference in the program's place (the control) where given."""
    torch.set_num_threads(2)
    run = CellRun(_toy(), seed, "cpu", log=lambda m: None)
    run.warm_up()
    prog = run.readings()
    case = run.reference_case()
    run.free()
    ref = run.follow(case)
    return case, (run.follow(case, **kw) if kw else prog), ref


@functools.lru_cache(maxsize=None)
def _sound(seed):
    _, prog, ref = _follow(seed)
    return check.readings(prog, ref)


def _failed(r, limits=TOY_LIMITS):
    return {k for k in check.NUMBERS if not r[k] <= limits[k]}


def _vector_gaps(p, r, keys):
    """|p - r| / max(|r|, the median leaf's |r|) of each leaf in keys."""
    norm = {k: float(v.double().norm()) for k, v in r.items()}
    med = statistics.median(norm.values())
    return {k: float((p[k] - r[k]).double().norm()) / max(norm[k], med)
            for k in keys}


@pytest.mark.parametrize("seed", SEEDS)
def test_the_programs_step_follows_the_reference(seed):
    case, prog, ref = _follow(seed)
    assert all([len(p) for p in step] == [5, 4] for step in case["batches"])
    labels = np.stack([g.label for step in case["batches"] for part in step
                       for g in part])
    assert labels.shape[1] == 128 and 0.2 < np.isnan(labels).mean() < 0.4
    # the loss: a mean over ~800 labeled entries and two micro-batches,
    # summed in another order (the block layout's dense products against
    # the reference's per-edge index_add); float32 round-off, 2e-7 read
    for a, b in zip(prog["losses"], ref["losses"]):
        assert abs(a - b) <= 2e-6 * abs(b), (prog["losses"], ref["losses"])
    # the first gradient, leaf by leaf as a vector: the same round-off
    # through four layers and their backward, under 1e-6 read; a fault
    # in one aggregator or one micro-batch's weight moves it by 1e-3 and
    # more
    grad = _vector_gaps(prog["grad"], ref["grad"], ref["grad"])
    assert max(grad.values()) <= 1e-5, max(grad.items(), key=lambda kv: kv[1])
    # the weights after three Adam steps (lr 0.01), by the check's own
    # measure: Adam's first steps move an element by about lr whatever
    # its gradient's size, so an element whose gradient is round-off
    # (a bias that batch norm cancels, a max or min that a last-bit
    # difference hands to another edge) steps differently on the two
    # sides; the median leaf's norm of the change stays within 1e-5
    # (5.4e-7 read), the worst leaf's within 1e-2 (1.7e-4 read)
    r = check.readings(prog, ref)
    assert r["change_gap"] <= 1e-5, r
    assert r["change_gap_worst"] <= 1e-2, r
    # and the limits the faults and the control are judged by: the toy
    # limits and the cell's own
    assert check.judge(r, TOY_LIMITS)[0], r
    assert check.judge(r, CELL_LIMITS)[0], r


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_programs_pcba_step_fails(monkeypatch, fault, seed):
    """Each fault fails the toy limits and the cell's own on numbers the
    sound step at the same seed passes."""
    sound = _sound(seed)
    assert not _failed(sound), sound
    assert not _failed(sound, CELL_LIMITS), sound
    FAULTS[fault](monkeypatch.setattr)
    _, prog, ref = _follow(seed)
    r = check.readings(prog, ref)
    assert FAILED <= _failed(r), r
    assert not check.judge(r, TOY_LIMITS)[0]
    assert CELL_FAILED[fault] <= _failed(r, CELL_LIMITS), r
    assert not check.judge(r, CELL_LIMITS)[0]


@pytest.mark.parametrize("control", ["tf32", "half_batch"])
def test_the_control_fails_the_toy_limits(control):
    """The reference in TF32 in the program's place, and half of each
    batch left out, fail the toy limits and the cell's own where the
    sound step at the same seed passes."""
    sound = _sound(SEED)
    assert not _failed(sound), sound
    assert not _failed(sound, CELL_LIMITS), sound
    kw = {"precision": "tf32"} if control == "tf32" else {"keep_graphs": 0.5}
    _, prog, ref = _follow(SEED, **kw)
    r = check.readings(prog, ref)
    assert FAILED <= _failed(r), r
    assert CELL_FAILED[control] <= _failed(r, CELL_LIMITS), r


def test_extremes_bytes_are_chip_smokes():
    """The byte count of benchmark/extremes_bytes.py is the one chip_smoke.py
    puts behind the kernel table's bounds: its three lines evaluated at
    the PCBA micro-batch (E = 66,560 with 51,468 real, C = 520, N =
    31,872 with 25,057 reached, F = 70) give the same bytes, and those
    bytes over 3.35 TB/s are the table's 0.009730 ms forward and 0.01834
    ms backward."""
    from benchmark.extremes_bytes import extremes_bytes
    src = (ROOT / "chip_smoke.py").read_text()
    lines = re.search(r"\n( +index_bytes = .*?\n +bwd_bytes = \(.*?\)\n)",
                      src, re.S).group(1)
    shape = dict(e_pad=66560, n_real=51468, n_chunks=66560 // 128, n=31872,
                 n_dst=25057, f=70)
    env = dict(shape)
    exec(re.sub(r"^ +", "", lines, flags=re.M), {}, env)
    fwd, bwd = extremes_bytes(**shape)
    assert (fwd, bwd) == (env["fwd_bytes"], env["bwd_bytes"])
    assert f"{fwd / 3.35e12 * 1e3:.6f}" == "0.009730"
    assert f"{bwd / 3.35e12 * 1e3:.5f}" == "0.01834"


def _run(**kw):
    peaks = {"devices": {"card": {"hbm_bytes_per_s": 3.35e12}}}
    base = dict(trace={"kernel_s": {}}, peaks=peaks, device_kind="card",
                traced_sizes=[], launches={}, net={"hidden_dim": 70})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_extremes_roofline_reads_the_pairs_bytes_over_its_time():
    from benchmark.bench import load_reader
    from benchmark.extremes_bytes import real_bytes
    read = load_reader("extremes_roofline")
    sizes = [(25000, 51000, 1024), (25100, 51200, 1024)]
    kernels = {"extremes_fwd_kernel(float const*, ...)": 1e-4,
               "void extremes_bwd_kernel<70>(...)": 3e-4, "other": 1.0}
    r = read(_run(trace={"kernel_s": kernels}, traced_sizes=sizes,
                  launches={"segment_extremes_fwd": 8,
                            "segment_extremes_bwd": 8,
                            "build_pair_adjacency": 2}))
    per = [real_bytes(n, e, 70) for n, e, _ in sizes]
    want = 4 * sum(f + b for f, b in per) / 3.35e12 / 4e-4 * 100
    assert r == pytest.approx(want, rel=1e-12)
    # nothing to read: no launch, no time, no trace
    assert read(_run(trace={"kernel_s": kernels}, traced_sizes=sizes)) is None
    assert read(_run(traced_sizes=sizes, launches={
        "segment_extremes_fwd": 8})) is None
    assert read(_run(trace=None)) is None


def test_micro_batch_ms_reads_the_micro_span():
    from benchmark.bench import load_reader
    read = load_reader("micro_batch_ms")
    spans = {"spans": {"step": {"count": 3, "ms": 30.0},
                       "step.micro": {"count": 6, "ms": 24.0}},
             "counters": {"step.micro_batches": 6}}
    assert read(_run(spans=spans)) == pytest.approx(4.0)
    spans = {"spans": {"step": {"count": 3, "ms": 30.0}}, "counters": {}}
    assert read(_run(spans=spans)) is None            # the parent's case
    assert read(_run(spans=None)) is None
