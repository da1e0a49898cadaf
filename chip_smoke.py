#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (dgn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels]

Run from the root of a checkout, on a machine with a CUDA GPU (written for
the H100) and the CUDA toolkit.  `--phases kernels` runs phases 1-3 only, to
try a kernel in seconds; it prints the kernels line with `launches` null
and no device line.  Phases, each of which fails the script:

1. card: name and power limit from nvidia-smi; no CUDA device -> exit 1;
2. build: every CUDA kernel of the package, from the checkout's sources, one
   nvcc per source, all started together;
3. kernels: each kernel at its paths' shapes, held against its plain
   PyTorch version on the card and against an f64 oracle, and timed beside
   the plain version, one equivalent PyTorch call and the card's bound:
   build_pair_adjacency at the ZINC and the CIFAR10 batch, in float32 and
   in its bf16 output mode (plus a multi-block case), each timing line
   with the batch's covered, uncovered and all-pad-chunk counts, the
   launch's grid and shared bytes, the write floor (zero_() of a
   tensor of the output's shape and dtype, timed the same way) and the
   write path (the kernel given an empty chunk range for every pair), the
   segment_extremes forward/backward
   pair at the HIV batch and at one PCBA micro-batch (plus tie, star,
   multi-block and dense-block cases) with its grids;
   The extremes pair is also held against its plain version at F = 14, the
   width a towers layer gives each of its 5 towers at HIV's hidden 70;
4. training, once per path: the port's entry point (dgn_tpu_torch.run)
   trains each of the thirteen configs of PATHS at full width on the card:
   ZINC, HIV, PATTERN, CIFAR10, PCBA at its batch of 2048 in 2
   micro-batches, and with the options of the reference's own training
   scripts: ZINC with 5 towers, flip and a positional encoding
   (zinc-towers), PCBA with the virtual node (pcba-vn), CIFAR10 with
   rotation, distortion, flip, a 2-layer posttrans and input dropout
   (cifar10-aug), ZINC with bond-type edge features (zinc-edge), the same
   with a 2-layer per-edge pretrans and a 2-layer posttrans
   (zinc-pretrans), HIV on the per-edge message path (hiv-per-edge,
   --decompose False), ZINC and HIV on the flat layout (zinc-flat,
   hiv-flat, --layout flat: segment ops, no kernel), and ZINC, HIV and
   CIFAR10 in bfloat16 (zinc-bf16, hiv-bf16, cifar10-bf16,
   --compute_dtype bfloat16: the adjacency kernel's bf16 blocks, bf16
   operands with float32 accumulation in every block product, gather and
   scatter; each path's launches must equal its float32 sibling's, and
   its blocks must be bf16).  Every kernel launch
   counter is set to 0 just before and read just after each run, and
   checked against the count the path's loaders, tower count, edge stage
   and layout imply (no adjacency build where the config does not
   decompose, no launch at all on the flat layout); then each path's step
   time and device activity, and one step from identical weights and
   identical augmentation draws on the CPU and on the card (with the
   entries that fall on different sides of a kink, a max/min edge, abs or
   a ReLU, on the two sides: where gradients may hop).  On the ZINC
   batch, one more such step with the softmax aggregators (`mean dir1-0.1
   dir1-neg-0.1`), decomposed (their weights go through
   build_pair_adjacency) and per-edge.  On zinc-flat's first batch, the
   flat-versus-block check: the same graphs packed both ways, one step
   from the same weights on the card, the same loss and scores.  Each
   path prints its peak device memory (torch.cuda.max_memory_allocated)
   over its entry-point run and over its timed steps, and each bf16 path
   its float32 sibling's step figures from the same call beside its own;
5. COLLAB: `dgn_tpu_torch.run --dataset COLLAB` trains link prediction on
   one synthetic 4,096-node graph (one epoch of 3 edge batches of 4,096,
   the default DGN-complex net at hidden 45, L = 4) with both counters
   at 0 before and required at 0 after; then MIN_STEPS train steps timed
   and profiled, and one step from identical weights and identical
   positive and negative edges on the CPU and on the card;
6. recipe: through the entry point on the card, outputs under out/: ZINC
   with --checkpoint for 2 epochs, then --resume to 3 (one epoch run,
   resumed from epoch 1), the snapshot restored into a fresh trainer bit
   for bit; --seeds 41,42 (a finite mean and std, a metrics.jsonl and a
   checkpoint directory per seed); tools/report.py over one metrics.jsonl;
   poison_padding (the flat layout's eval scores of ZINC's and HIV's first
   batches unchanged and finite; the extremes pair on HIV's block batch
   with NaN in every pad edge's lane gives the clean result, and the
   block layout's model output under poison is reported); profile_steps
   writes a trace of 3 train steps.

Prints a `{"kernels": [...]}` line and, last, the device line
`{"ok": true, "device": {...}}`.  Needs no network; starts no process other
than nvidia-smi and nvcc, and waits for each.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Tuple

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "configs"


class TrainPath(NamedTuple):
    """One training path: the config, the count of its DGN layers whose
    max/min runs the extremes kernel pair (0 on the flat layout, whose
    max/min is scatter_reduce), its synthetic_size and extra CLI flags."""
    key: str
    config: str
    extremes_layers: int
    size: int
    flags: Tuple[str, ...] = ()


ZINC = "molecules_graph_regression_DGN_ZINC.json"
HIV = "molecules_graph_classification_DGN_HIV.json"
PCBA = "molecules_graph_classification_DGN_PCBA.json"
CIFAR10 = "superpixels_graph_classification_DGN_CIFAR10.json"
BF16_FLAGS = ("--compute_dtype", "bfloat16")
# PATTERN's 4096 gives 1024 train graphs (load_sbm keeps n // 4), PCBA's
# 4096 gives two steps of 2048 graphs per epoch.  The augmentation values
# are tests/test_train.py's: the repo has no published setting for them.
PATHS = (
    TrainPath("zinc", ZINC, 0, 1024),
    TrainPath("hiv", HIV, 4, 1024),
    TrainPath("pattern", "SBMs_node_clustering_DGN_PATTERN.json", 0, 4096),
    TrainPath("cifar10", CIFAR10, 0, 1024),
    TrainPath("pcba", PCBA, 4, 4096),
    TrainPath("zinc-towers", ZINC, 0, 1024,
              ("--type_net", "towers", "--flip", "True", "--pos_enc_dim",
               "5")),
    TrainPath("pcba-vn", PCBA, 4, 4096, ("--virtual_node", "mean")),
    TrainPath("cifar10-aug", CIFAR10, 0, 1024,
              ("--augmentation", "15", "--distortion", "0.1", "--flip",
               "True", "--posttrans_layers", "2", "--in_feat_dropout",
               "0.1")),
    TrainPath("zinc-edge", ZINC, 0, 1024, ("--edge_feat", "True")),
    TrainPath("zinc-pretrans", ZINC, 0, 1024,
              ("--edge_feat", "True", "--pretrans_layers", "2",
               "--posttrans_layers", "2")),
    TrainPath("hiv-per-edge", HIV, 4, 1024, ("--decompose", "False")),
    TrainPath("zinc-flat", ZINC, 0, 1024, ("--layout", "flat")),
    TrainPath("hiv-flat", HIV, 0, 1024, ("--layout", "flat")),
    TrainPath("zinc-bf16", ZINC, 0, 1024, BF16_FLAGS),
    TrainPath("hiv-bf16", HIV, 4, 1024, BF16_FLAGS),
    TrainPath("cifar10-bf16", CIFAR10, 0, 1024, BF16_FLAGS))
# COLLAB's dense eigensolve grows as n^3: 4,096 nodes take about 10 s of
# host time, 16,384 did not finish in 90 s
COLLAB_NODES = 4096
SOFTMAX_AGGREGATORS = "mean dir1-0.1 dir1-neg-0.1"
EPOCHS = 1
MIN_STEPS = 24           # timed train steps per path (the first 3 dropped)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
F32_TOL, BF16_TOL = 1e-6, 1e-2
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# a bf16 step: both sides round the same float32 values, but values that
# differ in their last float32 bit between the CPU and the card can round
# to neighbouring bf16 values (2^-8 apart); the CPU tests hold the port
# against dgn_tpu in bf16 at the same 2e-2 (tests/test_torch_bf16.py)
BF16_STEP_RTOL, BF16_STEP_ATOL = 2e-2, 2e-3
POISON_RTOL, POISON_ATOL = 1e-5, 1e-6
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_events(torch, prof):
    """The device-side activities (kernels, memsets, copies) of a profile,
    without user-annotation ranges, which would count time twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def timed(torch, fn, iters: int = 20, warmup: int = 3):
    """(device ms, call ms) per call of fn(i) for i in range(iters).

    device ms: the summed durations of the device activities torch.profiler
    records, so host time between launches does not count.  call ms: CUDA
    events around back-to-back calls, host overhead included (a call whose
    device work is shorter than its launch reads the launch)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    # every call launches at least one device activity: a window with fewer
    # lost some of them, and would read low
    events = profiled(torch, lambda: [fn(i) for i in range(iters)],
                      min_events=iters)
    return sum(e.device_time for e in events) / 1e3 / iters, call_ms


def profiled(torch, run, min_events: int = 1):
    """The device events of run() under torch.profiler.  A window whose
    trace comes back with fewer than min_events device activities is run
    again, twice at most, before the script fails."""
    from torch.profiler import ProfilerActivity, profile
    for window in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = device_events(torch, prof)
        if len(events) >= min_events:
            return events
        print(f"torch.profiler recorded {len(events)} device activities in "
              f"window {window + 1} of 3, fewer than {min_events}")
    fail(f"torch.profiler recorded fewer than {min_events} device "
         "activities")


def multiblock_graphs(np, GraphData, n_graphs: int = 4, seed: int = 11):
    """Random graphs of 135-170 nodes: each spans two 128-node blocks, so
    the layout has real off-diagonal (src_block != dst_block) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(135, 171))
        us, vs = np.nonzero(np.triu(rng.random((n, n)) < 0.05, k=1))
        src = np.concatenate([us, vs]).astype(np.int32)
        dst = np.concatenate([vs, us]).astype(np.int32)
        out.append(GraphData(num_nodes=n, src=src, dst=dst,
                             node_feat=np.zeros(n, np.int32),
                             eig=rng.normal(size=(n, 2)).astype(np.float32),
                             label=np.zeros(1, np.float32)))
    return out


def packed(graphs):
    """One block-layout batch at the worst-case pads of its graphs, in the
    loader's order (descending node count)."""
    from dgn_tpu_torch.graph import mxu_bucket_sizes, mxu_pair_pad, pack_graphs
    graphs = sorted(graphs, key=lambda g: -g.num_nodes)
    n_pad, e_pad, g_pad = mxu_bucket_sizes(graphs, len(graphs))
    return pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                       mxu_layout=True, n_pairs_pad=mxu_pair_pad(
                           graphs, len(graphs), n_pad, e_pad))


def bound(bytes_moved: int, ops: int):
    """(bound ms, "bytes" or "operations"): the larger of bytes over the HBM
    rate and operations over the f32 rate."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


_PREPARED = {}
_LOADS = []          # one entry per load_dataset call since share_datasets


def share_datasets() -> None:
    """Build each synthetic dataset once per script run.  The kernel phase,
    each path's launch count and step, and the path's entry-point run read
    the same splits, and two paths of one config and size (cifar10 and
    cifar10-aug) share them: a CIFAR10 build (1,228 non-symmetric eig
    solves on the host) takes about 23 s.  run.prepare looks the loader up
    at call time, so the entry point runs as a user calls it, minus the
    repeated data generation; drive_path fails if a run loads its data
    without this cache."""
    from dgn_tpu_torch.data import datasets
    load, load_collab, cache = datasets.load_dataset, datasets.load_collab, {}

    def load_once(name, dp):
        key = (name, dataclasses.astuple(dp))
        _LOADS.append(key)
        if key not in cache:
            cache[key] = (load_collab(dp) if name == "COLLAB"
                          else load(name, dp))
        return cache[key]

    datasets.load_dataset = load_once
    datasets.load_collab = lambda dp: load_once("COLLAB", dp)


def is_flat(path: TrainPath) -> bool:
    return "--layout" in path.flags and \
        path.flags[path.flags.index("--layout") + 1] == "flat"


def towers_of(net) -> int:
    """Towers per DGN layer of a net config; each runs its own max/min."""
    return net.towers if net.type_net == "towers" else 1


def adjacency_builds(net, flat: bool) -> int:
    """Adjacency builds per forward pass of a net config: 1 where it takes
    the decomposed edge stage (decompose on and a linear pretrans, which
    the simple layer always has) on the block layout, 0 on the per-edge
    message path and on the flat layout, which builds no blocks."""
    return int(not flat and net.decompose and (
        net.type_net == "simple" or net.pretrans_layers == 1))


def path_argv(path: TrainPath) -> list:
    """The entry point's arguments for the path, without epochs and
    device."""
    return ["--config", str(CONFIGS / path.config), "--synthetic_size",
            str(path.size), *path.flags]


def prepared(key: str):
    """run.prepare's (ds, model, loss_fn, trainer, loaders) for the path and
    its config, built once: the kernel phase takes its first train batch and
    the training phase its loaders' batch counts, step and CPU-vs-card
    check from the same dataset."""
    if key not in _PREPARED:
        from dgn_tpu_torch import run
        from dgn_tpu_torch.config import config_from_args
        cfg, _ = config_from_args(path_argv(next(p for p in PATHS
                                                 if p.key == key)))
        _PREPARED[key] = run.prepare(cfg, DEVICE) + (cfg,)
    return _PREPARED[key]


def first_train_batch(key: str):
    """The first batch the path's shuffled train loader yields (a list of
    micro-batches for PCBA)."""
    return next(iter(prepared(key)[4]["train"]))


def family_weights(torch, gb, families):
    """[K, E] edge-mask-folded weights of the families ("one", "delta{k}",
    "abs{k}") as build_edge_context makes them, for a batch on the card."""
    mask = gb.edge_mask.float()
    rows = []
    for fam in families:
        if fam == "one":
            rows.append(mask)
            continue
        k = int(fam[-1])
        delta = gb.eig[gb.src.long(), k] - gb.eig[gb.dst.long(), k]
        rows.append((delta.abs() if fam.startswith("abs") else delta) * mask)
    return torch.stack(rows).contiguous()


def time_adjacency(torch, w, layout, shape: str, out_dtype) -> dict:
    """build_pair_adjacency at one shape and output dtype: device ms of the
    kernel, the plain version and the library call, the card's bound, the
    write floor: the device ms of zeroing a fresh tensor of the output's
    shape and dtype, timed the same way, which is what this card takes to
    write the same bytes in the same loop, and the write path: the kernel
    given an empty chunk range for every pair, so that it only writes
    zeros (the kernel's time less its loads and scatter)."""
    from dgn_tpu_torch.ops import adjacency
    dev = w.device
    k, e_pad = w.shape
    p = layout.n_pairs
    ms, call_ms = timed(
        torch, lambda i: adjacency.build_pair_adjacency(w, layout, out_dtype))
    plain_ms, plain_call_ms = timed(
        torch, lambda i: adjacency.build_pair_adjacency_plain(w, layout,
                                                              out_dtype))
    # the library call: one accumulating index_put_ into a zeroed tensor of
    # the output dtype.  Checked once against the kernel; the timed calls
    # then accumulate into the same tensor, which is the same work.
    out = torch.zeros((p, k, 128, 128), device=dev, dtype=out_dtype)
    idx = (layout.chunk_pair.long().repeat_interleave(128).expand(k, e_pad),
           torch.arange(k, device=dev)[:, None].expand(k, e_pad),
           layout.local_src.long().expand(k, e_pad),
           layout.local_dst.long().expand(k, e_pad))
    w_out = w.to(out_dtype)
    out.index_put_(idx, w_out, accumulate=True)
    ref = adjacency.build_pair_adjacency(w, layout, out_dtype)
    tol = F32_TOL if out_dtype == torch.float32 else BF16_TOL
    if (out.float() - ref.float()).abs().max().item() > tol:
        fail("the library call does not compute build_pair_adjacency")
    library_ms, library_call_ms = timed(
        torch, lambda i: out.index_put_(idx, w_out, accumulate=True))
    floor_ms, _ = timed(torch, lambda i: torch.empty(
        (p, k, 128, 128), device=dev, dtype=out_dtype).zero_())
    empty = dataclasses.replace(
        layout, pair_chunk_start=torch.zeros_like(layout.pair_chunk_start))
    if adjacency.build_pair_adjacency(w, empty, out_dtype).any():
        fail(f"build_pair_adjacency's write path is not zero ({shape})")
    write_path_ms, _ = timed(
        torch, lambda i: adjacency.build_pair_adjacency(w, empty, out_dtype))
    n_chunks = e_pad // 128
    real_chunks = int(layout.pair_chunk_start[-1])
    out_bytes = torch.finfo(out_dtype).bits // 8
    # inputs the kernel must read: the weights and local_src/dst of the
    # chunks that hold a real edge (the all-pad ones add nothing and are
    # never read) and its walk arrays (their entries of
    # pair_real_chunk_order, pair_chunk_start [P + 1])
    bytes_moved = (real_chunks * 128 * (k * 4 + 2 * 4)
                   + (real_chunks + p + 1) * 4
                   + p * k * 128 * 128 * out_bytes)
    adds = int((w != 0).sum().item())
    bound_ms, bound_by = bound(bytes_moved, adds)
    covered = layout.pair_covered
    off = int(((layout.pair_src != layout.pair_dst) & covered).sum())
    launch = adjacency.launch_shape(k, p)
    print(f"kernel build_pair_adjacency timing ({shape}, {out_dtype}): "
          f"K={k} E={e_pad} "
          f"C={n_chunks} P={p} ({int(covered.sum())} covered, {off} of them "
          f"off-diagonal, {p - int(covered.sum())} uncovered), "
          f"{n_chunks - real_chunks} all-pad chunks; grid {launch['grid']} "
          f"x {launch['threads']} threads, {launch['smem_bytes']} shared "
          f"bytes per CTA; {bytes_moved} bytes, {adds} adds; device ms "
          f"kernel {ms:.5f}, plain {plain_ms:.5f}, library {library_ms:.5f}, "
          f"bound {bound_ms:.5f}, write floor {floor_ms:.5f}, write path "
          f"{write_path_ms:.5f} (kernel at "
          f"{bound_ms / ms:.1%} of its bound, floor at "
          f"{bound_ms / floor_ms:.1%}); per call incl. host: kernel "
          f"{call_ms:.5f}, plain {plain_call_ms:.5f}, library "
          f"{library_call_ms:.5f}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "write_floor_ms": floor_ms, "write_path_ms": write_path_ms}


def adjacency_phase(torch, np):
    """build_pair_adjacency against its plain version and an f64 oracle,
    then timed at the ZINC batch and at the CIFAR10 path's first batch
    (graphs of 140-159 nodes, each spanning two node blocks, so the batch
    has off-diagonal pairs), in float32 and in the bf16 output mode the
    bf16 paths run.  One entry per shape and dtype: `build_pair_adjacency`
    at the ZINC batch, `build_pair_adjacency@cifar10` at the CIFAR10 one,
    `build_pair_adjacency@bf16` and `build_pair_adjacency@cifar10-bf16`
    the same in bf16."""
    from dgn_tpu_torch.data.synthetic import synthetic_zinc
    from dgn_tpu_torch.graph import GraphData
    from dgn_tpu_torch.ops import adjacency

    dev = torch.device(DEVICE)
    # 128 graphs each, with the families their path's aggregators need:
    # ZINC `mean dir1-dx dir1-av`, CIFAR10 `mean dir1-dx dir2-dx`
    zinc = packed(synthetic_zinc(512, seed=41)[:128]).to(dev)
    w_zinc = family_weights(torch, zinc, ("one", "delta1", "abs1"))
    cifar = first_train_batch("cifar10").to(dev)
    w_cifar = family_weights(torch, cifar, ("one", "delta1", "delta2"))

    sbm = packed(multiblock_graphs(np, GraphData))
    lay = sbm.mxu
    if not bool(((lay.pair_src != lay.pair_dst) & lay.pair_covered).any()):
        fail("multi-block case packed no off-diagonal pair")
    rng = np.random.default_rng(5)
    w_sbm = torch.from_numpy(
        rng.normal(size=(2, sbm.num_edges_padded)).astype(np.float32)
        * sbm.edge_mask.numpy()).to(dev)

    cases = [("zinc_main_f32", w_zinc, zinc.mxu, torch.float32),
             ("zinc_main_bf16", w_zinc, zinc.mxu, torch.bfloat16),
             ("sbm_multiblock_f32", w_sbm, lay.to(dev), torch.float32),
             ("cifar10_main_f32", w_cifar, cifar.mxu, torch.float32),
             ("cifar10_main_bf16", w_cifar, cifar.mxu, torch.bfloat16)]
    errs = {}
    for name, w, layout, dt in cases:
        got = adjacency.build_pair_adjacency(w, layout, dt)
        torch.cuda.synchronize()
        plain = adjacency.build_pair_adjacency_plain(w, layout, dt)
        oracle = adjacency.build_pair_adjacency_plain(
            w.double().cpu(), layout.to("cpu"))
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        e_plain = (got.float() - plain.float()).abs().max().item()
        e_oracle = (got.cpu().double() - oracle).abs().max().item()
        print(f"kernel build_pair_adjacency {name}: out {tuple(got.shape)} "
              f"{dt}, max|kernel-plain| {e_plain:.3g}, "
              f"max|kernel-f64 oracle| {e_oracle:.3g} (tol {tol:g})")
        if not (e_plain <= tol and e_oracle <= tol):
            fail(f"build_pair_adjacency {name} disagrees beyond {tol}")
        errs[name] = e_plain
        del got, plain, oracle

    common = {"route": "cuda", "source": "dgn_tpu_torch/ops/csrc/adjacency.cu",
              "replaces": "dgn_tpu/ops/pallas/adjacency.py:83",
              "launches": None}
    f32, bf16 = torch.float32, torch.bfloat16
    return [dict(common, name="build_pair_adjacency", path="zinc",
                 max_abs_err=errs["zinc_main_f32"],
                 **time_adjacency(torch, w_zinc, zinc.mxu, "zinc", f32)),
            dict(common, name="build_pair_adjacency@cifar10", path="cifar10",
                 max_abs_err=errs["cifar10_main_f32"],
                 **time_adjacency(torch, w_cifar, cifar.mxu, "cifar10", f32)),
            dict(common, name="build_pair_adjacency@bf16", path="zinc-bf16",
                 max_abs_err=errs["zinc_main_bf16"],
                 **time_adjacency(torch, w_zinc, zinc.mxu, "zinc", bf16)),
            dict(common, name="build_pair_adjacency@cifar10-bf16",
                 path="cifar10-bf16", max_abs_err=errs["cifar10_main_bf16"],
                 **time_adjacency(torch, w_cifar, cifar.mxu, "cifar10",
                                  bf16))]


def star_graph(np, GraphData, n: int = 120, hub: int = 10):
    """A star whose hub gets n-1 in-edges.  The hub is node 10, so the 10
    leaves before it come first in the dst-sorted edges and the hub's run
    of 119 edges crosses the 128-edge chunk boundary."""
    leaves = np.delete(np.arange(n), hub)
    hubs = np.full(n - 1, hub)
    return GraphData(num_nodes=n,
                     src=np.concatenate([leaves, hubs]).astype(np.int32),
                     dst=np.concatenate([hubs, leaves]).astype(np.int32),
                     node_feat=np.zeros(n, np.int32),
                     eig=np.zeros((n, 2), np.float32),
                     label=np.zeros(1, np.float32))


def dense_graph(np, GraphData, n: int = 128):
    """One graph at density 0.3: 40 chunks in one dst block, more than the
    extremes kernels stage at once, in-degree up to 51."""
    rng = np.random.default_rng(5)
    us, vs = np.nonzero(np.triu(rng.random((n, n)) < 0.3, k=1))
    return GraphData(num_nodes=n,
                     src=np.concatenate([us, vs]).astype(np.int32),
                     dst=np.concatenate([vs, us]).astype(np.int32),
                     node_feat=np.zeros(n, np.int32),
                     eig=np.zeros((n, 2), np.float32),
                     label=np.zeros(1, np.float32))


def time_extremes(torch, np, gb, ge: np.ndarray, shape: str) -> list:
    """The extremes forward and backward at one shape (gb on the CPU, ge its
    [E, F] edge values): device ms of the kernel, the plain version (and its
    autograd) and the library call, the card's bounds, and the grids."""
    from dgn_tpu_torch.ops import extremes
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(9)
    layout, mask = gb.mxu.to(dev), gb.edge_mask.to(dev)
    n, f = gb.num_nodes_padded, ge.shape[1]
    x = torch.from_numpy(ge).to(dev)
    e_pad = x.shape[0]
    n_chunks = e_pad // 128
    n_real = int(mask.sum().item())
    dst = (layout.edge_chunk_dst.long().repeat_interleave(128) * 128
           + layout.local_dst.long())
    n_dst = int(torch.unique(dst[mask]).numel())
    dmx = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(dev)
    dmn = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(dev)
    mx, mn = extremes.segment_extremes_fwd(x, layout, mask, n)
    fwd_ms, fwd_call = timed(
        torch, lambda i: extremes.segment_extremes_fwd(x, layout, mask, n))
    bwd_ms, bwd_call = timed(torch, lambda i: extremes.segment_extremes_bwd(
        x, mx, mn, dmx, dmn, layout, mask))
    pfwd_ms, pfwd_call = timed(
        torch, lambda i: extremes.segment_extremes_plain(x, layout, mask, n))
    xp = x.clone().requires_grad_()
    pout = extremes.segment_extremes_plain(xp, layout, mask, n)
    pbwd_ms, pbwd_call = timed(torch, lambda i: torch.autograd.grad(
        pout, xp, (dmx, dmn), retain_graph=True))
    # the library call: scatter_reduce amax and amin into a zeroed buffer
    # whose extra row n takes the pad edges (include_self=False leaves rows
    # without an edge at 0).  Checked once against the kernel.
    idx = torch.where(mask, dst, n)[:, None].expand(-1, f).contiguous()
    buf = torch.zeros((n + 1, f), device=dev)

    def library(v):
        return (buf.scatter_reduce(0, idx, v, "amax", include_self=False),
                buf.scatter_reduce(0, idx, v, "amin", include_self=False))

    lmx, lmn = library(x)
    if not (torch.equal(lmx[:n], mx) and torch.equal(lmn[:n], mn)):
        fail("the library call does not compute segment_extremes")
    lib_fwd_ms, lib_fwd_call = timed(torch, lambda i: library(x))
    xl = x.clone().requires_grad_()
    lout = library(xl)
    zero_row = torch.zeros((1, f), device=dev)
    lct = (torch.cat([dmx, zero_row]), torch.cat([dmn, zero_row]))
    lib_bwd_ms, lib_bwd_call = timed(torch, lambda i: torch.autograd.grad(
        lout, xl, lct, retain_graph=True))
    # bytes each must move: the real edges' values, the layout's index and
    # mask arrays, and the outputs (forward: max and min [N, F]; backward:
    # reads max, min and both cotangents at the n_dst nodes that real edges
    # reach, writes d_ge [E, F] whole)
    index_bytes = e_pad * 4 + e_pad + n_chunks * 4
    fwd_bytes = n_real * f * 4 + index_bytes + 2 * n * f * 4
    bwd_bytes = (n_real * f * 4 + index_bytes + 4 * n_dst * f * 4
                 + e_pad * f * 4)
    fwd_bound, fwd_by = bound(fwd_bytes, 2 * n_real * f)
    bwd_bound, bwd_by = bound(bwd_bytes, 6 * n_real * f + 2 * n_dst * f)
    launch = extremes.launch_shape(f, n_chunks, layout.n_node_blocks)
    print(f"kernel segment_extremes launch ({shape}): " + "; ".join(
        f"{k} grid {s['grid'][0]}x{s['grid'][1]} = "
        f"{s['grid'][0] * s['grid'][1]} blocks of 256 threads, "
        f"{s['smem_bytes']} dynamic shared bytes" for k, s in launch.items()))
    print(f"kernel segment_extremes timing ({shape}): E={e_pad} ({n_real} "
          f"real) C={n_chunks} N={n} ({n_dst} reached by a real edge, "
          f"{layout.n_node_blocks} node blocks) "
          f"F={f}; forward {fwd_bytes} bytes: device ms kernel "
          f"{fwd_ms:.5f}, plain {pfwd_ms:.5f}, library {lib_fwd_ms:.5f}, "
          f"bound {fwd_bound:.5f}; per call incl. host: kernel "
          f"{fwd_call:.5f}, plain {pfwd_call:.5f}, library {lib_fwd_call:.5f}")
    print(f"kernel segment_extremes timing ({shape}): backward {bwd_bytes} "
          f"bytes: device ms kernel {bwd_ms:.5f}, plain (autograd) "
          f"{pbwd_ms:.5f}, library (autograd) {lib_bwd_ms:.5f}, bound "
          f"{bwd_bound:.5f}; per call incl. host: kernel {bwd_call:.5f}, "
          f"plain {pbwd_call:.5f}, library {lib_bwd_call:.5f}")
    return [{"ms": fwd_ms, "plain_ms": pfwd_ms, "bound_ms": fwd_bound,
             "bound_by": fwd_by, "library_ms": lib_fwd_ms},
            {"ms": bwd_ms, "plain_ms": pbwd_ms, "bound_ms": bwd_bound,
             "bound_by": bwd_by, "library_ms": lib_bwd_ms}]


def extremes_phase(torch, np):
    """The segment_extremes kernel pair against its plain version (forward
    and autograd backward) and an f64 oracle, at F = 70 and at a tower's
    F = 14, then timed at the HIV batch (128 synthetic ogbg-molhiv graphs)
    and at one PCBA micro-batch (1024 synthetic ogbg-molpcba graphs of a
    2048-graph batch), F = 70.  One
    entry per kernel and shape: `segment_extremes_fwd`/`_bwd` at the HIV
    batch, `segment_extremes_fwd@pcba`/`_bwd@pcba` at the PCBA one."""
    from dgn_tpu_torch.data.synthetic import synthetic_ogb_mol
    from dgn_tpu_torch.graph import GraphData
    from dgn_tpu_torch.ops import extremes

    dev = torch.device(DEVICE)
    f_main = 70
    hiv = packed(synthetic_ogb_mol(512, seed=41, n_tasks=1, k_eig=4)[:128])
    pcba = first_train_batch("pcba")[0]
    rng = np.random.default_rng(7)

    def layer_values(gb, f=f_main):
        # what a layer hands the kernel: ge = h[src] of post-ReLU node
        # features, so exact zeros tie (ReLU) and one src's value repeats
        # across its edges
        h = np.maximum(rng.normal(size=(gb.num_nodes_padded, f)), 0.0)
        return h.astype(np.float32)[gb.src.numpy()]

    def quantized(gb, f):
        v = rng.normal(size=(gb.num_edges_padded, f))
        return (np.round(v * 2.0) / 2.0).astype(np.float32)

    ge_hiv, ge_pcba = layer_values(hiv), layer_values(pcba)
    star = packed([star_graph(np, GraphData)])
    sbm = packed(multiblock_graphs(np, GraphData))
    dense = packed([dense_graph(np, GraphData)])
    # towers of a 70-wide layer: 5 towers of 14 features, below one
    # 16-feature tile
    cases = [("hiv_main_f70", hiv, ge_hiv),
             ("hiv_towers_f14", hiv, layer_values(hiv, 14)),
             ("hiv_quantized_ties", hiv, quantized(hiv, f_main)),
             ("star_in_degree_119", star, quantized(star, 16)),
             ("sbm_multiblock", sbm, quantized(sbm, 16)),
             ("dense_block", dense, quantized(dense, f_main)),
             ("pcba_micro_f70", pcba, ge_pcba)]
    errs = {}
    for name, gb, vals in cases:
        layout, mask = gb.mxu.to(dev), gb.edge_mask.to(dev)
        n = gb.num_nodes_padded
        w1 = torch.from_numpy(rng.normal(size=(n, vals.shape[1])).astype(
            np.float32)).to(dev)

        def run(fn, dev_=dev, layout_=layout, mask_=mask, w=w1):
            x = torch.tensor(vals, device=dev_, requires_grad=True)
            mx, mn = fn(x, layout_, mask_, n)
            ((w * mx).sum() + (torch.sin(w) * mn).sum()).backward()
            return mx.detach(), mn.detach(), x.grad

        mx, mn, grad = run(extremes.segment_extremes)
        torch.cuda.synchronize()
        pmx, pmn, pgrad = run(extremes.segment_extremes_plain)
        omx, omn = extremes.segment_extremes_plain(
            torch.from_numpy(vals).double(), gb.mxu, gb.edge_mask, n)
        e_plain = max((mx - pmx).abs().max().item(),
                      (mn - pmn).abs().max().item())
        e_oracle = max((mx.cpu().double() - omx).abs().max().item(),
                       (mn.cpu().double() - omn).abs().max().item())
        e_grad = (grad - pgrad).abs().max().item()
        pad_grad = grad[~mask].abs().max().item() if (~mask).any() else 0.0
        print(f"kernel segment_extremes {name}: ge {tuple(vals.shape)}, "
              f"forward max|kernel-plain| {e_plain:.3g}, max|kernel-f64 "
              f"oracle| {e_oracle:.3g} (tol 0); backward max|kernel-plain| "
              f"{e_grad:.3g} (tol {F32_TOL:g}), max|pad-edge grad| "
              f"{pad_grad:.3g} (must be 0)")
        if e_plain != 0 or e_oracle != 0:
            fail(f"segment_extremes forward {name} is not exact")
        if not e_grad <= F32_TOL or pad_grad != 0:
            fail(f"segment_extremes backward {name} disagrees")
        errs[name] = (e_plain, e_grad)

    common = {"route": "cuda", "source": "dgn_tpu_torch/ops/csrc/extremes.cu",
              "launches": None}
    out = []
    for path, suffix, case, times in (
            ("hiv", "", "hiv_main_f70",
             time_extremes(torch, np, hiv, ge_hiv, "hiv")),
            ("pcba", "@pcba", "pcba_micro_f70",
             time_extremes(torch, np, pcba, ge_pcba, "pcba micro"))):
        for i, (name, replaces) in enumerate(
                (("segment_extremes_fwd", "dgn_tpu/ops/extremes.py:200"),
                 ("segment_extremes_bwd", "dgn_tpu/ops/extremes.py:173"))):
            out.append(dict(common, name=name + suffix, replaces=replaces,
                            path=path, max_abs_err=errs[case][i],
                            **times[i]))
    return out


def launch_counters():
    from dgn_tpu_torch.ops import adjacency, extremes
    return {"build_pair_adjacency": adjacency.build_pair_adjacency,
            "segment_extremes_fwd": extremes.segment_extremes_fwd,
            "segment_extremes_bwd": extremes.segment_extremes_bwd}


def packed_units(loader) -> int:
    """GraphBatches one pass of the loader yields: one per batch, or one per
    non-empty micro-batch of each batch."""
    n, bs, k = len(loader.graphs), loader.batch_size, loader.micro_batches
    return sum(min(k, bs, n - i) for i in range(0, n, bs))


def drive_path(torch, path: TrainPath):
    """Train the path's config through the user's entry point with every launch
    counter at 0 just before; fails unless the launches are what the path
    must make.  Per packed (micro-)batch: one adjacency build per forward
    pass whatever the tower count where the config decomposes, none where
    it does not (each train step, each of the shuffled
    train loader's in the final eval, and each cached val/test batch once,
    as the trainer keeps their edge contexts), the extremes forward once per
    max/min layer and tower per forward pass, and their backward once per
    such layer and tower per train step.  The counts of packed batches come
    from the path's loaders as run.prepare builds them (`prepared`).
    Returns (report, launches, peak device bytes over the run)."""
    from dgn_tpu_torch import run
    argv = path_argv(path) + ["--epochs", str(EPOCHS), "--device", DEVICE]
    counters = launch_counters()
    n_loads = len(_LOADS)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    report = run.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if len(_LOADS) != n_loads + 1:
        fail(f"{path.key}: the run did not load its dataset once through "
             "share_datasets' cache")
    _, model, _, _, loaders, _ = prepared(path.key)
    units = {split: packed_units(ld) for split, ld in loaders.items()}
    steps = EPOCHS * units["train"]
    evals = units["val"] + units["test"]
    forwards = steps + EPOCHS * evals + units["train"] + evals
    n_ext = path.extremes_layers * towers_of(model.cfg)
    n_adj = adjacency_builds(model.cfg, is_flat(path))
    expected = {"build_pair_adjacency":
                n_adj * (steps + units["train"] + evals),
                "segment_extremes_fwd": n_ext * forwards,
                "segment_extremes_bwd": n_ext * steps}
    print(f"path {path.key}: dgn_tpu_torch.run {' '.join(argv)} -> "
          f"{wall:.1f}s, final test {report['final']['test']}, packed "
          f"batches per pass {units}, launches {launches} (expected "
          f"{expected}), peak device memory {peak / 2**20:.1f} MiB")
    if launches != expected:
        fail(f"{path.key}: kernel launches {launches} are not the "
             f"expected {expected}")
    return report, launches, peak


def step_profile(torch, step, batches, label: str, per_micro: dict):
    """Step time of step(batch) over steady steps, then device activity in
    a profiled window; checks the launches each step makes (per_micro
    times the step's micro-batches)."""
    counters = launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    micros = sum(len(gb) if isinstance(gb, list) else 1 for gb in batches)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for gb in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = step(gb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if not math.isfinite(float(loss)):
            fail(f"{label}: non-finite training loss")
    for name, n in per_micro.items():
        if counters[name].launches - before[name] != n * micros:
            fail(f"{label}: train steps did not launch {name} {n} times per "
                 "micro-batch")
    steady = times[3:]
    med = statistics.median(steady)
    peak = torch.cuda.max_memory_allocated()
    print(f"train step ({label}): median {med:.3f} ms over {len(steady)} "
          f"steps (min {min(steady):.3f}, max {max(steady):.3f}; first "
          f"{times[0]:.1f} ms), peak device memory {peak / 2**20:.1f} MiB")
    n_prof = 5
    events = profiled(torch, lambda: [step(gb) for gb in batches[:n_prof]])
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / n_prof
    busy = sum(by_name.values())
    print(f"train step device activity ({label}): {busy:.3f} ms/step in "
          f"{len(events) / n_prof:.0f} device ops/step, {busy / med:.1%} of "
          f"the median step (the device idles the rest); top by device time:")
    for name, t_ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t_ms:.4f} ms/step  {name[:100]}")
    return {"median_ms": med, "busy_ms": busy, "ops": len(events) / n_prof,
            "peak_mib": peak / 2**20}


KINKS = ("abs", "relu", "leaky_relu")


@contextlib.contextmanager
def recording_kinks(torch, calls: list):
    """Appends, in call order, the CPU copies of the inputs of every call
    made inside the block where a gradient can hop: the aggregators'
    max/min ("max/min": the values, global dst, edge mask, node count),
    through the extremes kernel pair on the block layout or the segment
    ops on the flat one, and abs, relu and leaky_relu (their input)."""
    import types
    from torch.overrides import TorchFunctionMode
    from dgn_tpu_torch.ops import aggregators, extremes, mxu, segment
    inner = extremes.segment_extremes

    def spy(ge, layout, edge_mask, num_nodes):
        dst = (layout.edge_chunk_dst.long().repeat_interleave(mxu.TILE)
               * mxu.TILE + layout.local_dst.long())
        calls.append(("max/min", ge.detach().cpu(), dst.cpu(),
                      edge_mask.cpu(), num_nodes))
        return inner(ge, layout, edge_mask, num_nodes)

    def flat_spy(fn):
        def call(data, segment_ids, num_segments, mask):
            calls.append(("max/min", data.detach().cpu(),
                          segment_ids.long().cpu(), mask.cpu(),
                          num_segments))
            return fn(data, segment_ids, num_segments, mask)
        return call

    # the aggregators' view of the segment module only: segment_extremes
    # itself calls segment_max, which must not count twice
    spied_segment = types.SimpleNamespace(**{
        **vars(segment), **{name: flat_spy(getattr(segment, name)) for name in
                            ("segment_extremes", "segment_max",
                             "segment_min")}})

    class Inputs(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in KINKS:
                calls.append((name, args[0].detach().cpu()))
            return func(*args, **(kwargs or {}))

    extremes.segment_extremes = spy
    aggregators.segment = spied_segment
    try:
        with Inputs():
            yield
    finally:
        extremes.segment_extremes = inner
        aggregators.segment = segment


def extremes_moved(torch, a, b, dst, mask, n):
    """(node, feature) pairs whose max or min edge differs between the CPU's
    values a and the card's b, with the largest gap between the CPU's two
    highest (lowest) values among them (0 at a tie)."""
    real = mask.nonzero().squeeze(1)
    a, b, d = a[real], b[real], dst[real]
    idx = d[:, None].expand_as(a)

    def top(v):
        return v.new_full((n, v.shape[1]), float("-inf")).scatter_reduce(
            0, idx, v, "amax", include_self=False)

    count, gap_max = 0, 0.0
    for sign in (1.0, -1.0):            # max, then min as the max of -v
        va, vb = sign * a, sign * b
        ta = top(va)
        wa = va == ta.index_select(0, d)
        wb = vb == top(vb).index_select(0, d)
        moved = torch.zeros(ta.shape, dtype=torch.int32).index_add_(
            0, d, (wa != wb).int()) > 0
        n_top = torch.zeros(ta.shape, dtype=torch.int32).index_add_(
            0, d, wa.int())
        gap = torch.where(n_top > 1, 0.0,
                          ta - top(torch.where(wa, float("-inf"), va)))
        count += int(moved.sum())
        if moved.any():
            gap_max = max(gap_max, gap[moved].max().item())
    return count, gap_max, (a - b).abs().max().item()


def kinks_crossed(torch, cpu_calls, card_calls) -> str:
    """Per kind of call, over the CPU step's calls and the card's in call
    order: the entries where the two sides fall on different sides of the
    kink (another max/min edge; another sign at abs and the relus), the
    largest CPU distance from the kink among them (top-two gap; |input|),
    and the largest difference of the two sides' inputs."""
    if [c[0] for c in cpu_calls] != [c[0] for c in card_calls]:
        return "the two steps made different calls"
    out = {}
    for ca, cb in zip(cpu_calls, card_calls):
        kind, a, b = ca[0], ca[1], cb[1]
        if kind == "max/min":
            crossed, near, diff = extremes_moved(torch, a, b, *ca[2:])
        else:
            far = (a > 0) != (b > 0)
            if kind == "abs":
                far |= (a < 0) != (b < 0)
            crossed = int(far.sum())
            near = a[far].abs().max().item() if crossed else 0.0
            diff = (a - b).abs().max().item()
        n, c, g, d = out.get(kind, (0, 0, 0.0, 0.0))
        out[kind] = (n + 1, c + crossed, max(g, near), max(d, diff))
    return "; ".join(
        f"{kind} {c} in {n} calls (CPU distance <= {g:.3g}, max |input "
        f"diff| {d:.3g})" for kind, (n, c, g, d) in out.items())


def param_report(torch, model_cpu, model_gpu, lr: float) -> str:
    """How far one step from identical weights left the CPU's and the
    card's parameters apart, and their gradients."""
    d_param = {name: (a.detach() - b.detach().cpu()).abs().max().item()
               for (name, a), b in zip(model_cpu.named_parameters(),
                                       model_gpu.parameters())}
    worst = max(d_param, key=d_param.get)
    # a posttrans bias that feeds straight into batch norm (no graph norm,
    # or graph norm over one graph) has a gradient that is zero up to
    # rounding; Adam's first step turns that noise into a step of up to lr
    # either way, on each side.  So do weights whose gradient is zero up
    # to rounding, hence the gradients' own difference and the count of
    # entries that moved apart
    rest = max(v for k, v in d_param.items()
               if not k.endswith("posttrans.bias"))
    # and the entries Adam moved apart: how many of them got gradients of
    # opposite signs on the two sides, and how large the CPU's was there
    grads = {name: (a.grad, b.grad.cpu()) for (name, a), b in zip(
        model_cpu.named_parameters(), model_gpu.parameters())}
    d_grads = {k: (a - b).abs().max().item() for k, (a, b) in grads.items()}
    worst_grad = max(d_grads, key=d_grads.get)
    g_max = max(a.abs().max().item() for a, _ in grads.values())
    apart = flipped = 0
    g_apart = 0.0
    for (name, a), b in zip(model_cpu.named_parameters(),
                            model_gpu.parameters()):
        far = (a.detach() - b.detach().cpu()).abs() > 0.1 * lr
        ga, gb = grads[name]
        apart += int(far.sum())
        flipped += int((far & (ga.sign() != gb.sign())).sum())
        if far.any():
            g_apart = max(g_apart, ga[far].abs().max().item())
    n_param = sum(p.numel() for p in model_cpu.parameters())
    return (f"max |grad diff| {d_grads[worst_grad]:.3g} ({worst_grad}; max "
            f"|grad| {g_max:.3g}), max |param diff after Adam| "
            f"{d_param[worst]:.3g} ({worst}; {rest:.3g} without the "
            f"posttrans biases; {apart} of {n_param} entries apart by more "
            f"than lr/10, {flipped} of them with gradients of opposite "
            f"signs, CPU |grad| <= {g_apart:.3g} there)")


def cpu_vs_card(torch, task, cfg, ds, params, batch):
    """One train step from identical weights and batch (or list of
    micro-batches) on the CPU (plain versions) and on the card (kernels),
    with the same augmentation draws on both where params augment; scores
    compare on real graphs, or real nodes for SBM."""
    from dgn_tpu_torch import run
    from dgn_tpu_torch.train.trainer import Trainer, draw_augmentation
    model_cpu, loss_cpu = run.build_model(
        task, cfg, ds, torch.Generator().manual_seed(41))
    model_gpu = copy.deepcopy(model_cpu)
    t_cpu = Trainer(model_cpu, loss_cpu, params, task=task, device="cpu")
    t_gpu = Trainer(model_gpu, loss_cpu, params, task=task, device=DEVICE)
    micros = batch if isinstance(batch, list) else [batch]
    aug = draw_augmentation(micros[0].eig.shape, params,
                            torch.Generator().manual_seed(41))
    cpu_calls, card_calls = [], []
    with recording_kinks(torch, cpu_calls):
        l_cpu, s_cpu = t_cpu.train_step(batch, aug)
    with recording_kinks(torch, card_calls):
        l_gpu, s_gpu = t_gpu.train_step(batch, aug)
    if not isinstance(batch, list):
        s_cpu, s_gpu = [s_cpu], [s_gpu]
    pairs = []
    for gb, a, b in zip(micros, s_cpu, s_gpu):
        m = gb.node_mask if task == "sbm" else gb.graph_mask
        pairs.append((a[m], b.cpu()[m]))
    bf16 = cfg.compute_dtype == "bfloat16"
    what = (f"one {task} step over {len(micros)} packed batch(es), "
            f"augmentation {'on' if aug else 'off'}"
            f"{', compute_dtype bfloat16' if bf16 else ''}")
    if bf16:
        # the same step in float32 on the card, from the same weights: how
        # far bf16 moves the scores, beside the CPU-vs-card difference
        model_32, _ = run.build_model(
            task, dataclasses.replace(cfg, compute_dtype=None), ds,
            torch.Generator().manual_seed(41))
        _, s_32 = Trainer(model_32, loss_cpu, params, task=task,
                          device=DEVICE).train_step(batch, aug)
        s_32 = s_32 if isinstance(batch, list) else [s_32]
        d_32 = 0.0
        for gb, b, c in zip(micros, s_gpu, s_32):
            m = gb.node_mask if task == "sbm" else gb.graph_mask
            d_32 = max(d_32, (b.cpu()[m] - c.cpu()[m]).abs().max().item())
        what += (f"; the card's bf16 scores differ from its float32 ones "
                 f"by up to {d_32:.3g}")
    check_step(torch, what, l_cpu, l_gpu, pairs,
               param_report(torch, model_cpu, model_gpu, params.init_lr),
               kinks_crossed(torch, cpu_calls, card_calls),
               *((BF16_STEP_RTOL, BF16_STEP_ATOL) if bf16
                 else (STEP_RTOL, STEP_ATOL)))


def check_step(torch, what: str, l_cpu, l_gpu, pairs, params_line: str,
               kinks: str, rtol: float = STEP_RTOL,
               atol: float = STEP_ATOL) -> None:
    """Prints and checks a CPU-vs-card step: the loss at rtol, each (CPU,
    card) pair of score tensors at rtol / atol (STEP_RTOL / STEP_ATOL in
    float32)."""
    d_scores = max((a - b).abs().max().item() for a, b in pairs)
    d_loss = abs(float(l_cpu) - float(l_gpu))
    print(f"cpu vs cuda, {what}: |loss diff| {d_loss:.3g} (loss "
          f"{float(l_cpu):.6f}), max |score diff| {d_scores:.3g} (rtol "
          f"{rtol:g}, atol {atol:g}), {params_line}")
    print(f"  kinks crossed between the CPU and the card: {kinks}")
    if not (all(torch.allclose(b, a, rtol=rtol, atol=atol)
                for a, b in pairs)
            and math.isclose(float(l_gpu), float(l_cpu), rel_tol=rtol)):
        fail(f"the card's step ({what}) disagrees with the CPU step")


def softmax_check(torch, task, net, ds, params, batch):
    """The CPU-vs-card step with the softmax aggregators, once decomposed
    (one build_pair_adjacency launch on the card, its weights the softmax
    families) and once on the per-edge path (none)."""
    counter = launch_counters()["build_pair_adjacency"]
    for decompose in (True, False):
        before = counter.launches
        cpu_vs_card(torch, task, dataclasses.replace(
            net, aggregators=SOFTMAX_AGGREGATORS, decompose=decompose,
            dropout=0.0, in_feat_dropout=0.0), ds, params, batch)
        built = counter.launches - before
        print(f"softmax check ({SOFTMAX_AGGREGATORS}, decompose "
              f"{decompose}): build_pair_adjacency launched {built} times")
        if built != int(decompose):
            fail(f"the softmax step with decompose {decompose} launched "
                 f"build_pair_adjacency {built} times")


def flat_vs_block(torch, task, net, ds, params):
    """The first batch_size train graphs packed flat and under the block
    layout, in the same order, and one train step on each from the same
    weights, both on the card: the same loss and scores at STEP_RTOL /
    STEP_ATOL (their sums run in other orders, the block one through the
    kernels)."""
    from dgn_tpu_torch import run
    from dgn_tpu_torch.graph import (bucket_sizes_for, mxu_bucket_sizes,
                                     mxu_pair_pad, pack_graphs)
    from dgn_tpu_torch.train.trainer import Trainer
    graphs = ds.train[:params.batch_size]
    g = len(graphs)
    n_flat, e_flat = bucket_sizes_for(graphs, g)
    n_pad, e_pad, g_pad = mxu_bucket_sizes(graphs, g)
    batches = {
        "flat": pack_graphs(graphs, n_pad=n_flat, e_pad=e_flat, g_pad=g),
        "block": pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                             mxu_layout=True, n_pairs_pad=mxu_pair_pad(
                                 graphs, g, n_pad, e_pad))}
    net = dataclasses.replace(net, dropout=0.0, in_feat_dropout=0.0)
    model, loss_fn = run.build_model(task, net, ds,
                                     torch.Generator().manual_seed(41))
    steps = {}
    for name, batch in batches.items():
        trainer = Trainer(copy.deepcopy(model), loss_fn, params, task=task,
                          device=DEVICE)
        loss, scores = trainer.train_step(batch)
        steps[name] = (float(loss), scores.cpu()[batch.graph_mask])
    (l_flat, s_flat), (l_block, s_block) = steps["flat"], steps["block"]
    d_scores = (s_flat - s_block).abs().max().item()
    print(f"flat vs block on the card, one {task} step over {g} graphs "
          f"(flat n_pad={n_flat} e_pad={e_flat}; block n_pad={n_pad} "
          f"e_pad={e_pad}): loss {l_flat:.6f} vs {l_block:.6f}, "
          f"|loss diff| {abs(l_flat - l_block):.3g}, max |score diff| "
          f"{d_scores:.3g}")
    if not (torch.allclose(s_block, s_flat, rtol=STEP_RTOL, atol=STEP_ATOL)
            and math.isclose(l_block, l_flat, rel_tol=STEP_RTOL)):
        fail("the flat and the block layout disagree on the card")


def sibling(path: TrainPath):
    """The float32 path a bf16 path repeats (its key without -bf16), or
    None."""
    return path.key[:-len("-bf16")] if path.key.endswith("-bf16") else None


def check_blocks(torch, key: str, net, batch) -> None:
    """The adjacency blocks the model builds for the batch on the card are
    in the config's compute dtype (bf16 under compute_dtype bfloat16)."""
    from dgn_tpu_torch.models.dgn_net import edge_context_for
    gb = (batch[0] if isinstance(batch, list) else batch).to(DEVICE)
    with torch.no_grad():
        adj = edge_context_for(gb, net).adj
    want = net.torch_compute_dtype() or torch.float32
    print(f"path {key}: adjacency blocks {tuple(adj.shape)} {adj.dtype}, "
          f"{adj.numel() * adj.element_size() / 2**20:.1f} MiB")
    if adj.dtype != want:
        fail(f"{key}: the adjacency blocks are {adj.dtype}, not {want}")


def training_phase(torch):
    """Every path of PATHS through the entry point, each path's step, and
    each path's CPU-vs-card step (and the softmax check on ZINC's batch);
    a bf16 path's launches must equal its float32 sibling's, and its
    blocks must be bf16.  Returns ({path: launches}, {path: net config})."""
    out, nets, figures = {}, {}, {}
    for path in PATHS:
        key = path.key
        report, out[key], peak = drive_path(torch, path)
        sib = sibling(path)
        if sib is not None and out[key] != out[sib]:
            fail(f"{key}: launches {out[key]} differ from {sib}'s "
                 f"{out[sib]}")
        ds, model, _, trainer, loaders, cfg = _PREPARED.pop(key)
        nets[key] = model.cfg
        final = report["final"]
        if not all(math.isfinite(v) for split in ("train", "val", "test")
                   for v in final[split].values()):
            fail(f"a non-finite value in the {key} report: {final}")
        train = loaders["train"]
        batches = list(train)
        net, p = model.cfg, cfg.params
        if adjacency_builds(net, is_flat(path)):
            check_blocks(torch, key, net, batches[0])
        n_ext = path.extremes_layers * towers_of(net)
        figures[key] = step_profile(
            torch, trainer.train_step,
            batches * math.ceil(MIN_STEPS / len(batches)),
            f"{key}, {net.type_net} hidden {net.hidden_dim} L={net.L}, batch "
            f"{p.batch_size} in {train.micro_batches} micro-batch(es), "
            f"dropout {net.dropout}, n_pad={train.n_pad} e_pad={train.e_pad} "
            f"pairs={train.pair_pad}{', ' if path.flags else ''}"
            f"{' '.join(path.flags)}",
            {"build_pair_adjacency": adjacency_builds(net, is_flat(path)),
             "segment_extremes_fwd": n_ext, "segment_extremes_bwd": n_ext})
        figures[key]["run_peak_mib"] = peak / 2**20
        if sib is not None:
            print(f"path {key} beside {sib} in this call: " + "; ".join(
                f"{name} {figures[key][name]:.3f} vs {figures[sib][name]:.3f}"
                for name in ("median_ms", "busy_ms", "ops", "peak_mib",
                             "run_peak_mib")))
        # dropout 0: the CPU and CUDA generators draw different masks
        cpu_vs_card(torch, cfg.task, dataclasses.replace(
            model.cfg, dropout=0.0, in_feat_dropout=0.0), ds, p, batches[0])
        if key == "zinc":
            softmax_check(torch, cfg.task, model.cfg, ds, p, batches[0])
        if key == "zinc-flat":
            flat_vs_block(torch, cfg.task, model.cfg, ds, p)
        del ds, model, trainer, loaders, batches
        torch.cuda.empty_cache()
    return out, nets


def collab_phase(torch, np):
    """COLLAB link prediction through the entry point with every launch
    counter at 0 before and required at 0 after (one flat graph: no
    kernel), its report checked (Hits@K in [0, 1]); then MIN_STEPS train
    steps timed and profiled, and one step from identical weights and
    identical positive and negative edges on the CPU and on the card.
    Returns the run's launches."""
    from dgn_tpu_torch import run
    from dgn_tpu_torch.config import config_from_args
    argv = ["--dataset", "COLLAB", "--synthetic_size", str(COLLAB_NODES)]
    counters = launch_counters()
    n_loads = len(_LOADS)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    report = run.run(argv + ["--epochs", str(EPOCHS), "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: c.launches for name, c in counters.items()}
    print(f"path collab: dgn_tpu_torch.run {' '.join(argv)} --epochs "
          f"{EPOCHS} -> {wall:.1f}s, best val hits@50 "
          f"{report['best_val_hits@50']}, test at best "
          f"{report['test_at_best_val']}, launches {launches} (expected 0), "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if len(_LOADS) != n_loads + 1:
        fail("collab: the run did not load its dataset once through "
             "share_datasets' cache")
    if any(launches.values()):
        fail(f"collab: kernel launches {launches} on the flat layout")
    hits = [report["best_val_hits@50"], *report["test_at_best_val"].values()]
    if not all(0.0 <= v <= 1.0 for v in hits):
        fail(f"collab: Hits@K out of [0, 1]: {report}")

    cfg, _ = config_from_args(argv)
    gb, splits, trainer = run.prepare_collab(cfg, DEVICE)
    net = trainer.model.backbone.cfg
    train = splits["train"]
    bs = trainer.edge_batch
    # the batches of one epoch, the last short one filled from the head of
    # the order, as LinkPredTrainer.train_epoch draws them
    n_batches = max(len(train) // bs, 1)
    order = np.resize(np.random.default_rng(cfg.params.seed).permutation(
        len(train)), n_batches * bs)
    batches = [torch.as_tensor(train[order[i * bs:(i + 1) * bs]],
                               device=DEVICE) for i in range(n_batches)]
    step_profile(
        torch, lambda pos: trainer.train_step(gb, pos),
        batches * math.ceil(MIN_STEPS / len(batches)),
        f"collab, {net.type_net} hidden {net.hidden_dim} L={net.L}, one "
        f"graph of {gb.num_nodes_padded} nodes and {gb.num_edges_padded} "
        f"edges, edge batch {bs}", {name: 0 for name in counters})

    # the CPU and the card from the same weights, edges and negatives
    sides = [run.prepare_collab(cfg, dev) for dev in ("cpu", DEVICE)]
    n_real = int(gb.real_node_count())
    pos = torch.as_tensor(train[order[:bs]])
    neg = torch.as_tensor(np.random.default_rng(7).integers(
        0, n_real, size=(bs, 2)))
    out, calls = [], []
    for gb_s, _, t in sides:
        calls.append([])
        with recording_kinks(torch, calls[-1]):
            out.append(t.train_step(gb_s, pos, neg))
    (l_cpu, s_cpu), (l_gpu, s_gpu) = out
    check_step(torch, f"one collab step over {bs} positive and {bs} "
               "negative edges", l_cpu, l_gpu,
               [(a, b.cpu()) for a, b in zip(s_cpu, s_gpu)],
               param_report(torch, sides[0][2].model, sides[1][2].model,
                            cfg.params.init_lr),
               kinks_crossed(torch, *calls))
    return launches


RECIPE_DIR = REPO / "out" / "chip_smoke_recipe"
RECIPE_SIZE = 1024      # the ZINC path's size: its dataset is built once


def run_captured(argv) -> tuple:
    """(report, printed text) of the entry point on argv; the text is
    printed too."""
    import io
    from dgn_tpu_torch import run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = run.run(argv)
    print(buf.getvalue(), end="")
    return report, buf.getvalue()


def recipe_phase(torch, np) -> None:
    """The training recipe through the entry point on the card, under
    out/chip_smoke_recipe (emptied first): checkpoint and resume, the
    restore bit for bit, --seeds, tools/report.py, poison_padding and
    profile_steps."""
    import shutil
    from dgn_tpu_torch import observe, run
    from dgn_tpu_torch.config import config_from_args
    from dgn_tpu_torch.graph import bucket_sizes_for, pack_graphs
    from dgn_tpu_torch.ops import extremes
    from dgn_tpu_torch.tools import report as treport
    from dgn_tpu_torch.train.checkpoint import Checkpointer

    shutil.rmtree(RECIPE_DIR, ignore_errors=True)
    base = ["--config", str(CONFIGS / ZINC), "--synthetic_size",
            str(RECIPE_SIZE), "--device", DEVICE]
    ck, o1 = str(RECIPE_DIR / "ck"), str(RECIPE_DIR / "run")
    t0 = time.time()
    first, _ = run_captured(base + ["--epochs", "2", "--checkpoint", ck,
                                    "--out_dir", o1])
    if first["epochs_run"] != 2 or Checkpointer(ck).list() != [0, 1]:
        fail(f"recipe: --checkpoint ran {first['epochs_run']} epochs and "
             f"left snapshots {Checkpointer(ck).list()}")
    second, text = run_captured(base + ["--epochs", "3", "--checkpoint", ck,
                                        "--resume", "--out_dir", o1])
    if "resumed from epoch 1" not in text or second["epochs_run"] != 1 \
            or Checkpointer(ck).list() != [0, 1, 2]:
        fail(f"recipe: --resume ran {second['epochs_run']} epochs, "
             f"snapshots {Checkpointer(ck).list()}")
    # the last snapshot into a fresh trainer on the card, bit for bit
    cfg, _ = config_from_args(base + ["--epochs", "3"])
    _, model, _, trainer, loaders = run.prepare(cfg, DEVICE)
    if Checkpointer(ck).restore(trainer) != 3:
        fail("recipe: the restore does not continue at epoch 3")
    with np.load(str(RECIPE_DIR / "ck" / "ckpt_000002.npz")) as saved:
        names = list(model.state_dict())
        same = all(torch.equal(model.state_dict()[k].cpu(),
                               torch.from_numpy(saved[k])) for k in names)
        devices = {t.device.type for t in model.state_dict().values()}
        print(f"recipe: checkpoint/resume ran 2 + 1 epochs; the epoch-2 "
              f"snapshot restored into a fresh trainer on {devices}: "
              f"{len(names)} state_dict entries bit for bit equal: {same}")
    if not same or devices != {torch.device(DEVICE).type}:
        fail("recipe: the restored state differs from the snapshot")

    ck2, o2 = str(RECIPE_DIR / "ck_seeds"), str(RECIPE_DIR / "seeds")
    seeds, text = run_captured(base + ["--epochs", "1", "--seeds", "41,42",
                                       "--checkpoint", ck2, "--out_dir", o2])
    agg = seeds["test_at_best_val"]["mae"]
    per_seed = all((Path(o2) / f"seed{s}" / "metrics.jsonl").is_file()
                   and Checkpointer(f"{ck2}/seed{s}").list() == [0]
                   for s in (41, 42))
    if "[dgn_tpu_torch] SEEDS {" not in text or not per_seed or not (
            math.isfinite(agg["mean"]) and math.isfinite(agg["std"])):
        fail(f"recipe: --seeds gave {seeds} (per-seed outputs {per_seed})")

    rows = treport.load_epochs(f"{o1}/metrics.jsonl")
    summary = treport.summarize(rows)
    print(treport.to_markdown(summary, "tools/report.py on the recipe run"))
    if summary["epochs"] != 3 or summary["metric"] != "mae" \
            or "edges_per_s" not in summary["throughput"]:
        fail(f"recipe: tools/report.py summarised {summary}")

    poison_check(torch, np, observe, extremes, bucket_sizes_for, pack_graphs)

    batch = next(iter(loaders["train"]))
    trace_dir = RECIPE_DIR / "trace"
    loss, _ = observe.profile_steps(trainer.train_step, 3, str(trace_dir),
                                    batch)
    trace = trace_dir / "trace.json"
    size = trace.stat().st_size if trace.is_file() else 0
    print(f"recipe: profile_steps wrote {trace} ({size} bytes) over 3 "
          f"train steps, last loss {float(loss):.6f}; recipe phase "
          f"{time.time() - t0:.1f}s")
    if size == 0 or not math.isfinite(float(loss)):
        fail("recipe: profile_steps wrote no trace")


def poison_check(torch, np, observe, extremes, bucket_sizes_for,
                 pack_graphs) -> None:
    """poison_padding on the card.  The flat layout: the eval scores of
    ZINC's and HIV's first batch_size train graphs under poison equal the
    clean ones, finite (POISON_RTOL / POISON_ATOL).  The block layout: the
    extremes pair on HIV's block batch with NaN in every pad edge's lane
    gives the clean forward exactly and the clean backward, 0 at every pad
    edge; and the model's eval scores on ZINC's block batch under poison,
    which both packages let pad rows into (0 * NaN in the dense block
    products), are reported."""
    from dgn_tpu_torch import run
    from dgn_tpu_torch.config import config_from_args
    dev = torch.device(DEVICE)
    for key in ("zinc-flat", "hiv-flat"):
        path = next(p for p in PATHS if p.key == key)
        cfg, _ = config_from_args(path_argv(path))
        ds, model, _, _, _ = run.prepare(cfg, DEVICE)
        graphs = ds.train[:cfg.params.batch_size]
        n_pad, e_pad = bucket_sizes_for(graphs, len(graphs))
        gb = pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad,
                         g_pad=len(graphs)).to(dev)
        model.eval()
        with torch.no_grad():
            clean = model(gb)[gb.graph_mask]
            poisoned = model(observe.poison_padding(gb))[gb.graph_mask]
        d = (poisoned - clean).abs().max().item()
        print(f"recipe: poison_padding, {key} eval over {len(graphs)} "
              f"graphs: {int((~torch.isfinite(poisoned)).sum())} non-finite "
              f"scores, max |poisoned - clean| {d:.3g}")
        if not (torch.isfinite(poisoned).all() and torch.allclose(
                poisoned, clean, rtol=POISON_RTOL, atol=POISON_ATOL)):
            fail(f"recipe: a pad lane reached {key}'s scores")
        if key == "zinc-flat":
            block = packed(graphs).to(dev)
            with torch.no_grad():
                bad = model(observe.poison_padding(block))[block.graph_mask]
            print(f"recipe: poison_padding, ZINC eval on the block layout: "
                  f"{int((~torch.isfinite(bad)).sum())} of {bad.numel()} "
                  "scores non-finite (pad rows meet zero block entries)")
    from dgn_tpu_torch.data.synthetic import synthetic_ogb_mol
    hiv = packed(synthetic_ogb_mol(512, seed=41, n_tasks=1, k_eig=4)[:128])
    layout, mask = hiv.mxu.to(dev), hiv.edge_mask.to(dev)
    n, f = hiv.num_nodes_padded, 70
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(hiv.num_edges_padded, f)).astype(
        np.float32)).to(dev)
    x_bad = torch.where(mask[:, None], x, float("nan"))
    dmx, dmn = (torch.from_numpy(rng.normal(size=(n, f)).astype(
        np.float32)).to(dev) for _ in range(2))
    mx, mn = extremes.segment_extremes_fwd(x, layout, mask, n)
    bmx, bmn = extremes.segment_extremes_fwd(x_bad, layout, mask, n)
    g = extremes.segment_extremes_bwd(x, mx, mn, dmx, dmn, layout, mask)
    g_bad = extremes.segment_extremes_bwd(x_bad, bmx, bmn, dmx, dmn, layout,
                                          mask)
    ok = (torch.equal(mx, bmx) and torch.equal(mn, bmn)
          and torch.equal(g, g_bad) and not g_bad[~mask].any())
    print(f"recipe: poison_padding, the extremes pair on HIV's block batch "
          f"with NaN in all {int((~mask).sum())} pad edges' lanes: forward "
          f"and backward equal to the clean calls, pad gradient 0: {ok}")
    if not ok:
        fail("recipe: the extremes pair read a pad edge's lane")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", choices=("all", "kernels"),
                        default="all",
                        help="kernels: phases 1-3 only; the kernels line "
                        "then has no launches and no device line follows")
    args = parser.parse_args()
    if not (REPO / "dgn_tpu_torch").is_dir() or not all(
            (CONFIGS / path.config).is_file() for path in PATHS):
        fail("run chip_smoke.py from the root of a dgn_tpu checkout")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA GPU")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    # the bf16 block products (ops/mxu.py) need torch.bmm's out_dtype on
    # bf16 operands
    ones = torch.ones((1, 2, 2), device=DEVICE, dtype=torch.bfloat16)
    print(f"torch.bmm(bf16, bf16, out_dtype=float32): "
          f"{torch.bmm(ones, ones, out_dtype=torch.float32).dtype}")

    from dgn_tpu_torch.ops import cuda_build
    t = time.time()
    logs = cuda_build.build(["adjacency", "extremes"])
    print(f"build: {time.time() - t:.1f}s")
    for name, log in logs.items():
        kernel = name
        for line in log.splitlines():
            if "entry function" in line:
                found = re.findall(r"[a-z_]+_kernel", line)
                kernel = found[0] if found else name
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {kernel}: {line.strip()}")

    share_datasets()
    t = time.time()
    kernels = adjacency_phase(torch, np) + extremes_phase(torch, np)
    print(f"kernel phase: {time.time() - t:.1f}s")
    if args.phases == "kernels":
        print(json.dumps({"kernels": kernels}))
        print(f"card: {card_line()}")
        return
    launches, nets = training_phase(torch)
    launches["collab"] = collab_phase(torch, np)
    recipe_phase(torch, np)
    # `launches` is the kernel's count on the path whose shape the entry
    # timed ("path"); the counts of every path stand beside it (COLLAB's
    # checked to be 0 in collab_phase)
    for kern in kernels:
        counter = kern["name"].split("@")[0]
        kern["launches"] = launches[kern["path"]][counter]
        kern["launches_by_path"] = {p: c[counter] for p, c in launches.items()}
        for path in PATHS:
            runs = (adjacency_builds(nets[path.key], is_flat(path))
                    if counter == "build_pair_adjacency"
                    else path.extremes_layers)
            n = kern["launches_by_path"][path.key]
            if runs and n <= 0:
                fail(f"kernel {counter} was not launched on the {path.key} "
                     "path")
            if not runs and n != 0:
                fail(f"kernel {counter} was launched {n} times on the "
                     f"{path.key} path, which must not launch it")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
