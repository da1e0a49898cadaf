#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (dgn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels|graphs]

Run from the root of a checkout, on a machine with a CUDA GPU (written for
the H100) and the CUDA toolkit.  `--phases kernels` runs phases 1-3 only, to
try a kernel in seconds; it prints the kernels line with `launches` null
and no device line.  `--phases graphs` runs phases 1-2 and then only the
graph checks of phase 4 (GRAPH_PATHS).  Phases, each of which fails the
script:

1. card: name and power limit from nvidia-smi; no CUDA device -> exit 1;
2. build: every CUDA kernel of the package, from the checkout's sources, one
   nvcc per source, all started together;
3. kernels: each kernel at its paths' shapes, held against its plain
   PyTorch version on the card and against an f64 oracle, and timed beside
   the plain version, one equivalent PyTorch call and the card's bound:
   build_pair_adjacency at the ZINC and the CIFAR10 batch, in float32 and
   in its bf16 and f16 output modes (plus a multi-block case), each timing
   line
   with the batch's covered, uncovered and all-pad-chunk counts, the
   launch's grid and shared bytes, the write floor (zero_() of a
   tensor of the output's shape and dtype, timed the same way) and the
   write path (the kernel given an empty chunk range for every pair), and
   at an edge-parallel rank's shard of a ZINC batch (2 ranks); the
   segment_extremes forward/backward
   pair at the HIV batch and at one PCBA micro-batch (plus tie, star,
   multi-block and dense-block cases) with its grids, and at an
   edge-parallel rank's shard of an HIV batch;
   The extremes pair is also held against its plain version at F = 14, the
   width a towers layer gives each of its 5 towers at HIV's hidden 70;
4. training, once per path: the port's entry point (dgn_tpu_torch.run)
   trains each of the paths of PATHS at full width on the card:
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
   scatter) and in float16 (zinc-fp16, hiv-fp16, cifar10-fp16,
   --compute_dtype float16: the kernel's f16 blocks, f16 operands); each
   such path's launches must equal its float32 sibling's, and its blocks
   must be in its compute dtype.  Every kernel launch
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
   build_pair_adjacency) and per-edge.  On ZINC and PATTERN (GRAPH_PATHS)
   the graph check: a trainer whose steps replay CUDA graphs
   (train/graphs.py) against one that runs every step eagerly, from the
   same weights with the same Adam over the same block batches (ZINC: six,
   the fourth escape-sized, the lr halved before it), each step's loss,
   gradients and weights within benchmark/limits/zinc-block.json's limits
   (where a second eager trainer already leaves one, within twice its
   reading), the same launch counts, and the replays the batches imply.
   On
   zinc-flat's first batch, the
   flat-versus-block check: the same graphs packed both ways, one step
   from the same weights on the card, the same loss and scores.  Each
   path prints its peak device memory (torch.cuda.max_memory_allocated)
   over its entry-point run and over its timed steps, and each bf16 or
   f16 path its float32 sibling's step figures from the same call beside
   its own and how far its scores lie from the sibling's on the card;
5. COLLAB: `dgn_tpu_torch.run --dataset COLLAB` trains link prediction on
   one synthetic 2,048-node graph (one epoch of edge batches of 4,096,
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
   writes a trace of 3 train steps that holds their 3 dgn.step ranges;
7. real files: seeded dataset files in the reference's layouts
   (tests/real_files.py, docs/DATA.md) under out/chip_smoke_real/, trained
   through the entry point with --data_dir: zinc-real twice, with an empty
   and then a warm --cache_dir (the warm run must solve no eigenproblem
   and load eig arrays equal to the cold run's), hiv-real (OGB raw csv.gz,
   scaffold split, tiny molecules dropped; both kernels), cifar10-real
   (superpixel pickles: the host k-NN and sym eig), pattern-real (SBM
   pickles with dense W), zinc-buckets (--n_buckets 4: each bucket's pads,
   its slot efficiency and step beside zinc-real's, one adjacency launch
   per packed batch) and collab-real (ogbl-collab raw csv.gz and
   split/time/*.pt, no launch), each with its launch counts checked; then
   host packing ms per batch on this host: the flat layout with numpy and
   with the native packer (runtime/packer.cpp, built with g++ here; its
   batches must equal numpy's) for ZINC and HIV, and the block layout for
   ZINC and CIFAR10;
8. data parallelism: the ZINC and HIV configs at full width (DP_PATHS)
   at 1 NCCL rank and at 2 gloo ranks that share cuda:0 (NCCL refuses two
   ranks on one GPU), spawned (dgn_tpu_torch/parallel/launch.py) with a
   deadline, each rank through the port's rank entry (run._run_rank, what
   `--n_devices` runs) for one epoch with its launch counters at 0 just
   before and checked just after; then one data-parallel step with dropout
   off against the one-process step on the same batch (1 rank) or on the
   concatenated super-batch (2 ranks): loss, scores, the gradients'
   relative distance, no parameter's gradient 0 (the weights after Adam
   printed), at 2 ranks a planted fault (sync batch norm's sum without
   its summed backward) that the gradient check must reject; then the
   config's step as shipped, timed per rank (median, all-reduce ms, busy
   ms and ops on rank 0, peak MiB);
9. edge parallelism: EP_PATHS the same way with `--partition ep`, ep-zinc
   at 1 NCCL rank and at 2 gloo ranks, ep-hiv (the extremes pair on each
   rank's shard) and ep-pattern (node-level) at 2 gloo ranks, held against
   the one-process step on the same graphs; at 2 ranks the sums over the
   ranks without their summed backward must be rejected, and on ep-hiv the
   halo exchange without its reverse backward too (printed elsewhere,
   beside the halo's real rows: see GRAD_REL); each rank's shard geometry,
   the host ms of the halo exchanges, and the exchange's transport;
10. scaling: tools/scaling.py's dp and ep rows at 1 and 2 ranks;
11. dense: DenseDGNLayer (45 wide, 5 towers, `mean max min std dir1-dx
   dir1-smooth` x 3 scalers) on 128 ZINC molecules padded to their largest
   size, forward and backward with the eigenvectors solved on the card
   (torch.linalg.eigh), held against the CPU from the same weights, with
   the two solvers' null counts, then timed (the eigh alone too).

Prints a `{"kernels": [...]}` line and, last, the device line
`{"ok": true, "device": {...}}`.  Needs no network; starts no process other
than nvidia-smi, nvcc, g++ and the ranks of phases 8-10, and waits for
each (a rank past its deadline is terminated).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import itertools
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
FP16_FLAGS = ("--compute_dtype", "float16")
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
    TrainPath("cifar10-bf16", CIFAR10, 0, 1024, BF16_FLAGS),
    TrainPath("zinc-fp16", ZINC, 0, 1024, FP16_FLAGS),
    TrainPath("hiv-fp16", HIV, 4, 1024, FP16_FLAGS),
    TrainPath("cifar10-fp16", CIFAR10, 0, 1024, FP16_FLAGS))
# The paths on dataset files in the reference's real layouts (docs/DATA.md),
# written under REAL_DIR by tests/real_files.py from seeds: 512 train
# graphs each (CIFAR10 512 after the last 56 of 568 become val; HIV about
# 1024 of OGB_GRAPHS after its tiny molecules are dropped), 51 val and
# test; the ZINC paths keep their eigenvectors in REAL_CACHE.  (1024 train
# graphs until the fp16 paths came: cut to keep the script's time.)
REAL_DIR = REPO / "out" / "chip_smoke_real"
REAL_DATA, REAL_CACHE = REAL_DIR / "data", REAL_DIR / "eig_cache"
DATA_FLAGS = ("--data_dir", str(REAL_DATA))
ZINC_REAL_FLAGS = DATA_FLAGS + ("--cache_dir", str(REAL_CACHE))
REAL_PATHS = (
    TrainPath("zinc-real", ZINC, 0, 1024, ZINC_REAL_FLAGS),
    TrainPath("hiv-real", HIV, 4, 1024, DATA_FLAGS),
    TrainPath("cifar10-real", CIFAR10, 0, 1024, DATA_FLAGS),
    TrainPath("pattern-real", "SBMs_node_clustering_DGN_PATTERN.json", 0,
              1024, DATA_FLAGS),
    TrainPath("zinc-buckets", ZINC, 0, 1024,
              ZINC_REAL_FLAGS + ("--n_buckets", "4")))
REAL_SIZES = {"train": 512, "val": 51, "test": 51}
OGB_GRAPHS = 1422        # 80 % train, every tenth molecule dropped as tiny
PACK_BATCHES = 24        # host pack timings per dataset and packer
# COLLAB's dense eigensolve grows as n^3: 4,096 nodes took about 10 s of
# host time (the size until the fp16 paths came), 16,384 did not finish in
# 90 s
COLLAB_NODES = 2048
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
# f16 blocks: one rounding of entries |w| <= 2 (1 and eigenvector
# differences), at most half of float16's 2^-10 spacing in [1, 2)
F16_TOL = 1e-3
# an f16 step: the same neighbouring roundings, with float16's spacing
# 2^-11, 8 times finer than bf16's: the bf16 tolerances / 8.  A CPU
# rehearsal of this check (a second model whose weights differ in their
# last float32 bit standing for the card, 3 draws) moved hiv-fp16's scores
# by up to 7.0e-6 (HIV's max/min ties; bf16 4.3e-5), ZINC's and CIFAR10's
# by under 1e-7
F16_STEP_RTOL, F16_STEP_ATOL = 2.5e-3, 2.5e-4
# tolerances by dtype name: a kernel's blocks against the plain version
# and the oracle, and a CPU-vs-card step under a config's compute_dtype
KERNEL_TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL, "float16": F16_TOL}
STEP_TOL = {None: (STEP_RTOL, STEP_ATOL), "float32": (STEP_RTOL, STEP_ATOL),
            "bfloat16": (BF16_STEP_RTOL, BF16_STEP_ATOL),
            "float16": (F16_STEP_RTOL, F16_STEP_ATOL)}
POISON_RTOL, POISON_ATOL = 1e-5, 1e-6
# torch.profiler windows per timing before a short trace fails the script
# (the card has returned 5, 15 and 19 of at least 20 activities in three
# windows in a row), and the spin-kernel launches at each edge of a window
PROFILER_WINDOWS, SENTINELS = 5, 8
DEVICE = "cuda"
# the graph check: per path, the batches it steps through, the step given
# an escape-sized batch and the step before which the lr halves (None:
# neither), and the replays that follow (one capture on the second step
# of the loader's signature; the escape runs eagerly)
GRAPH_PATHS = {"zinc": (6, 3, 3, 4), "pattern": (2, None, None, 1)}
GRAPH_LIMITS = REPO / "benchmark" / "limits" / "zinc-block.json"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def kernel_tol(dtype) -> float:
    """KERNEL_TOL of a torch dtype."""
    return KERNEL_TOL[str(dtype).removeprefix("torch.")]


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
    """The device events of run() under torch.profiler.  The window opens
    and closes with SENTINELS launches of torch's spin kernel, which the
    events returned leave out: this card's profiler has dropped activities
    at a window's edges (19 of 20 in five windows in a row).  A window
    whose trace still comes back with fewer than min_events device
    activities is run again, four times at most, before the script
    fails."""
    from torch.profiler import ProfilerActivity, profile

    def sentinels():
        for _ in range(SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    for window in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sentinels()
            run()
            torch.cuda.synchronize()
            sentinels()
        events = [e for e in device_events(torch, prof)
                  if "spin_kernel" not in e.name]
        if len(events) >= min_events:
            return events
        print(f"torch.profiler recorded {len(events)} device activities in "
              f"window {window + 1} of {PROFILER_WINDOWS}, fewer than "
              f"{min_events}")
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
_DATASETS = {}       # share_datasets' cache: (name, DataParams) -> dataset


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
    load, load_collab, cache = (datasets.load_dataset, datasets.load_collab,
                                _DATASETS)

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
    """The entry point's arguments for the path, without epochs and device;
    a path on dataset files (--data_dir) has no synthetic size."""
    size = () if "--data_dir" in path.flags else ("--synthetic_size",
                                                   str(path.size))
    return ["--config", str(CONFIGS / path.config), *size, *path.flags]


def prepared(key: str):
    """run.prepare's (ds, model, loss_fn, trainer, loaders) for the path and
    its config, built once: the kernel phase takes its first train batch and
    the training phase its loaders' batch counts, step and CPU-vs-card
    check from the same dataset."""
    if key not in _PREPARED:
        from dgn_tpu_torch import run
        from dgn_tpu_torch.config import config_from_args
        cfg, _ = config_from_args(path_argv(next(
            p for p in PATHS + REAL_PATHS if p.key == key)))
        _PREPARED[key] = run.prepare(cfg, DEVICE) + (cfg,)
    return _PREPARED[key]


def first_train_batch(key: str):
    """The first batch the path's shuffled train loader yields (a list of
    micro-batches for PCBA)."""
    return next(iter(prepared(key)[4]["train"]))


def ep_first_shard(key: str):
    """Rank 0's shard of the first batch of the path's train split at 2
    edge-parallel ranks, as the entry point's shuffled PartitionedLoader
    cuts it (the ep paths train on the same datasets)."""
    from dgn_tpu_torch.parallel import PartitionedLoader
    ds, *_, cfg = prepared(key)
    p = cfg.params
    return next(iter(PartitionedLoader(ds.train, p.batch_size, 2, rank=0,
                                       shuffle=True, seed=p.seed,
                                       layout="mxu")))


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
    tol = kernel_tol(out_dtype)
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
    has off-diagonal pairs), in float32 and in the bf16 and f16 output
    modes the bf16 and fp16 paths run.  One entry per shape and dtype:
    `build_pair_adjacency` at the ZINC batch, `build_pair_adjacency@cifar10`
    at the CIFAR10 one, `build_pair_adjacency@bf16` and
    `build_pair_adjacency@cifar10-bf16` the same in bf16,
    `build_pair_adjacency@fp16` and `build_pair_adjacency@cifar10-fp16` in
    f16."""
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
    # an edge-parallel rank's [own | halo] node axis and its [interior |
    # boundary] pairs
    ep = ep_first_shard("zinc").to(dev)
    w_ep = family_weights(torch, ep, ("one", "delta1", "abs1"))

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
             ("zinc_main_f16", w_zinc, zinc.mxu, torch.float16),
             ("sbm_multiblock_f32", w_sbm, lay.to(dev), torch.float32),
             ("cifar10_main_f32", w_cifar, cifar.mxu, torch.float32),
             ("cifar10_main_bf16", w_cifar, cifar.mxu, torch.bfloat16),
             ("cifar10_main_f16", w_cifar, cifar.mxu, torch.float16),
             ("ep_zinc_shard_f32", w_ep, ep.mxu, torch.float32)]
    errs = {}
    for name, w, layout, dt in cases:
        got = adjacency.build_pair_adjacency(w, layout, dt)
        torch.cuda.synchronize()
        plain = adjacency.build_pair_adjacency_plain(w, layout, dt)
        oracle = adjacency.build_pair_adjacency_plain(
            w.double().cpu(), layout.to("cpu"))
        tol = kernel_tol(dt)
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
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
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
                                  bf16)),
            dict(common, name="build_pair_adjacency@fp16", path="zinc-fp16",
                 max_abs_err=errs["zinc_main_f16"],
                 **time_adjacency(torch, w_zinc, zinc.mxu, "zinc", f16)),
            dict(common, name="build_pair_adjacency@cifar10-fp16",
                 path="cifar10-fp16", max_abs_err=errs["cifar10_main_f16"],
                 **time_adjacency(torch, w_cifar, cifar.mxu, "cifar10",
                                  f16)),
            dict(common, name="build_pair_adjacency@ep-zinc",
                 path="ep-zinc-gloo2/rank0",
                 max_abs_err=errs["ep_zinc_shard_f32"],
                 **time_adjacency(torch, w_ep, ep.mxu, "ep-zinc shard",
                                  f32))]


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
    2048-graph batch) and at rank 0's shard of an HIV batch at 2
    edge-parallel ranks, F = 70.  One entry per kernel and shape:
    `segment_extremes_fwd`/`_bwd` at the HIV batch,
    `segment_extremes_fwd@pcba`/`_bwd@pcba` at the PCBA one and
    `segment_extremes_fwd@ep-hiv`/`_bwd@ep-hiv` at the shard."""
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

    hiv_ep = ep_first_shard("hiv")
    ge_hiv, ge_pcba = layer_values(hiv), layer_values(pcba)
    ge_ep = layer_values(hiv_ep)
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
             ("pcba_micro_f70", pcba, ge_pcba),
             ("ep_hiv_shard_f70", hiv_ep, ge_ep)]
    errs = {}
    for name, gb, vals in cases:
        layout, mask = gb.mxu.to(dev), gb.edge_mask.to(dev)
        n = gb.num_nodes_padded
        w1 = torch.from_numpy(rng.normal(size=(n, vals.shape[1])).astype(
            np.float32)).to(dev)
        # the min's cotangent, made once for both sides: on a CPU-only
        # torch the first sin of a process can come back 1.5e-4 off on one
        # thread's share of the entries, which failed CPU rehearsals of this
        # check though both sides ran the same plain version
        w2 = torch.sin(w1)

        def run(fn, dev_=dev, layout_=layout, mask_=mask, w=w1, w_min=w2):
            x = torch.tensor(vals, device=dev_, requires_grad=True)
            mx, mn = fn(x, layout_, mask_, n)
            ((w * mx).sum() + (w_min * mn).sum()).backward()
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
    # the last: an edge-parallel rank's shard, its [own | halo] node blocks,
    # of which the halo ones take no edge
    for path, suffix, case, times in (
            ("hiv", "", "hiv_main_f70",
             time_extremes(torch, np, hiv, ge_hiv, "hiv")),
            ("pcba", "@pcba", "pcba_micro_f70",
             time_extremes(torch, np, pcba, ge_pcba, "pcba micro")),
            ("ep-hiv-gloo2/rank0", "@ep-hiv", "ep_hiv_shard_f70",
             time_extremes(torch, np, hiv_ep, ge_ep, "ep-hiv shard"))):
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
    non-empty micro-batch of each batch; a BucketedLoader (no
    micro-batches) one per batch of each bucket."""
    if not hasattr(loader, "micro_batches"):
        return len(loader)
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
    argv = path_argv(path) + ["--epochs", str(EPOCHS), "--device", DEVICE]
    counters = launch_counters()
    n_loads = len(_LOADS)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    report, text = run_captured(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    ready = re.search(r"data ready in ([0-9.]+)s", text)
    report["data_ready_s"] = float(ready.group(1)) if ready else None
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
    # the trainer keeps the contexts of a cached loader's batches (built
    # once); a BucketedLoader has no cache, so every forward pass builds
    built = (steps + units["train"] + evals
             if getattr(loaders["val"], "cache", False) else forwards)
    expected = {"build_pair_adjacency": n_adj * built,
                "segment_extremes_fwd": n_ext * forwards,
                "segment_extremes_bwd": n_ext * steps}
    print(f"path {path.key}: dgn_tpu_torch.run {' '.join(argv)} -> "
          f"{wall:.1f}s (data ready in {report['data_ready_s']}s), final "
          f"test {report['final']['test']}, packed "
          f"batches per pass {units}, launches {launches} (expected "
          f"{expected}), peak device memory {peak / 2**20:.1f} MiB")
    if launches != expected:
        fail(f"{path.key}: kernel launches {launches} are not the "
             f"expected {expected}")
    return report, launches, peak


def step_profile(torch, step, batches, label: str, per_micro: dict,
                 n_prof: int = 5):
    """Step time of step(batch) over steady steps, then device activity in
    a profiled window of the first n_prof batches; checks the launches
    each step makes (per_micro times the step's micro-batches)."""
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
    lowp = cfg.torch_compute_dtype() is not None
    what = (f"one {task} step over {len(micros)} packed batch(es), "
            f"augmentation {'on' if aug else 'off'}"
            f"{f', compute_dtype {cfg.compute_dtype}' if lowp else ''}")
    if lowp:
        # the same step in float32 on the card, from the same weights: how
        # far the compute dtype moves the scores, beside the CPU-vs-card
        # difference
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
        what += (f"; the card's {cfg.compute_dtype} scores differ from its "
                 f"float32 ones by up to {d_32:.3g}")
    check_step(torch, what, l_cpu, l_gpu, pairs,
               param_report(torch, model_cpu, model_gpu, params.init_lr),
               kinks_crossed(torch, cpu_calls, card_calls),
               *STEP_TOL[cfg.compute_dtype])


def check_step(torch, what: str, l_cpu, l_gpu, pairs, params_line: str,
               kinks: str, rtol: float = STEP_RTOL,
               atol: float = STEP_ATOL) -> None:
    """Prints and checks a CPU-vs-card step: the loss at rtol, each (CPU,
    card) pair of score tensors at rtol / atol (STEP_RTOL / STEP_ATOL in
    float32; STEP_TOL under a compute dtype)."""
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


def escape_batch(ds, loader):
    """The loader's first batch_size train graphs packed at pads one 512
    step above the loader's: another batch signature, as an escape repack
    makes."""
    from dgn_tpu_torch.graph import pack_graphs
    graphs = sorted(ds.train[:loader.batch_size], key=lambda g: -g.num_nodes)
    return pack_graphs(graphs, n_pad=loader.n_pad + 512,
                       e_pad=loader.e_pad + 512, g_pad=loader.g_pad,
                       mxu_layout=True, n_pairs_pad=loader.pair_pad)


def graph_check(torch, key, task, net, ds, params, loader) -> None:
    """A trainer whose steps replay CUDA graphs (train/graphs.py) against a
    trainer that runs every step eagerly, from the same weights and with
    the same Adam, over GRAPH_PATHS[key]'s batches of loader: after each
    step the loss, every parameter's gradient and its change from the
    start, read as benchmark/check.py reads the benchmark's steps, within
    GRAPH_LIMITS; the same kernel launches on both; the replays the
    batches imply.  A second eager trainer (the control) is read against
    the first alike: the spread of the card's own atomics.  Where the
    control leaves a limit (PATTERN's gradients do, with no graph in
    either trainer), the graphed trainer is held at twice the control's
    reading of that number.  Prints each step's readings and one line
    with the worst ones and the step ms of each side."""
    from benchmark import check
    from dgn_tpu_torch import observe, run
    from dgn_tpu_torch.train.trainer import Trainer
    n, escape_at, drop_at, replays = GRAPH_PATHS[key]
    batches = list(itertools.islice(itertools.cycle(loader), n))
    if escape_at is not None:
        batches[escape_at] = escape_batch(ds, loader)
    model, loss_fn = run.build_model(task, net, ds,
                                     torch.Generator().manual_seed(41))
    sides = {"graphed": model, "eager": copy.deepcopy(model),
             "control": copy.deepcopy(model)}
    trainers = {side: Trainer(m, loss_fn, params, task=task, device=DEVICE)
                for side, m in sides.items()}
    for side in ("eager", "control"):
        trainers[side].step_graphs = None
    if trainers["graphed"].step_graphs is None:
        fail(f"graph check {key}: the trainer holds no step graphs")
    w0 = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    counters = launch_counters()
    launched = {side: dict.fromkeys(counters, 0) for side in sides}
    losses = {side: [] for side in sides}
    ms = {side: [] for side in sides}
    limits = json.loads(GRAPH_LIMITS.read_text())
    worst = {side: dict.fromkeys(check.NUMBERS, 0.0)
             for side in ("graphed", "control")}
    steps = []
    observe.reset()
    with observe.tracing():
        for i, gb in enumerate(batches):
            if i == drop_at:
                for t in trainers.values():
                    t.scheduler.lr = params.init_lr / 2
            for side, t in trainers.items():
                before = {k: c.launches for k, c in counters.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _ = t.train_step(gb)
                torch.cuda.synchronize()
                ms[side].append((time.perf_counter() - t0) * 1e3)
                losses[side].append(float(loss))
                for k, c in counters.items():
                    launched[side][k] += c.launches - before[k]
            grads = {side: {k: p.grad.detach().cpu() for k, p in
                            t.model.named_parameters() if p.grad is not None}
                     for side, t in trainers.items()}
            change = {side: {k: p.detach().cpu() - w0[k] for k, p in
                             t.model.named_parameters()}
                      for side, t in trainers.items()}
            ref = {"losses": losses["eager"], "grad": grads["eager"],
                   "change": change["eager"], "raw_grad": grads["eager"]}
            step = {}
            for side in ("graphed", "control"):
                r = check.readings({"losses": losses[side],
                                    "grad": grads[side],
                                    "change": change[side]}, ref)
                step[side] = {k: r[k] for k in check.NUMBERS}
                step[side]["grad_at"] = r["grad_at"]
                for k in check.NUMBERS:
                    worst[side][k] = max(worst[side][k], r[k])
            steps.append(step)
        counts = observe.summary()["counters"]
    # a limit the card's own spread (the control) already leaves holds the
    # graphed side at twice the control's reading instead
    held = {k: limits[k] if worst["control"][k] <= limits[k]
            else 2 * worst["control"][k] for k in check.NUMBERS}
    ok, shown = check.judge(worst["graphed"], held)
    print(f"graph check {key}: per step, graphed and control (a second "
          f"eager trainer) against the eager one: {json.dumps(steps)}; "
          f"control's worst {json.dumps(worst['control'])}")
    got = counts.get("step.graph_replays", 0)
    print(f"graph check {key}: {n} steps (escape-sized batch at step "
          f"{escape_at}, lr halved before step {drop_at}; 0-based): "
          f"replays {got} (want {replays}), captures "
          f"{counts.get('step.graph_captures', 0)}, eager steps "
          f"{counts.get('step.eager', 0)} of both trainers; launches "
          f"graphed {launched['graphed']} eager {launched['eager']}; worst "
          f"over the steps {json.dumps(shown)}; losses graphed "
          f"{losses['graphed']} eager {losses['eager']}; step ms graphed "
          f"{[round(x, 3) for x in ms['graphed']]} eager "
          f"{[round(x, 3) for x in ms['eager']]}")
    if got != replays:
        fail(f"graph check {key}: {got} replays, not {replays}")
    if launched["graphed"] != launched["eager"]:
        fail(f"graph check {key}: the graphed trainer's launches "
             f"{launched['graphed']} differ from the eager one's "
             f"{launched['eager']}")
    if not ok:
        fail(f"graph check {key}: the replayed steps leave the limits: "
             f"{shown}")


def graphs_phase(torch) -> None:
    """The graph check of each of GRAPH_PATHS alone (`--phases graphs`)."""
    for key in GRAPH_PATHS:
        ds, model, _, _, loaders, cfg = prepared(key)
        graph_check(torch, key, cfg.task, model.cfg, ds, cfg.params,
                    loaders["train"])
        _PREPARED.pop(key)


def sibling(path: TrainPath):
    """The float32 path a bf16 or fp16 path repeats (its key without the
    suffix), or None."""
    for suffix in ("-bf16", "-fp16"):
        if path.key.endswith(suffix):
            return path.key[:-len(suffix)]
    return None


def check_blocks(torch, key: str, net, batch) -> None:
    """The adjacency blocks the model builds for the batch on the card are
    in the config's compute dtype (bf16 or f16 under compute_dtype
    bfloat16 or float16)."""
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
    a bf16 or fp16 path's launches must equal its float32 sibling's, and
    its blocks must be in its compute dtype.  Returns ({path: launches},
    {path: net config})."""
    out, nets, figures = {}, {}, {}
    for path in PATHS:
        key = path.key
        t_path = time.time()
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
        if key in GRAPH_PATHS:
            graph_check(torch, key, cfg.task, model.cfg, ds, p, train)
        if key == "zinc-flat":
            flat_vs_block(torch, cfg.task, model.cfg, ds, p)
        del ds, model, trainer, loaders, batches
        torch.cuda.empty_cache()
        print(f"path {key}: {time.time() - t_path:.1f}s in all")
    return out, nets


def drive_collab(torch, key: str, argv: list) -> dict:
    """COLLAB link prediction through the entry point on argv with every
    launch counter at 0 before and required at 0 after (one flat graph: no
    kernel), its report checked (Hits@K in [0, 1]).  Returns the run's
    launches."""
    counters = launch_counters()
    n_loads = len(_LOADS)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    report, text = run_captured(argv + ["--epochs", str(EPOCHS), "--device",
                                        DEVICE])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: c.launches for name, c in counters.items()}
    ready = re.search(r"data ready in ([0-9.]+)s", text)
    print(f"path {key}: dgn_tpu_torch.run {' '.join(argv)} --epochs "
          f"{EPOCHS} -> {wall:.1f}s (data ready in "
          f"{ready.group(1) if ready else None}s), best val hits@50 "
          f"{report['best_val_hits@50']}, test at best "
          f"{report['test_at_best_val']}, launches {launches} (expected 0), "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if len(_LOADS) != n_loads + 1:
        fail(f"{key}: the run did not load its dataset once through "
             "share_datasets' cache")
    if any(launches.values()):
        fail(f"{key}: kernel launches {launches} on the flat layout")
    hits = [report["best_val_hits@50"], *report["test_at_best_val"].values()]
    if not all(0.0 <= v <= 1.0 for v in hits):
        fail(f"{key}: Hits@K out of [0, 1]: {report}")
    return launches


def collab_phase(torch, np):
    """COLLAB link prediction through the entry point (`drive_collab`);
    then MIN_STEPS train steps timed and profiled, and one step from
    identical weights and identical positive and negative edges on the CPU
    and on the card.  Returns the run's launches."""
    from dgn_tpu_torch import run
    from dgn_tpu_torch.config import config_from_args
    argv = ["--dataset", "COLLAB", "--synthetic_size", str(COLLAB_NODES)]
    counters = launch_counters()
    launches = drive_collab(torch, "collab", argv)

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
    ranges = ([e.get("name") for e in json.loads(trace.read_text())
               ["traceEvents"]].count("dgn.step") if size else 0)
    print(f"recipe: profile_steps wrote {trace} ({size} bytes, {ranges} "
          f"dgn.step ranges) over 3 train steps, last loss "
          f"{float(loss):.6f}; recipe phase {time.time() - t0:.1f}s")
    if size == 0 or not math.isfinite(float(loss)):
        fail("recipe: profile_steps wrote no trace")
    if ranges != 3:
        fail(f"recipe: profile_steps' trace holds {ranges} dgn.step ranges "
             "for 3 steps")


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


def write_real_files() -> float:
    """Every dataset file of the real phase, in the reference's layouts
    (tests/real_files.py), under REAL_DATA; REAL_DIR is emptied first, the
    eigenvector cache with it.  Returns the seconds taken."""
    import shutil
    sys.path.insert(0, str(REPO / "tests"))
    import real_files
    shutil.rmtree(REAL_DIR, ignore_errors=True)
    t = time.time()
    data = str(REAL_DATA)
    real_files.write_zinc(data, REAL_SIZES, seed=1)
    real_files.write_ogb(data, "HIV", OGB_GRAPHS, seed=2)
    # the reader keeps the last len // 10 train images for val: 568
    # images leave 512 to train on
    n_images = next(n for n in range(REAL_SIZES["train"], 2 * REAL_SIZES[
        "train"] + 10) if n - n // 10 == REAL_SIZES["train"])
    real_files.write_superpixels(
        data, "CIFAR10", {"train": [150] * n_images,
                          "test": [150] * REAL_SIZES["test"]}, seed=3)
    real_files.write_sbm(data, "SBM_PATTERN", REAL_SIZES, seed=4)
    real_files.write_collab(data, COLLAB_NODES, seed=5)
    return time.time() - t


@contextlib.contextmanager
def counted_solves(calls: list):
    """Appends the node count of every eigenproblem solved in the block
    (spectral.graph_eig, which EigCache calls on a miss)."""
    from dgn_tpu_torch import spectral
    inner = spectral.graph_eig

    def count(num_nodes, *args, **kwargs):
        calls.append(num_nodes)
        return inner(num_nodes, *args, **kwargs)

    spectral.graph_eig = count
    try:
        yield
    finally:
        spectral.graph_eig = inner


def zinc_cache_check(torch, path: TrainPath):
    """zinc-real twice through the entry point, each with its dataset loaded
    anew from the files: cold (an empty eigenvector cache) and warm.  Fails
    unless the cold run solved eigenproblems, the warm one none, and their
    eig arrays are equal (==).  Returns the warm run's launches."""
    import numpy as np
    from dgn_tpu_torch.config import config_from_args
    cfg, _ = config_from_args(path_argv(path))
    key = (cfg.dataset, dataclasses.astuple(cfg.data))
    eigs, solves = {}, {}
    for name in ("cold", "warm"):
        _DATASETS.pop(key, None)
        _PREPARED.pop(path.key, None)
        calls = []
        with counted_solves(calls):
            report, launches, _ = drive_path(torch, path)
        ds = _DATASETS[key]
        eigs[name] = [g.eig for gs in ds.splits.values() for g in gs]
        solves[name] = len(calls)
        print(f"path {path.key} ({name} cache): data ready in "
              f"{report['data_ready_s']}s, {len(calls)} eigenproblems "
              f"solved, {len(list(REAL_CACHE.glob('*.npy')))} files in "
              f"{REAL_CACHE.name}")
    same = len(eigs["cold"]) == len(eigs["warm"]) and all(
        a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())
        for a, b in zip(eigs["cold"], eigs["warm"]))
    print(f"path {path.key}: the warm run's {len(eigs['warm'])} eig arrays "
          f"equal the cold run's: {same}")
    if not (solves["cold"] > 0 and solves["warm"] == 0 and same):
        fail(f"{path.key}: the eigenvector cache did not serve the warm run "
             f"({solves}, equal eig {same})")
    return launches


def loader_label(loader) -> str:
    """The pads of a loader: one geometry, or one per bucket."""
    if hasattr(loader, "buckets"):
        return "buckets " + ", ".join(
            f"(n_pad={n}, e_pad={e}, pairs={pp})"
            for (n, e), pp in zip(loader.geometry, loader.pair_pads))
    return (f"n_pad={loader.n_pad} e_pad={loader.e_pad} "
            f"pairs={loader.pair_pad}")


def slot_efficiency(loader) -> dict:
    """A loader's padding_stats, or for a BatchLoader the same figures of
    its one geometry over one epoch."""
    if hasattr(loader, "padding_stats"):
        return loader.padding_stats()
    n = len(loader)
    return {"node_slot_efficiency": sum(g.num_nodes for g in loader.graphs)
            / (n * loader.n_pad),
            "edge_slot_efficiency": sum(g.num_edges for g in loader.graphs)
            / (n * loader.e_pad), "n_buckets": 1,
            "geometry": [(loader.n_pad, loader.e_pad)]}


def real_step(torch, path: TrainPath) -> dict:
    """The path's train step over MIN_STEPS of its shuffled train batches
    (step_profile: median, busy ms, ops, peak MiB), the device activity
    over one whole epoch of them: a bucketed loader's first batches may
    all come from one bucket."""
    ds, model, _, trainer, loaders, cfg = _PREPARED[path.key]
    batches = list(loaders["train"])
    net = model.cfg
    n_ext = path.extremes_layers * towers_of(net)
    return step_profile(
        torch, trainer.train_step,
        batches * math.ceil(MIN_STEPS / len(batches)),
        f"{path.key}, {net.type_net} hidden {net.hidden_dim} L={net.L}, "
        f"batch {cfg.params.batch_size}, {loader_label(loaders['train'])}",
        {"build_pair_adjacency": adjacency_builds(net, is_flat(path)),
         "segment_extremes_fwd": n_ext, "segment_extremes_bwd": n_ext},
        n_prof=len(batches))


def same_batch(torch, a, b) -> bool:
    """Every tensor field of two GraphBatches equal, dtype included."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif x is not None or y is not None:
            return False
    return True


def pack_phase(torch, np) -> None:
    """Host packing ms per batch on this machine's host, over PACK_BATCHES
    random train batches of the real-file datasets: the flat layout at its
    worst-case pads (every batch fits) with numpy and with the native
    packer, in turns, their outputs equal, for ZINC and HIV; and the block
    layout, which packs natively once the packer is built, at the pads of
    the path's own train loader, escapes included (`_pack_one`), for ZINC
    and CIFAR10.  Fails unless the native packer built here."""
    from dgn_tpu_torch.data.loader import _order_for_layout
    from dgn_tpu_torch.graph import bucket_sizes_for, pack_graphs
    from dgn_tpu_torch.runtime import native
    if not native.available():
        fail("the native packer did not build on this host (g++)")
    rng = np.random.default_rng(0)

    def draws(key):
        train = _PREPARED[key][0].train
        size = min(_PREPARED[key][5].params.batch_size, len(train))
        return train, size, [[train[i] for i in rng.choice(
            len(train), size, replace=False)] for _ in range(PACK_BATCHES)]

    def report(name, packer, size, ms):
        print(f"host pack ({name}, {packer}): median "
              f"{statistics.median(ms):.3f} ms per batch of {size} (min "
              f"{min(ms):.3f}, max {max(ms):.3f}) over {len(ms)} batches")

    for key in ("zinc-real", "hiv-real"):
        train, size, batches = draws(key)
        n_pad, e_pad = bucket_sizes_for(train, size)
        ms = {False: [], True: []}
        for i, batch in enumerate(batches):
            out = {}
            for use in ((False, True) if i % 2 == 0 else (True, False)):
                t = time.perf_counter()
                out[use] = pack_graphs(batch, n_pad=n_pad, e_pad=e_pad,
                                       g_pad=size, native=use)
                ms[use].append((time.perf_counter() - t) * 1e3)
            if not same_batch(torch, out[False], out[True]):
                fail(f"host pack ({key}): the native packer's batch differs "
                     "from numpy's")
        report(f"{key}, flat n_pad={n_pad} e_pad={e_pad}", "numpy", size,
               ms[False])
        report(f"{key}, flat", "native", size, ms[True])
        print(f"host pack ({key}): native and numpy batches equal in all "
              f"{len(batches)}; native/numpy median "
              f"{statistics.median(ms[True]) / statistics.median(ms[False]):.3f}")
    for key in ("zinc-real", "cifar10-real"):
        _, size, batches = draws(key)
        loader = _PREPARED[key][4]["train"]
        escapes0, ms = loader.n_escapes, []
        for batch in batches:
            batch = _order_for_layout(batch, "mxu")
            t = time.perf_counter()
            loader._pack_one(batch)
            ms.append((time.perf_counter() - t) * 1e3)
        report(f"{key}, block {loader_label(loader)}, "
               f"{loader.n_escapes - escapes0} escape repacks", "native",
               size, ms)


def real_phase(torch, np):
    """The paths on dataset files in the reference's layouts: the files
    written (write_real_files), zinc-real cold and warm (zinc_cache_check),
    then hiv-real, cifar10-real, pattern-real and zinc-buckets through the
    entry point with their launch counts checked (drive_path), zinc-real's
    and zinc-buckets' steps with their slot efficiency and pads, COLLAB on
    the ogbl-collab layout (drive_collab, no launch), and the host pack
    phase.  Returns ({path: launches}, {path: net config})."""
    t0 = time.time()
    print(f"real phase: dataset files written in {write_real_files():.1f}s "
          f"under {REAL_DATA.relative_to(REPO)}")
    launches = {REAL_PATHS[0].key: zinc_cache_check(torch, REAL_PATHS[0])}
    for path in REAL_PATHS[1:]:
        report, launches[path.key], _ = drive_path(torch, path)
        final = report["final"]
        if not all(math.isfinite(v) for split in final.values()
                   for v in split.values()):
            fail(f"a non-finite value in the {path.key} report: {final}")
        ds = _PREPARED[path.key][0]
        print(f"path {path.key}: train/val/test "
              f"{len(ds.train)}/{len(ds.val)}/{len(ds.test)} graphs from "
              f"the files, train pads {loader_label(_PREPARED[path.key][4]['train'])}")
    figures = {key: real_step(torch, next(p for p in REAL_PATHS
                                          if p.key == key))
               for key in ("zinc-real", "zinc-buckets")}
    single = slot_efficiency(_PREPARED["zinc-real"][4]["train"])
    bucketed = slot_efficiency(_PREPARED["zinc-buckets"][4]["train"])
    print(f"zinc-buckets against zinc-real on the same files: train slot "
          f"efficiency nodes {bucketed['node_slot_efficiency']:.4f} vs "
          f"{single['node_slot_efficiency']:.4f}, edges "
          f"{bucketed['edge_slot_efficiency']:.4f} vs "
          f"{single['edge_slot_efficiency']:.4f} ({bucketed['n_buckets']} "
          f"buckets {bucketed['geometry']} vs {single['geometry']}); "
          + "; ".join(f"{name} {figures['zinc-buckets'][name]:.3f} vs "
                      f"{figures['zinc-real'][name]:.3f}"
                      for name in ("median_ms", "busy_ms", "ops",
                                   "peak_mib")))
    launches["collab-real"] = drive_collab(
        torch, "collab-real", ["--dataset", "COLLAB", *DATA_FLAGS])
    pack_phase(torch, np)
    nets = {path.key: _PREPARED[path.key][1].cfg for path in REAL_PATHS}
    _PREPARED.clear()
    _DATASETS.clear()
    torch.cuda.empty_cache()
    print(f"real phase: {time.time() - t0:.1f}s")
    return launches, nets


# The multi-rank phases (data and edge parallelism) on one card: NCCL
# refuses two ranks on one GPU, so the 2-rank runs are gloo ranks that share
# cuda:0 (gloo all-reduces and all-to-alls CUDA tensors and gathers CPU
# ones); the 1-rank runs are NCCL.  Full width, 4 train batches of 128
# graphs per path (PATTERN's 2048 gives 512 train graphs, load_sbm keeps
# n // 4), 8 on ep-hiv, whose planted exchange fault is gated on the halo
# rows of its first batch (EXCHANGE_FAULT_GATED).  (8 on every path until
# the fp16 paths came: cut to keep the script's time.)
PATTERN = "SBMs_node_clustering_DGN_PATTERN.json"
DP_PATHS = (TrainPath("dp-zinc", ZINC, 0, 512),
            TrainPath("dp-hiv", HIV, 4, 512))
EP_PATHS = (TrainPath("ep-zinc", ZINC, 0, 512),
            TrainPath("ep-hiv", HIV, 4, 1024),
            TrainPath("ep-pattern", PATTERN, 0, 2048))
# (backend, ranks) of each path's runs
VARIANTS = {"dp-zinc": (("nccl", 1), ("gloo", 2)),
            "dp-hiv": (("nccl", 1), ("gloo", 2)),
            "ep-zinc": (("nccl", 1), ("gloo", 2)),
            "ep-hiv": (("gloo", 2),), "ep-pattern": (("gloo", 2),)}
PARALLEL_TIMEOUT = 600
# the gradients the step applied against the one-process step's: their
# relative L2 distance, held at GRAD_REL.  The sound step reads about 1e-6
# on an H100 (6.4e-7 at 1 rank, 1.1e-6 at 2, dp).  dp's gradients are the
# ranks' sum, as dgn_tpu's (ROADMAP C6), against the one-process step's
# times the rank count; ep's are the one-process gradients of L.  In
# float32 the posttrans kernels' gradients of a net without graph norm
# (HIV) depend on the order a batch's graphs are packed in (6.15e-4 of
# their norm on dp-hiv), so dp's one-process batch is packed in the
# loader's order; dp_reference measures that sensitivity too
# (order_sensitivity, ROADMAP C).  At 2 ranks each reference plants faults
# that this limit is for.  Gated: the sums over the ranks without their
# summed backward (MissingCrossRankBackward: sync batch norm, and in ep
# the readout's and the virtual node's pools), and on ep-hiv the halo
# exchange without its reverse backward (MissingExchangeBackward).  That
# fault moves only the cotangent of the halo rows (the cut crosses one
# graph: a few rows against thousands of own rows), and how far that moves
# the gradients depends on the net: on ep-hiv (the simple layer, no graph
# norm) far past GRAD_REL; on ep-zinc and ep-pattern (the complex layer
# with graph norm) less than the sound step's own float32 distance, so
# there it is printed beside the halo's real rows, not held
# (tests/test_torch_halo.py holds it element by element).  Entries outside
# rtol 1e-3 / atol 1e-4 x max |grad| are counted and printed.  The weights
# after Adam are printed, not held: Adam turns the rounding noise of a
# gradient that is zero up to rounding into a step of up to lr either way
GRAD_REL = 1e-4
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-3, 1e-4
EXCHANGE_FAULT_GATED = ("ep-hiv",)


def grad_distance(torch, a, b) -> float:
    """|a - b| / |b| over lists of gradient tensors (L2 over all)."""
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    return (num / sum(float((y.double() ** 2).sum()) for y in b)) ** 0.5


def order_sensitivity(torch, cfg, ds, net, graphs, order) -> tuple:
    """How far the one-process step's gradients move when the same graphs
    are packed in shard order instead of descending size: in float32 on
    the card, and in float64 on the CPU (the plain versions)."""
    from dgn_tpu_torch import run
    from dgn_tpu_torch.graph import pack_graphs
    out = []
    for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        grads = []
        for gs in (graphs, [graphs[i] for i in order]):
            model, loss_fn = run.build_model(
                cfg.task, net, ds, torch.Generator().manual_seed(41))
            model = model.to(device=device, dtype=dtype).train()
            gb = pack_graphs(gs, mxu_layout=True).to(device)
            gb = dataclasses.replace(gb, **{
                f.name: getattr(gb, f.name).to(dtype)
                for f in dataclasses.fields(gb)
                if isinstance(getattr(gb, f.name), torch.Tensor)
                and getattr(gb, f.name).is_floating_point()})
            loss_fn(model(gb), gb).backward()
            grads.append([p.grad for p in model.parameters()])
        out.append(grad_distance(torch, *grads))
    return tuple(out)


class MissingCrossRankBackward:
    """A planted fault, standing in for nn._AllReduceSum: the sum over the
    ranks by a bare all_reduce, whose backward passes on this rank's
    cotangent alone and so loses the other ranks' terms."""

    @staticmethod
    def apply(x, group):
        import torch.distributed as dist
        total = x.detach().clone()
        dist.all_reduce(total, group=group)
        return x + (total - x.detach())


class MissingExchangeBackward:
    """A planted fault, standing in for graph._AllToAll: the same exchange
    forward, a backward that returns the cotangent where it is instead of
    sending it back to the rows' owners."""

    @staticmethod
    def apply(x, group):
        from dgn_tpu_torch import graph as tgraph
        return x + (tgraph.exchange(x, group) - x).detach()


def with_fault(module, name: str, fault, step):
    """step() with module.name swapped for fault on this rank."""
    sound = getattr(module, name)
    setattr(module, name, fault)
    try:
        return step()
    finally:
        setattr(module, name, sound)


def compare_steps(torch, model, ref_model, got, want, loss, ref_loss,
                  faults) -> dict:
    """A multi-rank step (model, its gradients where Adam took them, and
    got, the scores of every real row) against the one-process step
    (ref_model, want), and each planted fault's {label: (model, gated)}
    gradients against the one-process ones."""
    pairs = [(name, a, b) for (name, a), b in zip(model.named_parameters(),
                                                  ref_model.parameters())]
    want_grads = [b.grad for _, _, b in pairs]
    d_param = {name: (a.detach() - b.detach()).abs().max().item()
               for name, a, b in pairs}
    g_max = max(b.grad.abs().max().item() for _, _, b in pairs)
    rel = grad_distance(torch, [a.grad for _, a, _ in pairs], want_grads)
    worst = max(d_param, key=d_param.get)
    return dict(
        ref_loss=float(ref_loss), loss_close=math.isclose(
            float(loss), float(ref_loss), rel_tol=STEP_RTOL),
        n_rows=int(got.shape[0]), d_scores=(got - want).abs().max().item(),
        scores_close=bool(torch.allclose(got, want, rtol=STEP_RTOL,
                                         atol=STEP_ATOL)),
        grad_rel=rel, grads_close=rel <= GRAD_REL, g_max=g_max,
        d_grad=max((a.grad - b.grad).abs().max().item()
                   for _, a, b in pairs),
        grads_apart=sum(int((~torch.isclose(
            a.grad, b.grad, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * g_max)).sum()) for _, a, b in pairs),
        n_entries=sum(a.numel() for _, a, _ in pairs),
        zero_grads=[name for name, a, _ in pairs
                    if not bool(a.grad.ne(0).any())],
        d_param=d_param[worst], worst_param=worst,
        d_param_rest=max(v for k, v in d_param.items()
                         if not k.endswith("posttrans.bias")),
        faults=[(label, grad_distance(
            torch, [p.grad for p in m.parameters()], want_grads), gated,
            largest_share(torch, m, pairs)) for label, (m, gated)
            in faults.items()])


def largest_share(torch, model, pairs) -> tuple:
    """(name, share) of the parameter that holds the largest share of the
    squared distance between model's gradients and the one-process ones."""
    sq = {name: float(((p.grad.double() - b.grad.double()) ** 2).sum())
          for p, (name, _, b) in zip(model.parameters(), pairs)}
    name = max(sq, key=sq.get)
    return name, sq[name] / max(sum(sq.values()), 1e-300)


def dp_reference(torch, ds, net, cfg, mesh, path) -> dict:
    """One data-parallel step (dropout and input dropout 0) on this rank's
    shard of the first unshuffled super-batch, and on rank 0 the one-process
    Trainer step from the same weights on the super-batch's graphs packed
    as one batch (with one rank, the rank's own batch), its gradients
    scaled by the rank count.  At 2 ranks also the step with
    MissingCrossRankBackward."""
    import torch.distributed as dist
    from dgn_tpu_torch import nn as tnn
    from dgn_tpu_torch import run
    from dgn_tpu_torch.graph import pack_graphs
    from dgn_tpu_torch.parallel import DataParallelTrainer, StackedLoader
    from dgn_tpu_torch.train.trainer import Trainer
    net0 = dataclasses.replace(net, dropout=0.0, in_feat_dropout=0.0)
    per_dev = max(cfg.params.batch_size // mesh.size, 1)
    n_pad, e_pad = run.pad_geometry(ds.train + ds.val + ds.test, per_dev,
                                    "mxu")
    loader = StackedLoader(ds.train, per_dev, mesh.size, rank=mesh.rank,
                           n_pad=n_pad, e_pad=e_pad, layout="mxu")
    shards, geometry = next(loader.super_batches())
    gb = loader.pack_shard(*shards[mesh.rank], geometry)

    def dp_step():
        model, loss_fn = run.build_model(cfg.task, net0, ds,
                                         torch.Generator().manual_seed(41))
        trainer = DataParallelTrainer(model, loss_fn, cfg.params, mesh,
                                      task=cfg.task)
        # the gradients stay on the parameters after Adam's step
        loss, scores = trainer.train_step(gb)
        return model, loss, trainer.gather_shards(gb, scores)

    model, loss, (view, all_scores) = dp_step()
    out = {"loss": float(loss), "ranks": mesh.size,
           "backend": dist.get_backend()}
    faults = {}
    if mesh.size > 1:
        faults["sync batch norm's sum without its summed backward"] = (
            with_fault(tnn, "_AllReduceSum", MissingCrossRankBackward,
                       dp_step)[0], True)
    if mesh.rank != 0:
        return out
    ref_model, loss_fn = run.build_model(
        cfg.task, dataclasses.replace(net0, bn_axis=None), ds,
        torch.Generator().manual_seed(41))
    ref = Trainer(ref_model, loss_fn, cfg.params, task=cfg.task,
                  device=mesh.device)
    # the data-parallel step applies the gradients summed over the ranks,
    # as dgn_tpu's does (ROADMAP C6): the reference's, times the rank count
    ref._reduce_grads = lambda: [p.grad.mul_(mesh.size)
                                 for p in ref_model.parameters()
                                 if p.grad is not None]
    # the one-device loader's batch: every real graph of the super-batch,
    # in descending node count
    graphs = [g for gs, ghost in shards if not ghost for g in gs]
    order = sorted(range(len(graphs)), key=lambda i: -graphs[i].num_nodes)
    one = gb if mesh.size == 1 else pack_graphs(
        [graphs[i] for i in order], mxu_layout=True)
    ref_loss, ref_scores = ref.train_step(one)
    got = torch.from_numpy(all_scores[view.graph_mask.numpy()])
    want = ref_scores[one.graph_mask.to(ref_scores.device)].cpu()
    if mesh.size > 1:
        want = want[torch.argsort(torch.tensor(order))]
    out.update(compare_steps(torch, model, ref_model, got, want, loss,
                             ref_loss, faults),
               against=("the same batch" if mesh.size == 1
                        else "the concatenated batch"))
    if mesh.size > 1:
        f32, f64 = order_sensitivity(
            torch, cfg, ds, dataclasses.replace(net0, bn_axis=None), graphs,
            order)
        out["notes"] = [
            f"the one-process step's gradients, the super-batch packed in "
            f"shard order against descending size: apart by {f32:.3g} of "
            f"their norm in float32 on the card, {f64:.3g} in float64 on "
            f"the CPU"]
    return out


def ep_shape(gb) -> dict:
    """A rank's batch geometry: own rows and halo rows (padded, real: the
    remote nodes its real edges read), the exchange's rows per peer, and
    the interior and boundary pairs (padded, covered: a pad edge covers a
    pad pair)."""
    lay = gb.mxu
    ni = lay.n_pairs_int
    cov = lay.pair_covered.cpu()
    n_loc = gb.halo.n_local
    src = gb.src.cpu()[gb.edge_mask.cpu()]
    return {"own": (n_loc, int(gb.node_mask.cpu()[:n_loc].sum())),
            "halo": (gb.num_nodes_padded - n_loc,
                     int(src[src >= n_loc].unique().numel())),
            "s_max": int(gb.halo.send_idx.shape[1]),
            "pairs_int": (ni, int(cov[:ni].sum())),
            "pairs_bnd": (lay.n_pairs - ni, int(cov[ni:].sum()))}


def ep_reference(torch, ds, net, cfg, mesh, path) -> dict:
    """One ep step (dropout 0) on this rank's shard of the first unshuffled
    batch, and on rank 0 the one-process Trainer step from the same
    weights on the batch's graphs packed as one block-layout batch.  At 2
    ranks also the steps with MissingCrossRankBackward and with
    MissingExchangeBackward."""
    import torch.distributed as dist
    from dgn_tpu_torch import graph as tgraph
    from dgn_tpu_torch import nn as tnn
    from dgn_tpu_torch import run
    from dgn_tpu_torch.graph import pack_graphs
    from dgn_tpu_torch.parallel import (EdgeParallelTrainer,
                                        PartitionedLoader, partition_shards)
    from dgn_tpu_torch.train.trainer import Trainer
    net0 = dataclasses.replace(net, dropout=0.0, in_feat_dropout=0.0)
    node = cfg.task == "sbm"
    bs = cfg.params.batch_size
    graphs = next(PartitionedLoader(ds.train, bs, mesh.size).batches())
    # every rank's shard, as the entry point's loaders cut the batch
    shards = partition_shards(graphs, mesh.size, g_pad=bs, layout="mxu")
    gb = shards[mesh.rank]

    def ep_step():
        model, loss_fn = run.build_model(cfg.task, net0, ds,
                                         torch.Generator().manual_seed(41))
        trainer = EdgeParallelTrainer(model, loss_fn, cfg.params, mesh,
                                      task=cfg.task)
        # the gradients stay on the parameters after Adam's step
        loss, scores = trainer.train_step(gb)
        return model, loss, scores

    model, loss, scores = ep_step()
    shape = ep_shape(gb)
    out = {"loss": float(loss), "ranks": mesh.size,
           "backend": dist.get_backend(), "rank_note": str(shape)}
    faults = {}
    if mesh.size > 1:
        faults["the sums over the ranks, pools and sync batch norm, "
               "without their summed backward"] = (
            with_fault(tnn, "_AllReduceSum", MissingCrossRankBackward,
                       ep_step)[0], True)
        faults[f"the halo exchange without its reverse backward, halo "
               f"{shape['halo'][1]} real rows against {shape['own'][1]} own "
               f"on rank {mesh.rank}"] = (
            with_fault(tgraph, "_AllToAll", MissingExchangeBackward,
                       ep_step)[0], path.key in EXCHANGE_FAULT_GATED)
    if mesh.rank != 0:
        return out
    ref_model, loss_fn = run.build_model(
        cfg.task, dataclasses.replace(net0, bn_axis=None), ds,
        torch.Generator().manual_seed(41))
    ref = Trainer(ref_model, loss_fn, cfg.params, task=cfg.task,
                  device=mesh.device)
    one = pack_graphs(graphs, mxu_layout=True)
    ref_loss, ref_scores = ref.train_step(one)
    mask = one.node_mask if node else one.graph_mask
    want = ref_scores[mask.to(ref_scores.device)].cpu()
    if node:
        got = scores.cpu()[torch.cat([s.node_mask for s in shards])]
    else:
        got = scores.cpu()[gb.graph_mask]
    out.update(compare_steps(torch, model, ref_model, got, want, loss,
                             ref_loss, faults),
               against="the same " + ("nodes" if node else "graphs"))
    return out


# per partition: the step's name, its reference, and where its collectives
# are timed (the attribute wrapped on the trainer, or on the graph module)
PARTITIONS = {
    "dp": ("data-parallel", DP_PATHS, dp_reference, "trainer",
           "_all_reduce", "all-reduce"),
    "ep": ("edge-parallel", EP_PATHS, ep_reference, "graph", "exchange",
           "halo exchanges"),
}


def timed_steps(torch, trainer, batches, rank: int, owner, attr: str,
                n_prof: int = 5) -> dict:
    """The trainer's step as shipped over MIN_STEPS steps of this rank's
    shards: median, min and max ms (the first 3 dropped), host ms and
    calls of each step's collectives (owner.attr wrapped for these steps,
    CUDA-synchronised around each call), peak MiB, then on rank 0 the
    device activity of n_prof profiled steps (every rank steps
    alongside)."""
    batches = batches * math.ceil(MIN_STEPS / len(batches))
    torch.cuda.reset_peak_memory_stats()
    comm, calls, times = [], [], []
    sound = getattr(owner, attr)

    def timed_call(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = sound(*args, **kwargs)
        torch.cuda.synchronize()
        comm[-1] += (time.perf_counter() - t) * 1e3
        calls[-1] += 1
        return result

    setattr(owner, attr, timed_call)
    try:
        for gb in batches:
            comm.append(0.0)
            calls.append(0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, _ = trainer.train_step(gb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            if not math.isfinite(float(loss)):
                fail("a multi-rank step gave a non-finite loss")
    finally:
        setattr(owner, attr, sound)
    out = {"median_ms": statistics.median(times[3:]),
           "min_ms": min(times[3:]), "max_ms": max(times[3:]),
           "steps": len(times) - 3,
           "comm_ms": statistics.median(comm[3:]), "calls": calls[-1],
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    run = lambda: [trainer.train_step(gb) for gb in batches[:n_prof]]
    if rank != 0:
        run()
        torch.cuda.synchronize()
        return out
    events = profiled(torch, run)
    out["busy_ms"] = sum(e.device_time for e in events) / 1e3 / n_prof
    out["ops"] = len(events) / n_prof
    return out


def parallel_rank(rank: int, n: int, init_method: str, partition: str,
                  key: str, backend: str):
    """One rank of a multi-rank path on cuda:0: joins the group, trains
    the path's config for EPOCHS through the port's rank entry
    (run._run_rank with --partition, what `--n_devices N` runs in each
    rank) with every launch counter at 0 just before and read just after,
    then the partition's reference step and the timed steps."""
    import io
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from dgn_tpu_torch import graph as tgraph
    from dgn_tpu_torch import run
    from dgn_tpu_torch.config import config_from_args
    from dgn_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE, 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank)
    try:
        if dist.get_backend() != backend or dist.get_world_size() != n:
            fail(f"{key}: the group is {dist.get_backend()} with "
                 f"{dist.get_world_size()} ranks, not {backend} with {n}")
        mesh = make_mesh(n, device=device)
        _, paths, reference, owner, attr, _ = PARTITIONS[partition]
        path = next(p for p in paths if p.key == key)
        cfg, args = config_from_args(path_argv(path) + [
            "--epochs", str(EPOCHS), "--device", DEVICE, "--partition",
            partition])
        captured, prepare = [], run.prepare
        run.prepare = lambda *a, **k: captured.append(prepare(*a, **k)) \
            or captured[-1]
        counters = launch_counters()
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            report = run._run_rank(cfg, args, mesh)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: c.launches for name, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        run.prepare = prepare
        ds, model, _, trainer, loaders = captured[0]
        units = {split: len(ld) for split, ld in loaders.items()}
        steps = EPOCHS * units["train"]
        evals = units["val"] + units["test"]
        # neither multi-rank loader keeps an eval cache: every forward
        # pass builds
        forwards = steps + EPOCHS * evals + units["train"] + evals
        n_ext = path.extremes_layers * towers_of(model.cfg)
        expected = {"build_pair_adjacency":
                    adjacency_builds(model.cfg, False) * forwards,
                    "segment_extremes_fwd": n_ext * forwards,
                    "segment_extremes_bwd": n_ext * steps}
        ref = reference(torch, ds, model.cfg, cfg, mesh, path)
        timing = timed_steps(
            torch, trainer, list(loaders["train"]), rank,
            trainer if owner == "trainer" else tgraph, attr)
        train = loaders["train"]
        where = (f"train pads (n, e, pairs) "
                 f"{(train.n_pad, train.e_pad, train.pair_pad)}"
                 if partition == "dp" else
                 f"halo exchange over {dist.get_backend(mesh.group)} on "
                 f"CUDA tensors")
        return {"rank": rank, "report": report, "launches": launches,
                "expected": expected, "units": units, "wall_s": wall,
                "run_peak_mib": peak, "ref": ref, "timing": timing,
                "text": buf.getvalue() if rank == 0 else "",
                "lr": cfg.params.init_lr, "where": where}
    finally:
        dist.destroy_process_group()


def parallel_phase(partition: str) -> dict:
    """The partition's paths at full width through their VARIANTS, spawned
    with a deadline: every rank's launches must be what its loaders imply,
    rank 0's step must equal the one-process step (loss, scores and
    gradients, no parameter's gradient 0; the weights after Adam printed),
    at 2 ranks each gated planted fault (MissingCrossRankBackward, and on
    ep-hiv MissingExchangeBackward) must fail that gradient check, and the
    ranks' losses must agree.  Returns {path-variant/rank r: launches}."""
    from dgn_tpu_torch.parallel.launch import spawn
    name, paths, _, _, _, comm = PARTITIONS[partition]
    out = {}
    for path in paths:
        for backend, n in VARIANTS[path.key]:
            key = f"{path.key}-{backend}{n}"
            t0 = time.time()
            try:
                ranks = spawn(parallel_rank, n, (partition, path.key,
                                                 backend),
                              timeout=PARALLEL_TIMEOUT)
            except RuntimeError as e:
                fail(f"{key}: {e}")
            r0 = ranks[0]
            print(r0["text"], end="")
            for r in ranks:
                out[f"{key}/rank{r['rank']}"] = r["launches"]
                if r["launches"] != r["expected"]:
                    fail(f"{key} rank {r['rank']}: kernel launches "
                         f"{r['launches']} are not the expected "
                         f"{r['expected']}")
            final = r0["report"]["final"]
            if not all(math.isfinite(v) for split in final.values()
                       for v in split.values()):
                fail(f"{key}: a non-finite value in the report: {final}")
            ref = r0["ref"]
            if ref["ranks"] != n or ref["backend"] != backend:
                fail(f"{key}: the step ran on {ref['ranks']} {ref['backend']}"
                     f" ranks")
            if len({r["ref"]["loss"] for r in ranks}) != 1:
                fail(f"{key}: the ranks' losses differ: "
                     f"{[r['ref']['loss'] for r in ranks]}")
            t = r0["timing"]
            print(f"path {key}: {n} {backend} rank(s) on cuda:0, "
                  f"{r0['where']}, {time.time() - t0:.1f}s (entry run "
                  f"{r0['wall_s']:.1f}s), packed shards per rank "
                  f"{r0['units']}, final test {final['test']}, launches per "
                  f"rank {[r['launches'] for r in ranks]} (expected "
                  f"{r0['expected']}), run peak "
                  f"{[round(r['run_peak_mib'], 1) for r in ranks]} MiB")
            if "rank_note" in ref:
                print(f"  shard geometry of the first batch per rank (own "
                      f"and halo rows (padded, real), s_max, interior and "
                      f"boundary pairs (padded, covered)): "
                      + "; ".join(f"rank {r['rank']} {r['ref']['rank_note']}"
                                  for r in ranks))
            print(f"  {name} step vs the one-process step on "
                  f"{ref['against']} ({ref['n_rows']} rows, dropout 0): loss "
                  f"{ref['loss']:.6f} vs {ref['ref_loss']:.6f} (|diff| "
                  f"{abs(ref['loss'] - ref['ref_loss']):.3g}), max |score "
                  f"diff| {ref['d_scores']:.3g} (rtol {STEP_RTOL:g}, atol "
                  f"{STEP_ATOL:g}), gradients apart by {ref['grad_rel']:.3g}"
                  f" of their norm (at most {GRAD_REL:g}; max |diff| "
                  f"{ref['d_grad']:.3g}, max |grad| {ref['g_max']:.3g}, "
                  f"{ref['grads_apart']} of {ref['n_entries']} entries "
                  f"outside rtol {GRAD_RTOL:g} / atol {GRAD_ATOL_OF_MAX:g} x "
                  f"max |grad|), parameters with a zero gradient "
                  f"{ref['zero_grads']}, max |param diff after Adam| "
                  f"{ref['d_param']:.3g} ({ref['worst_param']}; "
                  f"{ref['d_param_rest']:.3g} without the posttrans biases; "
                  f"lr {r0['lr']:g})")
            for what, rel, gated, (leaf, share) in ref["faults"]:
                print(f"  planted fault ({what}): gradients apart by "
                      f"{rel:.3g} of their norm "
                      + (f"(must exceed {GRAD_REL:g})" if gated
                         else "(printed, not held)")
                      + f", {share:.3g} of the squared distance in {leaf}")
                if gated and not rel > GRAD_REL:
                    fail(f"{key}: the gradient check does not see a step "
                         f"with {what}")
            for note in ref.get("notes", ()):
                print(f"  {note}")
            medians = [round(r["timing"]["median_ms"], 3) for r in ranks]
            print(f"  train step as shipped (rank 0): median "
                  f"{t['median_ms']:.3f} ms over {t['steps']} steps (min "
                  f"{t['min_ms']:.3f}, max {t['max_ms']:.3f}), busy "
                  f"{t['busy_ms']:.3f} ms/step in {t['ops']:.0f} device "
                  f"ops/step, {comm} {t['comm_ms']:.3f} ms/step in "
                  f"{t['calls']} calls (host, synchronised), peak "
                  f"{t['peak_mib']:.1f} MiB; per rank median {medians} ms, "
                  f"{comm} "
                  f"{[round(r['timing']['comm_ms'], 3) for r in ranks]} ms")
            if not (ref["loss_close"] and ref["scores_close"]
                    and ref["grads_close"] and not ref["zero_grads"]):
                fail(f"{key}: the {name} step disagrees with the "
                     "one-process step")
    return out


def scaling_phase() -> None:
    """tools/scaling.py on the card: dp and ep at 1 and 2 ranks (2 gloo
    ranks sharing cuda:0), the flagship ZINC net at batch 128; its rows
    carry no predicted efficiency (no link bandwidth is measured here)."""
    from dgn_tpu_torch.tools import scaling
    rows = scaling.run_scaling(("dp", "ep"), (1, 2), batch=128, hidden=45,
                               L=4, steps=10,
                               emit=lambda s: print(f"scaling row: {s}"))
    for (part, n), row in rows.items():
        if not (math.isfinite(row["step_ms"]) and row["step_ms"] > 0):
            fail(f"scaling {part} at {n} ranks: step {row['step_ms']} ms")


DENSE_GRAPHS = 128
DENSE_WIDTH = 45
DENSE_AGGREGATORS = ("mean", "max", "min", "std", "dir1-dx", "dir1-smooth")
DENSE_SCALERS = ("identity", "amplification", "attenuation")
DENSE_TOWERS = 5
DENSE_RTOL, DENSE_ATOL = 1e-4, 1e-5
DENSE_GRAD_RTOL, DENSE_GRAD_ATOL = 1e-3, 1e-5
DENSE_EIG_ATOL = 1e-4


def dense_phase(torch, np) -> None:
    """The dense research path (dgn_tpu_torch/dense) on the card:
    DenseDGNLayer at hidden 45 with 5 towers over 128 synthetic ZINC
    molecules padded to their largest node count (a pad node carries a
    self-loop: an isolated node's mean is 0/0), forward and backward with
    eigvec=None, so k_lowest_eigvecs runs torch.linalg.eigh on the card;
    held against the CPU from the same weights given the card's
    eigenvectors (their signs are the solver's), with the null counts
    (|eigenvalue| < EPS) of the two solvers and the eigenvectors' agreement
    up to sign on the graphs whose molecule's Fiedler value is simple
    (held at DENSE_EIG_ATOL); then timed."""
    from dgn_tpu_torch import dense
    from dgn_tpu_torch.data.synthetic import synthetic_zinc
    from dgn_tpu_torch.ops.scalers import degree_stats
    t0 = time.time()
    graphs = synthetic_zinc(DENSE_GRAPHS, seed=41)
    n = max(g.num_nodes for g in graphs)
    adj = np.zeros((len(graphs), n, n), np.float32)
    real = np.zeros((len(graphs), n), bool)
    for b, g in enumerate(graphs):
        adj[b, g.dst, g.src] = 1.0
        real[b, :g.num_nodes] = True
        pads = np.arange(g.num_nodes, n)
        adj[b, pads, pads] = 1.0
    rng = np.random.default_rng(41)
    x = rng.normal(size=(len(graphs), n, DENSE_WIDTH)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32) * real[..., None]
    avg_d = degree_stats(np.concatenate(
        [np.bincount(g.dst, minlength=g.num_nodes) for g in graphs]))
    layer = dense.DenseDGNLayer(
        DENSE_WIDTH, DENSE_WIDTH, DENSE_AGGREGATORS, DENSE_SCALERS, avg_d,
        torch.Generator().manual_seed(41), towers=DENSE_TOWERS)
    card = copy.deepcopy(layer).to(DEVICE)
    a_gpu, a_cpu = torch.from_numpy(adj).to(DEVICE), torch.from_numpy(adj)
    vec_gpu = dense.k_lowest_eigvecs(a_gpu, 2)
    vec_cpu = dense.k_lowest_eigvecs(a_cpu, 2)
    nc_gpu = dense.spectral.null_counts(a_gpu).cpu()
    nc_cpu = dense.spectral.null_counts(a_cpu)
    # each padded graph is its molecule plus one component per pad node;
    # column 1 is the molecule's Fiedler vector, defined up to sign where
    # the molecule's Fiedler value is simple
    fiedler = []
    for b, g in enumerate(graphs):
        vals = np.linalg.eigvalsh(np.diag(adj[b, :g.num_nodes, :g.num_nodes]
                                          .sum(1)).astype(np.float64)
                                  - adj[b, :g.num_nodes, :g.num_nodes])
        if vals[1] > 1e-3 and vals[2] - vals[1] > 1e-3:
            fiedler.append(b)
    got, want = vec_gpu.cpu()[fiedler], vec_cpu[fiedler]
    sign = torch.sign((got * want).sum(-2, keepdim=True))
    d_vec = (got * torch.where(sign == 0, 1.0, sign) - want).abs().max()

    def run(model, a, eigvec, xs):
        xs = xs.clone().requires_grad_(True)
        model.zero_grad(set_to_none=True)
        out = model(xs, a, eigvec)
        (out * torch.from_numpy(ct).to(a.device)).sum().backward()
        return out, xs.grad

    x_gpu = torch.from_numpy(x).to(DEVICE)
    t1 = time.time()
    out_gpu, dx_gpu = run(card, a_gpu, None, x_gpu)
    torch.cuda.synchronize()
    t2 = time.time()
    out_cpu, dx_cpu = run(layer, a_cpu, vec_gpu.cpu(), torch.from_numpy(x))
    t3 = time.time()
    mask = torch.from_numpy(real)
    d_out = (out_gpu.detach().cpu()[mask] - out_cpu.detach()[mask]).abs()
    ok = torch.allclose(out_gpu.detach().cpu()[mask], out_cpu.detach()[mask],
                        rtol=DENSE_RTOL, atol=DENSE_ATOL)
    grads = [(name, p.grad.cpu(), q.grad) for (name, p), q in
             zip(card.named_parameters(), layer.parameters())]
    grads.append(("x", dx_gpu.cpu(), dx_cpu))
    d_grad = max((a - b).abs().max().item() for _, a, b in grads)
    ok_grad = all(torch.allclose(a, b, rtol=DENSE_GRAD_RTOL,
                                 atol=DENSE_GRAD_ATOL) for _, a, b in grads)
    finite = bool(torch.isfinite(out_gpu).all()) and all(
        bool(torch.isfinite(a).all()) for _, a, _ in grads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # few iterations: cuSOLVER's eigh launches kernels per matrix, and the
    # profiler's trace of them costs seconds per call to read
    step = lambda i: run(card, a_gpu, None, x_gpu)
    busy, call = timed(torch, step, iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**20
    lap = dense.laplacian(a_gpu)
    eigh_busy, eigh_call = timed(torch, lambda i: torch.linalg.eigh(lap),
                                 iters=3, warmup=1)
    agree = int((nc_gpu == nc_cpu).sum())
    print(f"dense phase: DenseDGNLayer {DENSE_WIDTH}->{DENSE_WIDTH}, "
          f"{DENSE_TOWERS} towers, aggregators {' '.join(DENSE_AGGREGATORS)}"
          f", scalers {' '.join(DENSE_SCALERS)}, x {list(x.shape)} "
          f"({len(graphs)} ZINC molecules padded to N={n}), eigvec=None; "
          f"card vs CPU (CPU given the card's eigenvectors): max |out diff| "
          f"{d_out.max().item():.3g} on real nodes (rtol {DENSE_RTOL:g}, atol"
          f" {DENSE_ATOL:g}), max |grad diff| {d_grad:.3g} over "
          f"{len(grads)} tensors (rtol {DENSE_GRAD_RTOL:g}, atol "
          f"{DENSE_GRAD_ATOL:g})")
    print(f"  null counts (|eigenvalue| < {dense.EPS:g}) equal on the card "
          f"and the CPU for {agree} of {len(graphs)} graphs (card "
          f"{sorted(set(nc_gpu.tolist()))}, CPU "
          f"{sorted(set(nc_cpu.tolist()))}); eigenvectors 0-1 of the "
          f"{len(fiedler)} graphs whose molecule has a simple Fiedler value "
          f"equal up to sign to {d_vec.item():.3g}")
    print(f"  forward + backward: {busy:.3f} ms busy ({call:.3f} ms per "
          f"call), peak {peak:.1f} MiB; torch.linalg.eigh of the {n}x{n} "
          f"Laplacians: {eigh_busy:.3f} ms busy ({eigh_call:.3f} ms per "
          f"call); phase {time.time() - t0:.1f}s (the first card call "
          f"{t2 - t1:.1f}s, the CPU's {t3 - t2:.1f}s)")
    if not (ok and ok_grad and finite and agree == len(graphs)
            and d_vec.item() <= DENSE_EIG_ATOL):
        fail("the dense phase's card results disagree with the CPU's (or "
             "are not finite, or the null counts or eigenvectors differ)")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", choices=("all", "kernels", "graphs"),
                        default="all",
                        help="kernels: phases 1-3 only; the kernels line "
                        "then has no launches and no device line follows; "
                        "graphs: phases 1-2 and the graph checks")
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
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    # the bf16 and f16 block products (ops/mxu.py) need torch.bmm's
    # out_dtype on bf16 and f16 operands, accumulating in float32: 2049 =
    # 2^11 + 1 is exact in float32 and not in either 16-bit type
    for name, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        a = torch.ones((1, 1, 2049), device=DEVICE, dtype=dt)
        got = torch.bmm(a, a.transpose(1, 2), out_dtype=torch.float32)
        print(f"torch.bmm({name}, {name}, out_dtype=float32): {got.dtype}, "
              f"2049 ones summed to {got.item():g}")
        if got.dtype != torch.float32 or got.item() != 2049:
            fail(f"torch.bmm on {name} operands does not accumulate and "
                 "return float32")

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
    if args.phases == "graphs":
        graphs_phase(torch)
        print(f"card: {card_line()}")
        return
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
    real_launches, real_nets = real_phase(torch, np)
    launches.update(real_launches)
    nets.update(real_nets)
    t = time.time()
    launches.update(parallel_phase("dp"))
    print(f"dp phase: {time.time() - t:.1f}s")
    t = time.time()
    launches.update(parallel_phase("ep"))
    print(f"ep phase: {time.time() - t:.1f}s")
    t = time.time()
    scaling_phase()
    print(f"scaling phase: {time.time() - t:.1f}s")
    dense_phase(torch, np)
    # `launches` is the kernel's count on the path whose shape the entry
    # timed ("path"); the counts of every path stand beside it (COLLAB's
    # checked to be 0 in collab_phase)
    for kern in kernels:
        counter = kern["name"].split("@")[0]
        kern["launches"] = launches[kern["path"]][counter]
        kern["launches_by_path"] = {p: c[counter] for p, c in launches.items()}
        for path in PATHS + REAL_PATHS:
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
        for key, n in kern["launches_by_path"].items():
            path = next((p for p in DP_PATHS + EP_PATHS
                         if key.startswith(p.key + "-")), None)
            runs = path is not None and (
                counter == "build_pair_adjacency" or path.extremes_layers)
            if runs and n <= 0:
                fail(f"kernel {counter} was not launched on {key}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
