#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (dgn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU (written for
the H100) and the CUDA toolkit.  Phases, each of which fails the script:

1. card: name and power limit from nvidia-smi; no CUDA device -> exit 1;
2. build: every CUDA kernel of the package, from the checkout's sources;
3. kernels: each kernel at the main path's shapes (ZINC, batch 128), plus a
   multi-block case and bf16 output, held against its plain PyTorch version
   on the card and against an f64 oracle, and timed beside the plain
   version, one equivalent PyTorch call and the card's bound;
4. training: the port's entry point (dgn_tpu_torch.run) trains the
   canonical ZINC config at full width on the card, with every kernel
   launch counter set to 0 just before and read just after; then the step
   time, and one step from identical weights on the CPU and on the card.

Prints a `{"kernels": [...]}` line and, last, the device line
`{"ok": true, "device": {...}}`.  Needs no network; starts no process other
than nvidia-smi and nvcc, and waits for each.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "molecules_graph_regression_DGN_ZINC.json"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
F32_TOL, BF16_TOL = 1e-6, 1e-2
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
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
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    events = device_events(torch, prof)
    if not events:
        fail("torch.profiler recorded no device activity")
    return sum(e.device_time for e in events) / 1e3 / iters, call_ms


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


def kernel_phase(torch, np):
    from dgn_tpu_torch.data.synthetic import synthetic_zinc
    from dgn_tpu_torch.graph import (GraphData, mxu_bucket_sizes,
                                     mxu_pair_pad, pack_graphs)
    from dgn_tpu_torch.ops import adjacency

    def packed(graphs):
        graphs = sorted(graphs, key=lambda g: -g.num_nodes)
        n_pad, e_pad, g_pad = mxu_bucket_sizes(graphs, len(graphs))
        return pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                           mxu_layout=True, n_pairs_pad=mxu_pair_pad(
                               graphs, len(graphs), n_pad, e_pad))

    # the main path's batch: 128 ZINC-like graphs, the three families of
    # `mean dir1-dx dir1-av` (one, delta1, abs1) as build_edge_context
    # makes them
    zinc = packed(synthetic_zinc(512, seed=41)[:128])
    dev = torch.device(DEVICE)
    gb = zinc.to(dev)
    mask = gb.edge_mask.float()
    delta = gb.eig[gb.src.long(), 1] - gb.eig[gb.dst.long(), 1]
    w_main = torch.stack([mask, delta * mask, delta.abs() * mask]).contiguous()

    sbm = packed(multiblock_graphs(np, GraphData))
    lay = sbm.mxu
    if not bool(((lay.pair_src != lay.pair_dst) & lay.pair_covered).any()):
        fail("multi-block case packed no off-diagonal pair")
    rng = np.random.default_rng(5)
    w_sbm = torch.from_numpy(
        rng.normal(size=(2, sbm.num_edges_padded)).astype(np.float32)
        * sbm.edge_mask.numpy()).to(dev)

    cases = [("zinc_main_f32", w_main, gb.mxu, torch.float32),
             ("zinc_main_bf16", w_main, gb.mxu, torch.bfloat16),
             ("sbm_multiblock_f32", w_sbm, lay.to(dev), torch.float32)]
    err_main = None
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
        if name == "zinc_main_f32":
            err_main = e_plain

    # timing at the main path's shape, f32 output
    layout = gb.mxu
    k, e_pad = w_main.shape
    p = layout.n_pairs
    ms, call_ms = timed(
        torch, lambda i: adjacency.build_pair_adjacency(w_main, layout))
    plain_ms, plain_call_ms = timed(
        torch, lambda i: adjacency.build_pair_adjacency_plain(w_main, layout))
    # the library call: one accumulating index_put_ into a zeroed tensor.
    # Checked once against the kernel; the timed calls then accumulate into
    # the same tensor, which is the same work.
    out = torch.zeros((p, k, 128, 128), device=dev)
    idx = (layout.chunk_pair.long().repeat_interleave(128).expand(k, e_pad),
           torch.arange(k, device=dev)[:, None].expand(k, e_pad),
           layout.local_src.long().expand(k, e_pad),
           layout.local_dst.long().expand(k, e_pad))
    out.index_put_(idx, w_main, accumulate=True)
    ref = adjacency.build_pair_adjacency(w_main, layout)
    if (out - ref).abs().max().item() > F32_TOL:
        fail("the library call does not compute build_pair_adjacency")
    library_ms, library_call_ms = timed(
        torch, lambda i: out.index_put_(idx, w_main, accumulate=True))
    n_chunks = e_pad // 128
    bytes_moved = (w_main.numel() * 4 + 2 * e_pad * 4 + 2 * n_chunks * 4
                   + p * k * 128 * 128 * 4)
    adds = int((w_main != 0).sum().item())
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / FP32_FLOP_PER_S * 1e3
    print(f"kernel build_pair_adjacency timing: K={k} E={e_pad} C={n_chunks} "
          f"P={p} ({int(layout.pair_covered.sum())} covered), "
          f"{bytes_moved} bytes, {adds} adds; device ms kernel {ms:.5f}, "
          f"plain {plain_ms:.5f}, library {library_ms:.5f}, bound "
          f"{max(bytes_ms, ops_ms):.5f}; per call incl. host: kernel "
          f"{call_ms:.5f}, plain {plain_call_ms:.5f}, library "
          f"{library_call_ms:.5f}")
    return {"name": "build_pair_adjacency", "route": "cuda",
            "source": "dgn_tpu_torch/ops/csrc/adjacency.cu",
            "replaces": "dgn_tpu/ops/pallas/adjacency.py:83",
            "launches": None, "max_abs_err": err_main, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}, zinc


def training_phase(torch, np, kernels, zinc_batch):
    from dgn_tpu_torch import run
    from dgn_tpu_torch.config import load_config
    from dgn_tpu_torch.models import zinc_model
    from dgn_tpu_torch.ops import adjacency
    from dgn_tpu_torch.train.trainer import Trainer

    # ---- the main path, through the user's entry point
    epochs, size = 2, 1024
    argv = ["--config", str(CONFIG), "--epochs", str(epochs),
            "--synthetic_size", str(size), "--device", DEVICE]
    counters = [adjacency.build_pair_adjacency]
    for c in counters:
        c.launches = 0
    t0 = time.time()
    report = run.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"build_pair_adjacency": adjacency.build_pair_adjacency.launches}
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    # one adjacency build per forward pass: every train step, every pass of
    # the shuffled train loader in the final eval, and each cached val/test
    # batch once (the trainer keeps their edge contexts)
    bs = 128
    train_b = math.ceil(size / bs)
    evalb = 2 * math.ceil(max(size // 10, 16) / bs)
    expected = epochs * train_b + train_b + evalb
    print(f"main path: dgn_tpu_torch.run {' '.join(argv)} -> {wall:.1f}s, "
          f"final test mae {report['final']['test']['mae']:.4f}, "
          f"launches {launches} (expected build_pair_adjacency {expected})")
    maes = [report["final"][s]["mae"] for s in ("train", "val", "test")]
    if not all(math.isfinite(m) for m in maes):
        fail(f"non-finite MAE in the final report: {maes}")
    if launches["build_pair_adjacency"] != expected:
        fail("build_pair_adjacency launches do not match one per forward")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # ---- step time at full width
    cfg = load_config(str(CONFIG), {"synthetic_size": size})
    _, model, loss_fn, trainer, loaders = run.prepare(cfg, DEVICE)
    batches = [gb for _ in range(3) for gb in loaders["train"]]
    before = adjacency.build_pair_adjacency.launches
    times = []
    for gb in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = trainer.train_step(gb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if not math.isfinite(float(loss)):
            fail("non-finite training loss")
    if adjacency.build_pair_adjacency.launches - before != len(batches):
        fail("train steps did not launch build_pair_adjacency once each")
    steady = times[3:]
    print(f"train step (hidden 45, L=4, batch 128, synthetic ZINC): median "
          f"{statistics.median(steady):.3f} ms over {len(steady)} steps "
          f"(min {min(steady):.3f}, max {max(steady):.3f}; first "
          f"{times[0]:.1f} ms), n_pad={loaders['train'].n_pad} "
          f"e_pad={loaders['train'].e_pad} pairs={loaders['train'].pair_pad}")

    # ---- where a step's time goes: device activity in a profiled window
    from torch.profiler import ProfilerActivity, profile
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for gb in batches[:n_prof]:
            trainer.train_step(gb)
        torch.cuda.synchronize()
    events = device_events(torch, prof)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / n_prof
    busy = sum(by_name.values())
    print(f"train step device activity: {busy:.3f} ms/step in "
          f"{len(events) / n_prof:.0f} device ops/step, "
          f"{busy / statistics.median(steady):.1%} of the median step "
          f"(the device idles the rest); top by device time:")
    for name, t_ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {t_ms:.4f} ms/step  {name[:100]}")

    # ---- one step from identical weights and batch: CPU vs card
    gen = torch.Generator().manual_seed(41)
    model_cpu, loss_cpu = zinc_model(model.cfg, gen)
    model_gpu = copy.deepcopy(model_cpu)
    t_cpu = Trainer(model_cpu, loss_cpu, cfg.params, device="cpu")
    t_gpu = Trainer(model_gpu, loss_cpu, cfg.params, device=DEVICE)
    l_cpu, s_cpu = t_cpu.train_step(zinc_batch)
    l_gpu, s_gpu = t_gpu.train_step(zinc_batch)
    gm = zinc_batch.graph_mask
    s_cpu, s_gpu = s_cpu[gm], s_gpu.cpu()[gm]
    d_scores = (s_cpu - s_gpu).abs().max().item()
    d_loss = abs(float(l_cpu) - float(l_gpu))
    d_param = max((a.detach() - b.detach().cpu()).abs().max().item()
                  for a, b in zip(model_cpu.parameters(),
                                  model_gpu.parameters()))
    print(f"cpu vs cuda, one step: |loss diff| {d_loss:.3g} "
          f"(loss {float(l_cpu):.6f}), max |score diff| {d_scores:.3g}, "
          f"max |param diff after Adam| {d_param:.3g}")
    if not (torch.allclose(s_gpu, s_cpu, rtol=STEP_RTOL, atol=STEP_ATOL)
            and math.isclose(float(l_gpu), float(l_cpu), rel_tol=STEP_RTOL)):
        fail("the card's step disagrees with the CPU step")


def main() -> None:
    if not (REPO / "dgn_tpu_torch").is_dir() or not CONFIG.is_file():
        fail("run chip_smoke.py from the root of a dgn_tpu checkout")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA GPU")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")

    from dgn_tpu_torch.ops import cuda_build
    t = time.time()
    logs = cuda_build.build(["adjacency"])
    print(f"build: {time.time() - t:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    kern, zinc_batch = kernel_phase(torch, np)
    kernels = [kern]
    training_phase(torch, np, kernels, zinc_batch)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
