#!/usr/bin/env python3
"""build_pair_adjacency against its first CUDA design, in turns.

    git show 72526e5:dgn_tpu_torch/ops/csrc/adjacency.cu > out/adjacency_base.cu
    python3 adjacency_ab.py out/adjacency_base.cu

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit.  The base source has the first design's C interface:
dgn_build_pair_adjacency(weights, local_src, local_dst, pair_chunk_order,
pair_sorted_ids, out, n_fam, n_edges, n_chunks, n_pairs, out_bf16, stream).
It is built with the package's nvcc flags into out/adjacency_ab/.

At chip_smoke.py's four shapes of the kernels line (the ZINC batch and the
CIFAR10 path's first train batch, in f32 and in bf16) both designs are
held against the plain version, then timed in turns with chip_smoke.timed
(device ms from torch.profiler): plain, base, current, current, base,
plain.  Prints one line per timing, the card, and last one JSON object
with every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
BUILD = REPO / "out" / "adjacency_ab"
ORDER = ("plain", "base", "current", "current", "base", "plain")


def base_launcher(torch, src: Path):
    """build_pair_adjacency(w, layout, dtype) through the base source."""
    from dgn_tpu_torch.ops import cuda_build
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libbase.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).dgn_build_pair_adjacency
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(w, lay, dt):
        k, e = w.shape
        out = torch.empty((lay.n_pairs, k, 128, 128), dtype=dt,
                          device=w.device)
        err = fn(w.data_ptr(), lay.local_src.data_ptr(),
                 lay.local_dst.data_ptr(), lay.pair_chunk_order.data_ptr(),
                 lay.pair_sorted_ids.data_ptr(), out.data_ptr(), k, e,
                 e // 128, lay.n_pairs, int(dt == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"base launch failed: cudaError {err}")
        return out
    return run


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("base", type=Path)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("adjacency_ab: torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from dgn_tpu_torch.data.synthetic import synthetic_zinc
    from dgn_tpu_torch.ops import adjacency, cuda_build
    print(f"card: {cs.card_line()}", flush=True)
    cuda_build.build(["adjacency"])
    calls = {"plain": adjacency.build_pair_adjacency_plain,
             "base": base_launcher(torch, args.base),
             "current": adjacency.build_pair_adjacency}

    cs.share_datasets()
    dev = torch.device("cuda")
    zinc = cs.packed(synthetic_zinc(512, seed=41)[:128]).to(dev)
    cifar = cs.first_train_batch("cifar10").to(dev)
    shapes = {"zinc": (cs.family_weights(torch, zinc, ("one", "delta1",
                                                       "abs1")), zinc.mxu),
              "cifar10": (cs.family_weights(torch, cifar, (
                  "one", "delta1", "delta2")), cifar.mxu)}
    results = {}
    for shape, (w, lay) in shapes.items():
        for dt in (torch.float32, torch.bfloat16):
            name = shape + ("-bf16" if dt == torch.bfloat16 else "")
            plain = adjacency.build_pair_adjacency_plain(w, lay, dt).float()
            tol = cs.F32_TOL if dt == torch.float32 else cs.BF16_TOL
            for v in ("base", "current"):
                err = (calls[v](w, lay, dt).float() - plain).abs().max().item()
                print(f"{name} {v}: max|version-plain| {err:.3g}")
                if err > tol:
                    sys.exit(f"adjacency_ab: {v} disagrees at {name}")
            times = []
            for v in ORDER:
                ms, _ = cs.timed(torch, lambda i: calls[v](w, lay, dt))
                times.append([v, ms])
                print(f"{name} {v}: device ms {ms:.5f}", flush=True)
            results[name] = times
    print(f"card: {cs.card_line()}")
    print(json.dumps({"adjacency_ab": results}))


if __name__ == "__main__":
    main()
