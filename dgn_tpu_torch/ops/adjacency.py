"""Adjacency-block build: the CUDA kernel's wrapper and its plain version.

`build_pair_adjacency` turns [K, E] per-family edge weights into
[P, K, 128, 128] per-(src_block, dst_block) adjacency blocks, the batch
constants that every layer's `mxu.pair_adj_matmul` multiplies against.  It
replaces the Pallas TPU kernel `dgn_tpu/ops/pallas/adjacency.py:
build_pair_adjacency`; the CUDA source (`csrc/adjacency.cu`) says how.

The wrapper dispatches on the device of the tensor it is given: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes the
plain version.  The weights are batch constants (eig-derived, no
gradient), so the kernel has no backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

TILE = 128
# the output dtypes, in the order of the C interface's out_kind
_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def build_pair_adjacency_plain(weights: torch.Tensor, layout,
                               out_dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """The plain PyTorch version: zeros, then one accumulating index_put_.

    Accumulates in f32 (f64 for f64 weights) and casts once, so a bf16 or
    f16 block entry is its f32 sum rounded once."""
    k, e_pad = weights.shape
    dt = out_dtype if out_dtype is not None else weights.dtype
    acc_dt = torch.float64 if weights.dtype == torch.float64 else torch.float32
    out = torch.zeros((layout.n_pairs, k, TILE, TILE), dtype=acc_dt,
                      device=weights.device)
    pair = layout.chunk_pair.long().repeat_interleave(TILE).expand(k, e_pad)
    fam = torch.arange(k, device=weights.device).unsqueeze(1).expand(k, e_pad)
    ls = layout.local_src.long().expand(k, e_pad)
    ld = layout.local_dst.long().expand(k, e_pad)
    out.index_put_((pair, fam, ls, ld), weights.to(acc_dt), accumulate=True)
    return out.to(dt)


def _check_index(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.device != device or t.dtype != torch.int32 or t.dim() != 1 \
            or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"build_pair_adjacency: layout.{name} must be a "
                         f"contiguous int32 [{n}] tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


@functools.cache
def _kernel():
    """(launch, launch shape, error string) C functions of
    csrc/adjacency.cu, built on first use."""
    from . import cuda_build
    lib = cuda_build.load("adjacency")
    fn = lib.dgn_build_pair_adjacency
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape = lib.dgn_pair_adjacency_launch_shape
    shape.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    shape.restype = None
    errstr = lib.dgn_cuda_error_string
    errstr.argtypes = [ctypes.c_int]
    errstr.restype = ctypes.c_char_p
    return fn, shape, errstr


def launch_shape(n_fam: int, n_pairs: int) -> dict:
    """The kernel's grid, threads and shared bytes per CTA at these sizes,
    as csrc/adjacency.cu launches it (builds the kernel on first use)."""
    out = (ctypes.c_int * 3)()
    _kernel()[1](n_fam, n_pairs, ctypes.addressof(out))
    return {"grid": (out[0],), "threads": out[1], "smem_bytes": out[2]}


def _launch(weights: torch.Tensor, layout, out_dtype) -> torch.Tensor:
    if weights.dtype != torch.float32 or weights.dim() != 2 \
            or not weights.is_contiguous():
        raise ValueError("build_pair_adjacency: weights must be a contiguous "
                         f"float32 [K, E] tensor, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    k, e_pad = weights.shape
    if k == 0 or e_pad == 0 or e_pad % TILE:
        raise ValueError(f"build_pair_adjacency: need K > 0 and E a positive "
                         f"multiple of {TILE}, got {tuple(weights.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"build_pair_adjacency: out_dtype {out_dtype} is not "
                         "float32, bfloat16 or float16")
    n_pairs = layout.n_pairs
    if n_pairs <= 0:
        raise ValueError("build_pair_adjacency: layout has no pairs")
    n_chunks = e_pad // TILE
    dev = weights.device
    _check_index("local_src", layout.local_src, e_pad, dev)
    _check_index("local_dst", layout.local_dst, e_pad, dev)
    _check_index("pair_real_chunk_order", layout.pair_real_chunk_order,
                 n_chunks, dev)
    _check_index("pair_chunk_start", layout.pair_chunk_start, n_pairs + 1,
                 dev)
    for name, t in (("weights", weights), ("local_src", layout.local_src),
                    ("local_dst", layout.local_dst)):
        if t.data_ptr() % 16:
            raise ValueError(f"build_pair_adjacency: {name} must start on a "
                             "16-byte boundary (the kernel loads 16 bytes)")

    fn, _, errstr = _kernel()
    out = torch.empty((n_pairs, k, TILE, TILE), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(weights.data_ptr(), layout.local_src.data_ptr(),
                 layout.local_dst.data_ptr(),
                 layout.pair_real_chunk_order.data_ptr(),
                 layout.pair_chunk_start.data_ptr(), out.data_ptr(),
                 k, e_pad, n_pairs, _OUT_DTYPES.index(out_dtype), stream)
    if err != 0:
        raise RuntimeError("build_pair_adjacency kernel launch failed: "
                           f"{errstr(err).decode()} (cudaError {err})")
    build_pair_adjacency.launches += 1
    return out


def build_pair_adjacency(weights: torch.Tensor, layout,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """[K, E] edge weights -> [P, K, TILE, TILE] adjacency blocks.

    CUDA tensors launch the kernel (f32 weights; f32, bf16 or f16
    output, f32 accumulation) or raise; CPU tensors take build_pair_adjacency_plain.  Pad edges must
    weigh 0: the kernel walks only each pair's chunks that hold a real edge
    (layout.pair_real_chunk_order from layout.pair_chunk_start), which
    gives the plain version's result exactly when an all-pad chunk adds
    nothing.  Each kernel launch adds one to
    `build_pair_adjacency.launches`."""
    if weights.device.type == "cuda":
        dt = out_dtype if out_dtype is not None else weights.dtype
        return _launch(weights, layout, dt)
    if weights.device.type != "cpu":
        raise ValueError(f"build_pair_adjacency: unsupported device "
                         f"{weights.device}")
    return build_pair_adjacency_plain(weights, layout, out_dtype)


build_pair_adjacency.launches = 0
