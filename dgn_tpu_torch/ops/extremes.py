"""Per-destination max and min of edge values: the CUDA kernel pair's
wrappers and their plain version.

`segment_extremes(ge, layout, edge_mask, num_nodes)` returns (mx, mn), each
[num_nodes, F]: the max and the min of ge [E, F] over the real edges of each
destination node, 0 for a node with no real edge.  Its gradient splits
equally among tied edges (XLA's and torch's scatter-max semantics, which
parity rests on: ReLU and embedding lookups make exact ties common).  It
replaces `dgn_tpu/ops/extremes.py:mxu_segment_extremes`, a custom-VJP XLA
lowering for the TPU; `csrc/extremes.cu` says how the kernels work.

The wrapper dispatches on the device of `ge`: a CUDA tensor runs the
hand-written forward and backward kernels through `_SegmentExtremes` (or
raises), a CPU tensor takes `segment_extremes_plain`.  Each kernel launch
adds one to `segment_extremes_fwd.launches` or `segment_extremes_bwd.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

TILE = 128


def _global_dst(layout) -> torch.Tensor:
    return (layout.edge_chunk_dst.long().repeat_interleave(TILE) * TILE
            + layout.local_dst.long())


def segment_extremes_plain(ge: torch.Tensor, layout, edge_mask: torch.Tensor,
                           num_nodes: int):
    """The plain PyTorch version: scatter_reduce amax / amin over the real
    edges, then 0 for nodes without one.

    The rows start at -inf / +inf, not at 0: torch's scatter_reduce
    gradient counts an untouched `self` entry that equals the result among
    the ties even with include_self=False, so a zero start would split a
    tie at exactly 0 among one edge too many."""
    f = ge.shape[1]
    real = edge_mask.nonzero().squeeze(1)
    dst = _global_dst(layout).index_select(0, real)
    vals = ge.index_select(0, real)
    idx = dst[:, None].expand(-1, f)
    mx = ge.new_full((num_nodes, f), float("-inf")).scatter_reduce(
        0, idx, vals, "amax", include_self=False)
    mn = ge.new_full((num_nodes, f), float("inf")).scatter_reduce(
        0, idx, vals, "amin", include_self=False)
    has = torch.zeros(num_nodes, dtype=torch.bool, device=ge.device)
    has[dst] = True
    has = has[:, None]
    return torch.where(has, mx, 0.0), torch.where(has, mn, 0.0)


@functools.cache
def _kernels():
    """(forward, backward, error string, launch shape) C functions of
    csrc/extremes.cu, built on first use."""
    from . import cuda_build
    lib = cuda_build.load("extremes")
    fwd = lib.dgn_segment_extremes_fwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.dgn_segment_extremes_bwd
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    errstr = lib.dgn_cuda_error_string
    errstr.argtypes = [ctypes.c_int]
    errstr.restype = ctypes.c_char_p
    shape = lib.dgn_segment_extremes_launch_shape
    shape.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    shape.restype = None
    return fwd, bwd, errstr, shape


def launch_shape(n_feat: int, n_chunks: int, n_blocks: int) -> dict:
    """The kernels' grids and dynamic shared bytes per block at these sizes,
    as csrc/extremes.cu launches them (builds the kernels on first use)."""
    out = (ctypes.c_int * 6)()
    _kernels()[3](n_feat, n_chunks, n_blocks, ctypes.addressof(out))
    return {"fwd": {"grid": (out[0], out[1]), "smem_bytes": out[2]},
            "bwd": {"grid": (out[3], out[4]), "smem_bytes": out[5]}}


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"segment_extremes: {name} must be a contiguous "
                         f"{dtype} {list(shape)} tensor on {device}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")


def _check_inputs(ge, layout, edge_mask, num_nodes):
    """(E, F, chunks, node blocks) after checking what the kernels take."""
    if ge.dtype != torch.float32 or ge.dim() != 2 or not ge.is_contiguous():
        raise ValueError("segment_extremes: ge must be a contiguous float32 "
                         f"[E, F] tensor, got {ge.dtype} {list(ge.shape)}")
    e_pad, f = ge.shape
    if e_pad == 0 or e_pad % TILE or f == 0:
        raise ValueError(f"segment_extremes: need E a positive multiple of "
                         f"{TILE} and F > 0, got {list(ge.shape)}")
    n_chunks = e_pad // TILE
    nb = layout.n_node_blocks
    if not 0 < num_nodes <= nb * TILE:
        raise ValueError(f"segment_extremes: num_nodes {num_nodes} outside "
                         f"(0, {nb * TILE}] for {nb} node blocks")
    dev = ge.device
    _check("layout.local_dst", layout.local_dst, torch.int32, (e_pad,), dev)
    _check("layout.edge_chunk_dst", layout.edge_chunk_dst, torch.int32,
           (n_chunks,), dev)
    _check("edge_mask", edge_mask, torch.bool, (e_pad,), dev)
    return e_pad, f, n_chunks, nb


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{_kernels()[2](err).decode()} (cudaError {err})")


def segment_extremes_fwd(ge: torch.Tensor, layout, edge_mask: torch.Tensor,
                         num_nodes: int):
    """Launch the forward kernel on CUDA tensors: (mx, mn) [num_nodes, F]."""
    _, f, n_chunks, nb = _check_inputs(ge, layout, edge_mask, num_nodes)
    fwd = _kernels()[0]
    mx = torch.empty((num_nodes, f), dtype=ge.dtype, device=ge.device)
    mn = torch.empty_like(mx)
    with torch.cuda.device(ge.device):
        stream = torch.cuda.current_stream(ge.device).cuda_stream
        err = fwd(ge.data_ptr(), layout.local_dst.data_ptr(),
                  layout.edge_chunk_dst.data_ptr(), edge_mask.data_ptr(),
                  mx.data_ptr(), mn.data_ptr(), f, n_chunks, nb, num_nodes,
                  stream)
    _raise_if(err, "segment_extremes_fwd")
    segment_extremes_fwd.launches += 1
    return mx, mn


def segment_extremes_bwd(ge: torch.Tensor, mx: torch.Tensor,
                         mn: torch.Tensor, dmx: torch.Tensor,
                         dmn: torch.Tensor, layout,
                         edge_mask: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: d_ge [E, F]."""
    num_nodes = mx.shape[0]
    _, f, n_chunks, nb = _check_inputs(ge, layout, edge_mask, num_nodes)
    for name, t in (("mx", mx), ("mn", mn), ("dmx", dmx), ("dmn", dmn)):
        _check(name, t, torch.float32, (num_nodes, f), ge.device)
    bwd = _kernels()[1]
    d_ge = torch.empty_like(ge)
    with torch.cuda.device(ge.device):
        stream = torch.cuda.current_stream(ge.device).cuda_stream
        err = bwd(ge.data_ptr(), mx.data_ptr(), mn.data_ptr(),
                  dmx.data_ptr(), dmn.data_ptr(),
                  layout.local_dst.data_ptr(),
                  layout.edge_chunk_dst.data_ptr(), edge_mask.data_ptr(),
                  d_ge.data_ptr(), f, n_chunks, nb, num_nodes, stream)
    _raise_if(err, "segment_extremes_bwd")
    segment_extremes_bwd.launches += 1
    return d_ge


segment_extremes_fwd.launches = 0
segment_extremes_bwd.launches = 0


class _SegmentExtremes(torch.autograd.Function):
    """The kernel pair as one differentiable op: ge has a gradient, the
    layout and the mask do not."""

    @staticmethod
    def forward(ctx, ge, layout, edge_mask, num_nodes):
        mx, mn = segment_extremes_fwd(ge, layout, edge_mask, num_nodes)
        ctx.save_for_backward(ge, mx, mn, edge_mask)
        ctx.layout = layout
        return mx, mn

    @staticmethod
    def backward(ctx, dmx, dmn):
        ge, mx, mn, edge_mask = ctx.saved_tensors
        d_ge = segment_extremes_bwd(ge, mx, mn, dmx.contiguous(),
                                    dmn.contiguous(), ctx.layout, edge_mask)
        return d_ge, None, None, None


def segment_extremes(ge: torch.Tensor, layout, edge_mask: torch.Tensor,
                     num_nodes: int):
    """(max, min) of ge [E, F] per destination over real edges, each
    [num_nodes, F], 0 where a node has no real edge; ties split the
    gradient equally.

    CUDA tensors run the kernel pair (f32 only) or raise; CPU tensors take
    segment_extremes_plain."""
    if ge.device.type == "cuda":
        return _SegmentExtremes.apply(ge.contiguous(), layout, edge_mask,
                                      num_nodes)
    if ge.device.type != "cpu":
        raise ValueError(f"segment_extremes: unsupported device {ge.device}")
    return segment_extremes_plain(ge, layout, edge_mask, num_nodes)
