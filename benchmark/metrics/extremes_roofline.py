"""The segment_extremes kernel pair's (extremes_fwd_kernel,
extremes_bwd_kernel) share of its HBM bytes bound, in %: the bytes its
launches in the traced stretch need (extremes_bytes.real_bytes at each
traced micro-batch's real nodes and edges and the hidden width, times the
launches of each kernel in the stretch, run.launches), over 3.35 TB/s,
over the two kernels' summed device time there.  Nothing where the pair
did not launch."""
from benchmark.extremes_bytes import real_bytes

KERNELS = ("extremes_fwd_kernel", "extremes_bwd_kernel")
COUNTERS = ("segment_extremes_fwd", "segment_extremes_bwd")


def read(run):
    tr = run.trace
    dev = run.peaks["devices"].get(run.device_kind)
    if tr is None or dev is None or not run.traced_sizes:
        return None
    launches = [run.launches.get(c, 0) for c in COUNTERS]
    seconds = sum(t for n, t in tr["kernel_s"].items()
                  if any(k in n for k in KERNELS))
    if not sum(launches) or seconds <= 0:
        return None
    f = run.net["hidden_dim"]
    per = [real_bytes(n, e, f) for n, e, _ in run.traced_sizes]
    nbytes = sum(sum(b[i] for b in per) * launches[i] / len(per)
                 for i in range(2))
    return 100.0 * nbytes / dev["hbm_bytes_per_s"] / seconds
