"""The adjacency kernel's (pair_adjacency_kernel) share of its HBM bytes
bound, in %: the bytes its launches in the traced window need
(counts.adjacency_bytes per launch, one launch per step's batch), over
3.35 TB/s, over the kernel's summed device time there.  Nothing where it
did not launch."""

KERNEL = "pair_adjacency_kernel"


def read(run):
    tr = run.trace
    dev = run.peaks["devices"].get(run.device_kind)
    if tr is None or dev is None or not run.traced_blocks \
            or not tr["launches"]:
        return None
    seconds = sum(t for n, t in tr["kernel_s"].items() if KERNEL in n)
    if seconds <= 0:
        return None
    k = len(run.counts.families(run.net["aggregators"].split()))
    per_step = [run.counts.adjacency_bytes(e, c, k)
                for e, c in run.traced_blocks]
    nbytes = sum(per_step) * tr["launches"] / len(per_step)
    return 100.0 * nbytes / dev["hbm_bytes_per_s"] / seconds
