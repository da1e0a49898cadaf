"""The whole training step's share of the card's peak, in %: the FLOPs the
published layer equations need on every window step's real nodes, edges
and graphs (counts.train_flops), over the untraced window's seconds and the
peak of the dtype the products run in.  Nothing on a card the peak table
does not hold."""


def read(run):
    dev = run.peaks["devices"].get(run.device_kind)
    if dev is None or run.compute_dtype not in dev["flops_per_s"]:
        return None
    w = run.window
    flops = sum(run.counts.train_flops(run.net, run.task, run.meta, n, e, g)
                for n, e, g in zip(w["nodes"], w["edges"],
                                   w["graphs_per_step"]))
    return 100.0 * flops / w["seconds"] / dev["flops_per_s"][run.compute_dtype]
