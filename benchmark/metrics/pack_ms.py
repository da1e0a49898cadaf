"""Mean host ms of the loader's next() (the block or flat pack, escape
repacks included) per packed batch of the untraced window."""


def read(run):
    pack = run.window["pack_s"]
    return 1e3 * sum(pack) / len(pack) if pack else None
