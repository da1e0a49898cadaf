"""Share of the untraced window's batches that overflowed the loader's
geometry and were packed again (BatchLoader.n_escapes), in %."""


def read(run):
    steps = run.window["steps"]
    return 100.0 * run.window["escapes"] / steps if steps else None
