"""Mean host ms of the program's `loader.pack` span (data/loader.py: one
batch, from the loader's next() to its yield, escape repacks included)
per packed batch of the traced stretch: the inside counterpart of
pack_ms.  Nothing where the program recorded no span (benchmark/spans.py)."""
from benchmark import spans


def read(run):
    s = spans.recorded(run)
    if s is None or "loader.pack" not in s["spans"]:
        return None
    pack = s["spans"]["loader.pack"]
    return pack["ms"] / pack["count"]
