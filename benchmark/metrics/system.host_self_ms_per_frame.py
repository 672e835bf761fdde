"""State machine (`runtime/system.py`): host time a frame inside the
benchmark's span around `process_frame` that no span of the program
covers (its own spans are the layers below), in ms."""

from benchmark.tracing import length, union


def read(w):
    outer = union(w.spans.get("bench.process_frame", ()))
    if not outer or not w.frames:
        return None
    inner = union(iv for n, ivs in w.spans.items() if n.startswith("port.")
                  for iv in ivs)
    covered, k = 0, 0
    for a, b in outer:
        while k < len(inner) and inner[k][1] <= a:
            k += 1
        i = k
        while i < len(inner) and inner[i][0] < b:
            covered += max(0, min(b, inner[i][1]) - max(a, inner[i][0]))
            i += 1
    return (length(outer) - covered) * 1e-6 / w.frames
