"""Matching and pose solve (`ops/matching.py`, `tracking/tracker.py`):
wall time of `port.track.match` and `port.track.gn`, in ms a frame."""


def read(w):
    if not w.frames or "port.track.gn" not in w.spans:
        return None
    return w.span_time("port.track.match", "port.track.gn") * 1e-6 / w.frames
