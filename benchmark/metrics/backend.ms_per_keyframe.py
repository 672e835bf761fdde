"""Backend (`backend/factor_graph.py`, `ops/pose_graph.py`,
`runtime/inference.py`): wall time of the `port.backend.*` spans, in ms a
keyframe event."""


def read(w):
    if not w.keyframes or "port.backend.solve" not in w.spans:
        return None
    return w.span_time("port.backend.") * 1e-6 / w.keyframes
