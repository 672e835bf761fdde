"""Retrieval (`retrieval/`): wall time of `port.retrieval`, in ms a
keyframe event."""


def read(w):
    if not w.keyframes or "port.retrieval" not in w.spans:
        return None
    return w.span_time("port.retrieval") * 1e-6 / w.keyframes
