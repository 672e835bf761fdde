"""Gaussian heads and render (`splat/`, `ensure_gaussians`): wall time of
`port.gaussians.heads` and the `port.render.*` spans, in ms a frame."""


def read(w):
    if not w.frames or not any(n.startswith("port.render.")
                               for n in w.spans):
        return None
    return w.span_time("port.gaussians.heads", "port.render.") * 1e-6 \
        / w.frames
