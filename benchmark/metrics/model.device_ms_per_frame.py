"""Tracking step, model (`runtime/fused.py`, `models/`): device time of the
kernels launched under `port.track.encode`, `.decode` and `.heads`, in ms
a frame."""


def read(w):
    if not w.frames or "port.track.encode" not in w.spans \
            or not w.kernels():
        return None
    return w.device_time_under("port.track.encode", "port.track.decode",
                               "port.track.heads") * 1e-6 / w.frames
