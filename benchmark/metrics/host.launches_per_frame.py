"""Host dispatch: kernels launched on the card, a frame."""


def read(w):
    k = len(w.kernels())
    return k / w.frames if w.frames and k else None
