"""Device: the share of the traced window in which no kernel, copy or
fill ran on the card."""


def read(w):
    if w.seconds <= 0 or not w.ops:
        return None
    return 1.0 - w.busy() * 1e-9 / w.seconds
