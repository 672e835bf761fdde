"""Whole step: the network operations of every dispatch in the traced
window (encoder, decoder and heads, counted from the configuration's
shapes by `benchmark/flops.py`) over the window's length times the card's
dense bf16 peak, in %. Float32 heads are counted against the same peak,
so their share reads low, never high."""


def read(w):
    if not w.peak_flops or not w.flops or w.seconds <= 0:
        return None
    return 100.0 * w.flops / (w.seconds * w.peak_flops)
