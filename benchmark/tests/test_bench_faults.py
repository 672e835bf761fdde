"""Faults planted in the program under the benchmark make `correct` come
out false, each through the number that is there to catch it: a tracking
step that returns its state unchanged, half of a batch left out with the
mean taken over the rest, an answer altered where it is produced (a
tracked pose, the map's gaussians of a keyframe, a rendered frame). (No
cell runs on more than one chip, so none has an exchange to leave out.)
The rest of the run is the benchmark's own, on the CPU with the tiny
model."""

import pytest
import torch

from benchmark import run

SMALL = (192, 256)


def _unchanged(session):
    step = session.sys.tracker.step

    def stale(img, kf, T_init, idx_init, K=None, oracle=None):
        out, flags = step(img, kf, T_init, idx_init, K, oracle)
        out = dict(out, T_WCf=T_init, kf=kf)
        return out, flags

    session.sys.tracker.step = stale


def _half_batch(model):
    encode = model.encode

    def half(img):
        feat, pos = encode(img)
        n = feat.shape[1] // 2
        feat = torch.cat([feat[:, :n], feat[:, :n].mean(1, keepdim=True)
                          .expand(-1, feat.shape[1] - n, -1)], 1)
        return feat, pos

    model.encode = half


def _altered(session):
    step = session.sys.tracker.step

    def moved(img, kf, T_init, idx_init, K=None, oracle=None):
        out, flags = step(img, kf, T_init, idx_init, K, oracle)
        T = out["T_WCf"].clone()
        T[0] += 0.05
        return dict(out, T_WCf=T), flags

    session.sys.tracker.step = moved


def _chunk_moved(session):
    acc = session.sys.gaussian_module
    to_world = acc.gaussians_to_world

    def moved(frame):
        out = to_world(frame)
        return None if out is None else (out[0] + 0.01,) + tuple(out[1:])

    acc.gaussians_to_world = moved


def _render_shifted(monkeypatch):
    from splatt3r_slam_tpu_torch.splat import decoder

    render = decoder.render_frame

    def shifted(frame, ref_frame, **kw):
        img = render(frame, ref_frame, **kw)
        return None if img is None else img.roll(8, dims=1)

    monkeypatch.setattr(decoder, "render_frame", shifted)


FAULTS = {"state_unchanged": ({"session": _unchanged}, "track"),
          "half_batch": ({"model": _half_batch}, "trunk"),
          "answer_altered": ({"session": _altered}, "track"),
          "gaussians_altered": ({"session": _chunk_moved}, "accum"),
          "render_altered": (_render_shifted, "render")}
CASES = [(c, f) for c in ("live-track-40", "eval-exact-40")
         for f in sorted(FAULTS)
         if not (f == "render_altered" and c == "eval-exact-40")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch):
    plant, number = FAULTS[fault]
    if callable(plant):  # patched in the program's module for this test
        plant(monkeypatch)
        plant = None
    out = run.execute(run.load_cell(cell), 31337, 4.0, False, device="cpu",
                      small=SMALL, fault=plant)
    value, limit = out["checks"][number]
    assert out["result"]["correct"] is False
    assert value > limit, (number, value, limit)


def test_without_a_fault_the_numbers_hold():
    """The same run with nothing planted: the numbers the faults break
    hold (the tiny fp32 model reads far inside the full-size limits)."""
    out = run.execute(run.load_cell("live-track-40"), 31337, 4.0, False,
                      device="cpu", small=SMALL)
    for number in ("trunk", "track", "fusion", "match", "heads", "render",
                   "accum"):
        value, limit = out["checks"][number]
        assert value <= limit, (number, value, limit)
