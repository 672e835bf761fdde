"""The port's noisy closed loop with a real tracking loss and
relocalization (the runs of `tests/test_closed_loop.py:211-272`).

`reloc_pan_trajectory(30, 64, (16, 20))`: 1% depth-proportional pointmap
noise, a lognormal 0.2 confidence noise, an occlusion window at frames
16-19 that trips the tracking gate, and `OracleRetrieval` (true-overlap
ranking) driving the real relocalization (strict gate, pose seed, solve).

Modular (stride 1): the host noise is the JAX package's numpy noise bit
for bit, so both packages give the same modes, keyframe ids and edges, and
keyframe poses within 1e-4 relative to the largest translation.

Fused (stride 2): the step draws its noise from a seeded generator on the
device, a stream JAX's `fold_in` cannot be matched with, so the port is
held alone to the JAX test's checks, over five draws: in every draw RELOC
is entered by the tracking gate after the blackout starts and not before,
at least one relocalization succeeds, the run ends in TRACKING with 4-12
keyframes, and the ATE over the keyframes outside the blackout is below
the budget (0.25 m); the ATE over all keyframes is held for the median
draw and printed for each. The latter depends on the draw in both
packages: a frame inside the blackout relocalizes onto the last keyframe
through the consecutive edge, which the gate never refuses (ROADMAP Queue
3), and keeps the pose of the keyframe it was seeded from, so where that
keyframe lies decides most of the error.
"""

import copy
import pathlib
import statistics
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_port_closed_loop import (  # noqa: E402
    keyframe_ate,
    run_closed_loop,
    tiny_engines,
)

from splatt3r_slam_tpu import config as jcfg  # noqa: E402
from splatt3r_slam_tpu_torch import config as tcfg  # noqa: E402
from splatt3r_slam_tpu_torch.runtime import fused  # noqa: E402
from splatt3r_slam_tpu_torch.runtime import oracle as tor  # noqa: E402
from test_torch_port_bench import one_torch_thread  # noqa: E402,F401

W = 64
BLACKOUT = (16, 20)
N_NOISY = 30
NOISE = dict(noise=0.01, conf_noise=0.2, blackout=BLACKOUT, with_reloc=True)
DRAWS = 5


@pytest.fixture(scope="module")
def engines():
    saved = (copy.deepcopy(jcfg.config), copy.deepcopy(tcfg.config))
    yield tiny_engines()
    jcfg.set_global_config(saved[0])
    tcfg.set_global_config(saved[1])


def _poses():
    return tor.reloc_pan_trajectory(N_NOISY, W, BLACKOUT)


def _reloc_checks(run):
    modes = run["modes"]
    assert "RELOC" in modes, "the blackout never tripped the gate"
    assert all(m != "RELOC" for m in modes[:BLACKOUT[0]])
    assert run["reloc_ok"] >= 1, "no successful relocalization"
    assert modes[-1] == "TRACKING", "never recovered from RELOC"
    assert 4 <= len(run["kf_ids"]) <= 12, run["kf_ids"]


def test_noisy_modular_reloc_matches_jax(engines):
    je, te = engines
    want = run_closed_loop("jax", je, False, _poses(), **NOISE)
    got = run_closed_loop("torch", te, False, _poses(), **NOISE)
    assert got["modes"] == want["modes"]
    assert got["reloc_ok"] == want["reloc_ok"]
    assert got["kf_ids"] == want["kf_ids"]
    assert (got["ii"], got["jj"]) == (want["ii"], want["jj"])
    scale = np.abs(want["T"][:, :3, 3]).max()
    np.testing.assert_allclose(got["T"][:, :3, :3], want["T"][:, :3, :3],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["T"][:, :3, 3], want["T"][:, :3, 3],
                               rtol=0, atol=1e-4 * scale)
    _reloc_checks(got)
    assert keyframe_ate(got) < 0.25
    st = got["system"].backend.stats
    assert st["reloc_ok"] == got["reloc_ok"] <= st["reloc_tried"]


def test_noisy_fused_reloc_meets_the_jax_checks(engines, monkeypatch):
    _, te = engines
    geometry = fused._oracle_geometry
    ates = []
    for draw in range(DRAWS):
        # draw d seeds each frame's device noise as frame id + 10^5·d would
        monkeypatch.setattr(fused, "_oracle_geometry",
                            lambda o, *a, d=draw: geometry(
                                dict(o, fid=o["fid"] + 100_000 * d), *a))
        run = run_closed_loop("torch", te, True, _poses(), **NOISE)
        _reloc_checks(run)
        assert keyframe_ate(run, skip=range(*BLACKOUT)) < 0.25
        ates.append(keyframe_ate(run))
    # different draws, different noise
    assert len(set(ates)) > 1
    assert statistics.median(ates) < 0.25, ates
    print(f"noisy fused ATE over {DRAWS} draws: "
          + ", ".join(f"{a:.4f}" for a in ates))
