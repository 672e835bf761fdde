"""The port's closed loop on the plane-scene oracle against the JAX
package's (`tests/test_closed_loop.py`, same trajectory and settings).

`PlaneSceneOracle(inner=engine)` wraps the tiny fp32 two-view model at
48x64, one set of weights in both packages: every network dispatch runs
and its outputs are replaced by exact plane geometry, so `SLAMSystem` runs
closed loop (INIT → TRACKING, data-driven keyframes, the backend's
neighbour edges and solves on each keyframe) under config/base.yaml.
Noise-free, on the fused frontend at base.yaml's match stride 2 and on the
modular tracker at stride 1, both packages give the same mode sequence,
the same keyframe frame ids and the same backend edges (ii, jj); keyframe
poses agree within 1e-4 relative to the largest translation (the
translations are ~1). The JAX package's budgets hold for the port: ATE
below 0.08 m (modular) and 0.16 m (fused), 3-6 keyframes. The noisy
relocalization runs are in tests/test_torch_port_closed_loop_reloc.py.
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu import config as jcfg
from splatt3r_slam_tpu.backend import FactorGraph as JFactorGraph
from splatt3r_slam_tpu.lie import sim3 as jsim3
from splatt3r_slam_tpu.models import Splatt3RModel as JModel
from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.models.checkpoint import convert_state_dict
from splatt3r_slam_tpu.runtime import oracle as jor
from splatt3r_slam_tpu.runtime.frame import create_frame as j_create_frame
from splatt3r_slam_tpu.runtime.inference import InferenceEngine as JEngine
from splatt3r_slam_tpu.runtime.system import SLAMSystem as JSystem
from splatt3r_slam_tpu_torch import config as tcfg
from splatt3r_slam_tpu_torch.backend import FactorGraph
from splatt3r_slam_tpu_torch.lie import sim3
from splatt3r_slam_tpu_torch.models import (
    Splatt3RModel,
    TwoViewConfig,
    init_model,
)
from splatt3r_slam_tpu_torch.models.checkpoint import (
    load_state_dict,
    params_from_jax,
)
from splatt3r_slam_tpu_torch.runtime import oracle as tor
from splatt3r_slam_tpu_torch.runtime.evaluate import umeyama_alignment
from splatt3r_slam_tpu_torch.runtime.frame import Mode, create_frame
from splatt3r_slam_tpu_torch.runtime.fused import FusedTracker
from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 48, 64
N_FRAMES = 18


def tiny_engines():
    """Both packages' engines on one set of weights (a seeded torch state
    dict through the JAX package's converter and back, as
    tests/test_torch_port_backend.py makes them)."""
    cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    jcfg_m = JConfig(dtype="float32", head_dtype="float32").tiny()
    seed_model = init_model(cfg, seed=0, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in seed_model.state_dict().items()}, jcfg_m))
    tm = Splatt3RModel(cfg)
    assert load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg)) == []
    return JEngine(JModel(jcfg_m), jp, H, W), InferenceEngine(tm, H, W)


def run_closed_loop(pkg, engine, fused, poses, noise=0.0, conf_noise=0.0,
                    blackout=None, with_reloc=False):
    """Drive one package's SLAMSystem over `poses` with the oracle around
    `engine`, as tests/test_closed_loop.py does → dict of the run's modes,
    keyframe ids, edges, keyframe poses (4x4), ground truth, successful
    relocalizations and the system."""
    torch_side = pkg == "torch"
    cfgmod = tcfg if torch_side else jcfg
    cfgmod.load_config(str(ROOT / "config" / "base.yaml"))
    stride = int(cfgmod.config["matching"]["match_stride"]) if fused else 1
    if not fused:  # the modular tracker takes full-resolution indices
        cfgmod.config["matching"]["match_stride"] = 1
    mod = tor if torch_side else jor
    extra = dict(device="cpu") if torch_side else {}
    oracle = mod.PlaneSceneOracle(H, W, float(W), plane_n=(0.12, 0.08, 1.0),
                                  plane_d=2.0, inner=engine, stride=stride,
                                  noise=noise, conf_noise=conf_noise,
                                  blackout=blackout, **extra)
    if torch_side:
        sysm = SLAMSystem(oracle, H, W, fused=fused, max_gaussians=1024)
        graph = FactorGraph
    else:
        sysm = JSystem(oracle, H, W, fused=fused)
        graph = JFactorGraph
    retrieval = mod.OracleRetrieval(oracle) if with_reloc else None
    sysm.backend = graph(oracle, sysm.keyframes, retrieval=retrieval)
    tex = np.random.default_rng(0).random((H, W, 3)).astype(np.float32)
    modes, reloc_ok = [], 0
    for i, T in enumerate(poses):
        oracle.register(i, T)
        pre = sysm.mode
        if torch_side:
            frame = create_frame(i, tex.copy(), img_size=W, device="cpu")
        else:
            frame = j_create_frame(i, tex.copy(), img_size=W)
        _, flag = sysm.process_frame(frame)
        reloc_ok += int(pre.name == "RELOC" and bool(flag))
        modes.append(sysm.mode.name)
    kfs = [sysm.keyframes[k] for k in range(len(sysm.keyframes))]
    if torch_side:
        Ts = [sim3.matrix(kf.T_WC).numpy() for kf in kfs]
    else:
        Ts = [np.asarray(jsim3.matrix(kf.T_WC)) for kf in kfs]
    return dict(modes=modes, kf_ids=[kf.frame_id for kf in kfs],
                ii=[int(i) for i in sysm.backend.ii],
                jj=[int(j) for j in sysm.backend.jj], T=np.stack(Ts),
                gt=np.stack([oracle.gt[kf.frame_id] for kf in kfs]),
                reloc_ok=reloc_ok, system=sysm, oracle=oracle)


def keyframe_ate(run, skip=()) -> float:
    """Sim(3)-aligned RMSE of the keyframe positions against the ground
    truth, over the keyframes whose frame id is not in `skip`."""
    keep = [k for k, f in enumerate(run["kf_ids"]) if f not in skip]
    est, gt = run["T"][keep, :3, 3], run["gt"][keep, :3, 3]
    s, R, t = umeyama_alignment(est, gt)
    err = (s * (R @ est.T)).T + t - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


@pytest.fixture(scope="module")
def engines():
    saved = (copy.deepcopy(jcfg.config), copy.deepcopy(tcfg.config))
    yield tiny_engines()
    jcfg.set_global_config(saved[0])
    tcfg.set_global_config(saved[1])


@pytest.fixture(scope="module", params=["fused", "modular"])
def runs(request, engines):
    je, te = engines
    fused = request.param == "fused"
    poses = tor.pan_trajectory(N_FRAMES, W)
    return (request.param, run_closed_loop("jax", je, fused, poses),
            run_closed_loop("torch", te, fused, poses))


def test_closed_loop_decisions_match_jax(runs):
    _, want, got = runs
    assert got["modes"] == want["modes"]
    assert got["kf_ids"] == want["kf_ids"]
    assert (got["ii"], got["jj"]) == (want["ii"], want["jj"])
    assert len(got["ii"]) >= 2, "backend never optimised"


def test_closed_loop_keyframe_poses_match_jax(runs):
    _, want, got = runs
    scale = np.abs(want["T"][:, :3, 3]).max()
    np.testing.assert_allclose(got["T"][:, :3, :3], want["T"][:, :3, :3],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["T"][:, :3, 3], want["T"][:, :3, 3],
                               rtol=0, atol=1e-4 * scale)


def test_closed_loop_meets_the_jax_budgets(runs):
    kind, _, got = runs
    sysm = got["system"]
    assert all(m != "RELOC" for m in got["modes"])
    assert 3 <= len(got["kf_ids"]) <= 6, got["kf_ids"]
    assert keyframe_ate(got) < (0.16 if kind == "fused" else 0.08)
    assert isinstance(sysm.tracker, FusedTracker) == (kind == "fused")
    assert sysm.tracker.fails == 0
    assert sysm.mode == Mode.TRACKING
    # the wrapper pays the network: real encoder features beyond [0, 0, 0]
    feat = sysm.keyframes.last_keyframe().feat
    assert feat.numel() > 1 and float(feat[0, 1:].abs().max()) > 0
    # the backend ran solves of more than one GN iteration on real rows
    st = sysm.backend.stats
    assert st["solves"] == len(got["kf_ids"])
    assert st["iters"] > st["solves"] - 1
