"""The port's backend and modular tracker against the JAX package.

`ops/pose_graph.py`, `backend/factor_graph.py`, the edge matching of
`runtime/inference.py`, `runtime/tracker.py` and the threaded backend of
`runtime/system.py`, on the CPU. The network is the tiny fp32 model at
48x64 with one set of weights in both packages (`tiny_engines`).

Tolerances, stated per check: pose-graph solves on synthetic keyframes
within 2e-5 with one pose pinned and 1e-3 with two (fp32 on both sides,
sums in another order, and a poorly conditioned system); edge indices
equal on at least 99% of rows and gating fractions within 2% absolute
(a match index can move where the decoder's fp32 noise moves a score
across a tie); solved poses within 1e-4 relative + 1e-4 absolute (the
random model's translations reach ~200); tracked poses within 2e-4
(tests/test_fused.py's bar).
"""

import copy
import pathlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu import config as jcfg
from splatt3r_slam_tpu.backend import factor_graph as jfg
from splatt3r_slam_tpu.lie import sim3 as jsim3
from splatt3r_slam_tpu.models import Splatt3RModel as JModel
from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.models.checkpoint import convert_state_dict
from splatt3r_slam_tpu.ops import pose_graph as jpg
from splatt3r_slam_tpu.retrieval import RetrievalDatabase as JRetrieval
from splatt3r_slam_tpu.runtime.frame import KeyframeBuffer as JKeyframes
from splatt3r_slam_tpu.runtime.frame import create_frame as j_create_frame
from splatt3r_slam_tpu.runtime.inference import InferenceEngine as JEngine
from splatt3r_slam_tpu.runtime.system import SLAMSystem as JSystem
from splatt3r_slam_tpu.runtime.tracker import FrameTracker as JTracker
from splatt3r_slam_tpu_torch import config as tcfg
from splatt3r_slam_tpu_torch.backend import factor_graph as tfg
from splatt3r_slam_tpu_torch.models import (
    Splatt3RModel,
    TwoViewConfig,
    init_model,
)
from splatt3r_slam_tpu_torch.models.checkpoint import (
    load_state_dict,
    params_from_jax,
)
from splatt3r_slam_tpu_torch.ops import pose_graph as tpg
from splatt3r_slam_tpu_torch.retrieval import RetrievalDatabase
from splatt3r_slam_tpu_torch.runtime.frame import KeyframeBuffer
from splatt3r_slam_tpu_torch.runtime.frame import create_frame
from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
from splatt3r_slam_tpu_torch.runtime.tracker import FrameTracker

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ = ROOT / "tests" / "fixtures" / "tum" / "rgbd_dataset_freiburg1_fixture"
H, W = 48, 64


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# pose graph on synthetic keyframes (the setup of tests/test_pose_graph.py)
# ---------------------------------------------------------------------------

def _graph(seed=0, m=4, n=300, perturb=0.1):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n, 3)).astype(np.float32)
    P[:, 2] += 4.0
    T_gt = [jsim3.identity()]
    for _ in range(1, m):
        xi = np.concatenate([rng.normal(size=3) * 0.3,
                             rng.normal(size=3) * 0.2,
                             rng.normal(size=1) * 0.1]).astype(np.float32)
        T_gt.append(jsim3.exp(jnp.asarray(xi)))
    T_gt = jnp.stack(T_gt)
    Xs = jnp.stack([jsim3.act(jsim3.inverse(T_gt[k]), jnp.asarray(P))
                    for k in range(m)])
    Cs = np.ones((m, n, 1), np.float32) * 5.0
    ii = np.array(list(range(m - 1)) + [0])
    jj = np.array(list(range(1, m)) + [m - 1])
    E = len(ii)
    # shuffled matches with a few invalid rows and varied confidence
    idx = np.broadcast_to(np.arange(n), (E, n)).copy()
    valid = rng.random((E, n)) > 0.1
    Q = (1.0 + 5.0 * rng.random((E, n))).astype(np.float32)
    T0 = [np.asarray(T_gt[0])]
    for k in range(1, m):
        xi = (rng.normal(size=7) * perturb).astype(np.float32)
        T0.append(np.asarray(jsim3.retr(T_gt[k], jnp.asarray(xi))))
    return (np.asarray(T_gt), np.stack(T0), np.asarray(Xs), Cs, ii, jj, idx,
            valid, Q)


def _pad(ii, jj, idx, valid, Q, extra=3):
    """The JAX side's inert padding: edges switched off by edge_on."""
    E = len(ii)
    on = np.concatenate([np.ones(E), np.zeros(extra)]).astype(np.float32)
    return (np.concatenate([ii, np.zeros(extra, int)]),
            np.concatenate([jj, np.ones(extra, int)]),
            np.concatenate([idx, idx[:extra] * 0]),
            np.concatenate([valid, np.ones_like(valid[:extra])]),
            np.concatenate([Q, Q[:extra] * 100]), on)


@pytest.mark.parametrize("kind", ["rays", "calib", "points"])
def test_pose_graph_matches_jax(kind, monkeypatch):
    T_gt, T0, Xs, Cs, ii, jj, idx, valid, Q = _graph(
        perturb=0.05 if kind == "calib" else 0.1)
    pii, pjj, pidx, pvalid, pQ, on = _pad(ii, jj, idx, valid, Q)
    K = np.array([[140.0, 0, 80], [0, 140, 60], [0, 0, 1]], np.float32)
    monkeypatch.setattr(tpg, "_CHUNK", 3)  # 4 edges: a full and a part chunk
    stats = {}
    for pin in (1, 2):
        if kind == "calib":
            want = jpg.gauss_newton_calib(
                T0, Xs, Cs, jnp.asarray(K), pii, pjj, pidx, pvalid, pQ, on,
                (120, 160), num_fix=pin, max_iter=6)
            got = tpg.gauss_newton_calib(
                _t(T0), _t(Xs), _t(Cs), _t(K), _t(ii), _t(jj), _t(idx),
                _t(valid), _t(Q), (120, 160), num_fix=pin, max_iter=6,
                stats=stats)
        else:
            want = getattr(jpg, f"gauss_newton_{kind}")(
                T0, Xs, Cs, pii, pjj, pidx, pvalid, pQ, on, num_fix=pin,
                max_iter=6)
            got = getattr(tpg, f"gauss_newton_{kind}")(
                _t(T0), _t(Xs), _t(Cs), _t(ii), _t(jj), _t(idx), _t(valid),
                _t(Q), num_fix=pin, max_iter=6, stats=stats)
        # with two poses pinned the rays system of this graph is poorly
        # conditioned (the preconditioned matrix's condition number is
        # ~1e4-2e5): fp32 noise of ~1e-7 in H, which both sides carry
        # against fp64 alike, moves the 6-iteration poses by up to 3.3e-4
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5 if pin == 1 else 1e-3)
        # pinned poses keep their values exactly
        np.testing.assert_array_equal(got[:pin].numpy(), T0[:pin])
        if pin == 1 and kind != "calib":  # and the others find the truth
            np.testing.assert_allclose(got.numpy(), T_gt, atol=5e-3)
    assert stats["chol_fail"] == 0 and stats["iters"] == 12


def test_pose_graph_stride_and_early_stop():
    """pix_stride and the ‖dx‖ stop: a loose delta_thresh ends both loops
    at the same iteration."""
    T_gt, T0, Xs, Cs, ii, jj, idx, valid, Q = _graph(seed=1)
    pii, pjj, pidx, pvalid, pQ, on = _pad(ii, jj, idx, valid, Q)
    want = jpg.gauss_newton_rays(T0, Xs, Cs, pii, pjj, pidx, pvalid, pQ, on,
                                 max_iter=10, delta_thresh=1e-3,
                                 pix_stride=3)
    stats = {}
    got = tpg.gauss_newton_rays(_t(T0), _t(Xs), _t(Cs), _t(ii), _t(jj),
                                _t(idx), _t(valid), _t(Q), max_iter=10,
                                delta_thresh=1e-3, pix_stride=3, stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert 1 < stats["iters"] < 10


def test_non_spd_system_gives_zero_step():
    """A system whose Cholesky fails: the JAX package's NaN factor and the
    port's cholesky_ex status both give dx = 0, so the poses stay put."""
    _, T0, *_ = _graph(seed=2)
    ii, jj = np.array([0, 1, 2]), np.array([1, 2, 3])
    H_e = -np.tile(np.eye(14, dtype=np.float32), (3, 1, 1))
    g_e = np.ones((3, 14), np.float32)
    want = jpg._gn_iterations(lambda T: (jnp.asarray(H_e), jnp.asarray(g_e)),
                              jnp.asarray(T0), jnp.asarray(ii),
                              jnp.asarray(jj), jnp.ones(3), 1, 5, 1e-8)
    stats = {}
    got = tpg._gn_iterations(lambda T: (_t(H_e), _t(g_e)), _t(T0), _t(ii),
                             _t(jj), 1, 5, 1e-8, stats)
    np.testing.assert_array_equal(np.asarray(want), T0)
    np.testing.assert_array_equal(got.numpy(), T0)
    assert stats == {"iters": 1, "chol_fail": 1}
    x, info = tpg._solve_spd(*tpg._assemble_dense(
        _t(H_e), _t(g_e), _t(ii), _t(jj), 4, 1))
    assert int(info) != 0


def test_assemble_dense_matches_jax():
    rng = np.random.default_rng(3)
    E, m = 5, 4
    H_e = rng.normal(size=(E, 14, 14)).astype(np.float32)
    g_e = rng.normal(size=(E, 14)).astype(np.float32)
    ii, jj = np.array([0, 1, 2, 0, 3]), np.array([1, 2, 3, 3, 1])
    # the JAX side also gets an inert padded edge
    pii, pjj = np.append(ii, 0), np.append(jj, 1)
    pH, pg = np.concatenate([H_e, H_e[:1]]), np.concatenate([g_e, g_e[:1]])
    on = np.array([1, 1, 1, 1, 1, 0], np.float32)
    for num_fix in (1, 2):
        Hj, gj = jpg._assemble_dense(pH, pg, pii, pjj, on, m, num_fix)
        Ht, gt = tpg._assemble_dense(_t(H_e), _t(g_e), _t(ii), _t(jj), m,
                                     num_fix)
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-5)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)


# ---------------------------------------------------------------------------
# factor graph, retrieval edges and relocalization on tiny-model keyframes
# ---------------------------------------------------------------------------

def tiny_engines():
    """Both packages' engines on one set of weights: a seeded torch state
    dict, converted by the JAX package's checkpoint converter, then carried
    back into the port's model by `params_from_jax` (much faster than
    flax's init of the JAX model on this CPU)."""
    cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    jcfg_m = JConfig(dtype="float32", head_dtype="float32").tiny()
    seed_model = init_model(cfg, seed=0, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in seed_model.state_dict().items()}, jcfg_m))
    tm = Splatt3RModel(cfg)
    assert load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg)) == []
    return JEngine(JModel(jcfg_m), jp, H, W), InferenceEngine(tm, H, W)


@pytest.fixture(scope="module")
def engines():
    saved = (copy.deepcopy(jcfg.config), copy.deepcopy(tcfg.config))
    yield tiny_engines()
    jcfg.set_global_config(saved[0])
    tcfg.set_global_config(saved[1])


def _configs(**overrides):
    jcfg.load_config(str(ROOT / "config" / "base.yaml"))
    tcfg.reset_config()
    for c in (jcfg.config, tcfg.config):
        c["matching"]["max_iter"] = 2
        c["tracking"]["max_iters"] = 4
        c["local_opt"]["max_iters"] = 3
        c["retrieval"]["min_thresh"] = 0.0
        for key, value in overrides.items():
            section, name = key.split("__")
            c[section][name] = value


def _image(i):
    return cv2.cvtColor(cv2.imread(str(SEQ / "rgb" / sorted(
        p.name for p in (SEQ / "rgb").glob("*.png"))[i])), cv2.COLOR_BGR2RGB)


def _mono_frames(je, te, ids, seed):
    """The same frames in both packages, each through inference_mono, with
    seeded poses near identity."""
    rng = np.random.default_rng(seed)
    out = []
    for k, i in enumerate(ids):
        jf = j_create_frame(i, _image(i), img_size=W)
        tf = create_frame(i, _image(i), img_size=W, device="cpu")
        jf.update_pointmap(*je.inference_mono(jf))
        tf.update_pointmap(*te.inference_mono(tf))
        xi = np.zeros(7, np.float32) if k == 0 else (
            rng.normal(size=7) * 0.05).astype(np.float32)
        T = np.asarray(jsim3.exp(jnp.asarray(xi)))
        jf.T_WC, tf.T_WC = jnp.asarray(T), _t(T)
        out.append((jf, tf))
    return out


def _capture(monkeypatch):
    """Record the gating fractions of both packages' add_factors."""
    seen = {"jax": [], "torch": []}
    j_gate, t_gate = jfg._edge_gate_jit, tfg.edge_gate

    def jg(*a):
        out = j_gate(*a)
        seen["jax"].append(np.asarray(out[-1]))
        return out

    def tg(*a):
        out = t_gate(*a)
        seen["torch"].append(out[-1].numpy())
        return out

    monkeypatch.setattr(jfg, "_edge_gate_jit", jg)
    monkeypatch.setattr(tfg, "edge_gate", tg)
    return seen


def _assert_graphs_agree(jg, tg):
    assert tg.ii == jg.ii and tg.jj == jg.jj
    for name in ("idx_ii2jj", "idx_jj2ii", "valid_match_j",
                 "valid_match_i"):
        for a, b in zip(getattr(tg, name), getattr(jg, name)):
            same = (a.numpy() == np.asarray(b)).mean()
            assert same >= 0.99, (name, same)
    for name in ("Q_ii2jj", "Q_jj2ii"):
        for a, b in zip(getattr(tg, name), getattr(jg, name)):
            close = np.isclose(a.numpy(), np.asarray(b), rtol=1e-4,
                               atol=1e-5).mean()
            assert close >= 0.99, (name, close)


def test_factor_graph_matches_jax(engines, monkeypatch):
    """on_keyframe x3 (the neighbour edge from a tracking half, matched
    edges with retrieval, the solve) and one relocalize, from identical
    keyframes; local_opt.Q_conf 0 so that the edges carry weight."""
    je, te = engines
    _configs(local_opt__Q_conf=0.0, local_opt__min_match_frac=0.0,
             reloc__min_match_frac=0.0, reloc__strict=False)
    seen = _capture(monkeypatch)
    jk, tk = JKeyframes(H, W), KeyframeBuffer(H, W)
    jr = JRetrieval(feat_dim=64, proj_dim=64, n_words=128, nfeat=16)
    tr = RetrievalDatabase(feat_dim=64, proj_dim=64, n_words=128, nfeat=16,
                           device="cpu")
    jgr = jfg.FactorGraph(je, jk, retrieval=jr)
    tgr = tfg.FactorGraph(te, tk, retrieval=tr)
    frames = _mono_frames(je, te, [0, 4, 8, 12], seed=7)
    # a tracking half for keyframe 1's neighbour edge (what the fused step
    # leaves on the frame): identical arrays on both sides
    ns = (H // 2) * (W // 2)
    rng = np.random.default_rng(8)
    half = dict(idx_j2i=rng.integers(0, ns, ns),
                valid_i=rng.random(ns) > 0.3,
                Qi=(1 + 2 * rng.random(ns)).astype(np.float32), kf_idx=0)
    frames[1][0].edge_half = {k: jnp.asarray(v) if k != "kf_idx" else v
                              for k, v in half.items()}
    frames[1][1].edge_half = {k: _t(v) if k != "kf_idx" else v
                              for k, v in half.items()}
    for k, (jf, tf) in enumerate(frames[:3]):
        jk.append(jf)
        tk.append(tf)
        jgr.on_keyframe(k)
        tgr.on_keyframe(k)
        _assert_graphs_agree(jgr, tgr)
        for a, b in zip(tk.frames, jk.frames):
            np.testing.assert_allclose(a.T_WC.numpy(), np.asarray(b.T_WC),
                                       rtol=1e-4, atol=1e-4)
    assert tgr.stats["neighbor_edges"] == 1
    assert tgr.stats["factor_edges"] >= 2
    assert tgr.stats["solves"] == 3 and tgr.stats["iters"] > 0
    assert len(seen["torch"]) == len(seen["jax"]) >= 2
    for a, b in zip(seen["torch"], seen["jax"]):
        np.testing.assert_allclose(a, b, atol=0.02)

    jf, tf = frames[3]
    assert tgr.relocalize(tf) == jgr.relocalize(jf) is True
    assert len(tk) == len(jk) == 4
    _assert_graphs_agree(jgr, tgr)
    for a, b in zip(tk.frames, jk.frames):
        np.testing.assert_allclose(a.T_WC.numpy(), np.asarray(b.T_WC),
                                   rtol=1e-4, atol=1e-4)
    assert tgr.stats["reloc_ok"] == 1 and tr.kf_counter == jr.kf_counter == 4


def test_strict_reloc_refuses_and_pops(engines):
    """A strict gate that no edge passes: relocalize fails and the
    appended frame is popped again, in both packages."""
    je, te = engines
    _configs(reloc__min_match_frac=1.1, reloc__strict=True)
    jk, tk = JKeyframes(H, W), KeyframeBuffer(H, W)
    jr = JRetrieval(feat_dim=64, proj_dim=64, n_words=128, nfeat=16)
    tr = RetrievalDatabase(feat_dim=64, proj_dim=64, n_words=128, nfeat=16,
                           device="cpu")
    jgr = jfg.FactorGraph(je, jk, retrieval=jr)
    tgr = tfg.FactorGraph(te, tk, retrieval=tr)
    frames = _mono_frames(je, te, [0, 10], seed=9)
    jk.append(frames[0][0])
    tk.append(frames[0][1])
    jgr.on_keyframe(0)
    tgr.on_keyframe(0)
    assert tgr.relocalize(frames[1][1]) == jgr.relocalize(frames[1][0]) \
        is False
    assert len(tk) == len(jk) == 1 and tgr.ii == jgr.ii == []


def test_max_edges_window():
    """Eviction order of the sliding edge window: non-consecutive edges
    first, then the oldest consecutive ones."""
    tcfg.reset_config()
    tcfg.config["local_opt"]["max_edges"] = 3
    g = tfg.FactorGraph(None, KeyframeBuffer(H, W))
    for i, j in ((0, 1), (0, 2), (1, 2), (0, 3), (2, 3)):
        g._append_edge(i, j, *([torch.zeros(4)] * 6))
    g._enforce_max_edges()
    assert list(zip(g.ii, g.jj)) == [(0, 1), (1, 2), (2, 3)]
    tcfg.reset_config()


# ---------------------------------------------------------------------------
# modular tracker and the threaded backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,max_iters", [("weighted_pointmap", 4),
                                            ("recent", 0)])
def test_modular_tracker_matches_jax(engines, mode, max_iters):
    je, te = engines
    _configs(tracking__filtering_mode=mode, tracking__max_iters=max_iters,
             tracking__min_match_frac=0.0)
    jsys = JSystem(je, H, W, fused=False)
    tsys = SLAMSystem(te, H, W, fused=False, max_gaussians=1 << 12)
    assert isinstance(tsys.tracker, FrameTracker)
    assert isinstance(jsys.tracker, JTracker)
    for i in (0, 2, 4):
        jf = j_create_frame(i, _image(i), img_size=W)
        tf = create_frame(i, _image(i), img_size=W, device="cpu")
        jmode, jnew = jsys.process_frame(jf)
        tmode, tnew = tsys.process_frame(tf)
        assert (tmode.name, tnew) == (jmode.name, jnew), i
        np.testing.assert_allclose(tf.T_WC.numpy(), np.asarray(jf.T_WC),
                                   atol=2e-4)
        assert len(tsys.keyframes) == len(jsys.keyframes)
        for s in (jsys, tsys):
            if s.mode.name == "RELOC":
                s.mode = type(s.mode).TRACKING
    tkf, jkf = tsys.keyframes.last_keyframe(), jsys.keyframes.last_keyframe()
    assert tkf.N == jkf.N
    scale = max(1.0, float(np.abs(np.asarray(jkf.X_canon)).max()))
    np.testing.assert_allclose(tkf.X_canon.numpy(), np.asarray(jkf.X_canon),
                               atol=1e-4 * scale)
    if max_iters:
        assert tsys.tracker.fails == 2  # random weights: every solve fails


def test_modular_tracker_warns_for_unfused_modes(engines, capsys):
    _configs(tracking__filtering_mode="best_score")
    SLAMSystem(engines[1], H, W, max_gaussians=1 << 12)
    assert "modular tracker" in capsys.readouterr().out


class _Backend:
    def __init__(self, fail_at=None):
        self.seen, self.fail_at = [], fail_at

    def on_keyframe(self, kf_idx):
        if kf_idx == self.fail_at:
            raise ValueError(f"backend failed at {kf_idx}")
        self.seen.append(kf_idx)
        return True


@pytest.mark.parametrize("fail_at", [None, 1])
def test_threaded_backend(engines, fail_at):
    """single_thread: False runs on_keyframe on a worker thread in
    keyframe order; a worker's exception is raised on the main thread."""
    _configs(tracking__max_iters=0, tracking__min_match_frac=0.0,
             tracking__match_frac_thresh=2.0)
    tcfg.config["single_thread"] = False
    backend = _Backend(fail_at)
    sys_ = SLAMSystem(engines[1], H, W, backend=backend,
                      max_gaussians=1 << 12)
    assert not sys_.single_thread
    data = [(str(i), _image(i)) for i in (0, 2, 4)]
    if fail_at is None:
        res = sys_.run(data, verbose=False)
        assert backend.seen == [0, 1, 2] == list(range(len(res.keyframes)))
        assert not sys_._backend_thread.is_alive()
    else:
        with pytest.raises(ValueError, match="backend failed at 1"):
            sys_.run(data, verbose=False)
        # the failed worker dropped its queue; keyframe 2 ran only if its
        # dispatch came after the failure (it then started a new worker);
        # the error surfaced at the end of the run either way
        assert backend.seen in ([0], [0, 2])
        assert not sys_._backend_thread.is_alive()
    assert sys_.prewarm() is None
