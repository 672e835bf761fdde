"""Session files (`runtime/session.py`) between the port and the JAX package.

Stub systems on each package's real `KeyframeBuffer`, `GaussianPool` and
`FactorGraph` (no model: the session is the subject; the JAX package's own
session test is marked slow for its model's init), filled from one seeded
numpy state: three keyframes with poses, pointmaps, confidences, images,
encoder features and positions; 500 pool rows; three edges on the
matching subgrid of base.yaml (match stride 2). Held, exactly (every value
is stored and read back without arithmetic):
- a file saved by the JAX package loads into the port, and one saved by
  the port loads into the JAX package: mode, keyframes, pool rows and every
  edge list equal the saved state;
- the port's own round trip is bit for bit, the loaded tensors lie on the
  pool's device with the port's dtypes, and a backend solve on the loaded
  graph gives the same poses as on the original one;
- a match-stride mismatch raises ValueError in both packages.
"""

import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu import config as jcfg
from splatt3r_slam_tpu.backend import FactorGraph as JGraph
from splatt3r_slam_tpu.runtime import session as jsession
from splatt3r_slam_tpu.runtime.frame import Frame as JFrame
from splatt3r_slam_tpu.runtime.frame import GaussianPool as JPool
from splatt3r_slam_tpu.runtime.frame import KeyframeBuffer as JKeyframes
from splatt3r_slam_tpu.runtime.frame import Mode as JMode
from splatt3r_slam_tpu_torch import config as tcfg
from splatt3r_slam_tpu_torch.backend import FactorGraph
from splatt3r_slam_tpu_torch.runtime import session
from splatt3r_slam_tpu_torch.runtime.frame import (
    Frame,
    GaussianPool,
    KeyframeBuffer,
    Mode,
)
from test_torch_port_bench import one_torch_thread  # noqa: F401

H, W = 24, 32
N_KF, N_POOL, CAP = 3, 500, 2048
EDGES = ((0, 1), (1, 2), (0, 2))


@pytest.fixture(autouse=True)
def base_configs():
    """base.yaml in both packages (match stride 2), restored after."""
    saved = (copy.deepcopy(jcfg.config), copy.deepcopy(tcfg.config))
    tcfg.reset_config()
    jcfg.set_global_config(copy.deepcopy(tcfg.config))
    assert tcfg.config["matching"]["match_stride"] == 2
    yield
    jcfg.set_global_config(saved[0])
    tcfg.set_global_config(saved[1])


def _state(seed=0):
    """The seeded session contents as numpy arrays."""
    rng = np.random.default_rng(seed)
    ns = (H // 2) * (W // 2)  # rows on the matching subgrid
    kfs = []
    for k in range(N_KF):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        z = 1.5 + rng.random((H, W))
        X = np.stack([(u - W / 2) * z / W, (v - H / 2) * z / W, z], -1)
        kfs.append(dict(
            id=3 * k,
            T=np.concatenate([0.1 * rng.normal(size=3), 0.05 * q + [0, 0, 0,
                                                                   1],
                              [1.0]]).astype(np.float32),
            X=X.reshape(-1, 3).astype(np.float32),
            C=(1 + 3 * rng.random((H * W, 1))).astype(np.float32),
            N=k + 1, uimg=(rng.random((H, W, 3)) * 255).astype(np.uint8),
            feat=rng.normal(size=(1, 6, 16)).astype(np.float32),
            pos=np.stack(np.meshgrid(np.arange(2), np.arange(3),
                                     indexing="ij"), -1).reshape(1, 6, 2)))
        kfs[-1]["T"][3:7] /= np.linalg.norm(kfs[-1]["T"][3:7])
    pool = rng.random((N_POOL, 13)).astype(np.float32)
    edges = [dict(idx=rng.integers(0, ns, ns).astype(np.int32),
                  idx2=rng.integers(0, ns, ns).astype(np.int32),
                  vj=rng.random(ns) > 0.3, vi=rng.random(ns) > 0.3,
                  qj=(1 + rng.random(ns)).astype(np.float32),
                  qi=(1 + rng.random(ns)).astype(np.float32))
             for _ in EDGES]
    return kfs, pool, edges


LISTS = (("idx_ii2jj", "idx"), ("idx_jj2ii", "idx2"),
         ("valid_match_j", "vj"), ("valid_match_i", "vi"),
         ("Q_ii2jj", "qj"), ("Q_jj2ii", "qi"))


def _port_system(state=None):
    """A stub system and graph on the port's classes (on the CPU)."""
    kfb = KeyframeBuffer(H, W)
    sysm = types.SimpleNamespace(keyframes=kfb, mode=Mode.INIT,
                                 pool=GaussianPool(CAP, device="cpu"))
    graph = FactorGraph(None, kfb)
    if state is None:
        return sysm, graph
    kfs, pool, edges = state
    sysm.mode = Mode.TRACKING
    for k in kfs:
        f = Frame(k["id"], img=None, img_shape=np.array([[H, W]]),
                  img_true_shape=np.array([[H, W]]), uimg=k["uimg"],
                  T_WC=torch.as_tensor(k["T"]))
        f.X_canon, f.C = torch.as_tensor(k["X"]), torch.as_tensor(k["C"])
        f.N = f.N_updates = k["N"]
        f.feat = torch.as_tensor(k["feat"])
        f.pos = torch.as_tensor(k["pos"]).long()
        kfb.append(f)
    sysm.pool.data[:N_POOL] = torch.as_tensor(pool)
    sysm.pool.kf_id[:N_POOL] = np.arange(N_POOL) % N_KF
    sysm.pool.n = N_POOL
    for (i, j), e in zip(EDGES, edges):
        graph._append_edge(i, j, *(torch.as_tensor(e[k]).long() if k in (
            "idx", "idx2") else torch.as_tensor(e[k]) for _, k in LISTS))
    return sysm, graph


def _jax_system(state=None):
    """A stub system and graph on the JAX package's classes."""
    kfb = JKeyframes(H, W)
    sysm = types.SimpleNamespace(keyframes=kfb, mode=JMode.INIT,
                                 pool=JPool(CAP))
    graph = JGraph(None, kfb)
    if state is None:
        return sysm, graph
    kfs, pool, edges = state
    sysm.mode = JMode.TRACKING
    for k in kfs:
        f = JFrame(k["id"], img=None, img_shape=np.array([[H, W]]),
                   img_true_shape=np.array([[H, W]]), uimg=k["uimg"],
                   T_WC=jnp.asarray(k["T"]))
        f.X_canon, f.C = jnp.asarray(k["X"]), jnp.asarray(k["C"])
        f.N = f.N_updates = k["N"]
        f.feat, f.pos = jnp.asarray(k["feat"]), jnp.asarray(k["pos"])
        kfb.append(f)
    sysm.pool.data = sysm.pool.data.at[:N_POOL].set(jnp.asarray(pool))
    sysm.pool.kf_id[:N_POOL] = np.arange(N_POOL) % N_KF
    sysm.pool.n = N_POOL
    for (i, j), e in zip(EDGES, edges):
        graph.ii.append(i)
        graph.jj.append(j)
        for name, key in LISTS:
            getattr(graph, name).append(jnp.asarray(e[key]))
    return sysm, graph


def _held(sysm, graph, state):
    """The loaded system and graph equal the seeded state exactly."""
    kfs, pool, edges = state
    assert sysm.mode.value == 1 and len(sysm.keyframes) == N_KF
    for i, k in enumerate(kfs):
        f = sysm.keyframes[i]
        assert f.frame_id == k["id"] and f.N == f.N_updates == k["N"]
        for got, want in ((f.T_WC, k["T"]), (f.X_canon, k["X"]),
                          (f.C, k["C"]), (f.feat, k["feat"]),
                          (f.pos, k["pos"]), (f.uimg, k["uimg"])):
            np.testing.assert_array_equal(np.asarray(got), want)
        np.testing.assert_array_equal(np.asarray(f.img_shape).reshape(-1),
                                      [H, W])
    assert sysm.pool.n == N_POOL
    np.testing.assert_array_equal(np.asarray(sysm.pool.data[:N_POOL]), pool)
    np.testing.assert_array_equal(sysm.pool.kf_id[:N_POOL],
                                  np.arange(N_POOL) % N_KF)
    assert (graph.ii, graph.jj) == ([e[0] for e in EDGES],
                                    [e[1] for e in EDGES])
    for name, key in LISTS:
        got = getattr(graph, name)
        assert len(got) == len(EDGES)
        for g, e in zip(got, edges):
            np.testing.assert_array_equal(np.asarray(g), e[key])


def test_jax_file_loads_in_port(tmp_path):
    state = _state()
    jsession.save_session(tmp_path / "s.npz", *_jax_system(state))
    sysm, graph = _port_system()
    session.load_session(tmp_path / "s.npz", sysm, graph)
    _held(sysm, graph, state)
    kf = sysm.keyframes[1]
    assert kf.T_WC.dtype == kf.X_canon.dtype == torch.float32
    assert kf.pos.dtype == graph.idx_ii2jj[0].dtype == torch.long
    assert graph.valid_match_j[0].dtype == torch.bool
    np.testing.assert_array_equal(kf.T_WC_host, state[0][1]["T"][:3])


def test_port_file_loads_in_jax(tmp_path):
    state = _state(1)
    session.save_session(tmp_path / "s.npz", *_port_system(state))
    sysm, graph = _jax_system()
    jsession.load_session(tmp_path / "s.npz", sysm, graph)
    _held(sysm, graph, state)
    with np.load(tmp_path / "s.npz") as z:
        assert z["edges_idx"].dtype == np.int32
        assert int(z["edges_match_stride"]) == 2


def test_port_round_trip_and_solve(tmp_path):
    state = _state(2)
    sysm, graph = _port_system(state)
    session.save_session(tmp_path / "s.npz", sysm, graph)
    sysm2, graph2 = _port_system()
    session.load_session(tmp_path / "s.npz", sysm2, graph2)
    _held(sysm2, graph2, state)
    for name in ("ii", "jj") + tuple(n for n, _ in LISTS):
        for a, b in zip(getattr(graph, name), getattr(graph2, name)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    graph.solve()
    graph2.solve()
    for i in range(N_KF):
        assert torch.equal(sysm.keyframes[i].T_WC, sysm2.keyframes[i].T_WC)
    assert not torch.equal(sysm.keyframes[2].T_WC,
                           torch.as_tensor(state[0][2]["T"])), "no solve"


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_match_stride_mismatch_raises(tmp_path, saver):
    state = _state(3)
    save = (jsession.save_session, _jax_system) if saver == "jax" else (
        session.save_session, _port_system)
    save[0](tmp_path / "s.npz", *save[1](state))
    jcfg.config["matching"]["match_stride"] = 1
    tcfg.config["matching"]["match_stride"] = 1
    for load, make in ((session.load_session, _port_system),
                       (jsession.load_session, _jax_system)):
        with pytest.raises(ValueError, match="match_stride"):
            load(tmp_path / "s.npz", *make())
