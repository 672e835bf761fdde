"""The port's closed-loop oracle (`runtime/oracle.py`) and the device
geometry of the fused step's oracle variant (`runtime/fused.py::
_oracle_geometry`) against the JAX package.

The host geometry and its noise are numpy in both packages, so they are
held exactly (floats within 1e-6, indices equal); the engine surface of the
standalone oracle (no network) likewise, output for output, with the
port's dtypes (int64 indices, float32 values, bool masks). The device
geometry is float32 on both sides with sums in another order: indices equal
on at least 99.9% of rows (a quotient that lands on a floor or a rounding
tie may go either way) and points within 1e-5 relative to the largest.
The fused step's device noise has no JAX counterpart (torch cannot draw
JAX's `fold_in` stream); it is held by its statistics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.runtime import fused as jfused
from splatt3r_slam_tpu.runtime import oracle as jor
from splatt3r_slam_tpu_torch.runtime import fused as tfused
from splatt3r_slam_tpu_torch.runtime import oracle as tor
from test_torch_port_bench import one_torch_thread  # noqa: F401

H, W = 48, 64
PLANE = dict(plane_n=(0.12, 0.08, 1.0), plane_d=2.0)


class _Frame:
    """The fields of a frame the standalone oracle reads and writes."""

    def __init__(self, fid, feat=None):
        self.frame_id = fid
        self.feat = feat
        self.pos = None


def _pair(stride=1, **kw):
    """Standalone oracles of both packages over one trajectory."""
    j = jor.PlaneSceneOracle(H, W, float(W), stride=stride, **PLANE, **kw)
    t = tor.PlaneSceneOracle(H, W, float(W), stride=stride, device="cpu",
                             **PLANE, **kw)
    for i, T in enumerate(tor.reloc_pan_trajectory(30, W, (16, 20))):
        j.register(i, T)
        t.register(i, T)
    return j, t


def _same(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        assert got.dtype == bool, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif np.issubdtype(want.dtype, np.integer):
        assert got.dtype == np.int64, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got.dtype == np.float32, (what, got.dtype)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=what)


def test_host_geometry_matches_jax():
    np.testing.assert_allclose(tor.make_rays(H, W, 70.0),
                               jor.make_rays(H, W, 70.0), rtol=1e-6)
    for a, b in ((tor.pan_trajectory(40, 512), jor.pan_trajectory(40, 512)),
                 (tor.reloc_pan_trajectory(30, W, (16, 20)),
                  jor.reloc_pan_trajectory(30, W, (16, 20)))):
        assert len(a) == len(b)
        np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=1e-6,
                                   atol=1e-12)
    for stride in (1, 2):
        j, t = _pair(stride)
        for src, dst in ((0, 3), (5, 1), (12, 22)):
            Ts, Td = j.gt[src], j.gt[dst]
            np.testing.assert_allclose(t.gt_pointmap_cam(Ts),
                                       j.gt_pointmap_cam(Ts), rtol=1e-6)
            for name in ("project_into", "project_into_sub"):
                gi, gok, gX = getattr(t, name)(Ts, Td)
                wi, wok, wX = getattr(j, name)(Ts, Td)
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gok, wok)
                np.testing.assert_allclose(gX, wX, rtol=1e-6)
    # the pointmap cache returns the first result for a recurring pose
    assert t.gt_pointmap_cam(j.gt[3]) is t.gt_pointmap_cam(j.gt[3])


def test_noise_model_matches_jax_bit_for_bit():
    j, t = _pair(noise=0.01, conf_noise=0.2, blackout=(16, 20))
    X = j.gt_pointmap_cam(j.gt[7])
    for fid, salt in ((0, 0), (7, 2), (255, 1)):
        np.testing.assert_array_equal(t._noisy(X, fid, salt),
                                      j._noisy(X, fid, salt))
        np.testing.assert_array_equal(t._conf(100, fid, salt),
                                      j._conf(100, fid, salt))
    assert [t.blacked(i) for i in range(30)] == [j.blacked(i)
                                                 for i in range(30)]


@pytest.mark.parametrize("stride,noisy", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_engine_surface_matches_jax(stride, noisy):
    kw = dict(noise=0.01, conf_noise=0.2, blackout=(16, 20)) if noisy else {}
    j, t = _pair(stride, **kw)
    for fid, kid in ((3, 0), (9, 5), (17, 12)):  # 17: blacked out if noisy
        jf, jk, tf, tk = _Frame(fid), _Frame(kid), _Frame(fid), _Frame(kid)
        for g, w, what in zip(t.inference_mono(tf), j.inference_mono(jf),
                              ("X", "C")):
            _same(g, w, f"mono {what}")
        got = t.match_asymmetric(tf, tk)
        want = j.match_asymmetric(jf, jk)
        for k, (g, w) in enumerate(zip(got, want)):
            if k == 0:  # JAX's int32 indices
                w = np.asarray(w).astype(np.int64)
            _same(g, w, f"asymmetric output {k}")
        assert float(tf.feat[0, 0, 0]) == fid
        tfe = torch.cat([tf.feat, tk.feat, tk.feat])
        tke = torch.cat([tk.feat, tf.feat, tk.feat])
        jfe = jnp.concatenate([jf.feat, jk.feat, jk.feat])
        jke = jnp.concatenate([jk.feat, jf.feat, jk.feat])
        got = t.match_symmetric(tfe, None, tke, None)
        want = j.match_symmetric(jfe, None, jke, None)
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            _same(g, w.astype(np.int64) if k < 2 else w,
                  f"symmetric output {k}")
        got = t.match_oneway(tk.feat, None, tf.feat, None)
        want = j.match_oneway(jk.feat, None, jf.feat, None)
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            _same(g, w.astype(np.int64) if k == 0 else w, f"oneway {k}")


def test_fused_inputs_match_jax():
    j, t = _pair(2, noise=0.01, blackout=(16, 20))
    for fid, kid in ((4, 0), (17, 12)):
        got, want = t.fused_inputs(fid, kid), j.fused_inputs(fid, kid)
        assert got["fid"] == int(want["fid"]) == fid
        for key in ("on", "T_f", "T_k", "plane_n", "plane_d", "focal", "ok",
                    "sigma"):
            _same(got[key], np.asarray(want[key]), key)
    _, t0 = _pair(1)
    assert t0.fused_inputs(4, 0)["sigma"] is None


def _poses(seed, n=6):
    """Seeded camera poses near the pan, a few of them far enough that
    part of the keyframe leaves the frame."""
    rng = np.random.default_rng(seed)
    base = tor.pan_trajectory(12, W)
    out = []
    for _ in range(n):
        T = base[rng.integers(0, 12)].copy()
        T[:3, 3] += rng.normal(size=3) * 0.1
        out.append(T)
    return out


@pytest.mark.parametrize("s", [1, 2])
def test_oracle_geometry_matches_jax(s):
    hs, ws = H // s, W // s
    j, t = _pair(s, blackout=(3, 4))
    poses = _poses(s)
    rows = agree = 0
    for a in range(len(poses)):
        for b in range(len(poses)):
            j.register(100, poses[a])
            j.register(101, poses[b])
            t.register(100, poses[a])
            t.register(101, poses[b])
            want = jfused._oracle_geometry(j.fused_inputs(100, 101), H, W, s,
                                           hs, ws)
            got = tfused._oracle_geometry(t.fused_inputs(100, 101), H, W, s,
                                          hs, ws)
            for g, w in zip(got[:2], want[:2]):
                w = np.asarray(w)
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=1e-5 * np.abs(w).max())
            gi, gv = got[2].numpy(), got[3].numpy()
            wi, wv = np.asarray(want[2]), np.asarray(want[3])
            assert got[2].dtype == torch.int64 and gv.dtype == bool
            rows += gi.size
            agree += int(((gi == wi) & (gv == wv)).sum())
            # a valid row's index is on the grid
            assert gi.min() >= 0 and gi.max() < hs * ws
    assert agree >= 0.999 * rows, f"{rows - agree} of {rows} rows differ"
    # a blacked-out keyframe gives no valid row
    got = tfused._oracle_geometry(t.fused_inputs(100, 3), H, W, s, hs, ws)
    assert not bool(got[3].any())


def test_device_noise_is_seeded_and_depth_proportional():
    _, t = _pair(2, noise=0.01)
    _, exact = _pair(2)

    def geometry(oracle, fid):
        return tfused._oracle_geometry(oracle.fused_inputs(fid, 0), H, W, 2,
                                       H // 2, W // 2)

    a, b, c, clean = (geometry(t, 5), geometry(t, 5), geometry(t, 6),
                      geometry(exact, 5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    for noisy, want in zip(a[:2], clean[:2]):
        z = (noisy - want) / want[:, 2:3].abs()
        assert abs(float(z.std()) - 0.01) < 1e-3
        assert abs(float(z.mean())) < 1e-3


def test_stamp_writes_a_copy_and_checks_the_dtype():
    _, t = _pair()
    feat = torch.arange(24, dtype=torch.float32).reshape(1, 4, 6)
    alias = feat  # e.g. KFState.feat, a retrieval input, a keyframe row
    view = feat[0]
    before = feat.clone()
    frame = _Frame(7, feat)
    t._stamp(frame)
    assert float(frame.feat[0, 0, 0]) == 7.0
    assert torch.equal(frame.feat[0, 1:], before[0, 1:])
    assert torch.equal(alias, before) and torch.equal(view, before[0])
    # bfloat16 holds every integer up to 256 exactly, not 257
    ok = _Frame(256, torch.zeros(1, 2, 2, dtype=torch.bfloat16))
    t._stamp(ok)
    assert float(ok.feat[0, 0, 0]) == 256.0
    with pytest.raises(ValueError, match="not exactly representable"):
        t._stamp(_Frame(257, torch.zeros(1, 2, 2, dtype=torch.bfloat16)))
    t._stamp(_Frame(257, torch.zeros(1, 2, 2)))  # float32: fine


def test_oracle_retrieval_matches_jax():
    j, t = _pair()
    jr, tr = jor.OracleRetrieval(j), tor.OracleRetrieval(t)
    for fid in (0, 3, 6, 9, 12, 22, 24):
        jf, tf = _Frame(fid), _Frame(fid)
        assert tr.update(tf, k=3) == jr.update(jf, k=3)
    for fid in (5, 13, 27):
        assert tr.update(_Frame(fid), add_after_query=False, k=3) == \
            jr.update(_Frame(fid), add_after_query=False, k=3)
    tr.add_to_database(_Frame(13))
    assert tr.fids == [0, 3, 6, 9, 12, 22, 24, 13]
