"""The port's retrieval (`retrieval/model.py`, `asmk.py`, `database.py`)
against the JAX package, on seeded features on the CPU.

Tolerances: descriptors within 1e-5 relative to their peak (fp32, matmuls
in another order); visual words and the host (fp64) aggregates exactly;
the device (fp32) aggregate's words exactly and its sign bits on at least
99.9% of entries (a bit flips where a word's residual sum is near 0);
scores within 1e-9 on identical bits; `update` returns the same ids.
"""

import argparse
import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.retrieval import asmk as jasmk
from splatt3r_slam_tpu.retrieval import model as jmodel
from splatt3r_slam_tpu.retrieval.database import RetrievalDatabase as JDB
from splatt3r_slam_tpu_torch.retrieval import asmk
from splatt3r_slam_tpu_torch.retrieval import model as tmodel
from splatt3r_slam_tpu_torch.retrieval.database import RetrievalDatabase
from test_torch_port_bench import one_torch_thread  # noqa: F401

D = 64


def _feats(seed, n=48, d=D):
    return np.random.default_rng(seed).normal(size=(1, n, d)).astype(
        np.float32)


@pytest.mark.parametrize("hdims,residual", [((D,), False),
                                            ((96, D), True)])
def test_prep_features_matches_jax(hdims, residual):
    params = jmodel.init_retrieval_params(D, hdims, seed=3,
                                          residual=residual)
    # a non-trivial whitening
    rng = np.random.default_rng(4)
    params["prewhiten"]["m"] = rng.normal(size=(1, D)).astype(np.float32)
    params["postwhiten"]["p"] = rng.normal(size=(D, D)).astype(np.float32)
    for layer in params["projector"][:-1]:
        layer["ln_scale"] = rng.normal(size=layer["b"].shape).astype(
            np.float32)
    x = _feats(0)
    want = np.asarray(jmodel.prep_features(params, jnp.asarray(x), nfeat=20,
                                           residual=residual))
    got = tmodel.prep_features(tmodel.params_to_device(params, "cpu"),
                               torch.from_numpy(x), nfeat=20,
                               residual=residual).numpy()
    assert got.shape == want.shape == (1, 20, D)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_load_retrieval_checkpoint_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    sd = {"prewhiten.m": rng.normal(size=(1, D)),
          "prewhiten.p": rng.normal(size=(D, D)),
          "postwhiten.m": rng.normal(size=(1, 32)),
          "postwhiten.p": rng.normal(size=(32, 32)),
          "projector.0.weight": rng.normal(size=(48, D)),
          "projector.0.bias": rng.normal(size=48),
          "projector.1.weight": rng.normal(size=48),
          "projector.1.bias": rng.normal(size=48),
          "projector.2.weight": rng.normal(size=(32, 48)),
          "projector.2.bias": rng.normal(size=32)}
    path = tmp_path / "retrieval.pth"
    torch.save({"model": {k: torch.tensor(v, dtype=torch.float32)
                          for k, v in sd.items()},
                "args": argparse.Namespace(hdims="48_32", residual=False,
                                           nfeat=77)}, path)
    got, want = (tmodel.load_retrieval_checkpoint(str(path)),
                 jmodel.load_retrieval_checkpoint(str(path)))
    assert got["nfeat"] == want["nfeat"] == 77
    assert len(got["projector"]) == len(want["projector"]) == 2
    for a, b in zip(got["projector"], want["projector"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    db = RetrievalDatabase(checkpoint_path=str(path), feat_dim=D,
                           n_words=64, device="cpu")
    assert db.nfeat == 77 and db.codebook.centroids.shape == (64, 32)


def test_codebooks_match_jax(tmp_path):
    np.testing.assert_array_equal(asmk.Codebook.random(128, D, 2).centroids,
                                  jasmk.Codebook.random(128, D, 2).centroids)
    data = _feats(1, n=400)[0]
    got = asmk.Codebook.train_kmeans(data, 16, iters=5, seed=3).centroids
    want = jasmk.Codebook.train_kmeans(data, 16, iters=5, seed=3).centroids
    np.testing.assert_allclose(got, want, atol=1e-5)
    # an asmk dump: a class whose package is not installed, unpickled
    # through the stand-in
    mod = types.ModuleType("fake_asmk_pkg")

    class Index:
        pass

    Index.__module__, Index.__qualname__ = "fake_asmk_pkg", "Index"
    mod.Index = Index
    sys.modules["fake_asmk_pkg"] = mod
    obj = Index()
    obj.centroids = np.random.default_rng(6).normal(size=(32, D)).astype(
        np.float32)
    obj.other = np.ones((100, 100), np.float32)
    path = tmp_path / "cb.pkl"
    try:
        path.write_bytes(pickle.dumps({"codebook": obj}))
    finally:
        del sys.modules["fake_asmk_pkg"]
    np.testing.assert_array_equal(asmk.Codebook.load(str(path)).centroids,
                                  jasmk.Codebook.load(str(path)).centroids)
    np.testing.assert_array_equal(asmk.Codebook.load(str(path)).centroids,
                                  obj.centroids)


@pytest.mark.parametrize("ma", [1, 5])
def test_quantize_and_aggregate_match_jax(ma):
    cb = asmk.Codebook.random(128, D, 1)
    x = _feats(2, n=60)[0]
    want_w = np.asarray(jasmk.quantize(jnp.asarray(x),
                                       jnp.asarray(cb.centroids), ma))
    got_w = asmk.quantize(torch.from_numpy(x), cb.dev, ma).numpy()
    np.testing.assert_array_equal(got_w, want_w)
    # host aggregate: identical numpy code on identical inputs
    vecs = np.repeat(x, ma, axis=0)
    for a, b in zip(asmk.aggregate_binary(vecs, got_w.reshape(-1),
                                          cb.centroids),
                    jasmk.aggregate_binary(vecs, want_w.reshape(-1),
                                           cb.centroids)):
        np.testing.assert_array_equal(a, b)
    # device aggregate (fp32 sums) against the JAX device one and the host
    tw, tb, tv = asmk.aggregate_binary_torch(torch.from_numpy(x),
                                             torch.from_numpy(got_w),
                                             cb.dev)
    jw, jb, jv = jasmk.aggregate_binary_jax(jnp.asarray(x),
                                            jnp.asarray(want_w),
                                            jnp.asarray(cb.centroids))
    tv, jv = tv.numpy(), np.asarray(jv)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tw.numpy()[tv], np.asarray(jw)[jv])
    jbits = np.ascontiguousarray(np.asarray(jb)[jv]).view(np.uint8)
    tbits = tb.numpy()[tv]
    hw, hb = asmk.aggregate_binary(vecs, got_w.reshape(-1), cb.centroids)
    np.testing.assert_array_equal(tw.numpy()[tv], hw)
    for other in (jbits, hb):
        same = (np.unpackbits(tbits, axis=1)
                == np.unpackbits(other, axis=1)).mean()
        assert same >= 0.999, same


def test_similarity_and_ivf_match_jax():
    rng = np.random.default_rng(7)
    t_ivf, j_ivf = asmk.IVF(128, D), jasmk.IVF(128, D)
    for im in range(4):
        words = np.unique(rng.integers(0, 128, 40))
        bits = rng.integers(0, 256, (len(words), D // 8), np.uint8)
        t_ivf.add(words, bits, im)
        j_ivf.add(words, bits, im)
    qw = np.unique(rng.integers(0, 128, 50))
    qb = rng.integers(0, 256, (len(qw), D // 8), np.uint8)
    np.testing.assert_allclose(t_ivf.search(qw, qb), j_ivf.search(qw, qb),
                               atol=1e-9)
    np.testing.assert_array_equal(
        asmk.binary_similarity(qb[:5], qb[5:10], D),
        jasmk.binary_similarity(qb[:5], qb[5:10], D))


def test_database_update_matches_jax():
    """Query-then-add over seeded keyframe features: the same retrieved ids
    at every step, and the same scores through `query`."""
    kw = dict(feat_dim=D, proj_dim=D, n_words=256, nfeat=24)
    jdb, tdb = JDB(**kw), RetrievalDatabase(**kw, device="cpu")
    scenes = [_feats(8 + s, n=96) for s in range(3)]
    base = scenes[0]
    retrieved = []
    for k in range(6):
        noise = np.random.default_rng(100 + k).normal(
            size=base.shape).astype(np.float32)
        # keyframes 3-5 revisit the scenes of 0-2
        x = scenes[k % 3] + 0.3 * noise
        jf = types.SimpleNamespace(feat=jnp.asarray(x))
        tf = types.SimpleNamespace(feat=torch.from_numpy(x))
        want = jdb.update(jf, add_after_query=True, k=3, min_thresh=0.0)
        got = tdb.update(tf, add_after_query=True, k=3, min_thresh=0.0)
        assert got == want, k
        retrieved.append(got)
    assert tdb.kf_counter == jdb.kf_counter == 6
    assert retrieved[3][0] == 0 and retrieved[5][0] == 2
    feat = tdb.prep_features(torch.from_numpy(base))[0].numpy()
    np.testing.assert_allclose(tdb.query(feat), jdb.query(feat), atol=1e-9)
    tdb.add_to_database_np(feat)
    jdb.add_to_database_np(feat)
    tdb.add_to_database(types.SimpleNamespace(feat=torch.from_numpy(base)))
    assert tdb.kf_counter == 8 and tdb.ivf.n_images == 8
