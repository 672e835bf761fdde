"""The training step's parts in the port against the JAX package.

`DecoderSplatting`, the projection helpers and `render_depth`
(splat/decoder.py), the image metrics (utils/metrics.py), LPIPS
(utils/lpips.py), the loss mask (parallel/loss_mask.py), and the host-side
pieces (parallel/export.py, workspace.py, logging.py). Inputs are made with
numpy from a seed and go through both packages. Tolerances: 1e-5 for
pointwise fp32 arithmetic in the same order; 2e-3 for rendered images (the
compositor bar of tests/test_pallas_rasterizer.py); 1e-4 for LPIPS (five
conv stacks in fp32, sums in another order).
"""

import csv
import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.parallel import export as j_export
from splatt3r_slam_tpu.parallel import loss_mask as j_mask
from splatt3r_slam_tpu.splat import decoder as j_dec
from splatt3r_slam_tpu.splat.gaussians import build_covariance as j_cov
from splatt3r_slam_tpu.splat.gaussians import cov_to_triu as j_triu
from splatt3r_slam_tpu.utils import lpips as j_lpips
from splatt3r_slam_tpu.utils import metrics as j_metrics
from splatt3r_slam_tpu_torch.parallel import export as t_export
from splatt3r_slam_tpu_torch.parallel import loss_mask as t_mask
from splatt3r_slam_tpu_torch.parallel import workspace as t_ws
from splatt3r_slam_tpu_torch.parallel.logging import (
    MetricsLogger,
    TraceWindow,
)
from splatt3r_slam_tpu_torch.splat import cuda_rasterizer as cr
from splatt3r_slam_tpu_torch.splat import decoder as t_dec
from splatt3r_slam_tpu_torch.splat.gaussians import build_covariance
from splatt3r_slam_tpu_torch.utils import lpips as t_lpips
from splatt3r_slam_tpu_torch.utils import metrics as t_metrics
from test_torch_port_bench import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


# -- splat/decoder.py -----------------------------------------------------


def _decoder_inputs(rng, B=2, V=2, h=32, w=32):
    """Two views' predictions in front of the context camera, target poses
    a small step away from a non-identity context pose."""
    def pred():
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        z = 2.0 + rng.random((B, h, w))
        means = np.stack([(xx + 0.5 - w / 2) * z / 40.0,
                          (yy + 0.5 - h / 2) * z / 40.0, z], -1)
        q = rng.normal(size=(B, h, w, 4))
        return {
            "means": means.astype(np.float32),
            "scales": (0.02 + 0.05 * rng.random((B, h, w, 3))).astype(
                np.float32),
            "rotations": (q / np.linalg.norm(q, axis=-1, keepdims=True)
                          ).astype(np.float32),
            "sh": (rng.normal(size=(B, h, w, 3, 1)) * 0.5).astype(np.float32),
            "opacities": (0.2 + 0.7 * rng.random((B, h, w, 1))).astype(
                np.float32),
        }

    def pose(shift):
        T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        T[:, :3, 3] = shift
        return T

    ctx = pose([0.3, -0.2, 0.1])
    targets = [pose([0.3 + 0.05 * v, -0.2, 0.1 - 0.1 * v]) for v in range(V)]
    Km = np.tile(np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]],
                          np.float32), (B, 1, 1))
    return pred(), pred(), ctx, targets, Km


@pytest.mark.parametrize("rasterizer", ["auto", "cuda"])
def test_decoder_splatting_matches_jax(rng, rasterizer):
    """Same predictions and poses → the JAX decoder's (B, V, 3, H, W)
    colours within 2e-3. "cuda" on CPU tensors goes through `Composite`
    with its plain forward; "auto" on the CPU is the plain compositor."""
    p1, p2, ctx, targets, Km = _decoder_inputs(rng)
    jp, tp = [], []
    for p in (p1, p2):
        j = {k: jnp.asarray(v) for k, v in p.items()}
        j["covariances"] = j_cov(j["scales"], j["rotations"])
        t = {k: _t(v) for k, v in p.items()}
        t["covariances"] = build_covariance(t["scales"], t["rotations"])
        jp.append(j)
        tp.append(t)
    jp[1]["means_in_other_view"] = jp[1]["means"]
    tp[1]["means_in_other_view"] = tp[1]["means"]

    def batch(conv):
        return {"context": [{"camera_pose": conv(ctx)}],
                "target": [{"camera_pose": conv(t),
                            "camera_intrinsics": conv(Km)} for t in targets]}

    bg = (0.1, 0.2, 0.3)
    want, _ = j_dec.DecoderSplatting(bg, k_max=128, rasterizer="xla")(
        batch(jnp.asarray), jp[0], jp[1], (32, 32))
    before = cr.launches
    got, aux = t_dec.DecoderSplatting(bg, k_max=128, rasterizer=rasterizer)(
        batch(_t), tp[0], tp[1], (32, 32))
    assert aux is None and cr.launches == before
    assert tuple(got.shape) == (2, 2, 3, 32, 32) == want.shape
    want = np.asarray(want)
    assert want.std() > 0.05  # a real image, not background
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_fov_and_projection_matrix(rng):
    Kn = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    Kn[:, 0, 0] = 0.5 + rng.random(4)
    Kn[:, 1, 1] = 0.5 + rng.random(4)
    want = np.asarray(j_dec.get_fov(jnp.asarray(Kn)))
    got = t_dec.get_fov(_t(Kn))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    near = np.full(4, 0.1, np.float32)
    far = np.full(4, 100.0, np.float32)
    P = t_dec.get_projection_matrix(_t(near), _t(far), got[:, 0], got[:, 1])
    Pj = j_dec.get_projection_matrix(jnp.asarray(near), jnp.asarray(far),
                                     jnp.asarray(want[:, 0]),
                                     jnp.asarray(want[:, 1]))
    assert tuple(P.shape) == (4, 4, 4)
    # far/(far-near) terms reach 100: 1e-5 relative
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["depth", "disparity", "relative_disparity",
                                  "log"])
def test_render_depth_modes(rng, mode):
    G = 150
    means = rng.normal(size=(G, 3)).astype(np.float32)
    means[:, 2] = np.abs(means[:, 2]) + 3.0
    scales = (0.05 + 0.1 * rng.random((G, 3))).astype(np.float32)
    q = rng.normal(size=(G, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    covt = np.asarray(j_triu(j_cov(jnp.asarray(scales), jnp.asarray(q))))
    opa = (0.3 + 0.7 * rng.random(G)).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = 0.5
    Km = np.array([[80.0, 0, 32], [0, 80, 32], [0, 0, 1]], np.float32)
    want = np.asarray(j_dec.render_depth(
        *(jnp.asarray(a) for a in (means, covt, opa, view, Km)), (64, 64),
        mode=mode))
    got = t_dec.render_depth(*(_t(a) for a in (means, covt, opa, view, Km)),
                             (64, 64), mode=mode)
    assert tuple(got.shape) == (64, 64) and np.abs(want).max() > 0.1
    # depth-as-colour through the same compositor: pointwise 1e-5 of the
    # largest value (depths reach ~6)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# -- utils/metrics.py, parallel/loss_mask.py ----------------------------------


def test_metrics_match_jax(rng):
    a = rng.random((2, 40, 48, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    mask = (rng.random((2, 40, 48)) < 0.4).astype(np.float32)
    ja, jb, jm = jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)
    ta, tb, tm = _t(a), _t(b), _t(mask)
    # fp32 pointwise arithmetic and an 11x11 window sum: 1e-5
    np.testing.assert_allclose(t_metrics.ssim(ta, tb).numpy(),
                               np.asarray(j_metrics.ssim(ja, jb)), atol=1e-5)
    np.testing.assert_allclose(t_metrics.ssim(ta[0], tb[0]).numpy(),
                               np.asarray(j_metrics.ssim(ja[0], jb[0])),
                               atol=1e-5)
    for m_t, m_j in ((None, None), (tm, jm)):
        for name in ("ssim_mean", "mse", "psnr"):
            got = float(getattr(t_metrics, name)(ta, tb, m_t))
            want = float(getattr(j_metrics, name)(ja, jb, m_j))
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), name
    m = t_metrics.mse(ta, tb)
    assert float(t_metrics.psnr_from_mse(m)) == pytest.approx(
        float(j_metrics.psnr_from_mse(jnp.asarray(float(m)))), abs=1e-5)
    # an all-zero mask divides by 1, not 0
    assert float(t_metrics.mse(ta, tb, torch.zeros(2, 40, 48))) == 0.0


def test_loss_mask_matches_jax(rng):
    h, w = 24, 32
    Km = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]], np.float32)
    depth = (1.0 + 2.0 * rng.random((h, w))).astype(np.float32)
    depth[:3] = 0.0  # invalid depth is masked out
    T = np.eye(4, dtype=np.float32)
    c = np.cos(0.4)
    s = np.sin(0.4)
    side = np.array([[c, 0, s, 0.8], [0, 1, 0, 0], [-s, 0, c, 0],
                     [0, 0, 0, 1]], np.float32)
    back = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    ctx_T = np.stack([side, back])
    ctx_K = np.stack([Km, Km])
    pts_j = j_mask.unproject(jnp.asarray(depth), jnp.asarray(Km),
                             jnp.asarray(side))
    pts_t = t_mask.unproject(_t(depth), _t(Km), _t(side))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), atol=1e-5)
    np.testing.assert_array_equal(
        t_mask.in_frustum_mask(pts_t, _t(Km), _t(T), (h, w)).numpy(),
        np.asarray(j_mask.in_frustum_mask(pts_j, jnp.asarray(Km),
                                          jnp.asarray(T), (h, w))))
    want = np.asarray(j_mask.calculate_loss_mask(
        jnp.asarray(depth), jnp.asarray(Km), jnp.asarray(T),
        jnp.asarray(ctx_K), jnp.asarray(ctx_T), (h, w)))
    got = t_mask.calculate_loss_mask(_t(depth), _t(Km), _t(T), _t(ctx_K),
                                     _t(ctx_T), (h, w))
    assert got.dtype == torch.bool and 0 < want.sum() < want.size
    np.testing.assert_array_equal(got.numpy(), want)


# -- utils/lpips.py -----------------------------------------------------------


@pytest.fixture(scope="module")
def lpips_pair():
    jp = j_lpips.random_params(3, channel_scale=8)
    tp = t_lpips.params_from_hwio(jp)
    return jp, tp


@pytest.mark.parametrize("spatial", [False, True])
def test_lpips_matches_jax(lpips_pair, spatial):
    jp, tp = lpips_pair
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    want = np.asarray(j_lpips.lpips(jp, jnp.asarray(a), jnp.asarray(b),
                                    spatial=spatial))
    got = t_lpips.lpips(tp, _t(a), _t(b), spatial=spatial)
    assert tuple(got.shape) == want.shape == ((2, 32, 48) if spatial
                                              else (2,))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    want01 = np.asarray(j_lpips.lpips_from_01(
        jp, jnp.asarray(a * 0.5 + 0.5), jnp.asarray(b * 0.5 + 0.5),
        spatial=spatial))
    got01 = t_lpips.lpips_from_01(tp, _t(a * 0.5 + 0.5), _t(b * 0.5 + 0.5),
                                  spatial=spatial)
    np.testing.assert_allclose(got01.numpy(), want01, atol=1e-4, rtol=1e-4)


def test_lpips_params_same_seed_and_loaders(lpips_pair, tmp_path):
    """`random_params(seed)` draws the JAX package's numbers; the npz of
    scripts/convert_lpips.py and a torch LPIPS state dict load to the same
    tree."""
    jp, tp = lpips_pair
    own = t_lpips.random_params(3, channel_scale=8)
    flat = {}
    sd = {}
    slice_base = [0, 4, 9, 16, 23]
    for s, block in enumerate(t_lpips.VGG_SLICES):
        for c, (idx, _, _) in enumerate(block):
            assert torch.equal(own["convs"][s][c]["kernel"],
                               tp["convs"][s][c]["kernel"])
            flat[f"conv_{s}_{c}_kernel"] = np.asarray(
                jp["convs"][s][c]["kernel"])
            flat[f"conv_{s}_{c}_bias"] = np.asarray(jp["convs"][s][c]["bias"])
            stem = f"net.slice{s + 1}.{idx - slice_base[s]}"
            sd[f"{stem}.weight"] = tp["convs"][s][c]["kernel"]
            sd[f"{stem}.bias"] = tp["convs"][s][c]["bias"]
        assert torch.equal(own["lins"][s], tp["lins"][s])
        flat[f"lin_{s}"] = np.asarray(jp["lins"][s])
        sd[f"lin{s}.model.1.weight"] = tp["lins"][s].reshape(1, -1, 1, 1)
    np.savez(tmp_path / "lpips.npz", **flat)
    torch.save({"state_dict": sd}, tmp_path / "lpips.pt")
    for path in ("lpips.npz", "lpips.pt"):
        got = t_lpips.load_lpips_params(str(tmp_path / path))
        for s in range(5):
            assert torch.equal(got["lins"][s], tp["lins"][s])
            for c in range(len(tp["convs"][s])):
                for k in ("kernel", "bias"):
                    assert torch.equal(got["convs"][s][c][k],
                                       tp["convs"][s][c][k]), (path, s, c, k)


# -- parallel/export.py, workspace.py, logging.py -------------------------------


def test_batch_visuals_png_reads_back(rng, tmp_path):
    """The standard-library PNG writer against cv2's reader and the JAX
    package's cv2-written grid."""
    batch = {"img1": rng.uniform(-1, 1, (1, 16, 24, 3)).astype(np.float32),
             "img2": rng.uniform(-1, 1, (1, 16, 24, 3)).astype(np.float32),
             "target_img": rng.random((1, 1, 16, 24, 3)).astype(np.float32)}
    rendered = rng.random((1, 1, 16, 24, 3)).astype(np.float32)
    t_export.save_batch_visuals(tmp_path / "t", 7,
                                {k: _t(v) for k, v in batch.items()},
                                _t(rendered))
    j_export.save_batch_visuals(tmp_path / "j", 7, batch, rendered)
    got = cv2.imread(str(tmp_path / "t" / "step_0000007.png"))
    want = cv2.imread(str(tmp_path / "j" / "step_0000007.png"))
    assert got is not None and got.shape == (32, 48, 3)
    np.testing.assert_array_equal(got, want)


def test_save_as_ply_matches_jax(rng, tmp_path):
    n = 37
    q = rng.normal(size=(n, 4)).astype(np.float32)
    args = (rng.normal(size=(n, 3)).astype(np.float32),
            (0.01 + rng.random((n, 3))).astype(np.float32), q,
            rng.normal(size=(n, 3, 1)).astype(np.float32),
            rng.random((n, 1)).astype(np.float32))
    t_export.save_as_ply(tmp_path / "t.ply", *(_t(a) for a in args))
    j_export.save_as_ply(tmp_path / "j.ply", *args)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_workspace_config_includes_and_dotlist(tmp_path, monkeypatch):
    (tmp_path / "base.yaml").write_text(
        "train:\n  lr: 1.0e-5\n  k_max: 128\nmodel:\n  remat: false\n")
    (tmp_path / "exp.yaml").write_text(
        "include: [base.yaml]\ntrain:\n  k_max: 64\n")
    cfg = t_ws.load_config(str(tmp_path / "exp.yaml"),
                           dotlist=["train.lr=2e-4", "train.render_loss=true",
                                    "train.lr_milestones=[3, 5]"])
    assert cfg == {"train": {"lr": cfg["train"]["lr"], "k_max": 64,
                             "render_loss": True, "lr_milestones": [3, 5]},
                   "model": {"remat": False}}
    assert float(cfg["train"]["lr"]) == 2e-4
    ws = t_ws.create_workspace(str(tmp_path / "runs"), "exp", cfg)
    assert ws.name.startswith("exp_") and (ws / "config.yaml").exists()
    assert set(json.loads((ws / "provenance.json").read_text())) == {
        "commit", "branch", "dirty"}

    # without PyYAML the dotlist alone still works, and the dump is JSON
    import builtins
    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("no yaml")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg2 = t_ws.apply_dotlist({}, ["train.lr=2e-4", "train.render_loss=true",
                                   "train.lr_milestones=[3, 5]",
                                   "train.lpips_params=w/lpips.npz",
                                   "train.mast3r_loss_weight=null"])
    assert cfg2 == {"train": {"lr": 2e-4, "render_loss": True,
                              "lr_milestones": [3, 5],
                              "lpips_params": "w/lpips.npz",
                              "mast3r_loss_weight": None}}
    ws2 = t_ws.create_workspace(str(tmp_path / "runs"), "noyaml", cfg2)
    assert json.loads((ws2 / "config.yaml").read_text()) == cfg2


def test_metrics_logger_and_trace_window(tmp_path):
    lg = MetricsLogger(tmp_path, "run", meta={"a": 1})
    lg.log(0, {"loss": torch.tensor(1.5), "mse": 0.25})
    lg.log(1, {"loss": 1.25, "mse": 0.2})
    lg.log(1, {"val_psnr": 20.0})
    rows = list(csv.DictReader(open(lg.path)))
    assert [r["step"] for r in rows] == ["0", "1", "1"]
    assert float(rows[0]["loss"]) == 1.5 and rows[0]["val_psnr"] == ""
    assert float(rows[2]["val_psnr"]) == 20.0 and rows[2]["loss"] == ""
    assert json.loads((tmp_path / "run_meta.json").read_text()) == {"a": 1}

    tw = TraceWindow(tmp_path / "trace", 1, 3)
    for i in range(4):
        tw.step(i)
        torch.ones(4).sum()
    tw.close()
    trace = json.loads((tmp_path / "trace" / "steps_1_3.json").read_text())
    assert trace["traceEvents"]
