"""The port's kernel, model and accuracy scripts against the JAX package's.

`splatt3r_slam_tpu_torch/scripts/{bench_rasterizer, bench_rasterizer_grad,
bench_heads_batched, bench_attention, synthetic_pair, sweep_accuracy,
compute_ate, convert_lpips, make_tum_fixture}.py` on the CPU, at small
sizes, each held against its JAX counterpart on the same numpy inputs:

- `make_scene` equal bit for bit; the plain renderer at 3,000 gaussians
  and 64x96 against the JAX `render_tiles`, handed the gaussians in depth
  order, at the JAX tests' compositor bar (2e-3);
- the grad bench's loss and gradients through `render_tiles_cuda` (its
  plain forward and backward on the CPU) against autograd through the
  plain `render_tiles`: 1e-5 of each gradient's peak (both fp32, sums in
  another order), and its gate's verdict;
- the heads at the tiny width against the JAX `GaussianHead` on the same
  weights, 1e-4 of the peak (fp32; the bar of test_torch_port_model), the
  vmapped pair equal to the sequential one to 1e-5 in fp32;
- the einsum attention against the JAX `_attend` in bf16: one bf16 step
  (2^-8) of the output's peak, for a rounding that the two fp32 sums put
  on either side of a bf16 boundary;
- `synthetic_pair`'s scenes bit for bit; each sweep variant's translation
  error on one pair, and one gn_stride 4 backend solve's ATE, within 1e-4
  (the poses' bar); its rotation error through the angle's cosine within
  1e-6 (arccos near 0.6 degrees multiplies the pose's fp32 rounding by
  ~90, so the angle in degrees is no closer than ~3e-4);
- `compute_ate` equal to the JAX CLI's to 1e-9; `convert_lpips`'s npz equal
  to the JAX script's array by array, bit for bit; `make_tum_fixture`'s
  pixels equal to the committed fixture's and its text files
  byte-identical.

Every new entry point defaults to CUDA and raises without a GPU.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu_torch.scripts import (
    bench_attention,
    bench_heads_batched,
    bench_rasterizer,
    bench_rasterizer_grad,
    compute_ate,
    convert_lpips,
    make_tum_fixture,
    probe_wide_forward,
    sweep_accuracy,
)
from splatt3r_slam_tpu_torch.scripts import synthetic_pair as tsp
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = (ROOT / "tests" / "fixtures" / "tum"
           / "rgbd_dataset_freiburg1_fixture")


def load_script(name):
    """scripts/<name>.py of the JAX package's side as a module, sys.path
    left as it was (the scripts put the repository root on it)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def run_main(main, argv):
    """`main(argv)` with its stdout kept → (result, last printed line as
    JSON)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    return res, json.loads(buf.getvalue().strip().splitlines()[-1])


# -- bench_rasterizer ---------------------------------------------------------
def test_make_scene_bit_for_bit():
    jb = load_script("bench_rasterizer")
    for got, want in zip(bench_rasterizer.make_scene(2_000, seed=3),
                         jb.make_scene(2_000, seed=3)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_plain_render_matches_jax():
    from splatt3r_slam_tpu.splat import rasterizer as jr
    from splatt3r_slam_tpu_torch.splat.rasterizer import render_tiles

    hw = (64, 96)
    scene = bench_rasterizer.make_scene(3_000, seed=1, hw=hw)
    got = render_tiles(*(torch.from_numpy(a) for a in scene), hw,
                       tpg_side=4, k_max=512).numpy()
    means, cov, colors, opa, view, K = (jnp.asarray(a) for a in scene)
    _, _, depth, _, ok = jr.project_gaussians(means, cov, opa, view, K, hw)
    o = jnp.argsort(jnp.where(ok, depth, jnp.inf), stable=True)
    want = jr.render_tiles(means[o], cov[o], colors[o], opa[o], view, K, hw,
                           tpg_side=4, k_max=512)
    assert np.abs(got).max() > 0.1
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3)


def test_bench_rasterizer_cli_tiny():
    res, printed = run_main(bench_rasterizer.main, ["--device", "cpu"])
    assert printed == res
    row = res["4000"]
    assert isinstance(row["plain_ms"], float) and row["cuda_ms"] > 0
    # on the CPU both columns composite in plain torch
    assert row["max_abs_diff"] < 1e-5
    assert res["device"] == "cpu" and "peak_mib" not in row


# -- bench_rasterizer_grad ----------------------------------------------------
def test_grad_bench_cuda_route_matches_plain_autograd():
    res, printed = run_main(bench_rasterizer_grad.main, ["--device", "cpu"])
    assert printed == res
    assert res["gaussians"] == 4_000 and res["hw"] == [64, 96]
    assert res["loss"]["rel_diff"] < 1e-6
    for name, g in res["grad_vs_xla_autodiff"].items():
        assert g["finite"] and g["max_abs_plain"] > 0, name
        assert g["max_rel_diff_vs_peak"] < 1e-5, (name, g)
    assert [r["param"] for r in res["fd_probe_cuda"]] == list(
        bench_rasterizer_grad.NAMES)
    assert all(r["rel_err"] < 0.10 for r in res["fd_probe_cuda"])
    assert res["backward_validated_on_hardware"] is True


def test_grad_gate_verdict():
    good = {n: {"finite": True, "max_rel_diff_vs_peak": 0.005}
            for n in bench_rasterizer_grad.NAMES}
    fd = [{"rel_err": 0.05}] * 4
    gate = bench_rasterizer_grad.grad_gate
    assert gate(good, fd)
    assert not gate(dict(good, colors={"finite": True,
                                       "max_rel_diff_vs_peak": 0.01}), fd)
    assert not gate(dict(good, means={"finite": False,
                                      "max_rel_diff_vs_peak": 0.0}), fd)
    assert not gate(good, fd[:3] + [{"rel_err": 0.10}])


# -- bench_heads_batched ------------------------------------------------------
@pytest.fixture(scope="module")
def heads():
    """The tiny model's two heads in the port, and the JAX GaussianHead
    with the same weights (a seeded torch state dict carried over by the
    JAX package's converter)."""
    from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
    from splatt3r_slam_tpu.models.checkpoint import convert_state_dict
    from splatt3r_slam_tpu.models.heads import GaussianHead as JHead
    from splatt3r_slam_tpu_torch.models import TwoViewConfig, init_model

    cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    model = init_model(cfg, seed=0, device="cpu")
    jcfg = JConfig(dtype="float32", head_dtype="float32").tiny()
    jp = convert_state_dict({k: v.numpy() for k, v in
                             model.state_dict().items()}, jcfg)
    jhead = JHead(jcfg.enc_embed_dim, jcfg.dec_embed_dim,
                  jcfg.local_feat_dim, jcfg.patch_size, jcfg.sh_degree,
                  jcfg.use_offsets, jnp.float32,
                  feature_dim=jcfg.head_feature_dim,
                  layer_dims=jcfg.head_layer_dims,
                  last_dim=jcfg.head_last_dim)
    return cfg, model, jhead, jp


@pytest.mark.parametrize("mode", ["tracking", "full", "gaussian_only"])
def test_heads_match_jax_and_batched_equals_sequential(heads, mode):
    cfg, model, jhead, jp = heads
    h, w = 48, 64
    n = (h // 16) * (w // 16)
    dims = (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3
    hk1 = bench_heads_batched.hooks(1, n, dims, "cpu")
    hk2 = bench_heads_batched.hooks(2, n, dims, "cpu")
    seq, batched, stack = bench_heads_batched.seq_and_batched(
        model.downstream_head1, model.downstream_head2, (h, w), mode)
    with torch.no_grad():
        r1, r2 = seq(hk1, hk2)
        rb = batched(stack(hk1, hk2))
    key = "pts3d" if mode != "gaussian_only" else "scales"
    for i, (r, hk) in enumerate(((r1, hk1), (r2, hk2))):
        want = np.asarray(jhead.apply(
            {"params": jp[f"head{i + 1}"]},
            [jnp.asarray(t.numpy()) for t in hk], (h, w), mode)[key])
        assert r.shape == want.shape
        np.testing.assert_allclose(r.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(rb[i].numpy(), r.numpy(),
                                   atol=1e-5 * np.abs(want).max())


def test_bench_heads_cli_tiny():
    res, printed = run_main(bench_heads_batched.main,
                            ["gaussian_only", "--device", "cpu"])
    assert printed == res and res["mode"] == "gaussian_only"
    assert res["hw"] == [48, 64] and res["seq_ms"] > 0
    assert res["max_abs_diff"] <= 1e-5 * res["max_abs"]


# -- bench_attention ----------------------------------------------------------
def test_einsum_attention_matches_jax_bf16():
    from splatt3r_slam_tpu.models import layers as jl

    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 96, 4, 64)).astype(np.float32)
               for _ in range(3))
    scale = 64 ** -0.5
    got = bench_attention.attend_einsum(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16
    want = jl._attend(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                      scale)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 ** -8 * np.abs(want).max())


def test_bench_attention_cli_tiny():
    res, printed = run_main(bench_attention.main, ["--device", "cpu"])
    assert printed == res
    assert list(res["results"]) == [s[0] for s in bench_attention.SHAPES]
    for row in res["results"].values():
        assert row["einsum_ms"] > 0 and row["sdpa_ms"] > 0
        assert row["sdpa_math_ms"] > 0
        for b in bench_attention.BACKENDS:  # a time, or the refusal
            v = row[f"sdpa_{b}_ms"]
            assert isinstance(v, float) or v.startswith("FAIL"), v
        assert row["max_abs_diff"] < 0.05
        # the flash kernel's plain version on the CPU
        assert row["flash_ms"] > 0 and row["flash_max_abs_diff"] < 0.05


# -- synthetic_pair, sweep_accuracy -------------------------------------------
@pytest.fixture(scope="module")
def jsp():
    import synthetic_pair

    return synthetic_pair


def test_synthetic_scenes_bit_for_bit(jsp):
    sc_t, sc_j = tsp.make_scene(24, 32), jsp.make_scene(24, 32)
    assert sc_t["focal"] == sc_j["focal"]
    vt = tsp.make_trajectory(sc_t, 3, np.random.default_rng(7))
    vj = jsp.make_trajectory(sc_j, 3, np.random.default_rng(7))
    for a, b in zip(vt, vj):
        for key in ("T", "Xc", "D"):
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(
        tsp.cross_pointmap(sc_t, vt[0], vt[1]["T"], np.random.default_rng(1)),
        jsp.cross_pointmap(sc_j, vj[0], vj[1]["T"], np.random.default_rng(1)))
    np.testing.assert_allclose(tsp.se3_to_sim3(vt[2]["T"]).numpy(),
                               np.asarray(jsp.se3_to_sim3(vj[2]["T"])),
                               atol=1e-7)


@pytest.mark.parametrize("variant", list(sweep_accuracy.VARIANTS))
def test_sweep_variant_matches_jax(jsp, variant):
    from splatt3r_slam_tpu import config as jcfg
    from splatt3r_slam_tpu.tracking.tracker import TrackingConfig as JTC
    from splatt3r_slam_tpu_torch import config as tcfg
    from splatt3r_slam_tpu_torch.tracking.tracker import TrackingConfig

    base = str(ROOT / "config" / "base.yaml")
    kw = sweep_accuracy.VARIANTS[variant]
    H, W = sweep_accuracy.H, sweep_accuracy.W
    out = []
    for sp, cfgmod, TC in ((tsp, tcfg, TrackingConfig), (jsp, jcfg, JTC)):
        saved = cfgmod.config
        cfgmod.load_config(base)
        tc = TC.from_config(cfgmod.config)
        cfgmod.set_global_config(saved)
        sc = sp.make_scene(H, W)
        rng = np.random.default_rng(0)
        views = sp.make_trajectory(sc, 2, rng)
        Xc = sp.cross_pointmap(sc, views[0], views[1]["T"], rng)
        out.append(sp.track_pair(sc, views[1], views[0], Xc, tc, **kw))
    (ang, terr, fail, frac), (j_ang, j_terr, j_fail, j_frac) = out
    assert not fail and not j_fail
    assert frac == pytest.approx(j_frac, abs=1e-4) and frac > 0.3
    # the angle through its cosine: arccos at ~0.6 degrees multiplies the
    # fp32 rounding of the pose (~1e-7) by 1/sin(angle) ~ 90
    cos = [np.cos(np.radians(a)) for a in (ang, j_ang)]
    assert abs(cos[0] - cos[1]) <= 1e-6 and abs(terr - j_terr) <= 1e-4
    assert terr < 0.1


def test_backend_solve_gn_stride4_matches_jax(jsp):
    ates = []
    for sp in (tsp, jsp):
        sc = sp.make_scene(48, 64)
        rng = np.random.default_rng(100)
        views = sp.make_trajectory(sc, 4, rng)
        ates.append(sp.solve_graph(sc, views, rng, gn_stride=4))
    assert ates[0] == pytest.approx(ates[1], abs=1e-4)
    assert ates[0] < 0.05


# -- host tools ---------------------------------------------------------------
def test_compute_ate_matches_jax_cli(tmp_path, monkeypatch, capsys):
    gt = FIXTURE / "groundtruth.txt"
    rows = [ln.split() for ln in gt.read_text().splitlines()
            if ln and not ln.startswith("#")]
    rng = np.random.default_rng(5)
    est = tmp_path / "est.txt"
    est.write_text("".join(
        f"{r[0]} " + " ".join(f"{float(x) + 0.01 * rng.normal():.6f}"
                              for x in r[1:4]) + " " + " ".join(r[4:]) + "\n"
        for r in rows))
    jca = load_script("compute_ate")
    for flags in ([], ["--no-scale"]):
        monkeypatch.setattr(sys, "argv",
                            ["compute_ate.py", str(gt), str(est), *flags])
        capsys.readouterr()
        assert jca.main() == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        got = compute_ate.main([str(gt), str(est), "--device", "cpu",
                                *flags])
        capsys.readouterr()
        assert want["ate_rmse"] > 1e-3
        assert abs(got["ate_rmse"] - want["ate_rmse"]) <= 1e-9
        assert (got["gt"], got["est"]) == (want["gt"], want["est"])
    same = compute_ate.main([str(gt), str(gt), "--device", "cpu"])
    assert same["ate_rmse"] < 1e-9


def _vgg_state_dict(seed=0):
    """A fabricated `lpips.LPIPS('vgg')` state dict: the module's keys and
    shapes, seeded values."""
    from splatt3r_slam_tpu_torch.utils.lpips import LIN_CHANNELS, VGG_SLICES

    g = torch.Generator().manual_seed(seed)
    base = [0, 4, 9, 16, 23]
    sd = {}
    for s, block in enumerate(VGG_SLICES):
        for idx, cin, cout in block:
            stem = f"net.slice{s + 1}.{idx - base[s]}"
            sd[stem + ".weight"] = torch.randn(cout, cin, 3, 3, generator=g)
            sd[stem + ".bias"] = torch.randn(cout, generator=g)
        sd[f"lin{s}.model.1.weight"] = torch.rand(
            1, LIN_CHANNELS[s], 1, 1, generator=g)
    return sd


def test_convert_lpips_matches_jax_script(tmp_path, monkeypatch):
    from splatt3r_slam_tpu_torch.utils.lpips import (
        convert_torch_lpips,
        load_lpips_params,
    )

    sd = _vgg_state_dict()
    pt = tmp_path / "lpips_vgg.pt"
    torch.save(sd, pt)
    jcl = load_script("convert_lpips")
    monkeypatch.setattr(sys, "argv", ["convert_lpips.py", "--from-file",
                                      str(pt), str(tmp_path / "jax.npz")])
    jcl.main()
    res = convert_lpips.main(["--from-file", str(pt),
                              str(tmp_path / "port.npz"), "--device", "cpu"])
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files) and res["arrays"] == 31
    for k in b.files:
        assert a[k].dtype == b[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # and the file loads back to the converted tree
    back, want = load_lpips_params(str(tmp_path / "port.npz")), \
        convert_torch_lpips(sd)
    for x, y in zip(back["convs"], want["convs"]):
        for cx, cy in zip(x, y):
            assert torch.equal(cx["kernel"], cy["kernel"])
            assert torch.equal(cx["bias"], cy["bias"])
    for x, y in zip(back["lins"], want["lins"]):
        assert torch.equal(x, y)
    with pytest.raises(ImportError):
        convert_lpips.main(["--from-lpips", str(tmp_path / "x.npz"),
                            "--device", "cpu"])


def test_make_tum_fixture_equals_committed(tmp_path):
    from splatt3r_slam_tpu_torch.utils.image import read_png

    out = tmp_path / "fixture"
    res = make_tum_fixture.main(["--out", str(out), "--frames", "24",
                                 "--device", "cpu"])
    assert res["frames"] == 24
    for name in ("rgb.txt", "groundtruth.txt"):
        assert (out / name).read_bytes() == (FIXTURE / name).read_bytes()
    want = sorted(p.name for p in (FIXTURE / "rgb").glob("*.png"))
    assert sorted(p.name for p in (out / "rgb").glob("*.png")) == want
    for name in want:
        np.testing.assert_array_equal(read_png(out / "rgb" / name),
                                      read_png(FIXTURE / "rgb" / name))


# -- every new entry point asks for the card by default -----------------------
@pytest.mark.parametrize("main,argv", [
    (bench_rasterizer.main, []),
    (bench_rasterizer_grad.main, []),
    (bench_heads_batched.main, []),
    (bench_attention.main, []),
    (sweep_accuracy.main, []),
    (compute_ate.main, ["gt.txt", "est.txt"]),
    (convert_lpips.main, ["--from-file", "x.pt", "out.npz"]),
    (make_tum_fixture.main, ["--out", "unused"]),
    (probe_wide_forward.main, []),
], ids=lambda x: getattr(x, "__module__", "").rsplit(".", 1)[-1] or None)
def test_default_device_is_cuda_and_raises_without_gpu(main, argv,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
