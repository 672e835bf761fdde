"""The port's whole per-frame slice against the JAX package.

The tiny fp32 two-view model (JAX weights carried by `params_from_jax`) at
48x64, following the tests/test_fused.py fixture (base.yaml with
max_iters 4, min_match_frac 0, matching max_iter 2; match_stride 2 as
base.yaml sets it), drives create_frame → SLAMSystem.process_frame (fused
tracker) → GaussianAccumulator appends → ensure_gaussians + render_frame on
every frame, in both packages on the same numpy frames. Compared per frame:
mode, T_WC, keyframe count, gaussian pool size and the rendered image.

Two runs cover both branches of the state machine that random weights can
reach. With GN iterations on, the random model has no valid match, so the
solve fails into RELOC; as tests/test_fused.py does, the loop puts the
system back into TRACKING so that every frame runs the tracking step. With
max_iters 0 the solve passes the pose through, every frame folds into the
keyframe and (no match survives) becomes the next keyframe, which drives
the keyframe-state resync and the gaussian append on every frame.

Tolerances: poses 2e-4 (tests/test_fused.py's fused-vs-modular bar; here
they agree exactly because no GN step is taken); gaussian predictions and
pool means 1e-4 relative to their largest value (fp32 on both sides, sums
in another order); images 2e-3 (the compositor bar of
tests/test_pallas_rasterizer.py: the JAX side is the XLA tile compositor,
the port's the plain one), rendered from the same predictions, because
fp32 noise in depth can reorder a tile's list through the 18-bit depth
keys and the k_max cap. The port's render of its own predictions must be
finite and of the frame's shape.
"""

import copy
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu import config as jcfg
from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.models import init_model as j_init
from splatt3r_slam_tpu.runtime.frame import Mode as JMode
from splatt3r_slam_tpu.runtime.frame import create_frame as j_create_frame
from splatt3r_slam_tpu.runtime.inference import InferenceEngine as JEngine
from splatt3r_slam_tpu.runtime.system import SLAMSystem as JSystem
from splatt3r_slam_tpu.splat import GaussianAccumulator as JAccumulator
from splatt3r_slam_tpu.splat.decoder import render_frame as j_render
from splatt3r_slam_tpu_torch import config as tcfg
from splatt3r_slam_tpu_torch import resolve_device
from splatt3r_slam_tpu_torch.models import Splatt3RModel, TwoViewConfig
from splatt3r_slam_tpu_torch.models.checkpoint import (
    load_state_dict,
    params_from_jax,
)
from splatt3r_slam_tpu_torch.runtime.frame import Mode as TMode
from splatt3r_slam_tpu_torch.runtime.frame import create_frame
from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
from splatt3r_slam_tpu_torch.splat import GaussianAccumulator
from splatt3r_slam_tpu_torch.splat.decoder import render_frame
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 48, 64
N_FRAMES = 4


@pytest.fixture(scope="module")
def engines():
    saved = (copy.deepcopy(jcfg.config), copy.deepcopy(tcfg.config))
    jcfg.load_config(str(ROOT / "config" / "base.yaml"))
    tcfg.reset_config()
    for c in (jcfg.config, tcfg.config):
        c["tracking"]["max_iters"] = 4
        c["tracking"]["min_match_frac"] = 0.0
        c["matching"]["max_iter"] = 2
    assert jcfg.config["matching"]["match_stride"] == 2
    assert tcfg.config == jcfg.config  # built-in defaults == base.yaml
    jm, jp = j_init(JConfig(dtype="float32", head_dtype="float32").tiny(),
                    H, W)
    tm = Splatt3RModel(TwoViewConfig(dtype="float32",
                                     head_dtype="float32").tiny())
    assert load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                               tm.cfg)) == []
    yield JEngine(jm, jp, H, W), InferenceEngine(tm, H, W)
    jcfg.set_global_config(saved[0])
    tcfg.set_global_config(saved[1])


def _frames():
    rng = np.random.default_rng(0)
    base = (rng.random((2 * H, 2 * W, 3)) * 255).astype(np.uint8)
    return [base[i:i + H, 2 * i:2 * i + W] for i in range(N_FRAMES)]


def _cmp_rel(got, want, rtol=1e-4):
    """|got - want| <= rtol * max(1, max|want|): the random model's
    activations reach 1e6, and fp32 sums in another order differ relative
    to that scale (as in test_torch_port_model.py)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=rtol * scale)


def _depth_ordered_jax_render(monkeypatch):
    """Make the JAX package's `render_frame` hand its tile renderer the
    gaussians in depth order: the random model's depths span orders of
    magnitude, so its 18-bit depth keys tie and composite in index order,
    where the port's binning uses the exact depth order
    (`tests/test_torch_port_rasterizer.py::
    test_depth_key_ties_composite_in_depth_order`). In depth order the two
    orders agree. `render_frame` runs eagerly so that the patch is seen."""
    import jax.numpy as jnp

    from splatt3r_slam_tpu.splat import decoder as jdec
    from splatt3r_slam_tpu.splat import rasterizer as jr

    def render_tiles(means, covs, cols, opas, view, K, hw, *a, **kw):
        _, _, depth, _, ok = jr.project_gaussians(means, covs, opas, view, K,
                                                  hw)
        o = jnp.argsort(jnp.where(ok, depth, jnp.inf), stable=True)
        return jr.render_tiles(means[o], covs[o], cols[o], opas[o], view, K,
                               hw, *a, **kw)

    monkeypatch.setattr(jdec, "render_tiles", render_tiles)
    monkeypatch.setattr(jdec, "_render_frame_jit",
                        jdec._render_frame_jit.__wrapped__)


@pytest.mark.parametrize("max_iters", [4, 0])
def test_slice_matches_jax(engines, max_iters, monkeypatch):
    _depth_ordered_jax_render(monkeypatch)
    je, te = engines
    jcfg.config["tracking"]["max_iters"] = max_iters
    tcfg.config["tracking"]["max_iters"] = max_iters
    jsys = JSystem(je, H, W, gaussian_module=JAccumulator())
    tsys = SLAMSystem(te, H, W, gaussian_module=GaussianAccumulator(),
                      max_gaussians=1 << 16)
    modes = []
    for i, img in enumerate(_frames()):
        jf = j_create_frame(i, img, img_size=W)
        tf = create_frame(i, img, img_size=W, device="cpu")
        jmode, _ = jsys.process_frame(jf)
        tmode, _ = tsys.process_frame(tf)
        assert tmode.name == jmode.name, (i, tmode, jmode)
        modes.append(tmode.name)
        for s, m in ((jsys, JMode), (tsys, TMode)):
            if s.mode == m.RELOC:
                s.mode = m.TRACKING
        np.testing.assert_allclose(tf.T_WC.numpy(), np.asarray(jf.T_WC),
                                   atol=2e-4)
        assert len(tsys.keyframes) == len(jsys.keyframes), i
        assert tsys.pool.n == jsys.pool.n, i
        _cmp_rel(tsys.pool.get_all()[0], jsys.pool.get_all()[0])

        je.ensure_gaussians(jf)
        te.ensure_gaussians(tf)
        for view in ("gaussian_pred", "gaussian_pred_cross"):
            for k, v in getattr(jf, view).items():
                _cmp_rel(getattr(tf, view)[k], v)
        jkf = jsys.keyframes.last_keyframe()
        tkf = tsys.keyframes.last_keyframe()
        want = np.asarray(j_render(jf, jkf))
        own = render_frame(tf, tkf)
        assert own.shape == (H, W, 3) and torch.isfinite(own).all()
        # the render itself on identical gaussians: the predictions agree
        # only to fp32 noise, and the k_max cap turns noise in depth into
        # another per-tile list, so the image is held on the JAX frame's
        # own predictions
        for view in ("gaussian_pred", "gaussian_pred_cross"):
            setattr(tf, view, {k: torch.from_numpy(np.array(v))
                               for k, v in getattr(jf, view).items()})
        np.testing.assert_allclose(render_frame(tf, tkf).numpy(), want,
                                   atol=2e-3)
    if max_iters:
        assert modes[1:] == ["RELOC"] * (N_FRAMES - 1)
    else:
        assert modes[1:] == ["TRACKING"] * (N_FRAMES - 1)
        assert len(tsys.keyframes) == N_FRAMES


def test_run_loop_matches_process_frame(engines):
    """SLAMSystem.run (frames through the one-deep FramePrefetcher) gives
    the same keyframes and poses as calling process_frame frame by frame."""
    _, te = engines
    tcfg.config["tracking"]["max_iters"] = 0
    imgs = _frames()
    dataset = [(f"{i}", img) for i, img in enumerate(imgs)]  # (ts, image)
    res = SLAMSystem(te, H, W, max_gaussians=1 << 16).run(dataset,
                                                          verbose=False)
    ref = SLAMSystem(te, H, W, max_gaussians=1 << 16)
    for i, img in enumerate(imgs):
        ref.process_frame(create_frame(i, img, img_size=W, device="cpu"))
    assert res.n_frames == N_FRAMES
    assert len(res.keyframes) == len(ref.keyframes) == N_FRAMES
    for a, b in zip(res.keyframes.frames, ref.keyframes.frames):
        assert torch.equal(a.T_WC, b.T_WC) and torch.equal(a.X_canon,
                                                           b.X_canon)


def test_port_imports_no_jax():
    """Every port module imports without jax or the JAX package, and
    without cv2 (the GPU host has none)."""
    pkg = ROOT / "splatt3r_slam_tpu_torch"
    mods = sorted(
        "splatt3r_slam_tpu_torch." + ".".join(
            p.relative_to(pkg).with_suffix("").parts).replace(".__init__", "")
        for p in pkg.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'splatt3r_slam_tpu' or m.startswith('splatt3r_slam_tpu.')"
        " or m == 'cv2']\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 50
    assert {"splatt3r_slam_tpu_torch." + m for m in (
        "train", "parallel", "parallel.trainer", "parallel.loss_mask",
        "parallel.logging", "parallel.workspace", "parallel.export",
        "utils.metrics", "utils.lpips", "splat.decoder",
        "splat.cuda_rasterizer", "__main__", "cli", "utils.image",
        "runtime.dataloader", "runtime.evaluate", "runtime.tracker",
        "ops.pose_graph", "backend", "backend.factor_graph", "retrieval",
        "retrieval.model", "retrieval.asmk", "retrieval.database", "bench",
        "scripts", "scripts._common", "scripts.bench_system", "scripts.soak",
        "scripts.profile_stages", "scripts.profile_keyframe_event",
        "demo", "utils.draw", "runtime.visualization",
        "runtime.session", "runtime.webdemo",
        "scripts.sweep_rasterizer_fidelity")
    } <= set(mods)


def test_cuda_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        create_frame(0, np.zeros((H, W, 3), np.uint8), img_size=W)
    assert resolve_device("cpu").type == "cpu"


def test_create_frame_matches_jax_and_refuses_resizing():
    """At the working size and for a frame that needs resizing (which the
    port refused before it had host resizing): the same image, shape and
    uint8 pixels as the JAX create_frame (tests/test_torch_port_io.py
    holds the resize itself within one uint8 step of the native helper;
    on these frames it is exact)."""
    rng = np.random.default_rng(3)
    for img, size in ((_frames()[1], W),
                      ((rng.random((40, 60, 3)) * 255).astype(np.uint8), 64)):
        f = create_frame(3, img, img_size=size, device="cpu")
        jf = j_create_frame(3, img, img_size=size)
        np.testing.assert_allclose(f.img.numpy(), np.asarray(jf.img),
                                   atol=1e-6)
        np.testing.assert_array_equal(f.img_shape, np.asarray(jf.img_shape))
        np.testing.assert_array_equal(f.uimg, np.asarray(jf.uimg))
