"""Port two-view model against the JAX model at tiny fp32 dims.

Weights are carried by `params_from_jax` (flax tree → the port's
state_dict, which is the reference checkpoint key layout); a
`tests/torch_oracle.py` state dict is also fed to both packages. Stages
compared: encoder tokens, decoder hooks, and each head mode's outputs.
Tolerance: both sides run fp32 on the CPU (jax at "highest" matmul
precision); outputs differ only by summation order, so 1e-4 relative
(pts3d go through expm1 of the DPT output, which amplifies rounding —
hence relative, not absolute).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.models import init_model as j_init
from splatt3r_slam_tpu.models import layers as jl
from splatt3r_slam_tpu.models.checkpoint import (
    convert_state_dict,
    load_torch_file,
)
from splatt3r_slam_tpu_torch.models import TwoViewConfig, Splatt3RModel
from splatt3r_slam_tpu_torch.models import layers as tl
from splatt3r_slam_tpu_torch.models.checkpoint import (
    load_state_dict,
    load_torch_checkpoint,
    params_from_jax,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_oracle import TwoViewOracle  # noqa: E402
from test_torch_port_bench import one_torch_thread  # noqa: E402,F401

H, W = 48, 64


@pytest.fixture(scope="module")
def pair():
    cfg = JConfig(dtype="float32", head_dtype="float32").tiny()
    jm, jp = j_init(cfg, H, W)
    tm = Splatt3RModel(TwoViewConfig(dtype="float32",
                                     head_dtype="float32").tiny()).eval()
    assert load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                               tm.cfg)) == []
    return jm, jp, tm


def _imgs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
            for _ in range(2)]


def _cmp(got, want, rtol=1e-4):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=rtol * scale)


def _forward_both(jm, jp, tm, a, b):
    j1 = jm.apply({"params": jp}, jnp.asarray(a), method=jm.encode)
    j2 = jm.apply({"params": jp}, jnp.asarray(b), method=jm.encode)
    jd = jm.apply({"params": jp}, *j1, *j2, method=jm.decode)
    with torch.no_grad():
        t1 = tm.encode(torch.from_numpy(a))
        t2 = tm.encode(torch.from_numpy(b))
        td = tm.decode(*t1, *t2)
    return (j1, j2, jd), (t1, t2, td)


def test_encoder_and_decoder_hooks(pair):
    jm, jp, tm = pair
    (j1, j2, jd), (t1, t2, td) = _forward_both(jm, jp, tm, *_imgs())
    _cmp(t1[0], j1[0])
    np.testing.assert_array_equal(t1[1].numpy(), np.asarray(j1[1]))
    for jv, tv in zip(jd, td):
        for x, y in zip(jv, tv):
            _cmp(y, x)


@pytest.mark.parametrize("mode", ["full", "tracking", "gaussian_only"])
def test_head_modes(pair, mode):
    jm, jp, tm = pair
    (_, _, jd), (_, _, td) = _forward_both(jm, jp, tm, *_imgs(1))
    for head in (1, 2):
        want = jm.apply({"params": jp}, head, jd[head - 1], (H, W), mode,
                        method=jm.apply_head)
        with torch.no_grad():
            got = tm.apply_head(head, td[head - 1], (H, W), mode)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            _cmp(got[k], want[k])


def test_oracle_state_dict_feeds_both(tmp_path):
    """One fabricated reference state dict (Lightning .ckpt layout) loads
    into the JAX package through its converter and into the port without
    conversion; both then give the same two-view outputs."""
    torch.manual_seed(3)
    jcfg = JConfig(dtype="float32", head_dtype="float32").tiny()
    oracle = TwoViewOracle(enc_dim=jcfg.enc_embed_dim,
                           enc_depth=jcfg.enc_depth,
                           enc_heads=jcfg.enc_num_heads,
                           dec_dim=jcfg.dec_embed_dim,
                           dec_depth=jcfg.dec_depth,
                           dec_heads=jcfg.dec_num_heads)
    sd = {f"encoder.{k}": v for k, v in oracle.state_dict().items()}
    sd["lpips_criterion.scaling_layer.shift"] = torch.zeros(1, 3, 1, 1)
    path = tmp_path / "tiny.ckpt"
    torch.save({"state_dict": sd, "epoch": 1}, path)

    jm, _ = j_init(jcfg, H, W)
    jp = convert_state_dict(load_torch_file(str(path)), jcfg)
    tm = Splatt3RModel(TwoViewConfig(dtype="float32",
                                     head_dtype="float32").tiny()).eval()
    extra = load_state_dict(tm, load_torch_checkpoint(str(path)))
    assert extra == ["lpips_criterion.scaling_layer.shift"]
    a, b = _imgs(2)
    want = jm.apply({"params": jp}, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = tm(torch.from_numpy(a), torch.from_numpy(b))
    for wv, gv in zip(want, got):
        for k in ("pts3d", "conf", "desc", "scales", "opacities"):
            _cmp(gv[k], wv[k])


def test_layers_rope_resize_shuffle(rng):
    """RoPE (duplicated-half layout), align-corners resize and the NHWC
    pixel shuffle on asymmetric sizes."""
    pos = rng.integers(0, 7, size=(2, 10, 2)).astype(np.int32)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 8)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 8)
    _cmp(tc, jc, 1e-6)
    _cmp(ts, js, 1e-6)
    tok = rng.normal(size=(2, 10, 3, 16)).astype(np.float32)
    _cmp(tl.apply_rope2d(torch.from_numpy(tok), tc, ts),
         jl.apply_rope2d(jnp.asarray(tok), jc, js), 1e-6)
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    _cmp(tl.bilinear_resize_ac(torch.from_numpy(x), (7, 11)),
         jl.bilinear_resize_ac(jnp.asarray(x), (7, 11)), 1e-6)
    y = rng.normal(size=(1, 2, 3, 4 * 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.pixel_shuffle(torch.from_numpy(y), 2).numpy(),
        np.asarray(jl.pixel_shuffle(jnp.asarray(y), 2)))
    # and the NHWC shuffle is torch's NCHW pixel_shuffle, transposed
    ref = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(y).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(tl.pixel_shuffle(torch.from_numpy(y),
                                                   2).numpy(), ref.numpy())


def test_init_weights_follows_main_rule():
    """Seeded init: LayerNorm scale 1, biases 0, weights ~ N(0, 1/fan_in);
    the same seed gives the same weights."""
    from splatt3r_slam_tpu_torch.models import init_model

    cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    a = init_model(cfg, seed=5, device="cpu")
    b = init_model(cfg, seed=5, device="cpu")
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.all(sa["enc_norm.weight"] == 1)
    assert torch.all(sa["enc_blocks.0.attn.qkv.bias"] == 0)
    w = sa["enc_blocks.0.mlp.fc1.weight"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
