"""The port's flash-attention path against the JAX package's.

`splatt3r_slam_tpu_torch/models/flash_attention.py` (the kernel's plain
version, which the wrapper runs for CPU tensors), the selection rule in
`models/layers.py`, the modules and the tracking slice with the mode
"on", and the CLI flag. The JAX side runs its real Pallas TPU kernel
(`models/layers.py::_attend_flash` → `_flash_attention_kernel`) on the
CPU under `pltpu.force_tpu_interpret_mode()`. All inputs come from numpy
with a seed. The CUDA kernel itself runs only on the card
(`chip_smoke.py`'s `flash` phase holds it against the plain version).

Tolerances and what this CPU measured:
- plain version against the Pallas kernel, fp32: 1e-5 absolute (both
  exact fp32 with sums in another order; measured at most 1.2e-7);
- the same in bf16: 2^-7·max|want|, two bf16 ulps of the output's peak
  (both round the unnormalised p to bf16 against the same 128-row block
  maxima, and the output to bf16; measured at most 0.43 of the bar);
- plain version against the JAX einsum `_attend` in fp32: 5e-3, the bar
  of the JAX TPU test (tests/test_flash_attention.py; measured at most
  6.0e-7);
- `Attention` and `CrossAttention` with "on" against the JAX modules
  with "on": fp32 1e-5 of the output's peak; bf16 2^-6 of the peak (the
  attention output is rounded to bf16 on both sides, and a value that
  falls on the other side of a rounding boundary moves the bf16 output
  projection by up to one bf16 step of its own sum; measured at most
  0.04 of the fp32 bar and 0.30 of the bf16 one);
- the slice: poses 2e-4, pointmaps and confidences 1e-4 of their peak,
  the bars of tests/test_torch_port_slice.py::test_slice_matches_jax
  (measured: poses equal, pointmaps 2.9e-5, confidences 9.0e-6).
"""

import copy
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from splatt3r_slam_tpu import config as jcfg
from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.models import layers as JL
from splatt3r_slam_tpu.models.checkpoint import convert_state_dict
from splatt3r_slam_tpu.models.two_view import Splatt3RModel as JModel
from splatt3r_slam_tpu.runtime.frame import Mode as JMode
from splatt3r_slam_tpu.runtime.frame import create_frame as j_create_frame
from splatt3r_slam_tpu.runtime.inference import InferenceEngine as JEngine
from splatt3r_slam_tpu.runtime.system import SLAMSystem as JSystem
from splatt3r_slam_tpu_torch import cli, cuda_build
from splatt3r_slam_tpu_torch import config as tcfg
from splatt3r_slam_tpu_torch.models import Splatt3RModel, TwoViewConfig
from splatt3r_slam_tpu_torch.models import flash_attention as fa
from splatt3r_slam_tpu_torch.models import init_model
from splatt3r_slam_tpu_torch.models import layers as TL
from splatt3r_slam_tpu_torch.models.checkpoint import (
    _lin,
    load_state_dict,
    params_from_jax,
)
from splatt3r_slam_tpu_torch.runtime.frame import Mode as TMode
from splatt3r_slam_tpu_torch.runtime.frame import create_frame
from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
from splatt3r_slam_tpu_torch.scripts import bench_attention
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CUDA = torch.device("cuda")  # the rule reads the device's type only


@pytest.fixture(autouse=True)
def auto_mode():
    """Every test starts and ends with both packages in "auto"."""
    JL.set_flash_attention("auto")
    TL.set_flash_attention("auto")
    yield
    JL.set_flash_attention("auto")
    TL.set_flash_attention("auto")


@pytest.fixture
def calls(monkeypatch):
    """Counts: the JAX flash kernel's completed calls (its `_attend` drops
    to einsum on an error, so only a returned call counts), the port's
    plain flash calls and the port's `attend` calls."""
    n = {"jax_flash": 0, "flash": 0, "attend": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            n[key] += 1
            return out
        return wrapped

    monkeypatch.setattr(JL, "_attend_flash",
                        counting("jax_flash", JL._attend_flash))
    monkeypatch.setattr(fa, "flash_attention_torch",
                        counting("flash", fa.flash_attention_torch))
    monkeypatch.setattr(TL, "attend", counting("attend", TL.attend))
    return n


def _qkv(shape, dtype, seed):
    B, nq, nk, H, D = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, n, H, D)).astype(np.float32)
            for n in (nq, nk, nk)]


# -- the plain version against the Pallas TPU kernel -------------------------

CASES = ((1, 256, 256, 2, 64), (2, 768, 768, 2, 64), (1, 256, 512, 1, 64),
         (1, 256, 256, 1, 128))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CASES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_kernel(shape, dtype):
    arrays = _qkv(shape, dtype, seed=sum(shape))
    scale = shape[-1] ** -0.5
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JL._attend_flash(jq, jk, jv, scale)
                          .astype(jnp.float32))
    got = fa.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                               for a in arrays), scale)
    B, nq, _, H, D = shape
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, nq, H, D) and got.is_contiguous()
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "bfloat16":
        assert err <= 2 ** -7 * np.abs(want).max(), err
        return
    assert err <= 1e-5, err
    JL.set_flash_attention("off")
    einsum = np.asarray(JL._attend(jq, jk, jv, scale))
    assert np.abs(got.numpy() - einsum).max() <= 5e-3


def test_plain_follows_the_kernel_steps():
    """Across 128-row kv blocks the running max and sum carry over: in
    fp32 the plain version is softmax attention (against float64); in
    bf16 with one block it is p = exp(s - max) rounded to bf16, times v,
    over the fp32 sum of the unrounded p."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 128, 384, 2, 64),
                                                  "float32", seed=3))
    scale = 0.125
    s = torch.einsum("bnhd,bmhd->bhnm", q.double(), k.double()) * scale
    want = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v.double())
    got = fa.flash_attention_torch(q, k, v, scale)
    assert float((got.double() - want).abs().max()) < 1e-6
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    one = fa.flash_attention_torch(qb, kb, vb, scale, block_k=384)
    s = torch.einsum("bnhd,bmhd->bhnm", qb.double(), kb.double()) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True)).float()
    ref = torch.einsum("bhnm,bmhd->bnhd", p.bfloat16().double(),
                       vb.double()) / p.double().sum(-1)[..., None] \
        .transpose(1, 2)
    # one bf16 rounding of the output apart at most
    assert float((one.double() - ref).abs().max()) <= \
        2 ** -8 * float(ref.abs().max())
    unrounded = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1),
                             vb.double())
    assert not torch.equal(one, unrounded.bfloat16())


# -- the selection rule (tests/test_flash_attention.py::TestFlashHeuristic) --

class TestFlashSelection:
    def test_auto_rejects_tracking_shape(self):
        # production tracking shape: 768 q/kv tokens, head dim 64
        assert not TL._flash_wanted(768, 768, 64, CUDA)
        assert not TL._flash_wanted(768, 768, 64, "cpu")

    def test_auto_accepts_huge_shape_on_the_card_only(self):
        assert TL._flash_wanted(4096, 4096, 64, CUDA)
        assert not TL._flash_wanted(4096, 4096, 64, "cpu")
        assert not TL._flash_wanted(4096, 3840, 64, CUDA)  # below 4096²

    def test_on_requires_tileable_shape(self):
        TL.set_flash_attention("on")
        for dev in (CUDA, "cpu"):
            assert TL._flash_wanted(768, 768, 64, dev)
            assert not TL._flash_wanted(100, 768, 64, dev)  # n_q % 256
            assert not TL._flash_wanted(768, 700, 64, dev)  # n_kv % 256
            assert not TL._flash_wanted(768, 768, 48, dev)  # dh % 64

    def test_off_wins(self):
        TL.set_flash_attention("off")
        assert not TL._flash_wanted(4096, 4096, 64, CUDA)

    def test_bad_mode_rejected(self):
        TL.set_flash_attention("on")
        with pytest.raises(ValueError, match="fast"):
            TL.set_flash_attention("fast")
        assert TL.flash_attention_mode() == "on"

    @pytest.mark.parametrize("mode", ["auto", "on", "off"])
    def test_rule_is_the_jax_rule(self, mode):
        """The shape rule equals the JAX package's; so does the whole rule
        on the CPU (where JAX's auto never picks the kernel either)."""
        JL.set_flash_attention(mode)
        TL.set_flash_attention(mode)
        for nq in (64, 100, 256, 512, 768, 4096):
            for nk in (256, 700, 768, 4096):
                for dh in (32, 48, 64, 128, 192, 256, 320):
                    assert TL._flash_shape_ok(nq, nk, dh) == \
                        JL._flash_shape_ok(nq, nk, dh)
                    assert TL._flash_wanted(nq, nk, dh, "cpu") == \
                        JL._flash_wanted(nq, nk, dh), (nq, nk, dh)


def test_attend_routes_by_mode(calls):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 256, 512, 2, 64),
                                                  "float32", seed=4))
    for mode, flash in (("on", 1), ("auto", 0), ("off", 0)):
        TL.set_flash_attention(mode)
        calls["flash"] = 0
        got = TL.attend(q, k, v, 0.125)
        assert calls["flash"] == flash, mode
        want = (fa.flash_attention_torch if flash else TL.attend_sdpa)(
            q, k, v, 0.125)
        assert torch.equal(got, want)


def test_head_dim_above_256_is_refused():
    """A standing difference: the shape rule admits Dh 320 (any multiple
    of 64), the JAX package's flash kernel takes it, and the port's kernel
    is built for Dh up to 256, so `attend` with "on" raises there (on the
    CPU as on the card) instead of attending another way."""
    assert TL._flash_shape_ok(256, 256, 320) and JL._flash_shape_ok(256, 256,
                                                                      320)
    TL.set_flash_attention("on")
    q, k, v = (torch.zeros(1, 256, 1, 320) for _ in range(3))
    with pytest.raises(ValueError, match="head dim 320"):
        TL.attend(q, k, v, 0.05)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    z = torch.zeros
    bad = [
        ((z(1, 256, 1, 64), z(1, 256, 1, 64, dtype=torch.bfloat16),
          z(1, 256, 1, 64)), "one dtype"),
        ((z(1, 256, 1, 64, dtype=torch.float16),) * 3, "one dtype"),
        ((z(1, 100, 1, 64), z(1, 256, 1, 64), z(1, 256, 1, 64)),
         "multiples of 64"),
        ((z(1, 256, 1, 64), z(1, 256, 1, 64), z(1, 128, 1, 64)), "k and v"),
        ((z(256, 1, 64),) * 3, r"\(B, N, H"),
        ((z(1, 256, 1, 96),) * 3, "head dim 96"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            fa.flash_attention(*args, 0.125)


def test_strided_v_is_read_in_place():
    """The kernel takes v as the fused qkv projection hands it over (row
    stride 3·H·Dh), with no copy; a row that is not 16-byte aligned is
    refused."""
    B, N, H, D = 2, 256, 3, 64
    qkv = torch.zeros(B, N, 3 * H * D, dtype=torch.bfloat16)
    q, k, v = qkv.reshape(B, N, 3, H, D).unbind(2)
    assert fa._strides("v", v) == (N * 3 * H * D, 3 * H * D, D)
    assert v.data_ptr() == qkv.data_ptr() + 2 * H * D * 2
    with pytest.raises(ValueError, match="aligned"):
        fa._strides("v", qkv.reshape(-1)[1:1 + B * N * H * D].reshape(
            B, N, H, D))
    with pytest.raises(ValueError, match="contiguous last"):
        fa._strides("v", v.transpose(2, 3))


@pytest.mark.parametrize("name", list(cuda_build.KERNELS))
def test_registry_matches_the_c_entry_points(name):
    """Each registered entry point exists in its source with one parameter
    per registered argument type, and the stream last (no compiler here
    to check the ctypes binding against)."""
    source, entry, argtypes = cuda_build.KERNELS[name]
    code = source.read_text()
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', code)
    assert sig, entry
    params = [p.strip() for p in sig.group(1).split(",")]
    assert len(params) == len(argtypes) + 1
    assert params[-1] == "void* stream"
    for p, t in zip(params, argtypes):
        want = {"c_void_p": "*", "c_int": "int ", "c_long": "long long ",
                "c_float": "float "}[t.__name__]
        assert want in p, (p, t)


@pytest.mark.parametrize("name, case", [
    ("flash_attention", r"case (\d+): return flash::launch<\d+>"),
    ("flash_attention_bwd_dkv", r"case (\d+): return launch<\d+, DKV>"),
    ("flash_attention_bwd_dq", r"case (\d+): return launch<\d+, DKV>")])
def test_flash_source_is_hand_written(name, case):
    """The forward is mma.sync written out, fed by cp.async; the two
    backward kernels are wgmma written out, fed by TMA into an mbarrier
    ring; each with one template instance per head dim the wrapper admits,
    no library on the route and (backward) no atomics."""
    code = cuda_build.KERNELS[name][0].read_text()
    uses = {
        "flash_attention": (
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
            "cp.async.cg.shared.global"),
    }.get(name, ("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                 "wgmma.wait_group", "mbarrier.try_wait.parity",
                 "mbarrier.arrive.expect_tx", "cp.async.bulk.tensor.4d",
                 "CU_TENSOR_MAP_SWIZZLE_128B"))
    for op in uses:
        assert op in code, op
    for banned in ("cublas", "cudnn", "cutlass", "torch", "#include <mma"):
        assert banned not in code.lower(), banned
    ops = re.sub(r"//[^\n]*", "", code).lower()  # without the comments
    assert not re.search(r"\b(atomic|atom\.|red\.)", ops)
    assert tuple(int(d) for d in re.findall(case, code)) == fa.HEAD_DIMS
    csrc = cuda_build.KERNELS[name][0].parent
    assert {p.name for p in csrc.glob("*.cu")} == {
        s.name for s, _, _ in cuda_build.KERNELS.values()}


# -- the modules with "on" ---------------------------------------------------

def _rope(n_side, dh, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n_side[0]), np.arange(n_side[1]),
                         indexing="ij")
    pos = np.stack([yy, xx], -1).reshape(1, -1, 2)[:, rng.permutation(
        n_side[0] * n_side[1])]
    return (JL.rope_cos_sin(jnp.asarray(pos), dh // 2),
            TL.rope_cos_sin(torch.from_numpy(pos), dh // 2))


def _module_weights(params, names):
    out = {}
    for n in names:
        _lin(params["params"][n], n, out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_modules_match_jax(dtype, calls):
    """Attention (256 tokens) and CrossAttention (256 queries over 512
    keys) at Dh 64, both packages with "on", on one set of weights."""
    dim, heads = 128, 2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 256, dim)).astype(np.float32)
    y = rng.standard_normal((1, 512, dim)).astype(np.float32)
    (jx_cs, tx_cs), (jy_cs, ty_cs) = (_rope(s, dim // heads, i)
                                       for i, s in ((7, (16, 16)),
                                                    (8, (16, 32))))
    JL.set_flash_attention("on")
    TL.set_flash_attention("on")
    cases = []
    ja = JL.Attention(dim, heads, jdt)
    pa = ja.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt), jx_cs)
    ta = TL.Attention(dim, heads, dtype)
    ta.load_state_dict(_module_weights(pa, ("qkv", "proj")))
    cases.append((lambda: ja.apply(pa, jnp.asarray(x, jdt), jx_cs),
                   lambda: ta(torch.from_numpy(x).to(tdt), tx_cs)))
    jc = JL.CrossAttention(dim, heads, jdt)
    pc = jc.init(jax.random.PRNGKey(1), jnp.asarray(x, jdt),
                 jnp.asarray(y, jdt), jnp.asarray(y, jdt), jx_cs, jy_cs)
    tc = TL.CrossAttention(dim, heads, dtype)
    tc.load_state_dict(_module_weights(pc, ("projq", "projk", "projv",
                                            "proj")))
    cases.append((
        lambda: jc.apply(pc, jnp.asarray(x, jdt), jnp.asarray(y, jdt),
                         jnp.asarray(y, jdt), jx_cs, jy_cs),
        lambda: tc(torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt),
                   torch.from_numpy(y).to(tdt), tx_cs, ty_cs)))
    bar = 1e-5 if dtype == "float32" else 2 ** -6
    for i, (jrun, trun) in enumerate(cases):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jrun().astype(jnp.float32))
        with torch.no_grad():
            got = trun()
        assert got.dtype == tdt
        assert calls["jax_flash"] == calls["flash"] == calls["attend"] == \
            i + 1
        peak = np.abs(want).max()
        assert np.abs(got.float().numpy() - want).max() <= bar * peak


# -- the slice with "on" -----------------------------------------------------

SH, SW = 256, 512  # 16 x 32 patches: 512 tokens, no resize
NARROW = dict(enc_embed_dim=128, enc_num_heads=2, enc_depth=2,
              dec_embed_dim=64, dec_num_heads=1, dec_depth=2)


def _cmp_rel(got, want, rtol=1e-4):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=rtol * scale)


def test_slice_with_flash_matches_jax(calls):
    """The tracking slice (create_frame → SLAMSystem.process_frame, fused
    tracker, 4 GN iterations) on a narrow two-view model whose every
    attention has Dh 64 and 512 tokens, both packages with "on": every
    attention call of the port goes through the flash path and every one
    of the JAX package's through its Pallas kernel. Weights: a seeded
    torch state dict converted by the JAX package's converter and carried
    back by `params_from_jax` (as tests/test_torch_port_backend.py)."""
    saved = (copy.deepcopy(jcfg.config), copy.deepcopy(tcfg.config))
    try:
        jcfg.load_config(str(ROOT / "config" / "base.yaml"))
        tcfg.reset_config()
        for c in (jcfg.config, tcfg.config):
            c["tracking"]["max_iters"] = 4
            c["tracking"]["min_match_frac"] = 0.0
            c["matching"]["max_iter"] = 2
        cfg = TwoViewConfig(dtype="float32",
                            head_dtype="float32").tiny()._replace(**NARROW)
        jc = JConfig(dtype="float32",
                     head_dtype="float32").tiny()._replace(**NARROW)
        seed_model = init_model(cfg, seed=0, device="cpu")
        jp = jax.tree.map(jnp.asarray, convert_state_dict(
            {k: v.numpy() for k, v in seed_model.state_dict().items()}, jc))
        tm = Splatt3RModel(cfg)
        assert load_state_dict(tm, params_from_jax(
            jax.tree.map(np.asarray, jp), cfg)) == []
        JL.set_flash_attention("on")
        TL.set_flash_attention("on")
        jsys = JSystem(JEngine(JModel(jc), jp, SH, SW), SH, SW)
        tsys = SLAMSystem(InferenceEngine(tm, SH, SW), SH, SW)
        rng = np.random.default_rng(9)
        base = (rng.random((2 * SH, 2 * SW, 3)) * 255).astype(np.uint8)
        modes = []
        with pltpu.force_tpu_interpret_mode():
            for i in range(3):
                img = base[i:i + SH, 2 * i:2 * i + SW]
                jf = j_create_frame(i, img, img_size=SW)
                tf = create_frame(i, img, img_size=SW, device="cpu")
                assert tf.img.shape[1:3] == (SH, SW)
                jmode, _ = jsys.process_frame(jf)
                tmode, _ = tsys.process_frame(tf)
                assert tmode.name == jmode.name, (i, tmode, jmode)
                modes.append(tmode.name)
                for s, m in ((jsys, JMode), (tsys, TMode)):
                    if s.mode == m.RELOC:
                        s.mode = m.TRACKING
                np.testing.assert_allclose(tf.T_WC.numpy(),
                                           np.asarray(jf.T_WC), atol=2e-4)
                assert len(tsys.keyframes) == len(jsys.keyframes), i
                _cmp_rel(tf.X_canon, jf.X_canon)
                _cmp_rel(tf.C, jf.C)
    finally:
        jcfg.set_global_config(saved[0])
        tcfg.set_global_config(saved[1])
    assert modes[0] == "TRACKING" and len(modes) == 3
    assert calls["attend"] > 0 and calls["flash"] == calls["attend"]
    assert calls["jax_flash"] > 0  # traced once per jitted function


# -- the CLI and the entry points --------------------------------------------

@pytest.mark.parametrize("mode", ["on", "off", "auto"])
def test_cli_sets_the_mode(mode, monkeypatch):
    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    monkeypatch.setattr(tcfg, "load_config", stop)  # right after the mode
    TL.set_flash_attention("on" if mode == "off" else "off")
    with pytest.raises(Stop):
        cli.main(["--dataset", "unused", "--device", "cpu",
                  "--flash-attention", mode])
    assert TL.flash_attention_mode() == mode


def test_cuda_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_attention.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--dataset", "unused", "--flash-attention", "on"])
