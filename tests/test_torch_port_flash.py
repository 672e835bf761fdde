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
- the fp32 kernel's arithmetic (split TF32 on 64- or 32-row kv tiles,
  O rescaled and divided by l once; at the wide head dims S summed in
  128-column slices as the wide backward sums it) against the Pallas
  kernel: 1e-5 absolute on the output, l within 1e-5 relative and m within
  1e-5 of its peak (both exact fp32 up to split TF32's 2^-20 and sums in
  another order; measured at most 1.0e-6, 3.1e-6 and 8.5e-7, at Dh 512);
  one TF32 pass misses the output's bar (measured 2.4e-4 at least);
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
import jax.experimental.pallas.ops.tpu.flash_attention as jfa
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
from flash_tf32 import mm_split
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
         (1, 256, 256, 1, 128), (1, 256, 256, 1, 384), (1, 256, 256, 1, 512))


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


def _wide_fwd_contract(qf, kf, passes):
    """S = Q·Kᵀ over Dh as the fp32 wide forward's clusters sum it
    (csrc/flash_attention.cu): Dh in n slices of 128 columns, a cluster of
    cs = n blocks up to 8 and above it ceil(n / 8) passes of clusters of cs
    = ceil(n / passes); block r's two chains (each slice's 32-column boxes
    0 and 2, and 1 and 3) each run on over its slices r, r + cs, ... in
    turn, added in fp32 after each slice; its partial is the two chains
    added, and the cs partials are added in rank order. Up to Dh 1024 (one
    slice a block) that is the fp32 wide backward's order
    (`test_torch_port_flash_bwd._contract`)."""
    n = qf.shape[-1] // 128
    rounds = -(-n // 8)
    cs = -(-n // rounds)
    total = None
    for r in range(cs):
        chains = []
        for boxes in ((0, 2), (1, 3)):
            chain = None
            for sl in range(r, n, cs):
                cols = torch.cat([torch.arange(128 * sl + 32 * x,
                                               128 * sl + 32 * x + 32)
                                  for x in boxes])
                part = mm_split(qf[..., cols], kf[..., cols].transpose(-1, -2),
                                passes)
                chain = part if chain is None else chain + part
            chains.append(chain)
        part = chains[0] + chains[1]
        total = part if total is None else total + part
    return total


def _fwd_scores(qf, kf, passes):
    """S = Q·Kᵀ of one kv tile as the fp32 forward kernels sum it over Dh:
    in one sum at the template instances' head dims; at the wide head dims
    as their clusters do (`_wide_fwd_contract`)."""
    if fa.wide_head_dim(qf.shape[-1]):
        return _wide_fwd_contract(qf, kf, passes)
    return mm_split(qf, kf.transpose(-1, -2), passes)


def _split_tf32_forward(q, k, v, scale, passes=3):
    """The fp32 kernel's steps, emulated: kv tiles of 64 rows at Dh 64, 32
    above (the wide kernel's too), S = Q·Kᵀ (`_fwd_scores`) and P·V in
    split TF32 (`mm_split`), then s·scale, the online softmax with O
    rescaled by exp(m_old - m_new) and one division by l at the end →
    (out, l, m) as `flash_attention_torch` gives them with `residuals`."""
    qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, D)
    B, H, n_q, D = qf.shape
    rows = 64 if D == 64 else 32
    m = torch.full((B, H, n_q, 1), float("-inf"))
    l = torch.zeros((B, H, n_q, 1))
    o = torch.zeros((B, H, n_q, D))
    for k0 in range(0, kf.shape[2], rows):
        s = _fwd_scores(qf, kf[:, :, k0:k0 + rows], passes) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm_split(p, vf[:, :, k0:k0 + rows], passes)
        m = m_new
    return (o / l).transpose(1, 2), l[..., 0], m[..., 0]


@pytest.mark.parametrize("shape", [(1, 256, 256, 2, 64),
                                   (1, 256, 512, 1, 128),
                                   (1, 256, 256, 1, 384),
                                   (1, 256, 256, 1, 512),
                                   (1, 128, 256, 1, 1152)],
                         ids=lambda s: "x".join(map(str, s)))
def test_split_tf32_forward_matches_pallas_kernel(shape):
    """The fp32 forward kernel's arithmetic, emulated on the CPU: its steps
    with both products in split TF32 (three TF32 products summed in fp32)
    hold the JAX package's Pallas forward at the fp32 bar, the output
    within 1e-5 and the residuals l and m too, where one TF32 product
    alone does not; at the wide head dims in the clusters' order, above
    Dh 1024 that of their passes."""
    B, nq, nk, H, D = shape
    arrays = _qkv(shape, "float32", seed=sum(shape) + 2)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JL._attend_flash(jq, jk, jv, scale))
        _, jl, jm = jfa._flash_attention_impl(
            *(a.transpose(0, 2, 1, 3) for a in (jq, jk, jv)), None, None,
            True, False, scale, 1, 128, 128, 128, False)
    jl, jm = np.asarray(jl), np.asarray(jm)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    out, l, m = _split_tf32_forward(q, k, v, scale)
    one, _, _ = _split_tf32_forward(q, k, v, scale, passes=1)
    assert out.shape == (B, nq, H, D) and l.shape == m.shape == (B, H, nq)
    assert np.abs(out.numpy() - want).max() <= 1e-5
    assert float((np.abs(l.numpy() - jl) / jl).max()) <= 1e-5
    assert float(np.abs(m.numpy() - jm).max()) <= 1e-5 * np.abs(jm).max()
    assert np.abs(one.numpy() - want).max() > 1e-5


@pytest.mark.parametrize("dh", [384, 512])
def test_wide_forward_forms_the_backward_scores(dh):
    """Up to Dh 1024 the fp32 wide forward forms S in the fp32 wide
    backward's order, so that the p the backward recomputes from m and l
    is the p the forward summed: the forward's emulation, its own code
    (`_wide_fwd_contract`, per rank its two chains), tile by tile of 32 kv
    rows, gives the bits of the backward's emulation
    (`test_torch_port_flash_bwd._contract`, per slice its two chains) of
    S·scale over all kv rows, and the forward's m is their row maximum."""
    from test_torch_port_flash_bwd import _contract

    q, k, v = (torch.from_numpy(a)
               for a in _qkv((1, 128, 256, 2, dh), "float32", seed=dh))
    qf, kf = (t.transpose(1, 2) for t in (q, k))
    scale = dh ** -0.5
    tiles = torch.cat([_fwd_scores(qf, kf[:, :, k0:k0 + 32], 3)
                       for k0 in range(0, 256, 32)], -1) * scale
    bwd = _contract(qf, kf, 3) * scale
    assert torch.equal(tiles, bwd)
    _, _, m = _split_tf32_forward(q, k, v, scale)
    assert torch.equal(m, bwd.amax(-1))


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
                for dh in (32, 48, 64, 128, 192, 256, 320, 384, 448,
                           512):
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


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("dh", [64, 128, 192, 256, 320, 384, 512])
def test_attend_takes_the_jax_route(dh, mode, calls, monkeypatch, caplog):
    """`attend` against the JAX package's `_attend` on one input (1, 256,
    256, 1, Dh, fp32), both packages in one mode: the port runs its flash
    path exactly where the JAX package's Pallas kernel completes a call
    (with "on", at the head dims the TPU kernel takes: below 128 or a
    multiple of it), and both take their einsum path elsewhere, the JAX
    package after the kernel refuses the head dim, the port from the shape
    alone, each logging that once in the same words. The values agree at
    the bar of SDPA against the einsum path (5e-3, fp32)."""
    monkeypatch.setattr(JL, "_FLASH_FALLBACK_LOGGED", False)
    monkeypatch.setattr(TL, "_FLASH_ROUTE_LOGGED", False)
    arrays = _qkv((1, 256, 256, 1, dh), "float32", seed=dh)
    scale = dh ** -0.5
    JL.set_flash_attention(mode)
    TL.set_flash_attention(mode)
    with pltpu.force_tpu_interpret_mode(), caplog.at_level("WARNING"):
        want = np.asarray(JL._attend(*(jnp.asarray(a) for a in arrays),
                                     scale))
        got = TL.attend(*(torch.from_numpy(a) for a in arrays), scale)
    flash = mode == "on" and fa.flash_head_dim_ok(dh)
    assert calls["jax_flash"] == calls["flash"] == int(flash)
    assert flash == (mode == "on" and dh in (64, 128, 256, 384, 512))
    assert np.abs(got.numpy() - want).max() <= 5e-3
    refused = [r.getMessage() for r in caplog.records
               if "using einsum path" in r.getMessage()]
    if mode == "on" and not flash:
        words = (f"flash attention unavailable (head_dim={dh} should be a "
                 "multiple of 128 if larger); using einsum path")
        assert refused == [words, words]  # the JAX package's, then ours
    else:
        assert refused == []


def test_the_route_is_logged_once(caplog, monkeypatch):
    """The einsum path at a refused head dim is logged at the first call
    only, as the JAX package logs it."""
    monkeypatch.setattr(TL, "_FLASH_ROUTE_LOGGED", False)
    TL.set_flash_attention("on")
    q = torch.zeros(1, 256, 1, 192)
    with caplog.at_level("WARNING"):
        for _ in range(3):
            TL.attend(q, q, q, 0.1)
    assert [r.getMessage() for r in caplog.records] == [
        "flash attention unavailable (head_dim=192 should be a multiple of "
        "128 if larger); using einsum path"]


@pytest.mark.parametrize("dh", [192, 320, 448])
def test_wrapper_refuses_head_dims_the_tpu_kernel_refuses(dh):
    """`flash_attention` and `flash_attention_bwd`, called directly, refuse
    a head dim of 128 or more that is no multiple of 128 as the Pallas
    kernel does (`_attend_flash` raises it): NotImplementedError, the
    kernel's message."""
    z = torch.zeros(1, 64, 1, dh)
    msg = f"head_dim={dh} should be a multiple of 128 if larger"
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        fa.flash_attention(z, z, z, 0.1)
    l = m = torch.ones(1, 1, 64)
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        fa.flash_attention_bwd(z, z, z, z, l, m, z, 0.1)
    with pltpu.force_tpu_interpret_mode(), \
            pytest.raises(NotImplementedError, match=re.escape(msg)):
        jfa.flash_attention(*(jnp.zeros((1, 1, 256, dh)),) * 3,
                            sm_scale=0.1)


@pytest.mark.parametrize("dh", [384, 512, 1024])
def test_wrapper_admits_the_wide_head_dims(dh, calls):
    """Every multiple of 128 from 384 up is admitted, forward and backward:
    on the CPU the plain versions run (the kernels run on the card)."""
    rng = np.random.default_rng(dh)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 64, 2, dh)).astype(np.float32)) for _ in range(4))
    out, l, m = fa.flash_attention(q, k, v, dh ** -0.5, residuals=True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, l, m, do, dh ** -0.5)
    assert calls["flash"] == 1
    want = TL.attend_sdpa(q, k, v, dh ** -0.5)
    assert float((out - want).abs().max()) <= 1e-5
    assert dq.shape == dk.shape == dv.shape == q.shape


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


@pytest.mark.parametrize("entry, leading", [
    ("flash_attention_plan", ["dtype", "D", "B", "H", "n_q"]),
    ("flash_attention_bwd_plan", ["dkv", "dtype", "D", "B", "H", "n_q",
                                  "n_kv"])])
def test_plan_entry_points_match_their_ctypes_binding(entry, leading):
    """chip_smoke.py binds each plan entry point with ctypes (the registry
    `FLASH_PLAN_ARGTYPES`): one c_int per int parameter of the C signature,
    in order, then the int[4] it writes; both plans take the dtype (0
    bf16, 1 fp32), the backward's after dkv, as their launches do."""
    import ctypes
    import importlib.util

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_bindings",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    argtypes = smoke.FLASH_PLAN_ARGTYPES[entry]
    code = "".join(p.read_text() for p in sorted(
        (root / "splatt3r_slam_tpu_torch" / "csrc").glob("*.cu")))
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', code)
    assert sig, entry
    params = [p.strip() for p in sig.group(1).split(",")]
    assert [p.split()[-1] for p in params[:-1]] == leading
    assert all(p.startswith("int ") for p in params[:-1])
    assert params[-1] == "int* plan"
    assert argtypes[:-1] == [ctypes.c_int] * len(leading)
    assert argtypes[-1] == ctypes.POINTER(ctypes.c_int)


@pytest.mark.parametrize("name, case", [
    ("flash_attention", r"case (\d+): return flash::launch<\d+>"),
    ("flash_attention_bwd_dkv", r"case (\d+): return launch<\d+, DKV>"),
    ("flash_attention_bwd_dq", r"case (\d+): return launch<\d+, DKV>")])
def test_flash_source_is_hand_written(name, case):
    """The forward and the two backward kernels are wgmma written out, fed
    by TMA into an mbarrier ring; in fp32 too, with every product split
    TF32 on the tensor cores (every operand split into TF32 hi and lo
    rounded to nearest, wgmma .tf32 for S and dP and for the forward's P·V
    on a transposed V, mma.sync .tf32 for the backward's gradients), no
    FMA loop in the fp32 kernels and no cp.async left; each with one
    template instance per head dim of `HEAD_DIMS` and, for every other
    head dim the wrapper admits (multiples of 128 from 384 up), one wide
    kernel a dtype that takes the head dim at run time; the wide kernels
    (both dtypes, forward and backward) on thread-block clusters along Dh,
    each block contracting its own 128-column slice once a tile (no loop
    over 64-column chunks of Dh) and the partials of S (and dP) exchanged
    through distributed shared memory between cluster barriers, launched
    with the cluster attribute; no library on the route and no atomics. A
    source is read together with the local headers it includes, and its
    own text calls their wgmma, TMA and mbarrier helpers."""
    source = cuda_build.KERNELS[name][0]
    code = source.read_text()
    own = re.sub(r"//[^\n]*", "", code)
    for helper in ("mma_ss(", "mma_rs(", "tma_box(", "bar_wait("):
        assert helper in own, helper
    for header in re.findall(r'#include "([^"]+)"', code):
        code += (source.parent / header).read_text()
    uses = ("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
            "wgmma.wait_group", "mbarrier.try_wait.parity",
            "mbarrier.arrive.expect_tx", "cp.async.bulk.tensor.4d",
            "CU_TENSOR_MAP_SWIZZLE_128B")
    for op in uses:
        assert op in code, op
    for banned in ("cublas", "cudnn", "cutlass", "torch", "#include <mma"):
        assert banned not in code.lower(), banned
    # the fp32 path: split TF32 on the tensor cores
    for helper in ("mma_tf32_ss(", "split_tf32(", "split_pass<",
                   "fence_async_smem("):
        assert helper in own, helper
    for op in ("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32",
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
               "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
               "+ 0x1000u) & 0xFFFFE000u", "fence.proxy.async.shared::cta",
               "CU_TENSOR_MAP_DATA_TYPE_FLOAT32"):
        assert op in code, op
    stem = "flash_fwd" if name == "flash_attention" else "flash_bwd"
    if name == "flash_attention":  # P·V by wgmma on the transposed V
        for helper in ("mma_tf32<64>(", "split_vt<RS>(", "split_vt<WRS>("):
            assert helper in own, helper
    else:  # the gradients by mma.sync; wgmma from registers above Dh 128
        for helper in ("mma_tf32<RS>(", "mma_tf32_m16n8(", "grad_mma<RS>(",
                       "mma_tf32<GN>(", "transpose_t("):
            assert helper in own, helper
        for n in (16, 128):
            assert f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32" \
                in code
        assert "fmaf(" not in own
    for kernel in ("f32", "wide_f32"):  # no FMA loop in any fp32 kernel
        args = "tp" if kernel == "f32" else "tp, int D"
        fp32 = re.search(rf"{stem}_{kernel}\(const __grid_constant__ "
                         rf"TmaParams {args}\) \{{.*?\n\}}\n", own, re.S)
        assert fp32 and "fmaf(" not in fp32.group(0), kernel
        # wgmma .tf32, both operands from shared memory or A from registers
        assert re.search(r"mma_tf32(_ss\(|<)", fp32.group(0)), kernel
        assert "split_tf32(" in code
    assert "cp_async" not in code and "cp.async.cg" not in code
    ops = re.sub(r"//[^\n]*", "", code).lower()  # without the comments
    assert not re.search(r"\b(atomic|atom\.|red\.)", ops)
    assert tuple(int(d) for d in re.findall(case, code)) == fa.HEAD_DIMS
    # every other head dim: the wide kernels, the head dim at run time, for
    # the multiples of 128 from 384 up (FLASH_WIDE_FROM)
    assert re.search(r"if \((flash::)?wide\(D\)\) return "
                     r"(flash::)?launch_wide", own)
    assert ("bool wide(int D) { return D >= FLASH_WIDE_FROM && D % 128 == 0; }"
            in own)
    assert "#define FLASH_WIDE_FROM 384" in code
    assert (fa.WIDE_MIN, fa.MIN_BLOCK_SIZE) == (384, 128)
    for dtype in ("bf16", "f32"):
        assert re.search(rf"{stem}_wide_{dtype}\(const __grid_constant__ "
                         r"TmaParams tp, int D\)", own), dtype
    # no wide kernel streams S over Dh in 64-column chunks
    assert "const int nc = D / 64;" not in own
    if name == "flash_attention":
        # the wide forward, both dtypes: a cluster of blocks along Dh, each
        # contracting its own 128-column slice once a kv tile (one group of
        # wgmmas, no loop over chunks of Dh), the partials added and the
        # softmax formed once by the rows' owners through distributed
        # shared memory between cluster barriers; launched with the
        # cluster's size
        for dtype in ("bf16", "f32"):
            body = re.search(
                rf"flash_fwd_wide_{dtype}\(const __grid_constant__ "
                r"TmaParams tp, int D\) \{.*?\n\}\n", own, re.S).group(0)
            for helper in ("cluster_rank()", "cluster_blocks()",
                           "cluster_sync();", "own_load<", "own_finish<",
                           "row_owner("):
                assert helper in body, (dtype, helper)
            assert re.search(r"ld_cluster\w*\(", body), dtype
            assert not re.search(r"D / (32|64)|< nc\b", body), dtype
        for helper in ("mma_rs128(", "cluster_map(", "ld_dsmem(",
                       "st_dsmem("):
            assert helper in own, helper
        for op in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "barrier.cluster.arrive.release", "barrier.cluster.wait",
                   "mapa.shared::cluster", "ld.shared::cluster",
                   "st.shared::cluster",
                   "cudaLaunchAttributeClusterDimension",
                   "cudaLaunchKernelEx(", "cudaOccupancyMaxActiveClusters("):
            assert op in code, op
    else:
        # the wide pair, both dtypes: a cluster of blocks along Dh, each
        # contracting its own 128-column slice once a streamed tile (no loop
        # over every chunk of Dh), the partials added through distributed
        # shared memory between cluster barriers, launched with the
        # cluster's size; fp32 reads the P and dS of its elements from their
        # owners, bf16 has them pushed as A fragments into every block
        # (st.shared::cluster) and reads the streamed slice transposed by
        # the wgmma itself
        for dtype, helpers in (
                ("f32", ("ld_cluster(", "contract(", "mma_tf32<GN>(",
                         "transpose_t(")),
                ("bf16", ("own_load(", "own_finish(", "st_dsmem(",
                          "ld_dsmem4(", "cluster_map(", "mma_rs128(",
                          "mma_rs(", "mma_ss("))):
            body = re.search(
                rf"flash_bwd_wide_{dtype}\(const __grid_constant__ "
                r"TmaParams tp, int D\) \{.*?\n\}\n", own, re.S).group(0)
            for helper in ("cluster_rank()", "cluster_sync();") + helpers:
                assert helper in body, (dtype, helper)
            assert not re.search(r"D / (32|64)", body), dtype
        assert "transpose_t(" not in re.search(
            r"flash_bwd_wide_bf16\(const __grid_constant__ TmaParams tp, "
            r"int D\) \{.*?\n\}\n", own, re.S).group(0)
        for op in ("barrier.cluster.arrive.release", "barrier.cluster.wait",
                   "mapa.shared::cluster", "ld.shared::cluster",
                   "cudaLaunchAttributeClusterDimension",
                   "cudaLaunchKernelEx(", "cudaOccupancyMaxActiveClusters("):
            assert op in code, op
    csrc = cuda_build.KERNELS[name][0].parent
    assert {p.name for p in csrc.glob("*.cu")} == {
        s.name for s, _, _ in cuda_build.KERNELS.values()}


def test_wide_forward_probe_applies_to_the_source():
    """`scripts/probe_wide_forward.py` alters copies of the forward's
    source by its text: the clocked copy reads the clock around each of the
    seven steps of both wide kernels' tile loops and adds its reader; the
    all-read copy replaces the bf16 wide kernel's exchange and leaves the
    fp32 kernel as it is. So the probe still applies to this source."""
    from splatt3r_slam_tpu_torch.scripts import probe_wide_forward as probe

    src = cuda_build.KERNELS["flash_attention"][0].read_text()
    clocked = probe.phases_source(src)
    for k in range(len(probe.PHASES)):
        assert clocked.count(f"pc_[{k}] += t_ - pt_;") == 2, k
    for d in (0, 1):
        assert clocked.count(f"atomicAdd(&flash_probe[{d}][9]") == 1, d
    assert 'extern "C" int flash_probe_read(' in clocked
    allread = probe.allread_source(src)
    fp32 = "__global__ void __launch_bounds__(WT, 1)\n    flash_fwd_wide_f32"
    assert allread[allread.index(fp32):] == src[src.index(fp32):]
    bf16 = allread[:allread.index(fp32)]
    assert bf16.count("own_finish<false>(") == 0
    assert src[:src.index(fp32)].count("own_finish<false>(") > 0
    assert "flash_fwd_wide_bf16(" in bf16


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
