"""The flash-attention backward of the port against the JAX package's.

`splatt3r_slam_tpu_torch/models/flash_attention.py`: the plain backward
(`flash_attention_bwd_torch`, which `flash_attention_bwd` runs for CPU
tensors), the forward's residuals, `FlashAttention` under autograd and a
narrow model's full-finetune gradients with the mode "on". The JAX side
runs its real Pallas TPU kernels (`_attend_flash` under `jax.vjp` or
`jax.grad` → the custom VJP's `_flash_attention_bwd_dkv` and
`_flash_attention_bwd_dq`) on the CPU under
`pltpu.force_tpu_interpret_mode()`; every test counts their calls, since
the JAX package's `_attend` would drop to its einsum path on an error. All
inputs come from numpy with a seed. The CUDA kernels run only on the card
(`chip_smoke.py`'s `flash-train` phase holds them against the plain
version).

Tolerances and what this CPU measured:
- plain backward (and forward) against the Pallas kernels, fp32: 1e-5 of
  each gradient's peak (both exact fp32 with sums in another order;
  measured at most 1.9e-7);
- the same in bf16: 2^-7 of each gradient's peak, two bf16 steps (both
  round p and ds to bf16 and the gradients once at the end; the fp32 sums
  that decide a rounding differ in order; measured at most 0.18 of the
  bar);
- residuals against `_flash_attention_impl(save_residuals=True)`: l within
  1e-5 relative (fp32 sums of n_kv terms in another order; measured at
  most 8.4e-7), m within 1e-6 of its largest value (the same maxima of
  products summed in another order; measured 0 in fp32, 1.5e-7 in bf16);
- `FlashAttention` under autograd against autograd through `attend_sdpa`,
  fp32: 5e-3 of each peak, the bar of the JAX TPU test
  (tests/test_flash_attention.py; measured at most 6.7e-7);
- the narrow model's Regr3D loss and gradients against the JAX trainer's
  `jax.value_and_grad`: the bars of tests/test_torch_port_train.py::
  test_regr3d_loss_and_gradients (loss 1e-4 relative, each gradient 1e-4
  of its peak; measured 4.8e-7 and at most 8.0e-6);
- the same step with remat on and off: the same bits (the recompute runs
  the same CPU operations in the same order).
"""

import copy

import jax
import jax.experimental.pallas.ops.tpu.flash_attention as jfa
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.models import layers as JL
from splatt3r_slam_tpu.models.checkpoint import convert_state_dict
from splatt3r_slam_tpu.parallel import TrainConfig as JTrainConfig
from splatt3r_slam_tpu.parallel import Trainer as JTrainer
from splatt3r_slam_tpu.parallel.mesh import make_mesh as j_make_mesh
from splatt3r_slam_tpu_torch.models import TwoViewConfig, init_model
from splatt3r_slam_tpu_torch.models import flash_attention as fa
from splatt3r_slam_tpu_torch.models import layers as TL
from splatt3r_slam_tpu_torch.models.checkpoint import (
    load_state_dict,
    params_from_jax,
)
from splatt3r_slam_tpu_torch.parallel import TrainConfig, Trainer
from splatt3r_slam_tpu_torch.parallel import mesh as pmesh
from splatt3r_slam_tpu_torch.train import synthetic_batches
from flash_tf32 import mm_split, tf32
from test_torch_port_bench import one_torch_thread  # noqa: F401

FP32_BAR = 1e-5
BF16_BAR = 2 ** -7


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
    """Completed calls of the JAX package's attention, its flash forward
    and its two backward kernels' launchers (calls while tracing: jit and
    scan trace a function once per distinct shape and body), and of the
    port's plain forward and backward. The JAX package's fallback flag
    starts False, so that a test reads only its own fallbacks (another
    module in the same worker may have logged one)."""
    monkeypatch.setattr(JL, "_FLASH_FALLBACK_LOGGED", False)
    n = {"jax_attend": 0, "jax_fwd": 0, "jax_dkv": 0, "jax_dq": 0,
         "fwd": 0, "bwd": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            n[key] += 1
            return out
        return wrapped

    for mod, name, key in (
            (JL, "_attend", "jax_attend"),
            (JL, "_attend_flash", "jax_fwd"),
            (jfa, "_flash_attention_bwd_dkv", "jax_dkv"),
            (jfa, "_flash_attention_bwd_dq", "jax_dq"),
            (fa, "flash_attention_torch", "fwd"),
            (fa, "flash_attention_bwd_torch", "bwd")):
        monkeypatch.setattr(mod, name, counting(key, getattr(mod, name)))
    return n


def _arrays(shape, seed):
    """q, k, v and the cotangent do, fp32 numpy, (B, N, H, D)."""
    B, nq, nk, H, D = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, n, H, D)).astype(np.float32)
            for n in (nq, nk, nk, nq)]


def _jax_vjp(arrays, dtype, scale):
    """(out, dq, dk, dv) of the JAX package's flash attention through its
    Pallas kernels, fp32 numpy. The caches are cleared first, so that the
    kernels are traced (and counted) in every call."""
    jax.clear_caches()
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: JL._attend_flash(a, b, c, scale),
                           q, k, v)
        grads = vjp(do)
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _port(arrays, dtype, strided_v=False):
    """The port's q, k, v, do as torch tensors of `dtype`; with
    `strided_v`, v is the strided view of a fused qkv tensor, as
    `Attention` hands it over."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    if strided_v:
        B, N, H, D = v.shape
        qkv = torch.zeros(B, N, 3, H, D, dtype=dtype)
        qkv[:, :, 2] = v
        v = qkv.reshape(B, N, 3 * H * D).reshape(B, N, 3, H, D)[:, :, 2]
        assert v.stride(1) == 3 * H * D
    return q, k, v, do


def _rel(got, want):
    """max |got - want| / max |want|."""
    got = got.float().numpy() if torch.is_tensor(got) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the plain backward against the Pallas TPU kernels ------------------------

# (B, n_q, n_kv, H, Dh, v strided)
CASES = ((1, 256, 256, 2, 64, False), (1, 256, 512, 2, 64, False),
         (1, 256, 256, 1, 128, False), (1, 256, 256, 2, 64, True),
         (1, 256, 256, 1, 384, False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "x".join(map(str, c[:5]))
                         + ("_strided_v" if c[5] else ""))
def test_plain_backward_matches_pallas_kernels(case, dtype, calls):
    *shape, strided = case
    arrays = _arrays(shape, seed=sum(shape))
    scale = shape[-1] ** -0.5
    want = _jax_vjp(arrays, getattr(jnp, dtype), scale)
    assert calls["jax_fwd"] == calls["jax_dkv"] == calls["jax_dq"] == 1
    assert not JL._FLASH_FALLBACK_LOGGED
    tdt = getattr(torch, dtype)
    q, k, v, do = _port(arrays, tdt, strided)
    out, l, m = fa.flash_attention(q, k, v, scale, residuals=True)
    grads = fa.flash_attention_bwd(q, k, v, out, l, m, do, scale)
    assert calls["fwd"] == calls["bwd"] == 1
    bar = FP32_BAR if dtype == "float32" else BF16_BAR
    assert _rel(out, want[0]) <= bar
    for name, g, w, t in zip("qkv", grads, want[1:], (q, k, v)):
        assert g.dtype == tdt and g.shape == t.shape and g.is_contiguous()
        assert _rel(g, w) <= bar, (name, _rel(g, w))


# -- the fp32 kernels' arithmetic: split TF32 -----------------------------------

def _split_tf32_backward(q, k, v, o, l, m, do, scale, passes=3):
    """The plain backward's steps (fp32, one block) with every product in
    split TF32: S, dP, dV, dK and dQ; p and ds enter their products as
    fp32 values, split like every other operand."""
    qf, kf, vf, dof = (t.transpose(1, 2) for t in (q, k, v, do))
    di = fa._di(o, do)[..., None]
    s = mm_split(qf, kf.transpose(-1, -2), passes) * scale
    p = torch.exp(s - m[..., None]) * (1 / l)[..., None]
    dv = mm_split(p.transpose(-1, -2), dof, passes)
    dp = mm_split(dof, vf.transpose(-1, -2), passes)
    ds = (dp - di) * p * scale
    dk = mm_split(ds.transpose(-1, -2), qf, passes)
    dq = mm_split(ds, kf, passes)
    return tuple(g.transpose(1, 2) for g in (dq, dk, dv))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """`tf32` (flash_tf32.py) rounds to nearest on 10 mantissa bits, ties
    away from zero, for either sign; hi + lo of the split is within 2^-22
    of x."""
    one = 1.0 + 2.0 ** -10  # exactly representable in TF32
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert tf32(x).tolist() == [1.0, one, one, one, -one, 1.0]
    y = torch.from_numpy(np.random.default_rng(9).standard_normal(
        4096).astype(np.float32))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("shape", [(1, 256, 256, 2, 64), (1, 256, 256, 1, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_split_tf32_backward_matches_pallas_kernels(shape, calls):
    """The fp32 kernels' arithmetic, emulated on the CPU: the plain
    backward's steps with every product in split TF32 (three TF32 products
    summed in fp32) hold the JAX package's Pallas backward at the fp32 bar
    (1e-5 of each gradient's peak), where one TF32 product alone does not;
    the forward's l and m are the plain forward's."""
    arrays = _arrays(shape, seed=sum(shape) + 1)
    scale = shape[-1] ** -0.5
    want = _jax_vjp(arrays, jnp.float32, scale)
    assert calls["jax_fwd"] == calls["jax_dkv"] == calls["jax_dq"] == 1
    assert not JL._FLASH_FALLBACK_LOGGED
    q, k, v, do = _port(arrays, torch.float32)
    o, l, m = fa.flash_attention_torch(q, k, v, scale, residuals=True)
    got = _split_tf32_backward(q, k, v, o, l, m, do, scale)
    one = _split_tf32_backward(q, k, v, o, l, m, do, scale, passes=1)
    for name, g, g1, w in zip("qkv", got, one, want[1:]):
        assert _rel(g, w) <= FP32_BAR, (name, _rel(g, w))
        assert _rel(g1, w) > FP32_BAR, (name, _rel(g1, w))


def test_plain_backward_follows_the_kernel_steps():
    """In fp32 the plain backward is the gradient of softmax attention
    (against float64 autograd); in bf16, with one block, dv is p rounded to
    bf16, transposed, times do, summed in fp32 and rounded once, and dk and
    dq are ds = (do·vᵀ - di)·p·scale rounded to bf16, times q and k, summed
    in fp32 and rounded once (not the same without ds's rounding)."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((1, 128, 384, 2, 64),
                                                         seed=3))
    scale = 0.125
    out, l, m = fa.flash_attention_torch(q, k, v, scale, residuals=True)
    got = fa.flash_attention_bwd_torch(q, k, v, out, l, m, do, scale)
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bnhd,bmhd->bhnm", q64, k64) * scale
    o64 = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v64)
    want = torch.autograd.grad(o64, (q64, k64, v64), do.double())
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    out, l, m = fa.flash_attention_torch(qb, kb, vb, scale, residuals=True)
    dq, dk, dv = fa.flash_attention_bwd_torch(qb, kb, vb, out, l, m, dob,
                                              scale, block=384)
    s = torch.einsum("bnhd,bmhd->bhnm", qb.float(), kb.float()) * scale
    p = torch.exp(s - m[..., None]) * (1 / l[..., None])
    ref = torch.einsum("bhnm,bnhd->bmhd", p.bfloat16().float(),
                       dob.float()).bfloat16()
    assert torch.equal(dv, ref)
    dp = torch.einsum("bnhd,bmhd->bhnm", dob.float(), vb.float())
    di = (out.float() * dob.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (dp - di) * p * scale
    for d, equal in ((ds.bfloat16().float(), True), (ds, False)):
        assert torch.equal(dk, torch.einsum(
            "bhnm,bnhd->bmhd", d, qb.float()).bfloat16()) == equal
        assert torch.equal(dq, torch.einsum(
            "bhnm,bmhd->bnhd", d, kb.float()).bfloat16()) == equal


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_residuals_match_pallas(dtype):
    """l and m of the plain forward against the Pallas forward kernel's
    `save_residuals` outputs ((B, H, n_q), fp32)."""
    q, k, v, _ = _arrays((2, 256, 512, 2, 64), seed=12)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        _, jl, jm = jfa._flash_attention_impl(
            *(jnp.asarray(a, jdt).transpose(0, 2, 1, 3) for a in (q, k, v)),
            None, None, True, False, 0.125, 1, 128, 128, 128, False)
    _, l, m = fa.flash_attention(*(torch.from_numpy(a).to(tdt)
                                   for a in (q, k, v)), 0.125,
                                 residuals=True)
    assert l.shape == m.shape == (2, 2, 256)
    assert l.dtype == m.dtype == torch.float32
    jl, jm = np.asarray(jl), np.asarray(jm)
    assert float((np.abs(l.numpy() - jl) / jl).max()) <= 1e-5
    assert float(np.abs(m.numpy() - jm).max()) <= 1e-6 * np.abs(jm).max()


# -- FlashAttention under autograd --------------------------------------------

@pytest.mark.parametrize("shape", [(1, 256, 256, 2, 64), (2, 256, 512, 1, 64),
                                   (1, 256, 256, 1, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_autograd_matches_sdpa(shape, calls):
    """`attend` with "on" (FlashAttention) against autograd through
    `attend_sdpa`, fp32, at the JAX TPU test's bar (5e-3 of each peak);
    the residuals are taken only when a gradient is recorded."""
    q, k, v, do = (torch.from_numpy(a).requires_grad_(i < 3)
                   for i, a in enumerate(_arrays(shape, seed=5)))
    scale = shape[-1] ** -0.5
    TL.set_flash_attention("on")
    out = TL.attend(q, k, v, scale)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(TL.attend_sdpa(q, k, v, scale), (q, k, v),
                               do)
    assert calls["fwd"] == calls["bwd"] == 1
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 5e-3 * float(w.abs().max())
    with torch.no_grad():
        plain = TL.attend(q, k, v, scale)
    assert torch.equal(plain, out.detach())
    ctx_free = fa.FlashAttention.apply(q.detach(), k.detach(), v.detach(),
                                       scale)
    assert ctx_free.grad_fn is None and calls["bwd"] == 1


def test_cuda_tensor_without_gpu_raises(calls):
    """A tensor on the card takes the kernels' path or raises: without a
    GPU (no nvcc, no library) the backward raises, and never runs its
    plain version or another attention instead."""

    class OnCard(torch.Tensor):
        """A CPU tensor that reports itself as a CUDA tensor."""

        @property
        def is_cuda(self):
            return True

    q, k, v, do = (OnCard._make_subclass(OnCard, torch.from_numpy(a))
                   for a in _arrays((1, 256, 256, 1, 64), seed=6))
    l = torch.ones(1, 1, 256)
    m = torch.zeros(1, 1, 256)
    before = (fa.launches, fa.bwd_launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.flash_attention_bwd(q, k, v, q, l, m, do, 0.125)
    assert calls["bwd"] == 0 and (fa.launches, fa.bwd_launches) == before


def test_backward_refuses_what_the_kernels_do_not_take(tmp_path):
    """Wrong shapes and dtypes of o, l, m, do raise ValueError; a DTensor
    (tensor parallelism) raises TypeError, as the forward does."""
    from torch.distributed.tensor import DTensor, Replicate

    q = k = v = o = do = torch.zeros(1, 256, 1, 64)
    l = m = torch.ones(1, 1, 256)
    bad = [((q, k, v, o[:, :128], l, m, do), "o and do"),
           ((q, k, v, o, l, m, do.bfloat16()), "o and do"),
           ((q, k, v, o, l.double(), m, do), "contiguous fp32"),
           ((q, k, v, o, l, torch.ones(1, 256, 1)[..., 0], do),
            "contiguous fp32"),
           ((q, k, v, o, l, torch.ones(1, 1, 512)[..., ::2], do),
            "contiguous fp32")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            fa.flash_attention_bwd(*args, 0.125)
    with pmesh.process_group(0, 1, f"file://{tmp_path / 'store'}", "cpu"):
        mesh = pmesh.make_mesh(1)
        dt = DTensor.from_local(do, mesh["dp"], [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            fa.flash_attention_bwd(q, k, v, o, l, m, dt, 0.125)


# -- a narrow model's full finetune with "on" ---------------------------------

HW = 256  # 16 x 16 patches: 256 tokens, what the shape rule admits
# tiny() with Dh 64 everywhere: encoder and decoder 128 wide, 2 heads (its
# depths, 2 and 4, are kept: with a 2-block decoder this random model's
# gradients are ill-conditioned at 256x256, a 1e-7 relative perturbation of
# every attention output moving a head gradient by 4.8e-4 of its peak; here
# the same perturbation moves none by more than 1.9e-6)
NARROW = dict(enc_embed_dim=128, enc_num_heads=2, dec_embed_dim=128,
              dec_num_heads=2)


@pytest.fixture(scope="module")
def narrow():
    """A narrow fp32 two-view model whose every attention has Dh 64 at 256
    tokens: its weights in both packages (a seeded torch state dict
    converted by the JAX package's converter and carried back by
    `params_from_jax`) and one regr3d batch."""
    cfg = TwoViewConfig(dtype="float32",
                        head_dtype="float32").tiny()._replace(**NARROW)
    jc = JConfig(dtype="float32", head_dtype="float32").tiny()._replace(
        **NARROW)
    seed_model = init_model(cfg, seed=0, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in seed_model.state_dict().items()}, jc))
    batch = next(synthetic_batches(1, 1, HW, HW, False, seed=1))
    # attend calls of one training forward: the encoder's blocks once per
    # view and, per decoder block, each view's self and cross attention
    calls = 2 * cfg.enc_depth + 2 * 2 * cfg.dec_depth
    return dict(cfg=cfg, jc=jc, jp=jp, batch=batch, attend_calls=calls,
                state_dict=params_from_jax(jax.tree.map(np.asarray, jp),
                                           cfg))


def _trainer(narrow, remat=False):
    t = Trainer(narrow["cfg"]._replace(remat=remat),
                TrainConfig(render_loss=False,
                            train_gaussian_heads_only=False), device="cpu")
    assert load_state_dict(t.model, copy.deepcopy(narrow["state_dict"])) \
        == []
    return t


def test_full_finetune_gradients_match_jax(narrow, calls):
    """Regr3D loss and every parameter's gradient of the narrow model with
    "on" in both packages, the port's trainer against the JAX trainer's
    `jax.value_and_grad` (every attention through the Pallas kernels,
    forward and backward), at the bars of test_regr3d_loss_and_gradients."""
    JL.set_flash_attention("on")
    TL.set_flash_attention("on")
    jt = JTrainer(narrow["jc"], JTrainConfig(render_loss=False),
                  mesh=j_make_mesh(1))
    jbatch = {k: jnp.asarray(v) for k, v in narrow["batch"].items()}
    with pltpu.force_tpu_interpret_mode():
        (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
            jt.loss_fn, has_aux=True))(narrow["jp"], jbatch)
    # every attention the JAX model traced went through the Pallas kernels
    # (its scanned blocks are traced once a scan, not once a block)
    assert calls["jax_fwd"] == calls["jax_attend"] > 0
    assert calls["jax_dkv"] > 0 and calls["jax_dq"] > 0
    assert not JL._FLASH_FALLBACK_LOGGED
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_grads),
                              narrow["cfg"])
    t = _trainer(narrow)
    loss, _ = t.loss_fn(narrow["batch"])
    loss.backward()
    assert calls["fwd"] == calls["bwd"] == narrow["attend_calls"]
    assert abs(float(loss.detach()) - float(j_loss)) <= \
        1e-4 * abs(float(j_loss))
    seen = set()
    for name, p in t.model.named_parameters():
        want = j_grads[name].numpy()
        if "gaussian_dpt" in name:  # the regr3d loss does not reach them
            assert not want.any() and (p.grad is None or not p.grad.any())
            continue
        if p.grad is None:  # not reached by the forward in either package
            assert not want.any(), name
            continue
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-30), name
        seen.add(name.split(".")[0])
    assert {"enc_blocks", "dec_blocks", "dec_blocks2", "patch_embed",
            "downstream_head1", "downstream_head2"} <= seen


def test_remat_step_equals_the_plain_step(narrow, calls):
    """One full-finetune step with remat equals the step without it, bit
    for bit; with remat every attention's forward runs twice (the block is
    recomputed in the backward), the backward once."""
    TL.set_flash_attention("on")
    params, counts = [], []
    for remat in (False, True):
        t = _trainer(narrow, remat=remat)
        for key in calls:
            calls[key] = 0
        metrics = t.make_train_step()(narrow["batch"])
        counts.append((calls["fwd"], calls["bwd"]))
        params.append((float(metrics["loss"]),
                       {k: v.detach().clone()
                        for k, v in t.model.state_dict().items()}))
    n = narrow["attend_calls"]
    assert counts == [(n, n), (2 * n, n)]
    assert params[0][0] == params[1][0]
    moved = 0
    for k, v in params[0][1].items():
        assert torch.equal(v, params[1][1][k]), k
        if k in narrow["state_dict"]:
            moved += int(not torch.equal(v, narrow["state_dict"][k]))
    assert moved > 0
