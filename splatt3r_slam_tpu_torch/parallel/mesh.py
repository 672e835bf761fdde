"""Device mesh for data / fsdp / tensor-parallel training, and its ranks.

Counterpart of `splatt3r_slam_tpu/parallel/mesh.py`. The JAX package lays
parameters and the batch out on a `(dp, fsdp, tp)` mesh and lets GSPMD
insert the collectives; here the same mesh is a
`torch.distributed.device_mesh.DeviceMesh` and the layout is applied to
the module:

- tensor parallelism on `mesh["tp"]` (`parallelize_module`), Megatron
  style, by the JAX package's rules: `attn.qkv`, `cross_attn.projq`,
  `.projk`, `.projv` and `mlp.fc1` split their outputs (column-parallel),
  `attn.proj` and `mlp.fc2` their inputs (row-parallel); a column-parallel
  bias is split with its outputs (the JAX rules leave biases whole: the
  layout differs, the numbers do not). The JAX rule
  for the cross-attention's output projection names a module `xattn` that
  the model does not have, so that projection stays replicated in both
  packages: its input, one head group per rank, is gathered first. The
  fused `qkv` is reshaped by heads, so its rows are put in head order per
  rank before the split ([q, k, v] of rank 0's heads, then rank 1's, ...)
  and `Attention` reads its local head count from its local width.
  `full_tensors` and `load_full_state_dict` undo and redo that order, so
  checkpoints keep the unsharded layout.
- `fully_shard` (FSDP2) over `mesh["dp", "fsdp"]`: replicated over `dp`,
  sharded over `fsdp` (HSDP); with fsdp = tp = 1 it is plain data
  parallelism, by the same mechanism for every mesh shape. Where FSDP puts
  each shard is its own choice (the JAX package shards the largest axis of
  parameters of 2^16 elements or more); the numbers are the same.

`batch_rows` hands each rank its rows of the global batch, and
`data_sum` sums a loss's numerator or denominator over the ranks that
hold the other rows, so that a loss is the global batch's, as in the JAX
trainer. `launch` runs a function on N ranks (N processes, or this one
when N is 1) with a process group per run; importing this module starts
nothing.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.parallel import (
    ColwiseParallel,
    PrepareModuleInput,
    RowwiseParallel,
    parallelize_module,
)

MESH_DIMS = ("dp", "fsdp", "tp")
TIMEOUT_S = 600  # a collective or a rendezvous that waits longer fails

# (module-name suffix, weight axis split over tp): axis 0 splits a Linear's
# outputs (column-parallel), axis 1 its inputs (row-parallel)
TP_RULES = (
    (("attn", "qkv"), 0),
    (("attn", "proj"), 1),
    (("projq",), 0),
    (("projk",), 0),
    (("projv",), 0),
    (("mlp", "fc1"), 0),
    (("mlp", "fc2"), 1),
)


def is_rank0() -> bool:
    """True outside a process group and on its rank 0: the rank that
    writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(n_devices: int | None = None, fsdp: int = 1, tp: int = 1,
              device_type: str | None = None):
    """(dp, fsdp, tp) `DeviceMesh` over the process group's ranks; fsdp =
    tp = 1 is pure data parallelism. `device_type` defaults to "cuda" under
    NCCL and "cpu" otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group (see launch)")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    if n != dist.get_world_size():
        raise ValueError(f"{n} devices asked for, the process group has "
                         f"{dist.get_world_size()} ranks")
    if n % (fsdp * tp):
        raise ValueError(f"{n} devices not divisible by fsdp={fsdp} * "
                         f"tp={tp}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // (fsdp * tp), fsdp, tp),
                            mesh_dim_names=MESH_DIMS)


def mesh_shape(mesh) -> dict:
    return {d: mesh[d].size() for d in MESH_DIMS}


# -- tensor parallelism -------------------------------------------------------
def _tp_axis(module_name: str):
    parts = tuple(module_name.split("."))
    for suffix, axis in TP_RULES:
        if parts[-len(suffix):] == suffix:
            return axis
    return None


def tp_param_axes(model: nn.Module) -> dict:
    """{parameter name: axis} of every parameter split over tp."""
    return {f"{name}.weight": axis
            for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)
            and (axis := _tp_axis(name)) is not None}


def _tp_plan(model: nn.Module) -> dict:
    plan = {name.removesuffix(".weight"): ColwiseParallel() if axis == 0
            else RowwiseParallel()
            for name, axis in tp_param_axes(model).items()}
    for name, _ in model.named_modules():
        if name.endswith("cross_attn.proj"):  # replicated: gather its heads
            plan[name] = PrepareModuleInput(
                input_layouts=(Shard(-1),), desired_input_layouts=(
                    Replicate(),), use_local_output=True)
    return plan


def _qkv_modules(model: nn.Module):
    return [(name, mod) for name, mod in model.named_modules()
            if name.split(".")[-2:] == ["attn", "qkv"]]


def _head_order(width: int, tp: int) -> torch.Tensor:
    """Row order of a fused (3C, C) qkv weight that puts each tp rank's
    heads together: [q, k, v] rows of rank 0's heads, then rank 1's."""
    c = width // 3
    return torch.cat([torch.arange(part * c + r * c // tp,
                                   part * c + (r + 1) * c // tp)
                      for r in range(tp) for part in range(3)])


def _permute_qkv(model: nn.Module, tp: int) -> None:
    for name, mod in _qkv_modules(model):
        heads = int(model.get_submodule(name.rsplit(".", 1)[0]).num_heads)
        if heads % tp:
            raise ValueError(f"{name}: {heads} heads do not split over "
                             f"tp={tp}")
        order = _head_order(mod.weight.shape[0], tp).to(mod.weight.device)
        with torch.no_grad():
            mod.weight.copy_(mod.weight[order])
            mod.bias.copy_(mod.bias[order])
        mod.row_order = order


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Tensor-parallel plan on mesh["tp"] (when tp > 1), then FSDP2 over
    mesh["dp", "fsdp"]: each encoder and decoder block and each head is
    its own FSDP group, the rest (patch embedding, norms, decoder
    embedding) the root's. Parameters become DTensors."""
    tp = mesh["tp"].size()
    if tp > 1:
        _permute_qkv(model, tp)
        parallelize_module(model, mesh["tp"], _tp_plan(model))
    dp_mesh = mesh["dp", "fsdp"]
    for mod in (*model.enc_blocks, *model.dec_blocks, *model.dec_blocks2,
                model.downstream_head1, model.downstream_head2):
        fully_shard(mod, mesh=dp_mesh)
    fully_shard(model, mesh=dp_mesh)
    return model


def full_tensors(model: nn.Module, grads: bool = False) -> dict:
    """Every parameter (or, with `grads`, every gradient that exists) as
    a whole plain tensor in the unsharded layout, keyed by its state-dict
    name. A collective: every rank calls it."""
    out = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is None:
            continue
        t = t.detach()
        out[name] = t.full_tensor() if isinstance(t, DTensor) else t
    for name, mod in _qkv_modules(model):
        order = getattr(mod, "row_order", None)
        if order is None:
            continue
        undo = torch.argsort(order)
        for key in (f"{name}.weight", f"{name}.bias"):
            if key in out:
                out[key] = out[key][undo.to(out[key].device)]
    return out


def load_full_state_dict(model: nn.Module, state_dict: dict) -> list:
    """`models/checkpoint.py::load_state_dict` for a sharded model: whole
    tensors in the unsharded layout, checked as that function checks
    them, and every rank passes the same ones. Returns the ignored extra
    keys."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
    )

    from splatt3r_slam_tpu_torch.models.checkpoint import checked_state_dict

    sd, extra = checked_state_dict(model, state_dict)
    own = model.state_dict()
    sd = {k: torch.as_tensor(v).to(own[k].dtype) for k, v in sd.items()}
    for name, mod in _qkv_modules(model):
        order = getattr(mod, "row_order", None)
        if order is None:
            continue
        for key in (f"{name}.weight", f"{name}.bias"):
            sd[key] = sd[key][order.cpu()]
    set_model_state_dict(model, sd, options=StateDictOptions(
        full_state_dict=True, strict=False))
    return extra


# -- the batch and the loss's sums --------------------------------------------
def batch_rows(batch: dict, mesh) -> dict:
    """This rank's rows of the global batch: split over dp × fsdp, the
    same on every tp rank. Raises unless every leading axis divides."""
    n_fsdp = mesh["fsdp"].size()
    n = mesh["dp"].size() * n_fsdp
    i = mesh.get_local_rank("dp") * n_fsdp + mesh.get_local_rank("fsdp")
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % n:
            raise ValueError(f"batch {k!r} has {rows} rows, which do not "
                             f"split over dp x fsdp = {n} ranks")
        r = rows // n
        out[k] = v[i * r:(i + 1) * r]
    return out


def data_sum(mesh):
    """→ total(x): x summed over the ranks that hold the other rows of the
    batch (the mesh's dp and fsdp groups of this tp rank), differentiably.
    Its backward sums the cotangent over the same ranks, and FSDP's
    gradient reduction averages over them again, so a loss built from
    these sums gets the global batch's gradient once. A collective: every
    rank calls it."""
    import torch.distributed._functional_collectives as funcol

    def total(x):
        for dim in ("dp", "fsdp"):
            x = funcol.all_reduce(x, "sum", mesh[dim])
        return x

    return total


# -- ranks ----------------------------------------------------------------------
@contextlib.contextmanager
def process_group(rank: int, world: int, init_method: str,
                  device_type: str = "cuda", timeout_s: float = TIMEOUT_S):
    """Join (or, if this process has none, open and finally close) a
    process group of `world` ranks: NCCL on CUDA, rank r on cuda:r (on
    cuda:LOCAL_RANK under torchrun); gloo on the CPU."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {world} ranks asked "
                               f"for inside one of "
                               f"{dist.get_world_size()}")
        yield
        return
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_entry(rank, fn, world, init_method, out, args):
    result = fn(rank, world, init_method, *args)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)


def launch(fn, world: int, args=(), device_type: str = "cuda",
           timeout_s: float = TIMEOUT_S):
    """Run `fn(rank, world, init_method, *args)` on `world` ranks and
    return rank 0's result: in this process when world is 1, else in
    `world` processes started with spawn (`fn` and `args` must pickle).
    `fn` opens its group with `process_group(rank, world, init_method,
    device_type)`; the rendezvous is a file store in a fresh temporary
    directory. On CUDA it raises before starting anything unless there is
    one GPU per rank. A rank that raises, or a run past `timeout_s`, ends
    every rank and raises here."""
    import torch.multiprocessing as mp

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type == "cuda" and have < world:
        raise RuntimeError(
            f"{world} CUDA ranks need {world} GPUs, found {have}; pass "
            "device='cpu' (--device cpu) explicitly to run on the CPU")
    with tempfile.TemporaryDirectory(prefix="port_dist_") as d:
        init_method = f"file://{os.path.join(d, 'store')}"
        if world == 1:
            return fn(0, 1, init_method, *args)
        out = os.path.join(d, "rank0.pkl")
        ctx = mp.start_processes(
            _rank_entry, args=(fn, world, init_method, out, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        with open(out, "rb") as f:
            return pickle.load(f)
