"""Ablation experiment runner (training side).

    python -m splatt3r_slam_tpu_torch.ablations [--config ws.yaml]
        [--ablations NAME ...] [--steps N] [--devices N] [--res H W]
        [--out DIR] [--tiny] [--set k=v ...] [--device cuda|cpu]

Counterpart of the repository's `ablations.py` (after the reference's
`splatt3r_core/ablations.py`): each ablation is a dotlist override on a
base config (`--config`, with `include:` lists, or none), and each runs a
short training loop on one synthetic batch, dumping per-step metrics into
a timestamped workspace (`metrics.json` beside the resolved config and the
provenance). The model is `TwoViewConfig()` at full width, or the tiny fp32
one with `--tiny`, with fresh seeded weights for every ablation.

Every run goes through the (dp, fsdp, tp) mesh trainer, as the JAX script
always runs on a mesh: `--devices N` starts N ranks through
`parallel/mesh.py::launch` (one process group; every rank runs every
ablation and takes its row of the batch of N), and `--devices 1`, the
default, is the mesh at world size 1 in this process, as `train
--devices 1` is. Runs on CUDA unless `--device cpu` is given, and raises
without a GPU. Each run prints `[name] final: {metrics}`; the last line of
stdout is {name: final metrics} as JSON.
"""

from __future__ import annotations

import argparse
import json

ABLATIONS = {
    "baseline": [],
    "no_offsets": ["model.use_offsets=false"],
    "with_offsets": ["model.use_offsets=true"],
    "full_finetune": ["train.train_gaussian_heads_only=false"],
    "with_ssim": ["train.ssim_weight=0.2"],
    "with_mast3r_loss": ["train.mast3r_loss_weight=0.1"],
}


def build_configs(dotlist, args):
    """→ (config dict, TwoViewConfig, TrainConfig) of one ablation, built
    from the config's fields as the JAX script builds them."""
    from splatt3r_slam_tpu_torch.models import TwoViewConfig
    from splatt3r_slam_tpu_torch.parallel import TrainConfig
    from splatt3r_slam_tpu_torch.parallel.workspace import (
        apply_dotlist,
        load_config,
    )

    cfg = (load_config(args.config, dotlist=dotlist) if args.config
           else apply_dotlist({}, dotlist))
    mdl = cfg.get("model", {})
    trn = cfg.get("train", {})

    model_cfg = TwoViewConfig(use_offsets=bool(mdl.get("use_offsets", False)))
    if args.tiny:
        model_cfg = TwoViewConfig(dtype="float32", head_dtype="float32") \
            .tiny()._replace(use_offsets=model_cfg.use_offsets)
    tcfg = TrainConfig(
        lr=float(trn.get("lr", 1e-5)),
        train_gaussian_heads_only=bool(
            trn.get("train_gaussian_heads_only", True)
        ),
        mast3r_loss_weight=trn.get("mast3r_loss_weight"),
        grad_clip_norm=float(trn.get("gradient_clip_val", 0.5)),
        ssim_weight=float(trn.get("ssim_weight", 0.0)),
        render_loss=bool(trn.get("render_loss", True)),
        k_max=int(trn.get("k_max", 64)),
    )
    return cfg, model_cfg, tcfg


def run_one(name, dotlist, args, mesh, device):
    """One ablation on `mesh`, this rank on `device` → its last step's
    metrics."""
    from splatt3r_slam_tpu_torch.parallel import Trainer
    from splatt3r_slam_tpu_torch.parallel.mesh import is_rank0
    from splatt3r_slam_tpu_torch.parallel.workspace import create_workspace
    from splatt3r_slam_tpu_torch.train import synthetic_batches

    cfg, model_cfg, tcfg = build_configs(dotlist, args)
    trainer = Trainer(model_cfg, tcfg, device=device, mesh=mesh, seed=0)
    step = trainer.make_train_step()
    h, w = args.res
    # the JAX script's batch: one sample a rank, drawn in its order from
    # np.random.default_rng(0), as the train CLI's first synthetic batch is
    batch = next(synthetic_batches(1, args.devices, h, w, True, seed=0))

    ws = create_workspace(args.out, f"ablation_{name}", cfg)
    history = []
    for _ in range(args.steps):
        m = step(batch)
        history.append({k: float(v) for k, v in m.items()})
    if is_rank0():
        with open(ws / "metrics.json", "w") as f:
            json.dump(history, f, indent=2)
        print(f"[{name}] final: {history[-1]}")
    return history[-1]


def _run_rank(rank, world, init_method, args):
    """Every ablation on this rank of a `world`-rank mesh."""
    import torch

    from splatt3r_slam_tpu_torch.parallel.mesh import (
        make_mesh,
        process_group,
    )

    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    with process_group(rank, world, init_method, dev.type):
        mesh = make_mesh(world)
        return {name: run_one(name, ABLATIONS.get(name, [])
                              + list(args.overrides), args, mesh, dev)
                for name in args.ablations}


def main(argv=None) -> dict:
    """Run the ablations; returns {name: final metrics}, as printed."""
    from splatt3r_slam_tpu_torch.parallel.mesh import launch
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    p = argparse.ArgumentParser(prog="python -m splatt3r_slam_tpu_torch."
                                "ablations",
                                description=__doc__.split("\n")[0])
    p.add_argument("--config", default=None)
    p.add_argument("--ablations", nargs="*", default=list(ABLATIONS))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--res", type=int, nargs=2, default=(32, 48))
    p.add_argument("--out", default="logs/ablations")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   help="extra dotlist overrides applied to every run")
    cm.add_device_args(p)  # --device, and --tiny: the tiny fp32 model
    args = p.parse_args(argv)
    device, _ = cm.setup(args)

    results = launch(_run_rank, args.devices, (args,),
                     device_type=device.type)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
