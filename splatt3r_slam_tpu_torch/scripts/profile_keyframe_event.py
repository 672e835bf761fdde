"""Per-part times of the port's keyframe event.

    python -m splatt3r_slam_tpu_torch.scripts.profile_keyframe_event
        [--kfs N] [--out FILE] [--device cuda|cpu] [--tiny]

Counterpart of the repository's `scripts/profile_keyframe_event.py`. The
tracking step is profiled by `profile_stages.py`; this times what a new
keyframe costs on top of it, part by part, after building up `--kfs`
keyframes (one forced every frame, seeded random weights, full width,
the retrieval database with its 65,536-word codebook):

- `keyframes_append_ms`: `KeyframeBuffer.append` (and `pop_last`);
- `match_symmetric_1edge_ms`: `InferenceEngine.match_symmetric` for one
  edge (one decoder batch of two views, tracking-mode heads, matching);
- `add_factors_1edge_ms`: `FactorGraph.add_factors` for one edge (the
  above, the gate and the edge's append; the edge is removed again);
- `solve_ms`: the pose-graph solve at that edge count;
- `retrieval_update_ms`: `RetrievalDatabase.update` (query, no add);
- `gaussians_to_world_ms` and `gs_to_world_plus_pool_append_ms`:
  gaussians to world, and with the pool's append.

`kf_event_sum_ms` adds append, add_factors, solve, retrieval update and
gaussians with the append, as the JAX script does. Each part runs 5 times
after one warm-up call, and its window ends in a device synchronise. The
JSON result is the last line of stdout (`--out` writes it too; the JAX
script always writes `logs/profile_keyframe_event.json`). Runs on CUDA by
default and never falls back to the CPU (see `scripts/_common.py`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def timeit(fn, device, iters=5, warmup=1) -> float:
    """Host ms per call over `iters` chained calls ending in a
    synchronise."""
    from splatt3r_slam_tpu_torch.scripts._common import sync

    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None, model=None) -> dict:
    """Profile the keyframe event; `model` (a full-width `Splatt3RModel`
    on the device) skips building one. Returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts."
             "profile_keyframe_event",
        description=__doc__.split("\n")[0])
    cm.add_device_args(ap)
    ap.add_argument("--kfs", type=int, default=8,
                    help="keyframes to build up before timing")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device, tiny = cm.setup(args)
    if args.kfs < 2:
        ap.error("--kfs must be at least 2 (one edge)")

    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch.backend import FactorGraph
    from splatt3r_slam_tpu_torch.backend.factor_graph import _EDGE_LISTS
    from splatt3r_slam_tpu_torch.retrieval import RetrievalDatabase
    from splatt3r_slam_tpu_torch.runtime.frame import Mode, create_frame
    from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
    from splatt3r_slam_tpu_torch.splat import GaussianAccumulator

    cm.load_base_config()
    cfg = cm.model_config(tiny)
    h, w = cm.hw(tiny)
    engine = InferenceEngine(cm.make_model(cfg, device, model), h, w)
    system = SLAMSystem(engine, h, w)
    if tiny:
        retrieval = RetrievalDatabase(feat_dim=cfg.enc_embed_dim,
                                      proj_dim=cfg.enc_embed_dim,
                                      n_words=1024, nfeat=64, device=device)
    else:
        retrieval = RetrievalDatabase(device=device)
    system.backend = FactorGraph(engine, system.keyframes,
                                 retrieval=retrieval)
    system.gaussian_module = GaussianAccumulator(spatial_stride=4)

    # build up a keyframe graph: a keyframe forced every frame
    rng = np.random.default_rng(0)
    small = rng.random((h // 8 + args.kfs, w // 8 + args.kfs, 3)
                       ).astype(np.float32)
    base = np.kron(small, np.ones((8, 8, 1), np.float32))
    cfgmod.config["tracking"]["min_match_frac"] = 0.0
    frames = []
    for i in range(args.kfs):
        img = np.ascontiguousarray(base[4 * i: 4 * i + h, 6 * i: 6 * i + w])
        f = create_frame(i, img, img_size=w, device=device)
        frames.append(f)
        system.process_frame(f, force_keyframe=(i > 0))
        if system.mode == Mode.RELOC and i > 0:
            # random weights: a failed GN sends the frame to RELOC, which
            # skips the keyframe; run the event itself so the graph grows
            system.mode = Mode.TRACKING
            system.add_keyframe(f)
    print(f"built {len(system.keyframes)} keyframes, "
          f"{len(system.backend.ii)} edges", flush=True)

    fg = system.backend
    kfN = len(system.keyframes) - 1
    kf_a, kf_b = system.keyframes[kfN - 1], system.keyframes[kfN]
    for kf in (kf_a, kf_b):
        engine.ensure_encoded(kf)
    res = {"kfs": len(system.keyframes), "edges": len(fg.ii)}

    def t(fn):
        return timeit(fn, device)

    res["match_symmetric_1edge_ms"] = t(
        lambda: engine.match_symmetric(kf_a.feat, kf_a.pos, kf_b.feat,
                                       kf_b.pos))

    def add_remove():
        n0 = len(fg.ii)
        fg.add_factors([kfN - 1], [kfN], 0.0)
        for name in ("ii", "jj") + _EDGE_LISTS:  # state stays fixed
            del getattr(fg, name)[n0:]

    res["add_factors_1edge_ms"] = t(add_remove)
    res["solve_ms"] = t(fg.solve)
    res["retrieval_update_ms"] = t(
        lambda: retrieval.update(kf_b, add_after_query=False, k=3,
                                 min_thresh=5e-3))
    engine.ensure_gaussians(frames[-1])
    res["gaussians_to_world_ms"] = t(
        lambda: system.gaussian_module.gaussians_to_world(frames[-1]))

    def pool_append():
        out = system.gaussian_module.gaussians_to_world(frames[-1])
        system.pool.append_chunk(*out, kfN)

    res["gs_to_world_plus_pool_append_ms"] = t(pool_append)

    def append_pop():
        system.keyframes.append(frames[-1])
        system.keyframes.pop_last()

    res["keyframes_append_ms"] = t(append_pop)
    res["kf_event_sum_ms"] = (
        res["add_factors_1edge_ms"] + res["solve_ms"]
        + res["retrieval_update_ms"] + res["gs_to_world_plus_pool_append_ms"]
        + res["keyframes_append_ms"])
    system.close()
    res = {k: (round(v, 1) if isinstance(v, float) else v)
           for k, v in res.items()}
    res.update(cm.device_fields(device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
