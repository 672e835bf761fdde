"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything is found by name: the cell in `BENCHMARK.json`, its
configuration in `benchmark/configs/<config>.json`, its traffic in
`benchmark/workloads/<traffic>.json`, its limits in
`benchmark/limits/<cell>.json` and each per-layer metric's reader in
`benchmark/metrics/<metric>.py`.

A run makes the weights, the frames and the true trajectory from the
seed, sets up the program (`splatt3r_slam_tpu_torch`) and warms it up on
part of a session (that is `setup_s`), then runs sessions back to back
for `--seconds`: `frames_per_s` is the frames completed over the window's
seconds, `frame_ms_p95` the 95th percentile of every frame's time. With
`--trace 1` the first session of the window runs under `torch.profiler`
and the line carries the per-layer metrics instead. After the window the
program's outputs are compared with the plain reference
(`benchmark/reference/`), and the numbers compared, each with its limit,
end both the standard error and the result line.

The run needs as many CUDA devices as the cell asks for, and fails
without a result where there are fewer, or where JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "splatt3r_slam_tpu")


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


_caches()

import numpy as np  # noqa: E402
import torch  # noqa: E402


def load_cell(workload: str, root: pathlib.Path = ROOT) -> dict:
    """The cell `workload` of `BENCHMARK.json` with its files, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bdir = root / "benchmark"

    def applies(m):
        return workload in m.get("workloads", [workload])

    return {
        "entry": entry,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads(
            (bdir / "workloads" / f"{entry['traffic']}.json").read_text()),
        "limits": json.loads(
            (bdir / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "metrics_dir": bdir / "metrics",
    }


def reader(metrics_dir: pathlib.Path, name: str):
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


TINY_MODEL = {"enc_embed_dim": 64, "enc_depth": 2, "enc_num_heads": 2,
              "dec_embed_dim": 48, "dec_depth": 4, "dec_num_heads": 2,
              "head_feature_dim": 16, "head_layer_dims": [8, 12, 16, 24],
              "head_last_dim": 16, "dtype": "float32",
              "head_dtype": "float32"}


def tiny(cfg: dict, hw=(48, 64)) -> dict:
    """The configuration at the port's tiny test widths on (h, w) frames:
    for rehearsals on the CPU only."""
    cfg = json.loads(json.dumps(cfg))
    cfg["model"].update(TINY_MODEL)
    cfg["image"] = {"height": int(hw[0]), "width": int(hw[1])}
    cfg["runtime"]["max_gaussians"] = 1 << 16
    return cfg


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell: dict, seed: int, seconds: float, trace: bool,
            device="cuda", small=None, fault=None, control=False,
            started=None) -> dict:
    """One run → {"result": the line's object, "checks": {name: (value,
    limit)}, "info": what else the run saw}. `small`, an (h, w), runs the
    tiny widths on frames of that size (CPU rehearsals); `fault`, a dict
    of `model(model)` and `session(session)`, plants a fault in the program
    under the benchmark's own wrappers (fault tests). `control` adds
    the lower-precision control's readings on the same inputs. Set-up is
    timed from `started` (default: this module's import)."""
    from benchmark import driver, flops
    from benchmark.reference import precise
    from benchmark.reference.compare import Judge
    from benchmark.reference.geometry import Scene
    from benchmark.reference.network import Network, Shape
    from benchmark.traffic import Traffic
    from benchmark.weights import make_state

    cfg = tiny(cell["config"], small) if small else cell["config"]
    spec, limits = cell["traffic"], cell["limits"]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    slam = cfg["slam"]
    h, w = cfg["image"]["height"], cfg["image"]["width"]
    shape = Shape.from_dict(cfg["model"])
    state = make_state(shape, seed, dev)
    traffic = Traffic(spec, h, w, slam["dataset"]["subsample"], seed)
    frames, frames_u8 = traffic.frames(dev)
    prog = driver.Program(cfg, state, dev, seed, tiny_retrieval=bool(small),
                          fault=fault)

    def session(index, checked=()):
        return driver.Session(prog, traffic, frames, frames_u8, index,
                              checked, traffic.checked_solves(index)
                              if checked else ())

    # set-up: a warm-up on the traffic's first frames
    warm = session(-1)
    for j in range(min(int(spec["warmup_frames"]), traffic.n)):
        warm.step(j)
    warm.close()
    del warm
    _sync(dev)
    setup_s = time.perf_counter() - (_T0 if started is None else started)

    # the window
    tracer = None
    if trace:
        from benchmark.tracing import Tracer

        tracer = Tracer()
    ops0 = prog.tap.ops
    ran, frame_ms = [], []
    n_frames, traced = 0, None
    t0 = time.perf_counter()
    if tracer is not None:
        tracer.start()
    index = 0
    while True:
        s = session(index, traffic.checked(index))
        done = False
        for j in range(traffic.n):
            s.step(j)
            n_frames += 1
            frame_ms.append(s.records[-1]["ms"])
            if tracer is not None and traced is None and (
                    n_frames == int(spec["trace_frames"])):
                tracer.stop(lambda: _sync(dev))
                traced = (n_frames, prog.tap.ops - ops0,
                          [dict(r) for r in s.records])
            if time.perf_counter() - t0 >= seconds and (
                    tracer is None or traced is not None):
                done = True
                break
        ran.append((s.records, s.solves, s.close(), s.captures, s.chunks))
        del s
        index += 1
        if done:
            break
    _sync(dev)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the program's state goes before the reference runs
    del prog
    records = [r for rec, *_ in ran for r in rec]
    for r in records:
        r["T_WC"] = r["T_WC"].detach().double().cpu().numpy()
    sessions = [(r[0], r[2]) for r in ran]
    solves = [sv for r in ran for sv in r[1] if sv["calls"]]
    captures = [c for r in ran for c in r[3]]
    chunks = [c for r in ran for c in r[4]]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    info = {"frames": n_frames, "sessions": len(ran), "elapsed_s": elapsed,
            "keyframes": sum(len(s[1]["keyframes"]) for s in sessions),
            "edges": sum(len(s[1]["edges"]) for s in sessions),
            "loop_edges": [sum(1 for i, j in s[1]["edges"] if j - i > 1)
                           for s in sessions],
            "failed": sum(1 for r in records if r["after"] != "TRACKING"),
            "checked_frames": len(captures), "checked_solves": len(solves),
            "checked_chunks": len(chunks),
            "first_lost": next(([r["session"], r["j"]] for r in records
                                if r["after"] != "TRACKING"), None),
            # how far the poses' quaternions are from unit length
            "quat_norm_gap": max((abs(float(np.linalg.norm(r["T_WC"][3:7]))
                                      - 1.0) for r in records), default=0.0)}

    # per-layer metrics from the trace
    window = None
    if tracer is not None:
        t_r = time.perf_counter()
        window = tracer.window()
        del tracer
        nf, ops, trecs = traced
        window.frames = nf
        window.keyframes = sum(1 for r in trecs if r["flag"])
        window.flops = float(ops)
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
        window.peak_flops = flops.PEAKS.get(name, {}).get("bf16")
        info["trace_reduce_s"] = time.perf_counter() - t_r

    # the comparison
    t_c = time.perf_counter()
    precise()
    net = Network(shape).to(dev)
    net.load_state_dict(state, strict=True, assign=True)
    scene = Scene(h, w, traffic.plane_n, traffic.plane_d)
    judge = Judge(net, slam, frames, scene, traffic.poses, (h, w),
                  bool(cfg["runtime"]["retrieval"]),
                  PRECISION[cfg["model"]["head_dtype"]],
                  cfg["runtime"]["gaussians"])
    values = compare_all(judge, captures, solves, chunks)
    loop = judge.loop(sessions, float(limits["margin"]))
    checks = {}
    for name, vals in values.items():
        if name in limits and vals:
            checks[name] = (max(vals), float(limits[name]))
    for name, v in loop.items():
        if name in limits:
            checks[name] = (v, float(limits[name]))
    due = ["trunk", "track", "solve", "accum"] + (
        ["render"] if cfg["runtime"]["render_every"] else [])
    for name in due:
        if name not in checks:  # nothing of that stage was compared
            checks[name] = (math.inf, float(limits[name]))
    extra = {}
    if control:
        extra["control"] = compare_all(judge, captures, solves, chunks,
                                       control=lower(cfg["model"]))
    info["check_s"] = time.perf_counter() - t_c
    correct = all(math.isfinite(v) and v <= lim for v, lim in
                  checks.values())

    # the line
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = reader(cell["metrics_dir"], m["name"])(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell["end_to_end"]:
            if m["name"] == "frames_per_s":
                v = n_frames / elapsed
            elif m["name"] == "frame_ms_p95":
                v = float(np.percentile(frame_ms, 95))
            elif m["name"] == "setup_s":
                v = setup_s
            else:
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n_frames,
              "failed": info["failed"], "metrics": metrics,
              "device": device_info}
    if window is not None:
        device_info["busy_s"] = window.busy() * 1e-9
        device_info["window_s"] = window.seconds
        result["breakdown"] = window.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    info["frame_ms_median"] = statistics.median(frame_ms) if frame_ms \
        else None
    return {"result": result, "checks": checks, "info": info,
            "values": values, "loop": loop, **extra}


PRECISION = {"bfloat16": "bf16", "float32": "fp32"}


def lower(model: dict) -> tuple[str, str]:
    """The control's precisions (trunk, heads): the next below each that
    the configuration states, fp8 below bf16 and bf16 below fp32."""
    step = {"bfloat16": "fp8", "float32": "bf16"}
    return step[model["dtype"]], step[model["head_dtype"]]


def compare_all(judge, captures, solves, chunks, control=None,
                stages=("trunk", "heads", "gauss", "match", "render",
                        "accum", "track", "fusion", "solve")) -> dict:
    """{number: [a reading per checked frame or solve]}: the program's,
    or with `control` = (trunk, heads) precisions the control's, each
    stage on the program's own inputs to it."""
    import torch

    from benchmark.reference import solve

    net = None if control is None else judge.net.with_precision(*control)
    ar = solve.REFERENCE if control is None else solve.CONTROL
    dt = None if control is None else torch.bfloat16
    out = {k: [] for k in stages}
    for cap in captures:
        if "trunk" in stages:
            out["trunk"].append(judge.trunk(cap, net))
        if "heads" in stages:
            hd, ga = judge.heads(cap, net)
            out["heads"].append(hd)
            if ga is not None:
                out["gauss"].append(ga)
        if "match" in stages:
            out["match"].append(judge.match(cap, dt))
        if "render" in stages:
            r = judge.render(cap, dt)
            if r is not None:
                out["render"].append(r)
        if "track" in stages:
            tr, fu, dr = judge.track(cap, ar)
            out["track"].append(tr)
            out["fusion"].append(fu)
            if control is not None:
                out.setdefault("drift", []).append(dr)
    if "accum" in stages:
        for ch in chunks:
            out["accum"].append(judge.accum(ch, dt))
    if "solve" in stages:
        for sv in solves:
            v = judge.backend(sv, ar)
            if v is not None:
                out["solve"].append(v)
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    need = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    out = execute(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        return 4
    print(json.dumps({"run": out["info"]}), file=sys.stderr)
    for name, (v, lim) in out["checks"].items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
