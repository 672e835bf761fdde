"""`bench_system --oracle --fused` of the port against the JAX script's.

`python -m splatt3r_slam_tpu_torch.scripts.bench_system --device cpu
--oracle --fused --frames 18` (the tiny fp32 model at 48x64, base.yaml,
the fused frontend at match stride 2, the plane-scene oracle) against the
JAX `scripts/bench_system.py --tiny --oracle --fused --frames 18` run with
JAX_PLATFORMS=cpu. The JAX side runs the script's own closed loop,
`run_oracle_closed_loop`, on the script's arguments, with base.yaml loaded
as its `main` loads it, in this process. Its `main` would first make the
tiny model's weights with flax's init (about 40 s on this CPU, a minute
for the whole script); the engine here holds the port's seeded weights
converted with the JAX package's `convert_state_dict` instead. The
weights cannot reach the result: in the fused step the oracle's geometry
replaces every network output the tracking, the keyframe criterion and
the backend read. Both must give the same keyframes, RELOC count,
relocalizations and backend edges, ATE within 1e-3 m, and the same key
set (the port adds `device` and `power_limit_w`).
"""

import argparse
import contextlib
import io
import json
import pathlib

import jax
import jax.numpy as jnp

from splatt3r_slam_tpu import config as jcfg
from splatt3r_slam_tpu.models import Splatt3RModel as JModel
from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.models.checkpoint import convert_state_dict
from splatt3r_slam_tpu.runtime.inference import InferenceEngine as JEngine
from splatt3r_slam_tpu_torch.models import TwoViewConfig, init_model
from splatt3r_slam_tpu_torch.scripts import bench_system
from test_torch_port_bench import load_jax_script, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES = 18


def jax_oracle_run() -> dict:
    js = load_jax_script()
    jc = JConfig(dtype="float32", head_dtype="float32").tiny()
    seed = init_model(TwoViewConfig(dtype="float32",
                                    head_dtype="float32").tiny(),
                      seed=0, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in seed.state_dict().items()}, jc))
    engine = JEngine(JModel(jc), jp, 48, 64)
    saved = jcfg.config.copy()
    jcfg.load_config(str(ROOT / "config" / "base.yaml"))
    args = argparse.Namespace(
        frames=FRAMES, tiny=True, oracle=True, fused=True, noise=0.0,
        conf_noise=0.0, blackout=None, retrieval=False, prewarm=False)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            js.run_oracle_closed_loop(args, engine, jc, 48, 64, jcfg)
    finally:
        jcfg.set_global_config(saved)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_bench_system_oracle_fused_matches_jax_script(capsys):
    ret = bench_system.main(["--device", "cpu", "--oracle", "--fused",
                             "--frames", str(FRAMES)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == ret
    want = jax_oracle_run()
    assert set(out) == set(want) | {"device", "power_limit_w"}
    assert out["metric"] == want["metric"] == "closed_loop_fused_fps_tiny"
    for k in ("frames", "match_stride", "frontend", "mode", "keyframes",
              "relocs", "reloc_successes", "backend_edges", "threaded",
              "retrieval", "blackout"):
        assert out[k] == want[k], k
    assert out["relocs"] == 0 and out["keyframes"] >= 3
    assert abs(out["ate_rmse_m"] - want["ate_rmse_m"]) <= 1e-3
    assert out["ate_rmse_m"] < 0.16  # the JAX package's CI budget
    assert len(out["frame_ms"]) == FRAMES
