"""The port's soak and profilers on the CPU, tiny form.

`python -m splatt3r_slam_tpu_torch.scripts.soak --device cpu` at CI scale
(60 frames, a keyframe every 4, a keyframe buffer of 8, at most 6 edges
and 1,024 gaussians) must hold the bounds of `tests/test_soak.py`: the
run goes on past the buffer's capacity, the edge window holds its cap, the
pool's FIFO eviction fires and holds its cap, FPS stays within 3x across
the thirds, and no third exceeds the caps. Device memory is None on the
CPU. `profile_stages` and `profile_keyframe_event` print their JSON last,
with the keys they define.
"""

import json

from splatt3r_slam_tpu_torch.scripts import (
    profile_keyframe_event,
    profile_stages,
    soak,
)
from test_torch_port_bench import one_torch_thread  # noqa: F401


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_soak_tiny_bounded_buffers_flat_fps(capsys):
    ret = soak.main(["--device", "cpu", "--frames", "60", "--kf-every", "4",
                     "--kf-capacity", "8", "--max-edges", "6",
                     "--max-gaussians", "1024"])
    out = last_json(capsys)
    assert out == ret
    assert out["tiny"] is True and out["frames"] == 60
    assert out["keyframes_final"] > 8
    assert out["over_capacity_frames"] > 0
    assert out["edges_final"] <= 6
    assert out["pool_evictions"] >= 1
    assert out["gaussians_final"] <= 1024
    fps = [t["fps"] for t in out["thirds"]]
    assert len(fps) == 3
    assert fps[2] > fps[0] / 3.0, f"FPS collapsed across thirds: {fps}"
    assert max(t["edges"] for t in out["thirds"]) <= 6
    assert max(t["gaussians"] for t in out["thirds"]) <= 1024
    # a keyframe every 4 frames: frame 0 and frames 4, 8, ..., 56
    assert out["keyframes_final"] == 15
    assert out["mem_mb_post_warmup"] is None
    assert out["peak_mem_mb_post_warmup"] is None
    assert all(t["mem_mb"] is None and t["peak_mem_mb"] is None
               for t in out["thirds"])
    assert out["device"] == "cpu" and out["power_limit_w"] is None


def test_profile_stages_keys(capsys):
    ret = profile_stages.main(["--device", "cpu", "--iters", "2"])
    out = last_json(capsys)
    assert out == ret
    stages = ("encode_ms", "decode_ms", "head1_ms", "head2_ms", "match_ms",
              "gn_ms", "fused_step_ms")
    assert set(out) == set(stages) | {
        "sum_stages_ms", "fusion_gain_ms", "device_ms", "kernels_per_call",
        "fused_step_top_kernels", "fused_step_gflop",
        "achieved_tflops", "mfu_pct_vs_h100_bf16_peak", "match_stride",
        "backend", "hw", "device", "power_limit_w"}
    assert set(out["device_ms"]) == set(out["kernels_per_call"]) == \
        set(stages)
    # no card: no kernel times
    assert out["fused_step_top_kernels"] is None
    assert all(v is None for v in out["device_ms"].values())
    assert all(out[k] > 0 for k in stages)
    assert out["sum_stages_ms"] > 0 and out["fused_step_gflop"] > 0
    assert abs(out["sum_stages_ms"] - sum(out[k] for k in stages[:-1])) \
        <= 0.05
    assert out["mfu_pct_vs_h100_bf16_peak"] is None  # no card
    assert out["hw"] == "48x64" and out["match_stride"] == 2


def test_profile_keyframe_event_keys(capsys):
    ret = profile_keyframe_event.main(["--device", "cpu", "--kfs", "3"])
    out = last_json(capsys)
    assert out == ret
    parts = ("match_symmetric_1edge_ms", "add_factors_1edge_ms", "solve_ms",
             "retrieval_update_ms", "gaussians_to_world_ms",
             "gs_to_world_plus_pool_append_ms", "keyframes_append_ms")
    assert set(out) == set(parts) | {"kfs", "edges", "kf_event_sum_ms",
                                     "device", "power_limit_w"}
    assert out["kfs"] == 3 and out["edges"] >= 2
    assert all(out[k] >= 0 for k in parts)
    assert out["kf_event_sum_ms"] > 0
