"""The port's measurement entry points, run as
``python -m splatt3r_slam_tpu_torch.scripts.<name>``: counterparts of the
repository's `scripts/bench_system.py`, `scripts/soak.py`,
`scripts/profile_stages.py` and `scripts/profile_keyframe_event.py`, of
its kernel and accuracy scripts and of its dataset evaluation scripts
`scripts/eval_*.sh` (`eval_tum`, `eval_euroc`, `eval_7_scenes`,
`eval_eth3d`). `splatt3r_slam_tpu_torch.bench` is the counterpart of
`bench.py`."""
