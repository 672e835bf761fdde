"""The benchmark of the PyTorch/CUDA port (`splatt3r_slam_tpu_torch`):
`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`. See `run.py`."""
