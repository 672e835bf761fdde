from splatt3r_slam_tpu_torch.lie import sim3  # noqa: F401
