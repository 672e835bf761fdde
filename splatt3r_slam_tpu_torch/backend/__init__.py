from splatt3r_slam_tpu_torch.backend.factor_graph import FactorGraph  # noqa: F401
