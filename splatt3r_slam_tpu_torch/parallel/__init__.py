from splatt3r_slam_tpu_torch.parallel.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
)
