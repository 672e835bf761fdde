from splatt3r_slam_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from splatt3r_slam_tpu_torch.parallel.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
)
