from splatt3r_slam_tpu_torch.models.two_view import (  # noqa: F401
    Splatt3RModel,
    TwoViewConfig,
    init_model,
    init_weights,
)
