from splatt3r_slam_tpu_torch.splat.gaussians import (  # noqa: F401
    GaussianAccumulator,
    build_covariance,
    cov_to_triu,
)
