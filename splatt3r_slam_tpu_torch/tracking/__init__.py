from splatt3r_slam_tpu_torch.tracking.tracker import (  # noqa: F401
    TrackingConfig,
    opt_pose_calib_sim3,
    opt_pose_ray_dist_sim3,
)
