from splatt3r_slam_tpu_torch.geometry.projective import (  # noqa: F401
    backproject,
    constrain_points_to_ray,
    decompose_K,
    get_pixel_coords,
    point_to_dist,
    point_to_ray_dist,
    project_calib,
)
from splatt3r_slam_tpu_torch.geometry.robust import (  # noqa: F401
    check_convergence,
    huber,
    tukey,
)
