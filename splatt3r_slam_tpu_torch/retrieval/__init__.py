from splatt3r_slam_tpu_torch.retrieval.database import RetrievalDatabase  # noqa: F401
