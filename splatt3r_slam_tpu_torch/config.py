"""Config system: built-in `config/base.yaml` defaults, `inherit:` chains,
deep merge, and a module-global config dict.

Counterpart of `splatt3r_slam_tpu/config.py`. The machines the port runs on
may lack PyYAML, so `config/base.yaml`'s values are the built-in defaults
(`DEFAULTS`, and `config` starts as a copy of them); `yaml` is imported only
inside `load_config`, which reads the same schema as the reference.
"""

from __future__ import annotations

import copy
import pathlib
import re

# config/base.yaml, value for value
DEFAULTS: dict = {
    "use_calib": False,
    "single_thread": True,
    "dataset": {
        "subsample": 1,
        "img_downsample": 1,
        "center_principle_point": True,
    },
    "matching": {
        "max_iter": 10,
        "lambda_init": 1e-8,
        "convergence_thresh": 1e-6,
        "dist_thresh": 1e-1,
        "radius": 3,
        "dilation_max": 5,
        "match_stride": 2,
    },
    "tracking": {
        "pipeline_lag": 0,
        "min_match_frac": 0.05,
        "max_iters": 50,
        "C_conf": 0.0,
        "Q_conf": 1.5,
        "rel_error": 1e-3,
        "delta_norm": 1e-3,
        "huber": 1.345,
        "match_frac_thresh": 0.333,
        "sigma_ray": 0.003,
        "sigma_dist": 1e1,
        "sigma_pixel": 1.0,
        "sigma_depth": 1e1,
        "sigma_point": 0.05,
        "pixel_border": -10,
        "depth_eps": 1e-6,
        "filtering_mode": "weighted_pointmap",
        "filtering_score": "median",
    },
    "local_opt": {
        "pin": 1,
        "window_size": 1e6,
        "C_conf": 0.0,
        "Q_conf": 1.5,
        "min_match_frac": 0.1,
        "pixel_border": -10,
        "depth_eps": 1e-6,
        "max_iters": 10,
        "sigma_ray": 0.003,
        "sigma_dist": 1e1,
        "sigma_pixel": 1.0,
        "sigma_depth": 1e1,
        "sigma_point": 0.05,
        "delta_norm": 1e-8,
        "max_edges": 512,
        "gn_stride": 16,
        "reuse_tracking_edge": True,
    },
    "retrieval": {"k": 3, "min_thresh": 5e-3},
    "reloc": {"min_match_frac": 0.3, "strict": True},
}

# PyYAML's 1.1 resolver reads "1e-3" as a string; this is the standard
# extended float resolver (installed on first load_config).
_FLOAT_RE = re.compile(
    """^(?:
     [-+]?(?:[0-9][0-9_]*)\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\\.[0-9_]*
    |[-+]?\\.(?:inf|Inf|INF)
    |\\.(?:nan|NaN|NAN))$""",
    re.X,
)
_loader = None

# Module-global config dict, re-pointed in place by set_global_config.
config: dict = copy.deepcopy(DEFAULTS)


def _yaml_loader():
    global _loader
    if _loader is None:
        import yaml

        class _Loader(yaml.SafeLoader):
            pass

        _Loader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT_RE,
                                      list("-+0123456789."))
        _loader = (yaml, _Loader)
    return _loader


def merge_config(base: dict, child: dict) -> dict:
    """Deep merge: child values override base, dicts merge recursively."""
    out = dict(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> dict:
    """Load YAML with `inherit:` parent chaining, set the global config."""
    yaml, loader = _yaml_loader()
    path = pathlib.Path(path)
    with open(path) as f:
        cfg = yaml.load(f, Loader=loader) or {}
    if "inherit" in cfg:
        parent_rel = cfg.pop("inherit")
        # repo-root-relative in the reference; then cwd, then the file's dir
        parent = pathlib.Path(parent_rel)
        if not parent.exists():
            parent = pathlib.Path(__file__).resolve().parents[1] / parent_rel
        if not parent.exists():
            parent = path.parent / pathlib.Path(parent_rel).name
        cfg = merge_config(load_config(str(parent)), cfg)
    set_global_config(cfg)
    return cfg


def set_global_config(cfg: dict) -> None:
    """Point the module-global `config` at cfg's contents (in place)."""
    config.clear()
    config.update(cfg)


def reset_config() -> dict:
    """Restore the built-in base.yaml defaults into the global config."""
    set_global_config(copy.deepcopy(DEFAULTS))
    return config
