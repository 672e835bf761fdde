"""Training workspace: config includes + dotlist merges + provenance.

Counterpart of `splatt3r_slam_tpu/parallel/workspace.py`: a config with an
`include:` list, command-line dotlist overrides, a timestamped workspace
directory, and a git-commit provenance snapshot. Files and dotlist values
are read with the port's own YAML reader (`config.parse_yaml`,
`config.parse_scalar`), so PyYAML is not needed:
values resolve as the JAX package's loader resolves them, extended float
resolver included (``1e-3`` is a float). Where PyYAML is installed it
writes the resolved-config dump; otherwise the dump is JSON, which is
valid YAML.
"""

from __future__ import annotations

import datetime
import json
import pathlib
import subprocess

from splatt3r_slam_tpu_torch.config import parse_scalar, parse_yaml


def _set_dotted(cfg: dict, dotted: str, value):
    keys = dotted.split(".")
    d = cfg
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = parse_scalar(value) if isinstance(value, str) else value


def apply_dotlist(cfg: dict, dotlist=()) -> dict:
    for item in dotlist:
        k, v = item.split("=", 1)
        _set_dotted(cfg, k, v)
    return cfg


def load_config(path: str, dotlist=()) -> dict:
    """YAML with `include:` list (merged in order) + dotlist overrides.
    An include path is tried as given, then next to the including file."""
    path = pathlib.Path(path)
    cfg = parse_yaml(path.read_text(), str(path)) or {}
    includes = cfg.pop("include", [])
    merged: dict = {}
    for inc in includes:
        inc_path = pathlib.Path(inc)
        if not inc_path.exists():
            inc_path = path.parent / inc
        merged = _deep_merge(merged, load_config(str(inc_path)))
    return apply_dotlist(_deep_merge(merged, cfg), dotlist)


def _deep_merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def git_provenance(repo_dir=".") -> dict:
    """Commit hash + dirty state."""
    def run(*args):
        try:
            return subprocess.run(
                ["git", *args], cwd=repo_dir, capture_output=True, text=True,
                timeout=10,
            ).stdout.strip()
        except Exception:
            return ""

    return {
        "commit": run("rev-parse", "HEAD"),
        "branch": run("rev-parse", "--abbrev-ref", "HEAD"),
        "dirty": bool(run("status", "--porcelain")),
    }


def create_workspace(root: str, name: str, config: dict) -> pathlib.Path:
    """Timestamped run dir with the resolved config + provenance dumped.
    Under a process group it is a collective: rank 0 creates the directory
    and every rank gets its path."""
    import torch.distributed as dist

    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    ws = pathlib.Path(root) / f"{name}_{stamp}"
    if dist.is_initialized():
        box = [ws]
        dist.broadcast_object_list(box, src=0)
        ws = box[0]
        if dist.get_rank() != 0:
            return ws
    ws.mkdir(parents=True, exist_ok=True)
    with open(ws / "config.yaml", "w") as f:
        try:
            import yaml

            yaml.safe_dump(config, f)
        except ImportError:
            json.dump(config, f, indent=1)
    with open(ws / "provenance.json", "w") as f:
        json.dump(git_provenance(), f, indent=2)
    return ws
