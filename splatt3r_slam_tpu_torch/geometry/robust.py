"""Robust NLLS helpers (Huber / Tukey weights, convergence test).

Counterpart of `splatt3r_slam_tpu/geometry/robust.py`.
"""

from __future__ import annotations

import torch


def huber(r, k: float = 1.345):
    """Huber IRLS weight: 1 for |r|<k else k/|r|."""
    r_abs = r.abs()
    inside = r_abs < k
    r_safe = torch.where(inside, torch.ones_like(r_abs), r_abs)
    return torch.where(inside, torch.ones_like(r_abs), k / r_safe)


def tukey(r, t: float = 4.6851):
    """Tukey biweight."""
    r_abs = r.abs()
    tmp = 1.0 - (r_abs / t) ** 2
    return torch.where(r_abs < t, tmp * tmp, torch.zeros_like(tmp))


def check_convergence(rel_error_threshold, delta_norm_threshold, old_cost,
                      new_cost, delta):
    """Relative-cost-decrease OR small-step test (a bool tensor)."""
    rel_dec = ((old_cost - new_cost) / old_cost).abs()
    return (rel_dec < rel_error_threshold) | (
        torch.linalg.norm(delta) < delta_norm_threshold)
