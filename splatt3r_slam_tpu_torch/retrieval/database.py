"""Loop-closure retrieval database (query-then-add).

Counterpart of `splatt3r_slam_tpu/retrieval/database.py`: per-keyframe
top-k attention features, ASMK quantize / aggregate / IVF search, a query
before (optionally) adding, its own keyframe counter and a minimum score.
One device pass per update (feature head, quantization, and the binary
aggregation of both the ma-way query and the 1-way add) ends in one host
pull of a packed int32 matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from splatt3r_slam_tpu_torch import resolve_device
from splatt3r_slam_tpu_torch.retrieval import asmk as asmk_mod
from splatt3r_slam_tpu_torch.retrieval.model import (
    init_retrieval_params,
    load_retrieval_checkpoint,
    params_to_device,
    prep_features,
)


@torch.no_grad()
def update_device(params, backbone_feat, centroids, nfeat: int,
                  residual: bool, ma: int):
    """The update's device pass → one packed int32 matrix: rows
    [word, bits as int32 (D/32), valid] of the ma-way query aggregate, then
    those of the 1-way add aggregate."""
    feat = prep_features(params, backbone_feat, nfeat=nfeat,
                         residual=residual)[0]
    words = asmk_mod.quantize(feat, centroids, ma)  # (n, ma)

    def pack(w, b, v):
        return torch.cat([w[:, None], b.contiguous().view(torch.int32),
                          v[:, None].to(torch.int32)], dim=1)

    return torch.cat([
        pack(*asmk_mod.aggregate_binary_torch(feat, words, centroids)),
        pack(*asmk_mod.aggregate_binary_torch(feat, words[:, :1],
                                              centroids))])


class RetrievalDatabase:
    """update(frame, add_after_query, k, min_thresh) → prior keyframe ids."""

    def __init__(self, checkpoint_path=None, codebook_path=None,
                 feat_dim: int = 1024, proj_dim: int = 1024,
                 n_words: int = 65536, nfeat: int = 300, seed: int = 0,
                 ma_query: int = 5, alpha: float = 3.0, device="cuda"):
        self.device = resolve_device(device)
        if checkpoint_path is not None:
            self.params = load_retrieval_checkpoint(checkpoint_path)
            self.nfeat = self.params.get("nfeat", nfeat)
            proj_dim = self.params["postwhiten"]["p"].shape[0]
        else:
            self.params = init_retrieval_params(feat_dim, (proj_dim,), seed)
            self.nfeat = nfeat
        if codebook_path is not None:
            self.codebook = asmk_mod.Codebook.load(codebook_path, self.device)
        else:
            self.codebook = asmk_mod.Codebook.random(n_words, proj_dim, seed,
                                                     self.device)
        self.ivf = asmk_mod.IVF(self.codebook.size, proj_dim)
        self._residual = bool(self.params.get("residual", False))
        self._params_dev = params_to_device(
            {k: self.params[k] for k in ("prewhiten", "postwhiten",
                                         "projector")}, self.device)
        self.ma_query = ma_query
        self.alpha = alpha
        self.kf_counter = 0
        self.kf_ids: list[int] = []

    # ------------------------------------------------------------------
    def prep_features(self, backbone_feat):
        return prep_features(self._params_dev, backbone_feat.to(self.device),
                             nfeat=self.nfeat, residual=self._residual)

    def _quantize_aggregate(self, feat_np: np.ndarray, ma: int,
                            words_ma: np.ndarray | None = None):
        if words_ma is None:
            words_ma = asmk_mod.quantize(
                torch.as_tensor(feat_np, device=self.device),
                self.codebook.dev, ma).cpu().numpy()  # (n, ma)
        vecs = np.repeat(feat_np, ma, axis=0)
        return asmk_mod.aggregate_binary(vecs, words_ma.reshape(-1),
                                         self.codebook.centroids)

    def _device_update(self, backbone_feat):
        """One device pass + one host pull → ((qwords, qbits), (awords,
        abits)) for the ma-way query and the 1-way add (bits (m, D/8)
        uint8 in np.packbits order)."""
        packed = update_device(
            self._params_dev, backbone_feat.to(self.device),
            self.codebook.dev, self.nfeat, self._residual, self.ma_query,
        ).cpu().numpy()
        # rows: n_feat·ma (query) + n_feat (add), n_feat ≤ self.nfeat
        nq = packed.shape[0] // (self.ma_query + 1) * self.ma_query

        def unpack(rows):
            rows = rows[rows[:, -1] > 0]
            bits = np.ascontiguousarray(rows[:, 1:-1]).view(np.uint8)
            return rows[:, 0].astype(np.int64), bits.reshape(len(rows), -1)

        return unpack(packed[:nq]), unpack(packed[nq:])

    def update(self, frame, add_after_query: bool, k: int,
               min_thresh: float = 0.0):
        """Query the database with this frame, then optionally add it.
        Returns database indices (the keyframe order of addition) of the
        top-k matches scoring above min_thresh."""
        (qw, qb), (aw, ab) = self._device_update(frame.feat)
        topk_inds: list[int] = []
        if self.kf_counter > 0:
            scores = self.ivf.search(qw, qb, alpha=self.alpha)
            order = np.argsort(-scores)[:min(k, self.ivf.n_images)]
            topk_inds = [int(i) for i in order if scores[i] > min_thresh]
        if add_after_query:
            self._add_np(aw, ab)
        return topk_inds

    def query(self, feat_np: np.ndarray,
              words_ma: np.ndarray | None = None) -> np.ndarray:
        words, bits = self._quantize_aggregate(feat_np, self.ma_query,
                                               words_ma=words_ma)
        return self.ivf.search(words, bits, alpha=self.alpha)

    def add_to_database(self, frame):
        _, (aw, ab) = self._device_update(frame.feat)
        self._add_np(aw, ab)

    def add_to_database_np(self, feat_np: np.ndarray,
                           words1: np.ndarray | None = None):
        words, bits = self._quantize_aggregate(feat_np, ma=1,
                                               words_ma=words1)
        self._add_np(words, bits)

    def _add_np(self, words: np.ndarray, bits: np.ndarray):
        self.ivf.add(words, bits, self.kf_counter)
        self.kf_ids.append(self.kf_counter)
        self.kf_counter += 1
