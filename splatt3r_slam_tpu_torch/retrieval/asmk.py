"""ASMK-style binary aggregated match kernel + incremental inverted file.

Counterpart of `splatt3r_slam_tpu/retrieval/asmk.py`: binary kernel, no
IDF, multiple assignment 1 (database add) / 5 (query), similarity
σ(s) = s·|s|^(α−1) gated at 0 with α = 3.

Quantization (distance matmul + top-k) and the residual aggregation run on
the device (`quantize`, `aggregate_binary_torch`); the inverted file is
append-only host numpy. The device aggregate sums residuals in fp32 and
the host one (`aggregate_binary`) in fp64, as in the JAX package, so a
sign bit can differ where a word's residual sum is near 0.
"""

from __future__ import annotations

import numpy as np
import torch


class _Shim:
    """Permissive stand-in for classes of packages absent here (asmk,
    faiss): accepts any construction/state protocol pickle throws at it."""

    def __init__(self, *args, **kwargs):
        self._shim_args = args
        self._shim_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self._shim_state = state

    def __call__(self, *args, **kwargs):  # e.g. unpickled factory fns
        return _Shim(*args, **kwargs)


def _shim_unpickle(path: str):
    """Unpickle a local codebook file, standing in `_Shim` subclasses for
    classes whose package is not installed."""
    import pickle

    class _U(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_Shim,), {"__module__": module})

    with open(path, "rb") as f:
        return _U(f).load()


def _is_centroid_name(key) -> bool:
    return isinstance(key, str) and any(
        s in key.lower() for s in ("centroid", "codebook", "cluster"))


def _find_centroids(obj) -> np.ndarray | None:
    """BFS the unpickled graph for the visual-word centroid matrix: arrays
    under centroid-like names first, else the largest float 2-D array."""
    from collections import deque

    named, arrays = [], []
    seen = set()
    q = deque([(None, obj)])
    while q:
        key, node = q.popleft()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, np.ndarray):
            if node.ndim == 2 and node.dtype.kind == "f" and node.size:
                (named if _is_centroid_name(key) else arrays).append(node)
            continue
        if isinstance(node, dict):
            q.extend(node.items())
        elif isinstance(node, (list, tuple)):
            q.extend((key, v) for v in node)
        elif hasattr(node, "__dict__"):
            q.extend(node.__dict__.items())
    pool = named or arrays
    return max(pool, key=lambda a: a.size) if pool else None


class Codebook:
    """Visual-word centroids (K, D): host numpy and a device copy."""

    def __init__(self, centroids: np.ndarray, device="cpu"):
        self.centroids = np.asarray(centroids, np.float32)
        self.dev = torch.as_tensor(self.centroids, device=device)

    @property
    def size(self):
        return self.centroids.shape[0]

    @staticmethod
    def random(k: int, d: int, seed: int = 0, device="cpu") -> "Codebook":
        rng = np.random.default_rng(seed)
        c = rng.standard_normal((k, d)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        return Codebook(c, device)

    @staticmethod
    @torch.no_grad()
    def train_kmeans(data: np.ndarray, k: int, iters: int = 20,
                     seed: int = 0, device="cpu") -> "Codebook":
        """Plain k-means on the device (codebook training)."""
        rng = np.random.default_rng(seed)
        init = data[rng.choice(len(data), size=k, replace=len(data) < k)]
        cent = torch.as_tensor(init, dtype=torch.float32, device=device)
        X = torch.as_tensor(data, dtype=torch.float32, device=device)
        for _ in range(iters):
            d2 = ((X * X).sum(1)[:, None] + (cent * cent).sum(1)[None, :]
                  - 2 * X @ cent.T)
            a = torch.argmin(d2, dim=1)
            sums = torch.zeros_like(cent).index_add_(0, a, X)
            cnts = torch.zeros((k, 1), device=device).index_add_(
                0, a, torch.ones((len(X), 1), device=device))
            cent = torch.where(cnts > 0, sums / cnts.clamp(min=1), cent)
        return Codebook(cent.cpu().numpy(), device)

    @staticmethod
    def load(path: str, device="cpu") -> "Codebook":
        """A reference `*_codebook.pkl` (an asmk dump, unpickled with
        stand-ins for the asmk/faiss classes; the centroids are found by
        `_find_centroids`)."""
        cent = _find_centroids(_shim_unpickle(path))
        if cent is None:
            raise ValueError(f"cannot extract centroids from {path}")
        return Codebook(cent, device)


@torch.no_grad()
def quantize(qvecs, centroids, ma: int = 1):
    """Top-`ma` nearest centroids by the expanded-L2 matmul:
    topk(−(|q|² + |c|² − 2 q·cᵀ)) → (n, ma) int64."""
    d2 = ((qvecs * qvecs).sum(1)[:, None]
          + (centroids * centroids).sum(1)[None, :] - 2 * qvecs @ centroids.T)
    return torch.topk(-d2, ma, dim=1).indices


def aggregate_binary(vecs: np.ndarray, word_ids: np.ndarray,
                     centroids: np.ndarray):
    """Per-word residual sum → sign-binarized descriptors (host, fp64).

    vecs (n, D); word_ids (n,) assignments aligned with vecs. Returns
    (words (w,) int64 ascending, bits (w, D/8) uint8, np.packbits order)."""
    order = np.argsort(word_ids, kind="stable")
    w_sorted = word_ids[order]
    resid = vecs[order] - centroids[w_sorted]
    words, starts = np.unique(w_sorted, return_index=True)
    # segment sums as fp64 cumsum differences (a fp32 running sum could
    # cancel to ~1e-3 and flip bits of segments whose sum is near 0)
    cs = np.cumsum(resid, axis=0, dtype=np.float64)
    ends = np.concatenate([starts[1:], [resid.shape[0]]])
    sums = cs[ends - 1].copy()
    nz = starts > 0
    sums[nz] -= cs[starts[nz] - 1]
    bits = np.packbits((sums > 0).astype(np.uint8), axis=1)
    return words.astype(np.int64), bits


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits_torch(bools):
    """(..., D) bool → (..., D/8) uint8 in np.packbits' big bit order."""
    x = bools.to(torch.int32).reshape(*bools.shape[:-1], -1, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bools.device)
    return (x * w).sum(-1).to(torch.uint8)


@torch.no_grad()
def aggregate_binary_torch(vecs, words, centroids):
    """Device aggregate_binary. vecs (n, D) fp32; words (n, ma); centroids
    (K, D). Returns (words (N,) int32, bits (N, D/8) uint8, valid (N,)
    bool) with N = n·ma rows: the segment sums occupy the leading `valid`
    rows in ascending word order, as the host version returns them."""
    n, ma = words.shape
    v = torch.repeat_interleave(vecs, ma, dim=0)
    w = words.reshape(-1)
    w_sorted, order = torch.sort(w, stable=True)
    resid = v[order] - centroids[w_sorted]
    is_start = torch.ones_like(w_sorted, dtype=torch.bool)
    is_start[1:] = w_sorted[1:] != w_sorted[:-1]
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    N = w_sorted.shape[0]
    sums = torch.zeros((N, vecs.shape[1]), dtype=torch.float32,
                       device=vecs.device).index_add_(0, seg, resid)
    words_out = torch.zeros(N, dtype=torch.int64, device=vecs.device)
    words_out[seg] = w_sorted
    valid = torch.arange(N, device=vecs.device) <= seg[-1]
    return words_out.to(torch.int32), pack_bits_torch(sums > 0), valid


_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(1).astype(np.int32)


def binary_similarity(qbits: np.ndarray, dbits: np.ndarray, dim: int,
                      alpha: float = 3.0, threshold: float = 0.0):
    """σ over packed bit descriptors: s = 1 − 2·hamming/D, gated + powered
    (the asmk binary kernel)."""
    ham = _POPCNT[np.bitwise_xor(qbits, dbits)].sum(axis=-1)
    s = 1.0 - 2.0 * ham / dim
    out = np.sign(s) * np.abs(s) ** alpha
    return np.where(s >= threshold, out, 0.0)


class IVF:
    """Append-only inverted file: word → (image ids, packed residual bits),
    host numpy, consolidated into word-sorted flat arrays at search."""

    def __init__(self, n_words: int, dim: int):
        self.n_words = n_words
        self.dim = dim
        self._pending: list[tuple[np.ndarray, np.ndarray, int]] = []
        self._words = np.zeros((0,), np.int64)  # sorted
        self._bits = np.zeros((0, dim // 8), np.uint8)
        self._imids = np.zeros((0,), np.int64)
        self.n_images = 0
        self.image_norms: list[float] = []  # per-image Σ self-sim = n_words

    def add(self, words: np.ndarray, bits: np.ndarray, imid: int):
        self._pending.append((np.asarray(words, np.int64),
                              np.asarray(bits, np.uint8), int(imid)))
        self.image_norms.append(max(len(words), 1))
        self.n_images = max(self.n_images, imid + 1)

    def _consolidate(self):
        if not self._pending:
            return
        w = np.concatenate([self._words] + [p[0] for p in self._pending])
        b = np.concatenate([self._bits] + [p[1] for p in self._pending])
        i = np.concatenate(
            [self._imids]
            + [np.full(len(p[0]), p[2], np.int64) for p in self._pending])
        order = np.argsort(w, kind="stable")
        self._words, self._bits, self._imids = w[order], b[order], i[order]
        self._pending = []

    def search(self, words: np.ndarray, bits: np.ndarray, alpha=3.0,
               threshold=0.0):
        """Scores against every stored image (ASMK normalised)."""
        self._consolidate()
        scores = np.zeros(self.n_images, np.float64)
        lo = np.searchsorted(self._words, words, side="left")
        hi = np.searchsorted(self._words, words, side="right")
        lens = hi - lo
        total = int(lens.sum())
        if total:
            shift = np.concatenate([[0], np.cumsum(lens)[:-1]])
            sel = np.arange(total) + np.repeat(lo - shift, lens)
            qsel = np.repeat(np.arange(len(words)), lens)
            s = binary_similarity(bits[qsel], self._bits[sel], self.dim,
                                  alpha, threshold)
            np.add.at(scores, self._imids[sel], s)
        qn = np.sqrt(max(len(words), 1))
        xn = np.sqrt(np.asarray(self.image_norms[: self.n_images]))
        return scores / (qn * xn)
