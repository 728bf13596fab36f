"""Training-free multivector token pooling: numpy mirror of
`morphik_core_tpu/ops/pooling.py` (bit-identical; the JAX package's
module cannot be imported without jax through `ops/__init__`).

Mean-pool groups of consecutive page tokens, re-normalize, and
optionally refine with k-means passes. Queries are never pooled.
"""

from __future__ import annotations

import numpy as np


def pooled_token_count(n_tokens: int, factor: int) -> int:
    """Token count `pool_multivector` produces for an (n_tokens, d) input."""
    if factor <= 1 or n_tokens <= factor:
        return n_tokens
    return -(-n_tokens // factor)


def pool_multivector(mv: np.ndarray, factor: int, refine_iters: int = 0) -> np.ndarray:
    """(n_tokens, d) -> (ceil(n/factor), d): mean over consecutive groups
    of `factor` tokens, then L2-renormalized (MaxSim expects unit rows).

    `refine_iters` > 0 runs that many k-means reassignment passes seeded
    from the consecutive-mean segments (spatially adjacent patches are a
    good init). Measured on a trained tiny checkpoint (round 4):
    consecutive-mean at factor 32 keeps the gold page in the pooled
    top-10 only 17% of the time, k-means-refined 50% — semantically
    structured embeddings put a page's salient tokens (glyphs, headers)
    far apart spatially, so pure spatial pooling averages them away.
    Token count and downstream MaxSim semantics are unchanged."""
    if factor <= 1 or mv.shape[0] <= factor:
        return mv
    n, d = mv.shape
    pad = (-n) % factor
    if pad:
        mv = np.concatenate([mv, np.zeros((pad, d), mv.dtype)], axis=0)
    counts = np.full(mv.shape[0] // factor, factor, dtype=np.float32)
    if pad:
        counts[-1] = factor - pad
    pooled = mv.reshape(-1, factor, d).sum(axis=1) / counts[:, None]
    norms = np.linalg.norm(pooled, axis=-1, keepdims=True)
    pooled = (pooled / np.maximum(norms, 1e-12)).astype(np.float32)
    if refine_iters > 0:
        tokens = mv[:n].astype(np.float32)
        k = pooled.shape[0]
        for _ in range(refine_iters):
            assign = (tokens @ pooled.T).argmax(axis=1)  # (n,)
            onehot = np.zeros((k, n), np.float32)
            onehot[assign, np.arange(n)] = 1.0
            sums = onehot @ tokens  # (k, d)
            cnt = onehot.sum(axis=1, keepdims=True)
            means = sums / np.maximum(cnt, 1.0)
            nrm = np.linalg.norm(means, axis=-1, keepdims=True)
            # empty clusters keep their previous centroid
            pooled = np.where(
                cnt > 0, means / np.maximum(nrm, 1e-12), pooled
            ).astype(np.float32)
    return pooled.astype(mv.dtype)
