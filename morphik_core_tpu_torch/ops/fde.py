"""MUVERA Fixed-Dimensional Encoding, PyTorch port of
`morphik_core_tpu/ops/fde.py`.

`FDEConfig` and `_matrices` are numpy mirrors (the Philox-seeded
projection matrices are bit-identical to the reference's). The encode
runs batched over the R repetitions and the C documents on the tensors'
device, replacing the reference's `vmap`s:
  - SimHash bits: sign(x . G_r) per token -> bucket id (lowest bit first);
  - query FDE: per-bucket SUM of AMS-projected tokens;
  - document FDE: per-bucket MEAN, empty buckets filled with the
    projection of the nearest valid token by Hamming distance (ties to
    the lowest token index).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FDEConfig:
    dimension: int = 128
    num_repetitions: int = 20
    num_simhash_projections: int = 5
    projection_dimension: int = 16
    projection_type: str = "AMS_SKETCH"  # or "IDENTITY"
    seed: int = 42
    fill_empty_partitions: bool = True

    @property
    def num_partitions(self) -> int:
        return 2**self.num_simhash_projections

    @property
    def proj_dim(self) -> int:
        if self.projection_type == "IDENTITY":
            return self.dimension
        return self.projection_dimension

    @property
    def fde_dim(self) -> int:
        return self.num_repetitions * self.num_partitions * self.proj_dim


@functools.lru_cache(maxsize=8)
def _matrices(cfg: FDEConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(R, d, P) gaussian SimHash matrices and (R, d, p) AMS sketch
    matrices, deterministic in cfg.seed (numpy mirror)."""
    rng = np.random.default_rng(np.random.Philox(cfg.seed))
    g = rng.standard_normal(
        (cfg.num_repetitions, cfg.dimension, cfg.num_simhash_projections)
    ).astype(np.float32)
    if cfg.projection_type == "IDENTITY":
        s = np.broadcast_to(
            np.eye(cfg.dimension, dtype=np.float32)[None],
            (cfg.num_repetitions, cfg.dimension, cfg.dimension),
        ).copy()
    else:
        signs = rng.integers(
            0, 2, (cfg.num_repetitions, cfg.dimension, cfg.projection_dimension)
        ).astype(np.float32) * 2.0 - 1.0
        s = signs / np.sqrt(float(cfg.projection_dimension))
    return g, s


# Device copies of the matrices, per (config, device): uploaded once.
_DEVICE_MATRICES: Dict[Tuple[FDEConfig, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_matrices(cfg: FDEConfig, device: torch.device):
    key = (cfg, str(device))
    if key not in _DEVICE_MATRICES:
        g, s = _matrices(cfg)
        # the sketch comes out float64 (f32 signs / a numpy float64); the
        # reference's jnp.asarray rounds it to f32, and so does this
        _DEVICE_MATRICES[key] = tuple(torch.from_numpy(m).float().to(device) for m in (g, s))
    return _DEVICE_MATRICES[key]


def _partition_bits(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x (C, N, d), g (R, d, P) -> (C, R, N, P) float bits in {0, 1}."""
    return (torch.einsum("cnd,rdp->crnp", x, g) > 0).float()


def _encode(x: torch.Tensor, mask: torch.Tensor, cfg: FDEConfig, is_query: bool) -> torch.Tensor:
    """x (C, N, d), mask (C, N) -> (C, fde_dim)."""
    if x.shape[-1] != cfg.dimension:
        raise ValueError(
            f"multivector dim {x.shape[-1]} != FDEConfig.dimension {cfg.dimension}"
        )
    x = x.float()
    mask = mask.float()
    g, s = _device_matrices(cfg, x.device)
    n_p, n_b = cfg.num_simhash_projections, cfg.num_partitions
    c = x.shape[0]
    bits = _partition_bits(x, g)  # (C, R, N, P)
    weights = torch.tensor([2.0**i for i in range(n_p)], device=x.device)
    ids = (bits * weights).sum(-1).long()  # (C, R, N)
    onehot = torch.nn.functional.one_hot(ids, n_b).float() * mask[:, None, :, None]
    proj = torch.einsum("cnd,rdp->crnp", x, s)  # (C, R, N, p)
    sums = torch.einsum("crnb,crnp->crbp", onehot, proj)  # (C, R, B, p)
    if is_query:
        return sums.reshape(c, -1)
    counts = onehot.sum(dim=2)  # (C, R, B)
    centroids = sums / counts.clamp(min=1.0)[..., None]
    if cfg.fill_empty_partitions:
        bucket_idx = torch.arange(n_b, device=x.device)
        bucket_bits = ((bucket_idx[:, None] >> torch.arange(n_p, device=x.device)[None, :]) & 1).float()
        # Hamming distance = P - matches, as 0/1 matmuls (exact)
        matches = torch.einsum("bp,crnp->crbn", bucket_bits, bits) + torch.einsum(
            "bp,crnp->crbn", 1.0 - bucket_bits, 1.0 - bits
        )
        ham = n_p - matches
        ham = torch.where(mask[:, None, None, :] > 0, ham, torch.full_like(ham, float("inf")))
        nearest = ham.argmin(dim=-1)  # (C, R, B): first minimum = lowest index
        fill = torch.gather(proj, 2, nearest[..., None].expand(-1, -1, -1, proj.shape[-1]))
        any_valid = (mask.sum(dim=1) > 0)[:, None, None, None]
        keep = (counts[..., None] > 0) | ~any_valid
        centroids = torch.where(keep, centroids, fill)
    return centroids.reshape(c, -1)


def fde_query(x: torch.Tensor, cfg: FDEConfig, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Query-side FDE (per-bucket SUM). x (Nq, d) -> (fde_dim,)."""
    if mask is None:
        mask = torch.ones(x.shape[0], device=x.device)
    return _encode(x[None], mask[None], cfg, is_query=True)[0]


def fde_document(x: torch.Tensor, cfg: FDEConfig, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Document-side FDE (per-bucket centroid + empty fill) -> (fde_dim,)."""
    if mask is None:
        mask = torch.ones(x.shape[0], device=x.device)
    return _encode(x[None], mask[None], cfg, is_query=False)[0]


def fde_document_batch(x: torch.Tensor, mask: torch.Tensor, cfg: FDEConfig) -> torch.Tensor:
    """Batched document FDE. x (C, N, d), mask (C, N) -> (C, fde_dim)."""
    return _encode(x, mask, cfg, is_query=False)
