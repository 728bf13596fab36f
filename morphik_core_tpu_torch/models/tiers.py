"""Account tiers and their quotas: copy of
`morphik_core_tpu/models/tiers.py` (the JAX package's `models/__init__`
imports jax, so the port keeps its own)."""

from __future__ import annotations

from enum import Enum
from typing import Any, Dict


class AccountTier(str, Enum):
    FREE = "free"
    DEVELOPER = "developer"
    STARTUP = "startup"
    ENTERPRISE = "enterprise"
    SELF_HOSTED = "self_hosted"


# monthly (pages, queries) and absolute (storage, apps) quotas; None = unlimited
TIER_LIMITS: Dict[AccountTier, Dict[str, Any]] = {
    AccountTier.FREE: {
        "pages_per_month": 200,
        "queries_per_month": 500,
        "storage_bytes": 1 * 1024**3,
        "apps": 1,
    },
    AccountTier.DEVELOPER: {
        "pages_per_month": 2_000,
        "queries_per_month": 5_000,
        "storage_bytes": 10 * 1024**3,
        "apps": 5,
    },
    AccountTier.STARTUP: {
        "pages_per_month": 50_000,
        "queries_per_month": 100_000,
        "storage_bytes": 100 * 1024**3,
        "apps": 20,
    },
    AccountTier.ENTERPRISE: {
        "pages_per_month": None,
        "queries_per_month": None,
        "storage_bytes": None,
        "apps": None,
    },
    AccountTier.SELF_HOSTED: {
        "pages_per_month": None,
        "queries_per_month": None,
        "storage_bytes": None,
        "apps": None,
    },
}


def estimate_pages_from_chars(n_chars: int) -> float:
    """chars / 4 tokens, 630 tokens a page, at least one page."""
    return max(1.0, (n_chars / 4.0) / 630.0)
