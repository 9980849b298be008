"""Sub-seeds of a run's ``--seed``: one independent stream per purpose."""

from __future__ import annotations

import hashlib


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` (any whole ``seed``, negative or past
    64 bits included)."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)
