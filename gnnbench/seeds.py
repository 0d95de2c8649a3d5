"""Independent streams from the run's ``--seed``: the data, the weights and
the step's draws each get a seed of their own."""

from __future__ import annotations

import hashlib

STREAMS = ("data", "params", "draws")


def sub(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream``, a fixed function of (seed, stream)."""
    if stream not in STREAMS:
        raise ValueError(f"unknown stream {stream!r}")
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
