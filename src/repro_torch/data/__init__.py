"""Data plane of the port: demand-driven chunk leasing + double-buffered
loading onto the card (the port of ``repro/data``; ``ledger.py`` is a
byte copy).

The dataset is an addressable space of idempotent *chunks* (chunk = pure
function of (seed, chunk_id)); a ledger leases chunk ranges to workers
demand-driven with heartbeats and re-leasing, and a prefetching loader
keeps the next batch on the card while the current step runs (a
pinned, ``non_blocking`` copy on a side stream).
"""

from .ledger import ChunkLedger, Lease
from .loader import CardPut, PrefetchLoader, TokenChunkSource

__all__ = ["CardPut", "ChunkLedger", "Lease", "PrefetchLoader", "TokenChunkSource"]
