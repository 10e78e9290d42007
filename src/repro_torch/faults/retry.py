"""Typed retry policy for control-plane RPCs.

Retries are safe only because the RPCs they wrap are idempotent: every
retried method carries a natural idempotency key in its payload (stage
uid for ``stage_complete``/``stage_failed``, region key for
``region_staged``, worker id for registration) and the receiving
handler deduplicates on it (e.g. ``Manager._stage_done``).  Only
:class:`~repro.transport.BusTimeoutError` is retried — a
``RemoteError`` means the handler itself raised (retrying repeats the
failure) and ``BusClosedError`` means the peer is gone for good.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Type

from ..transport.bus import BusTimeoutError


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter and a bounded attempt budget."""

    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 1.0
    jitter: float = 0.25
    timeout: Optional[float] = None  # per-attempt call timeout

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        d = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        r = (rng or random).random()
        return d * (1.0 + self.jitter * (2.0 * r - 1.0))

    def run(self, fn: Callable[[], Any], *,
            retry_on: Tuple[Type[BaseException], ...] = (BusTimeoutError,),
            rng: Optional[random.Random] = None) -> Any:
        last: Optional[BaseException] = None
        for attempt in range(1, self.attempts + 1):
            try:
                return fn()
            except retry_on as exc:  # noqa: PERF203 - retry loop
                last = exc
                if attempt < self.attempts:
                    time.sleep(self.delay(attempt, rng))
        assert last is not None
        raise last

    def call(self, peer: Any, method: str, payload: Any = None, *,
             rng: Optional[random.Random] = None) -> Any:
        """Retried ``peer.call`` with this policy's per-attempt timeout."""
        kwargs = {} if self.timeout is None else {"timeout": self.timeout}
        return self.run(lambda: peer.call(method, payload, **kwargs), rng=rng)
