"""End-to-end statistics of a window, from the benchmark's own timestamps.

Every token's time is the host clock at the end of the wave that produced
it (after that wave's synchronize). A request's tokens land at the ends of
successive waves; its submit time is when its client sent it.

- tokens per second: every token that landed in the window over the
  window's length.
- time to first token: first-token time minus submit time, for every
  request whose first token landed in the window.
- inter-token gap: the time between two consecutive tokens of one request,
  for every pair whose later token landed in the window.

Tails are the 95th percentile of all such samples (numpy's linear
interpolation), never a statistic of per-chunk medians.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class RequestLog:
    """One request as the client saw it."""
    submit_s: float
    prompt_len: int
    token_s: List[float] = field(default_factory=list)


@dataclass
class Window:
    open_s: float
    close_s: float

    @property
    def seconds(self) -> float:
        return self.close_s - self.open_s

    def holds(self, t: float) -> bool:
        return self.open_s < t <= self.close_s


def tokens_in(window: Window, logs: List[RequestLog]) -> int:
    return sum(1 for r in logs for t in r.token_s if window.holds(t))


def tokens_per_s(window: Window, logs: List[RequestLog]) -> float:
    return tokens_in(window, logs) / window.seconds


def ttft_samples(window: Window, logs: List[RequestLog]) -> List[float]:
    return [r.token_s[0] - r.submit_s for r in logs
            if r.token_s and window.holds(r.token_s[0])]


def itl_samples(window: Window, logs: List[RequestLog]) -> List[float]:
    return [b - a for r in logs for a, b in zip(r.token_s, r.token_s[1:])
            if window.holds(b)]


def p95(samples: List[float]) -> Optional[float]:
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, np.float64), 95))
