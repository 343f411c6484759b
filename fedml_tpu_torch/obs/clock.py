"""NTP-style clock-offset estimation for cross-rank trace stitching.

Client span timestamps are taken on the client's wall clock; the server
stitches them into one per-round timeline, which needs each rank's clock
offset relative to the server. The estimate piggybacks on the round
protocol itself — the broadcast/upload exchange IS a symmetric two-way
handshake, so no extra messages are sent:

    T1  server stamps the broadcast          (server clock)
    T2  client receives it                   (client clock)
    T3  client stamps its upload             (client clock)
    T4  server receives the upload           (server clock)

The classic NTP estimators (RFC 5905 §8):

    offset = ((T2 - T1) + (T3 - T4)) / 2      (client clock minus server)
    rtt    = (T4 - T1) - (T3 - T2)            (wire time both ways)

``offset`` is exact when the two wire legs are symmetric; an asymmetry of
``a`` seconds biases it by ``a/2`` — which is also the bound on any
passive estimator, and on a loopback/LAN round far below the span
durations being stitched. Per rank we keep the sample with the smallest
RTT seen in a sliding window (the standard NTP clock filter: the fastest
exchange had the least queueing, hence the least asymmetry).

Host-side only, a few floats per rank; never runs under jit.
"""

from __future__ import annotations

import threading


def estimate(t1: float, t2: float, t3: float, t4: float) -> tuple[float, float]:
    """(offset, rtt) of one exchange: offset = client clock - server clock."""
    offset = ((t2 - t1) + (t3 - t4)) / 2.0
    rtt = (t4 - t1) - (t3 - t2)
    return offset, rtt


class ClockSync:
    """Per-rank offset estimates with a min-RTT clock filter.

    ``update`` folds one (T1..T4) exchange and returns the rank's current
    best offset; ``offset`` reads it (0.0 for a never-seen rank, so
    rebasing a rank with no estimate is the identity).
    """

    def __init__(self, window: int = 8):
        self.window = int(window)
        # rank -> list of (rtt, offset), newest last, len <= window
        self._samples: dict[int, list[tuple[float, float]]] = {}
        self._lock = threading.Lock()

    def update(self, rank: int, t1: float, t2: float, t3: float,
               t4: float) -> float:
        offset, rtt = estimate(t1, t2, t3, t4)
        with self._lock:
            s = self._samples.setdefault(int(rank), [])
            s.append((rtt, offset))
            del s[:-self.window]
            return min(s)[1]

    def offset(self, rank: int) -> float:
        with self._lock:
            s = self._samples.get(int(rank))
            return min(s)[1] if s else 0.0

    def rtt(self, rank: int) -> float | None:
        with self._lock:
            s = self._samples.get(int(rank))
            return min(s)[0] if s else None

    def snapshot(self) -> dict[int, dict[str, float]]:
        """{rank: {offset_s, rtt_s, samples}} — the round record's
        ``clock_offset_s`` block and the docs' debugging view."""
        with self._lock:
            return {r: {"offset_s": min(s)[1], "rtt_s": min(s)[0],
                        "samples": len(s)}
                    for r, s in self._samples.items() if s}
