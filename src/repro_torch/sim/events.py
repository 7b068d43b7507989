"""Heap-based discrete-event queue (counterpart of `repro/sim/events.py`,
host-only code copied as it is).

Time is *simulated* seconds — the engine never sleeps. Ties are broken by a
monotone sequence number so the pop order (and therefore every downstream
statistic) is deterministic for a fixed seed.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

ARRIVAL = "arrival"          # a client's update reached the server
LATE = "late"                # arrival after the round closed (dropped)
ROUND_CLOSE = "round_close"  # the server applied the global update


@dataclass(order=True, frozen=True)
class Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    client: int = field(compare=False, default=-1)
    round: int = field(compare=False, default=-1)

    def as_tuple(self) -> tuple:
        return (self.time, self.seq, self.kind, self.client, self.round)


class EventQueue:
    def __init__(self):
        self._heap: list[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, client: int = -1,
             round: int = -1) -> Event:
        ev = Event(float(time), self._seq, kind, client, round)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek(self) -> Event:
        return self._heap[0]

    def __len__(self) -> int:
        return len(self._heap)
