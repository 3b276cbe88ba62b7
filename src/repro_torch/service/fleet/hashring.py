"""Consistent-hash tenant placement with bounded load.

The fleet's placement question — "which worker owns this tenant?" — must
stay stable as workers join, die, and are replaced: naive ``hash(tenant)
% n`` remaps almost every tenant on any membership change, trashing each
worker's result cache, stream checkpoints, and batch-shape buckets at
once.  A consistent-hash ring remaps only ~``K/n`` of the keyspace per
change (the classic Karger bound), and the **bounded-load** variant
(Mirrokni/Thorup/Zadimoghaddam, arXiv:1608.01350) adds the missing half:
a hot tenant whose primary worker is saturated *spills* to the next node
clockwise on the ring instead of queueing behind the hotspot, while every
worker's accepted load stays under ``ceil(c · mean_load)``.

Pure data structure: no I/O, no clocks, no knowledge of what "load"
means — the router feeds it outstanding-request counts.  Hashing is
blake2b (stdlib, stable across processes and Python runs; ``hash()`` is
salted per-process and would move every tenant on restart).
"""

from __future__ import annotations

import bisect
import hashlib
import math
from typing import Callable, Dict, List, Optional

DEFAULT_REPLICAS = 64
DEFAULT_LOAD_FACTOR = 1.25


def _h(key: str) -> int:
    """Stable 64-bit position on the ring."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


class ConsistentHashRing:
    """Nodes on a 64-bit hash ring, ``replicas`` virtual points each.

    ``preference(key)`` is the heart: the distinct nodes in ring order
    starting at the key's position.  ``primary`` is preference[0];
    ``place`` walks the preference list under the bounded-load rule.
    """

    def __init__(self, nodes: Optional[List[str]] = None, *,
                 replicas: int = DEFAULT_REPLICAS,
                 load_factor: float = DEFAULT_LOAD_FACTOR) -> None:
        if load_factor <= 1.0:
            raise ValueError("load_factor must be > 1 (c=1 means perfectly "
                             "balanced — no room for any placement)")
        self.replicas = max(1, int(replicas))
        self.load_factor = float(load_factor)
        self._points: List[int] = []          # sorted virtual positions
        self._owner: Dict[int, str] = {}      # position -> node
        self._nodes: List[str] = []
        for n in nodes or []:
            self.add(n)

    # -- membership ----------------------------------------------------------

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.append(node)
        for i in range(self.replicas):
            pos = _h(f"{node}#{i}")
            while pos in self._owner:          # vanishing-probability clash
                pos = (pos + 1) & ((1 << 64) - 1)
            self._owner[pos] = node
            bisect.insort(self._points, pos)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.remove(node)
        dead = [pos for pos, owner in self._owner.items() if owner == node]
        for pos in dead:
            del self._owner[pos]
            idx = bisect.bisect_left(self._points, pos)
            del self._points[idx]

    @property
    def nodes(self) -> List[str]:
        return list(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    # -- placement -----------------------------------------------------------

    def preference(self, key: str) -> List[str]:
        """Every node, in ring order from the key's position.

        The stability property lives here: removing a node only promotes
        the ones behind it; adding a node only inserts it — other keys'
        orders are untouched except where the new node's points land.
        """
        if not self._nodes:
            return []
        start = bisect.bisect_right(self._points, _h(key))
        seen: List[str] = []
        n_points = len(self._points)
        for step in range(n_points):
            owner = self._owner[self._points[(start + step) % n_points]]
            if owner not in seen:
                seen.append(owner)
                if len(seen) == len(self._nodes):
                    break
        return seen

    def primary(self, key: str) -> Optional[str]:
        pref = self.preference(key)
        return pref[0] if pref else None

    def capacity(self, total_load: int) -> int:
        """Bounded-load ceiling per node for the given total outstanding
        load: ``ceil(c · (L+1) / n)``.  The ``+1`` counts the placement
        being made, so a single request on an idle fleet always fits its
        primary (capacity ≥ 1)."""
        if not self._nodes:
            return 0
        return math.ceil(
            self.load_factor * (total_load + 1) / len(self._nodes))

    def place(self, key: str, load: Callable[[str], int], *,
              total_load: Optional[int] = None) -> Optional[str]:
        """Bounded-load placement: the first node in the key's preference
        order whose current load is under the fleet-wide capacity.

        ``load(node)`` returns a node's outstanding count; ``total_load``
        defaults to the sum over members.  A fully saturated fleet (every
        node at capacity — only possible transiently, since capacity
        scales with total load) falls back to the primary rather than
        refusing: admission control is the worker's job, not the ring's.
        """
        pref = self.preference(key)
        if not pref:
            return None
        if total_load is None:
            total_load = sum(load(n) for n in self._nodes)
        cap = self.capacity(total_load)
        for node in pref:
            if load(node) < cap:
                return node
        return pref[0]
