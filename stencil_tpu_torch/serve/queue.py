"""The bounded admission queue: deadline propagation, load shedding,
backpressure.

Counterpart of ``stencil_tpu/serve/queue.py``, verbatim.  One queue for the
whole server (dispatch slots are the scarce fleet-wide resource, not
per-tenant buffers), BOUNDED by construction: an unbounded queue converts
overload into latency collapse and out-of-memory instead of a classified,
retryable refusal at the edge.

Shedding order:

1. expired requests first, oldest first — work past its deadline is
   already worthless to its caller, so it is the cheapest load to drop;
2. then, to make room for a HIGHER-priority arrival only, the oldest
   request of the lowest-priority tenant;
3. otherwise the ARRIVAL is refused (``OverloadError``) — backpressure to
   the caller, who owns the back-off decision.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

from stencil_tpu_torch.resilience.taxonomy import OverloadError
from stencil_tpu_torch.serve.request import Request


class BoundedQueue:
    """FIFO-per-tenant, priority-aware, deadline-propagating; refuses
    instead of growing past ``maxlen``."""

    def __init__(self, maxlen: int = 64):
        if maxlen < 1:
            raise ValueError(f"queue maxlen must be >= 1, got {maxlen}")
        self.maxlen = int(maxlen)
        self._q = collections.deque(maxlen=self.maxlen)

    def depth(self) -> int:
        return len(self._q)

    def full(self) -> bool:
        return len(self._q) >= self.maxlen

    def push(self, req: Request, now: float) -> None:
        """Enqueue, or raise ``OverloadError`` (queue_full) — the caller
        (``server.submit``) runs the shed ladder before giving up."""
        if self.full():
            raise OverloadError(
                why="queue_full",
                queue_depth=self.depth(),
                tenant=req.tenant,
                # the soonest-queued request's age is a fair "come back
                # when a slot likely opened" hint; crude but honest
                retry_after_s=1.0,
            )
        req.enqueued_at = now
        self._q.append(req)

    def shed_expired(self, now: float) -> List[Request]:
        """Remove every queued request whose deadline has passed, OLDEST
        first — deadline propagation means nobody downstream should spend
        fleet time on work its caller already abandoned."""
        expired = [r for r in self._q if r.expired(now)]
        if expired:
            keep = [r for r in self._q if not r.expired(now)]
            self._q.clear()
            self._q.extend(keep)
        return sorted(expired, key=lambda r: (r.enqueued_at, r.seq))

    def shed_lowest_priority(self, below: int) -> Optional[Request]:
        """Remove the oldest request of the LOWEST priority strictly below
        ``below`` (make-room shed for a higher-priority arrival); None when
        every queued request is at least that important."""
        victims = [r for r in self._q if r.priority < below]
        if not victims:
            return None
        victim = min(victims, key=lambda r: (r.priority, r.enqueued_at, r.seq))
        self._q.remove(victim)
        return victim

    def take(self, rotation: Sequence[str]) -> Optional[Request]:
        """Dequeue the oldest request of the first tenant in ``rotation``
        that has one queued — the server rotates the order after every
        dispatch, so tenants share dispatch slots round-robin instead of
        one chatty tenant starving the rest.  Falls back to plain FIFO for
        requests from tenants not in the rotation."""
        for tid in rotation:
            for r in self._q:
                if r.tenant == tid:
                    self._q.remove(r)
                    return r
        if self._q:
            return self._q.popleft()
        return None

    def remove(self, req: Request) -> bool:
        """Remove a specific queued request (the packed-dispatch planners
        pick requests by PEEKING — ``peek_all`` — then claim them here);
        False when it is no longer queued (e.g. shed meanwhile)."""
        try:
            self._q.remove(req)
            return True
        except ValueError:
            return False

    def peek_all(self) -> List[Request]:
        return list(self._q)
