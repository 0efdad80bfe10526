"""Load-driven elasticity: queue depth in, grow/shrink decisions out.

Counterpart of ``stencil_tpu/serve/policy.py``, verbatim.  The policy is a
pure observer: it never touches a subdomain grid itself.  The server feeds
it the queue depth after every dispatch cycle; when it decides, the server
hands the decision to its ``capacity`` callback, which moves the tenants
with ``DistributedDomain.reshard`` (the in-memory move every other capacity
change uses).

Hysteresis, both knobs pinned by tests:

* **consecutive observations** — one spiky sample must not move the mesh:
  the depth has to sit above ``high`` (or at/below ``low``) for
  ``consecutive`` successive observations before the policy acts;
* **cooldown** — after any action the policy holds for ``cooldown_s`` of
  (injectable) clock time, longer than a reshard takes, so it reacts to
  the post-transition steady state rather than to its own transient;
* **no repeats** — a decision is only emitted when it CHANGES the fleet
  level (grow after grow is suppressed until a shrink intervened): the
  capacity model behind the policy is two-level (half fleet / full
  fleet), so a repeated decision could only re-request the mesh it
  already has;
* **shrink arms on load** — an idle server that never saw depth above
  ``low`` has nothing to give back: shrink observations only count after
  the first sample above the low-water mark, so a fresh server does not
  open with a scale-down flap.

``low < high`` is enforced: the dead band between them is what prevents
grow/shrink ping-pong at a steady load level.
"""

from __future__ import annotations

from typing import Optional


class ElasticityPolicy:
    """Threshold + hysteresis policy over queue depth."""

    def __init__(
        self,
        high: int = 8,
        low: int = 1,
        consecutive: int = 3,
        cooldown_s: float = 30.0,
    ):
        if low >= high:
            raise ValueError(
                f"elasticity dead band is empty: low={low} must be < high={high}"
            )
        self.high = int(high)
        self.low = int(low)
        self.consecutive = int(consecutive)
        self.cooldown_s = float(cooldown_s)
        self._above = 0
        self._below = 0
        self._armed = False  # shrink counts only after load was seen
        self._last_kind: Optional[str] = None
        self._last_action_at: Optional[float] = None
        self.decisions: list = []  # (now, kind) history, for the soak artifact

    def observe(self, depth: int, now: float) -> Optional[str]:
        """Feed one queue-depth sample; returns ``"grow"``/``"shrink"``
        when the hysteresis gate opens, else None."""
        if depth > self.low:
            self._armed = True
        if depth > self.high:
            self._above += 1
            self._below = 0
        elif depth <= self.low:
            self._below += 1 if self._armed else 0
            self._above = 0
        else:
            self._above = self._below = 0  # the dead band resets both runs
        if (
            self._last_action_at is not None
            and now - self._last_action_at < self.cooldown_s
        ):
            return None
        kind = None
        if self._above >= self.consecutive and self._last_kind != "grow":
            kind = "grow"
        elif self._below >= self.consecutive and self._last_kind != "shrink":
            kind = "shrink"
        if kind is not None:
            self._above = self._below = 0
            self._last_kind = kind
            self._last_action_at = now
            self.decisions.append((now, kind))
        return kind
