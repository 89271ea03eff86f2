"""Stream directory: identity-based routing of producers to batch slots; a
copy of the JAX package's ``ingest/directory.py``.

Reference parity: the graph mirror + routing planner
(``src/infra/pipewire/graph.rs``, ``policy.rs``).  The reference identifies
application streams by a precedence of properties (app.id > app.name >
media.name > node.name, graph.rs ``StreamIdentity``), remembers identities of
inactive apps per client, and plans which nodes get tapped subject to a
truncation limit (policy.rs ``Plan { sources, truncated }``).

The rebuild's capture sources are external producers (sockets, shared
memory, files) rather than a PipeWire graph, so the directory keeps the
*semantics*: stable identity -> batch-slot assignment, remembered identities
that re-acquire their old slot when they come back (so resets/state carry
across brief disconnects), LRU eviction of remembered entries, and a
truncation flag when more identities want slots than the batch has.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict


@dataclasses.dataclass(frozen=True)
class StreamIdentity:
    """Stable stream identity with the reference's property precedence
    (graph.rs: app_id > app_name > media_name > node_name)."""

    app_id: str | None = None
    app_name: str | None = None
    media_name: str | None = None
    node_name: str | None = None

    @property
    def key(self) -> str:
        for prefix, value in (
            ("app.id", self.app_id),
            ("app.name", self.app_name),
            ("media.name", self.media_name),
            ("node.name", self.node_name),
        ):
            if value:
                return f"{prefix}:{value}"
        return "unknown"


class StreamDirectory:
    """Assigns producer identities to ``n_slots`` batch positions."""

    def __init__(self, n_slots: int, remember_limit: int = 256):
        self.n_slots = n_slots
        self._active: dict[str, int] = {}
        self._free = list(range(n_slots - 1, -1, -1))
        # remembered identity -> last slot (insertion-ordered for LRU)
        self._remembered: OrderedDict[str, int] = OrderedDict()
        self._remember_limit = remember_limit
        self.truncated = False

    def acquire(self, identity: StreamIdentity | str) -> int | None:
        """Slot for an (re)appearing stream; None when the batch is full
        (sets ``truncated``, policy.rs ``Plan::truncated``)."""
        key = identity if isinstance(identity, str) else identity.key
        if key in self._active:
            return self._active[key]
        slot = None
        remembered = self._remembered.pop(key, None)
        if remembered is not None and remembered in self._free:
            self._free.remove(remembered)
            slot = remembered
        elif self._free:
            slot = self._free.pop()
        if slot is None:
            self.truncated = True
            return None
        self._active[key] = slot
        return slot

    def release(self, identity: StreamIdentity | str) -> int | None:
        """Stream went away; its slot is remembered for re-acquisition
        (graph.rs remembered inactive apps)."""
        key = identity if isinstance(identity, str) else identity.key
        slot = self._active.pop(key, None)
        if slot is None:
            return None
        self._free.append(slot)
        self._remembered[key] = slot
        self._remembered.move_to_end(key)
        while len(self._remembered) > self._remember_limit:
            self._remembered.popitem(last=False)
        return slot

    def view(self) -> dict:
        """CaptureView-style snapshot for observability (pipewire.rs:96-149)."""
        return {
            "active": dict(self._active),
            "remembered": list(self._remembered),
            "free_slots": len(self._free),
            "truncated": self.truncated,
            "timestamp": time.time(),
        }
