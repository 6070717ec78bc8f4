"""Heartbeat-driven replica death detection for the serving fabric (port of
``repro/serve/fabric/failover.py``, line for line).

The fabric registers every replica with ONE fabric-level
``repro_torch.ft.watchdog.HeartbeatMonitor`` (injectable clock — the kill-one-replica
gate advances a fake clock instead of sleeping) and beats it on each
replica's behalf whenever that replica demonstrably made progress (a
synchronous ``tick``, or — threaded — a fresh service-level heartbeat
relayed by ``relay_beat``).  ``newly_dead`` is the edge-trigger: a replica
whose beat goes stale is reported EXACTLY once, at which point the fabric
drains it — every in-flight request is re-submitted from its prompt to a
healthy replica (``ServeFabric._on_dead``), partial decode discarded, so the
final greedy stream is bit-identical to a run that never saw the failure.

``revive`` re-arms detection when a replaced/restarted replica joins.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from repro_torch.ft.watchdog import HeartbeatMonitor


def _hb_name(name: str) -> str:
    return f"fabric.replica.{name}"


class FailoverController:
    """Edge-triggered stale-replica detection over a ``HeartbeatMonitor``."""

    def __init__(self, monitor: Optional[HeartbeatMonitor] = None, timeout_s: float = 10.0):
        self.monitor = monitor or HeartbeatMonitor(default_timeout_s=timeout_s)
        self.timeout_s = float(timeout_s)
        self._dead: Set[str] = set()

    def register(self, name: str):
        """Start liveness tracking for a (new) replica."""
        self.monitor.register(_hb_name(name), self.timeout_s)
        self._dead.discard(name)

    def beat(self, name: str):
        """Record one unit of replica progress."""
        self.monitor.beat(_hb_name(name))

    def relay_beat(self, replica) -> bool:
        """Threaded replicas beat their OWN service monitors from their loop
        threads; relay that into the fabric monitor when every service
        heartbeat is fresh.  Returns True when a beat was relayed."""
        for svc in replica.services():
            hb = svc.heartbeat
            if any(hb.age(n) > hb._timeout[n] for n in hb._timeout):
                return False
        self.beat(replica.name)
        return True

    def age(self, name: str) -> float:
        """Seconds since the replica's last (relayed) beat."""
        return self.monitor.age(_hb_name(name))

    def is_dead(self, name: str) -> bool:
        """True once ``newly_dead`` has reported the replica."""
        return name in self._dead

    def newly_dead(self, names: List[str]) -> List[str]:
        """Replicas whose heartbeat JUST went stale, each reported once."""
        stale = self.monitor.stale()
        out = []
        for name in names:
            if _hb_name(name) in stale and name not in self._dead:
                self._dead.add(name)
                out.append(name)
        return out

    def revive(self, name: str):
        """Re-arm detection for a replica that re-joined the fabric."""
        self.register(name)

    def metrics(self) -> Dict[str, float]:
        """Failover bookkeeping (the monitor's own gauges ride separately)."""
        return {"fabric_replicas_dead": float(len(self._dead))}
