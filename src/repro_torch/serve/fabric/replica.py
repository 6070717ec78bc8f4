"""One serving replica: engine(s) + service(s) + its own telemetry island
(port of ``repro/serve/fabric/replica.py``).

A ``Replica`` owns a complete single-engine serving stack — an ``LMService``
(slot pool, page pool, micro-batcher) and/or an ``EmbeddingService``, each
with its OWN ``repro_torch.obs.Obs`` bundle (registry, flight recorder, heartbeat)
— and gives the fabric a uniform handle over it: route-relevant load gauges
(``snapshot``), a synchronous scheduler tick (``tick``), thread lifecycle
(``start``/``stop``) and a crash simulator (``kill``).

Isolation is the point: replicas share nothing but (read-only) params, so a
dead replica's state can simply be abandoned — its in-flight requests are
re-submitted elsewhere from their prompts (``fabric.failover``) and greedy
decode re-derives the identical token stream.

``make_replica_mesh`` is the tp-sizing helper: ``FabricConfig(tp=M)`` gives
each replica an M-rank ``DeviceMesh`` whose ``model`` axis feature-shards
the embedding forward (``ServeEngine(model_axis=...)``).  One rank is one
device, as in ``launch/mesh.py``.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def make_replica_mesh(tp: int = 1, data: int = 1, offset: int = 0):
    """Build one replica's ``(data, model)`` ``DeviceMesh`` over ranks
    ``[offset, offset + data * tp)`` of the initialised process group
    (``None`` when the replica is single-device).  ``offset`` skips ranks
    claimed by earlier replicas so fabrics can tile a host.

    Building a mesh creates its process groups, which every rank of the
    default group must join: call this on EVERY rank, for every replica, in
    the same order.  A rank outside ``[offset, offset + data * tp)`` gets a
    mesh it does not belong to (``mesh.get_coordinate()`` is None) and must
    not run the replica's collectives.  Without a process group the world
    is one rank."""
    if tp <= 1 and data <= 1:
        return None
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    need = data * tp
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    if offset + need > world:
        raise ValueError(
            f"replica mesh needs devices [{offset}, {offset + need}) but only "
            f"{world} are visible"
        )
    grid = torch.arange(offset, offset + need).reshape(data, tp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


class Replica:
    """A named single-engine serving stack the fabric routes into."""

    def __init__(self, name: str, *, lm=None, embed=None):
        if lm is None and embed is None:
            raise ValueError("a replica needs at least one service (lm= or embed=)")
        self.name = str(name)
        self.lm = lm
        self.embed = embed
        self.alive = True
        self.crashed = False
        self.started = False

    def services(self) -> List:
        """The replica's services, LM first."""
        return [s for s in (self.lm, self.embed) if s is not None]

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, prompt_lens=None) -> "Replica":
        """Warm both services (every bucket and prompt shape runs once, so no
        request pays a first call)."""
        if self.lm is not None:
            self.lm.warmup(prompt_lens=prompt_lens)
        if self.embed is not None:
            self.embed.warmup()
        return self

    def tick(self) -> int:
        """One synchronous scheduler pass over both services (the fabric's
        deterministic drive mode); returns in-flight work remaining."""
        if self.crashed or not self.alive:
            return 0
        work = 0
        if self.lm is not None:
            work += self.lm.step(timeout=0.0) or 0
        if self.embed is not None:
            self.embed.run_pending(timeout=0.0)
            work += self.embed.batcher.depth()
        return work

    def start(self) -> "Replica":
        """Run each service's scheduler loop on its own daemon thread."""
        for s in self.services():
            s.start()
        self.started = True
        return self

    def stop(self):
        """Stop the service threads (graceful: queued work drains first)."""
        for s in self.services():
            s.stop()
        self.started = False

    def kill(self):
        """Simulate a crash: the replica stops ticking (and stops feeding the
        fabric heartbeat), WITHOUT completing or failing its in-flight
        requests — exactly what a dead host looks like from the router.  It
        stays ``alive`` (routable) until the stale heartbeat gets it declared
        dead: that detection gap is the thing failover exists to close.  Only
        meaningful under the synchronous drive mode; a started replica's
        threads would keep serving."""
        if self.started:
            raise RuntimeError("kill() models a crash under synchronous ticking; "
                               "stop() the threaded replica instead")
        self.crashed = True

    # -- router-facing load signals -----------------------------------------

    def occupancy(self) -> float:
        """Instantaneous slot occupancy (active / total) — the
        ``slots_occupancy`` signal at routing time rather than the pool's
        time-averaged gauge."""
        if self.lm is None:
            return 0.0
        pool = self.lm.engine.pool
        return (pool.n_slots - pool.free_slots()) / pool.n_slots

    def outstanding(self) -> int:
        """Requests queued or in flight across both services."""
        n = 0
        if self.lm is not None:
            n += self.lm.outstanding()
        if self.embed is not None:
            n += self.embed.batcher.depth()
        return n

    def ttft_p99_s(self) -> float:
        """``serve_ttft_seconds_p99`` derived from this replica's OWN TTFT
        histogram (0.0 cold, or when the replica runs ``Obs.disabled()`` —
        weighted-TTFT routing then degrades to pure least-occupancy)."""
        if self.lm is None:
            return 0.0
        return self.lm.obs.registry.quantile_gauges().get("serve_ttft_seconds_p99", 0.0)

    def snapshot(self) -> Dict[str, float]:
        """The routing-relevant gauge subset, one read per dispatch."""
        slots = float(self.lm.engine.pool.n_slots) if self.lm is not None else 1.0
        return {
            "slots_total": slots,
            "slots_occupancy": self.occupancy(),
            "queue_depth": float(self.outstanding()),
            "serve_ttft_seconds_p99": self.ttft_p99_s(),
        }

    def metrics(self) -> Dict[str, float]:
        """The replica's merged flat scrape surface (both services)."""
        out: Dict[str, float] = {"replica_alive": 1.0 if self.alive else 0.0}
        for s in self.services():
            out.update(s.metrics())
        return out
