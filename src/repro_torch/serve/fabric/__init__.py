"""repro_torch.serve.fabric — a replica router in front of N serving engines
(port of ``repro/serve/fabric``).

The single-engine stack scales *down* one request's cost; the fabric
scales *out*: ``FabricConfig(replicas=N, tp=M)`` stands up N
isolated ``Replica`` stacks (each its own engine, slot/page pools, ``Obs``
registry and heartbeat; each optionally spanning M ranks via the
feature-sharded tp forward, ``ServeEngine(model_axis=...)``) behind one
submit surface:

  * ``router``   — load-aware dispatch (least-occupancy / weighted-TTFT over
                   the replicas' own ``slots_occupancy`` and
                   ``serve_ttft_seconds_p99`` gauges) with consistent-prefix
                   affinity so shared-prefix traffic keeps hitting the
                   replica whose radix cache is warm;
  * ``replica``  — the per-replica wrapper (tick/start/stop/kill + the
                   routing gauge snapshot) and the tp mesh helper;
  * ``failover`` — heartbeat-driven drain-and-requeue: a replica that stops
                   beating is declared dead ONCE, its in-flight requests are
                   re-submitted from their prompts to healthy replicas
                   (idempotent by request id, partial decode discarded), and
                   greedy decode makes the re-run bit-identical to a
                   single-engine run.

Two drive modes: synchronous (``step``/``drain`` — deterministic, what the
failover gate and tests use, with an injectable clock so nothing sleeps) and
threaded (``start``/``stop`` — every replica's service loops on its own
daemon thread; torch releases the GIL inside its ops, so replicas overlap
their host work with device work — on one card they share its default
stream).  Flight events ``route`` / ``requeue`` /
``requeue_done`` / ``replica_dead`` / ``replica_join`` narrate every routing decision into the
fabric's recorder; ``metrics()`` exports per-replica labelled gauges
(``fabric_replica_occupancy{replica=}``, ``heartbeat_age_s{name=}``).

    fabric = ServeFabric(FabricConfig(replicas=2), lm_factory=make_service)
    fut = fabric.submit_lm(tokens, max_new_tokens=16)
    fabric.drain()
    tokens = fut.result()

The reference's ``docs/fabric.md`` describes the router policies, the
failover semantics and tp sizing; the port keeps them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.ft.watchdog import HeartbeatMonitor
from repro_torch.obs import Obs
from repro_torch.serve.batcher import ServeFuture
from repro_torch.serve.fabric.failover import FailoverController
from repro_torch.serve.fabric.replica import Replica, make_replica_mesh
from repro_torch.serve.fabric.router import POLICIES, Router, prefix_key

__all__ = [
    "FabricConfig",
    "FailoverController",
    "POLICIES",
    "Replica",
    "Router",
    "ServeFabric",
    "make_replica_mesh",
    "prefix_key",
]


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Fabric sizing + routing knobs.

    ``replicas``: independent engine stacks behind the router; ``tp``:
    ranks each replica's feature-sharded forward spans (1 = single-device
    replicas; the factory passes ``make_replica_mesh(tp, offset=...)`` into
    its engines); ``policy``: one of ``router.POLICIES``;
    ``affinity_tokens``: prompt prefix length the sticky-routing key hashes
    (0 disables affinity); ``heartbeat_timeout_s``: how long a replica may
    go without progress before failover drains it.
    """

    replicas: int = 2
    tp: int = 1
    policy: str = "least_occupancy"
    affinity_tokens: int = 16
    heartbeat_timeout_s: float = 10.0

    def validate(self) -> "FabricConfig":
        """Fail fast on unservable configurations."""
        if self.replicas < 1:
            raise ValueError(f"need at least one replica, got {self.replicas}")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; pick one of {POLICIES}")
        if self.heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be > 0")
        return self


class _Tracked:
    """Fabric-side bookkeeping for one in-flight request: the payload (for
    idempotent requeue), the caller-facing future, and the replica-side
    future currently carrying it."""

    __slots__ = ("kind", "payload", "future", "replica", "inner")

    def __init__(self, kind: str, payload, future: ServeFuture, replica: str, inner):
        self.kind = kind
        self.payload = payload
        self.future = future
        self.replica = replica
        self.inner = inner


class ServeFabric:
    """Replica router + failover controller over N serving stacks."""

    def __init__(
        self,
        cfg: FabricConfig,
        *,
        lm_factory: Optional[Callable[[str], Any]] = None,
        embed_factory: Optional[Callable[[str], Any]] = None,
        obs: Optional[Obs] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        """``lm_factory(name) -> LMService`` / ``embed_factory(name) ->
        EmbeddingService`` build each replica's FRESH service stack (own
        engine, own ``Obs``); ``obs`` is the fabric's OWN bundle (router
        flight events, per-replica labelled gauges) and ``clock`` feeds the
        fabric heartbeat monitor (injectable: the failover gate advances a
        fake clock instead of sleeping)."""
        if lm_factory is None and embed_factory is None:
            raise ValueError("pass lm_factory= and/or embed_factory=")
        self.cfg = cfg.validate()
        self.obs = obs or Obs()
        self.router = Router(cfg.policy, cfg.affinity_tokens)
        self.monitor = HeartbeatMonitor(
            default_timeout_s=cfg.heartbeat_timeout_s, clock=clock
        )
        self.failover = FailoverController(self.monitor, timeout_s=cfg.heartbeat_timeout_s)
        self.replicas: List[Replica] = []
        self._by_name: Dict[str, Replica] = {}
        self._inflight: Dict[str, _Tracked] = {}
        self._seq = 0
        self._threaded = False
        self.routed_total = 0
        self.requeued_total = 0
        self.dead_total = 0
        for i in range(cfg.replicas):
            name = f"r{i}"
            self.add_replica(Replica(
                name,
                lm=lm_factory(name) if lm_factory is not None else None,
                embed=embed_factory(name) if embed_factory is not None else None,
            ))

    # -- membership ---------------------------------------------------------

    def add_replica(self, replica: Replica) -> Replica:
        """Join a replica into the fabric (initial build AND elastic grow /
        replacement after a death — detection is re-armed either way)."""
        if replica.name in self._by_name and self._by_name[replica.name].alive:
            raise ValueError(f"replica {replica.name!r} already joined")
        if replica.name in self._by_name:  # replacement for a dead replica
            self.replicas = [r for r in self.replicas if r.name != replica.name]
        self._by_name[replica.name] = replica
        self.replicas.append(replica)
        self.failover.revive(replica.name)
        self.obs.recorder.record("replica_join", replica=replica.name,
                                 replicas=len(self.replicas))
        if self._threaded and not replica.started:
            replica.start()
        return replica

    def replica(self, name: str) -> Replica:
        """Look a replica up by name."""
        return self._by_name[name]

    def _candidates(self, kind: str) -> List[Replica]:
        svc = (lambda r: r.lm) if kind == "lm" else (lambda r: r.embed)
        return [r for r in self.replicas if svc(r) is not None]

    # -- request side -------------------------------------------------------

    def _route(self, kind: str, payload, tokens=None) -> ServeFuture:
        req_id = f"{kind}-{self._seq}"
        self._seq += 1
        fut = ServeFuture()
        tracked = _Tracked(kind, payload, fut, "", None)
        self._dispatch(req_id, tracked, tokens=tokens, via="route")
        self._inflight[req_id] = tracked
        return fut

    def _dispatch(self, req_id: str, tracked: _Tracked, *, tokens, via: str):
        """(Re)submit one tracked request to the best healthy replica.  A
        submit-time rejection (``ValueError``/``Backpressure``) fails the
        caller's future — the fabric never silently drops work."""
        replica, how = self.router.pick(self._candidates(tracked.kind), tokens=tokens)
        if tracked.kind == "lm":
            tokens_arr, max_new, kw = tracked.payload
            tracked.inner = replica.lm.submit(tokens_arr, max_new, **kw)
        else:
            tracked.inner = replica.embed.submit(tracked.payload)
        tracked.replica = replica.name
        self.routed_total += 1
        self.obs.recorder.record(via, request=req_id, replica=replica.name,
                                 policy=how, traffic=tracked.kind)

    def submit_lm(
        self,
        tokens,
        max_new_tokens: int,
        *,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> ServeFuture:
        """Route one generation request (the ``LMService.submit`` contract);
        prefix affinity keeps shared-prefix fan-out on one replica's warm
        radix cache.  Returns a fabric-level future that survives replica
        death: failover re-submits the prompt elsewhere."""
        tokens = np.asarray(tokens, np.int32)
        kw = dict(eos_id=eos_id, temperature=temperature, top_k=top_k, seed=seed)
        return self._route("lm", (tokens, int(max_new_tokens), kw), tokens=tokens)

    def submit_embed(self, x) -> ServeFuture:
        """Route one embedding request by load (no affinity — the embedding
        path has no per-replica warm state worth chasing)."""
        return self._route("embed", np.asarray(x))

    def outstanding(self) -> int:
        """Fabric-level in-flight request count."""
        return len(self._inflight)

    # -- scheduler ----------------------------------------------------------

    def _settle(self, req_id: str, tracked: _Tracked):
        del self._inflight[req_id]
        try:
            tracked.future.set_result(tracked.inner.result(timeout=0))
        except BaseException as e:  # noqa: BLE001 - relay ANY failure to the caller
            tracked.future.set_exception(e)

    def poll(self) -> int:
        """Copy completed replica-side futures into the fabric futures;
        returns how many settled this pass."""
        done = [(rid, t) for rid, t in self._inflight.items() if t.inner.done()]
        for rid, t in done:
            self._settle(rid, t)
        return len(done)

    def _on_dead(self, replica: Replica):
        """Drain-and-requeue: abandon the dead replica's state, deliver what
        it finished, and re-submit everything else from its prompt to the
        healthy replicas (idempotent: the request id and the caller's future
        are reused; the partial decode is simply discarded — greedy decode
        re-derives the identical stream)."""
        replica.alive = False
        self.dead_total += 1
        self.router.forget(replica.name)
        stranded = [(rid, t) for rid, t in self._inflight.items()
                    if t.replica == replica.name]
        self.obs.recorder.record("replica_dead", replica=replica.name,
                                 age_s=self.failover.age(replica.name),
                                 inflight=len(stranded))
        for rid, t in stranded:
            if t.inner.done():  # finished before the crash landed: deliver
                self._settle(rid, t)
                continue
            src = t.replica
            tokens = t.payload[0] if t.kind == "lm" else None
            try:
                self._dispatch(rid, t, tokens=tokens, via="requeue")
            except BaseException as e:  # noqa: BLE001 - no healthy target / rejected
                del self._inflight[rid]
                t.future.set_exception(e)
                continue
            self.requeued_total += 1
            self.obs.recorder.record("requeue_done", request=rid, src=src,
                                     dst=t.replica)

    def step(self) -> int:
        """One fabric tick: advance every live replica (synchronous mode),
        feed the heartbeat monitor, fail over newly-stale replicas, settle
        completed requests.  Returns fabric-level in-flight work."""
        for r in self.replicas:
            if not r.alive or r.crashed:
                continue
            if self._threaded:
                self.failover.relay_beat(r)
            else:
                r.tick()
                self.failover.beat(r.name)
        dead = self.failover.newly_dead(
            [r.name for r in self.replicas if r.alive]
        )
        for name in dead:
            self._on_dead(self._by_name[name])
        self.poll()
        return len(self._inflight)

    def drain(self, max_steps: int = 1_000_000, timeout_s: float = 300.0) -> int:
        """Tick until every fabric future settled (or limits hit); the
        deterministic closed-loop entry point.  Returns ticks run."""
        t0 = time.monotonic()
        ran = 0
        while self._inflight and ran < max_steps:
            self.step()
            ran += 1
            if self._threaded and self._inflight:
                if time.monotonic() - t0 > timeout_s:
                    raise TimeoutError(
                        f"fabric drain timed out with {len(self._inflight)} in flight"
                    )
                time.sleep(1e-3)  # replica threads own the scheduling
        return ran

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, prompt_lens=None) -> "ServeFabric":
        """Warm every replica's services."""
        for r in self.replicas:
            r.warmup(prompt_lens=prompt_lens)
        return self

    def start(self) -> "ServeFabric":
        """Threaded mode: every replica's services loop on daemon threads;
        ``drain``/``poll`` then only settle futures and relay heartbeats."""
        self._threaded = True
        for r in self.replicas:
            if r.alive and not r.started:
                r.start()
        return self

    def stop(self):
        """Stop every replica's service threads (graceful drain)."""
        for r in self.replicas:
            if r.started:
                r.stop()
        self._threaded = False

    def kill(self, name: str):
        """Crash-simulate one replica (synchronous mode): it stops ticking
        and beating; once its heartbeat exceeds the timeout, ``step``
        declares it dead and requeues its in-flight work."""
        self._by_name[name].kill()

    # -- scrape surface -----------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """Fabric scrape surface: flat aggregates + per-replica LABELLED
        gauges (``fabric_replica_occupancy{replica=}`` etc.; the heartbeat
        ages ride the monitor's own ``heartbeat_age_s{name=}`` family)."""
        from repro_torch.serve.service import collect_metrics

        own = {
            "fabric_replicas": float(len(self.replicas)),
            "fabric_replicas_alive": float(sum(r.alive for r in self.replicas)),
            "fabric_inflight": float(len(self._inflight)),
            "fabric_routed_total": float(self.routed_total),
            "fabric_requeued_total": float(self.requeued_total),
            "fabric_replicas_dead_total": float(self.dead_total),
        }
        reg = self.obs.registry
        g_occ = reg.gauge("fabric_replica_occupancy",
                          "per-replica instantaneous slot occupancy",
                          labelnames=("replica",))
        g_out = reg.gauge("fabric_replica_outstanding",
                          "per-replica queued + in-flight requests",
                          labelnames=("replica",))
        g_alive = reg.gauge("fabric_replica_alive",
                            "1 while the replica is routable",
                            labelnames=("replica",))
        for r in self.replicas:
            g_occ.labels(replica=r.name).set(r.occupancy())
            g_out.labels(replica=r.name).set(float(r.outstanding()))
            g_alive.labels(replica=r.name).set(1.0 if r.alive else 0.0)
        return collect_metrics(
            own,
            self.router.metrics(),
            self.failover.metrics(),
            self.monitor,
            self.obs,
            registry=reg,
        )

    def replica_metrics(self) -> Dict[str, Dict[str, float]]:
        """Each replica's own flat scrape surface, keyed by name (the
        per-replica flight recorders ride ``replica(name).lm.obs``)."""
        return {r.name: r.metrics() for r in self.replicas}
