"""The port's serving fabric (``repro_torch.serve.fabric``) against the
reference's, on the CPU.

Twins of every test of ``tests/test_serve_fabric.py`` — the router on fake
replicas, the failover controller's edge trigger and revive on an injected
clock, config and replica validation, the synchronous failover that stays
bit-identical, delivery of requests that finished before a crash, mixed
embedding + LM routing, replacing a dead replica, the labelled metrics, a
kill that stays undetected until the heartbeat is stale, the heartbeat's
labelled publication, ``make_replica_mesh`` and the tp forward — plus:

* ``prefix_key`` and ``Router.score`` give the reference's values on seeded
  inputs;
* on reduced ``gemma2-2b`` with the reference's weights carried across
  (``models.params_from_jax``), the port's fabric emits the REFERENCE
  fabric's tokens on the same stream, through a kill-and-requeue and on
  the mixed embedding + LM run, and its flight recorder counts the
  reference's events;
* ``tp_oracle_err`` at tp = 2 (ranks [0, 2) and [2, 4)) and tp = 4 below
  1e-5, on 4 gloo ranks (``FileStore`` rendezvous); a rank outside a
  replica's sub-mesh gets a mesh it does not join, and no hang;
* the launch counters lose no count under four threads, the threaded
  ``compare_fabric`` legs, ``launch/serve`` and the serve CLI's
  ``--fabric`` gate.
"""

import inspect
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.obs import Obs as RefObs  # noqa: E402
from repro.serve import ContinuousLMEngine as RefContinuousLMEngine  # noqa: E402
from repro.serve import EmbeddingService as RefEmbeddingService  # noqa: E402
from repro.serve import LMService as RefLMService  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.serve.fabric import FabricConfig as RefFabricConfig  # noqa: E402
from repro.serve.fabric import Router as RefRouter  # noqa: E402
from repro.serve.fabric import ServeFabric as RefServeFabric  # noqa: E402
from repro.serve.fabric import prefix_key as ref_prefix_key  # noqa: E402
from repro.train.ssl import SSLModelConfig as RefModelConfig  # noqa: E402
from repro.train.ssl import init_ssl_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.ft.watchdog import HeartbeatMonitor  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.serve.engine import ContinuousLMEngine, ServeEngine  # noqa: E402
from repro_torch.serve.fabric import (  # noqa: E402
    POLICIES,
    FabricConfig,
    FailoverController,
    Replica,
    Router,
    ServeFabric,
    make_replica_mesh,
    prefix_key,
)
from repro_torch.serve.service import EmbeddingService, LMService  # noqa: E402
from repro_torch.train.ssl import SSLModelConfig  # noqa: E402
from repro_torch.train.ssl import params_from_jax as ssl_params_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(input_dim=24, backbone_widths=(32,), projector_widths=(48, 48))
MODEL = SSLModelConfig(**WIDTHS)
REF_MODEL = RefModelConfig(**WIDTHS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Router: pure policy over replica snapshots
# ---------------------------------------------------------------------------


class FakeReplica:
    def __init__(self, name, occ=0.0, queue=0.0, ttft=0.0, slots=4.0, alive=True):
        self.name = name
        self.alive = alive
        self._snap = {
            "slots_total": slots,
            "slots_occupancy": occ,
            "queue_depth": queue,
            "serve_ttft_seconds_p99": ttft,
        }

    def snapshot(self):
        return dict(self._snap)


class TestRouter:
    def test_least_occupancy_prefers_idle_replica(self):
        r = Router("least_occupancy", affinity_tokens=0)
        a, b = FakeReplica("a", occ=0.75), FakeReplica("b", occ=0.25)
        chosen, how = r.pick([a, b])
        assert chosen is b and how == "least_occupancy"

    def test_queue_depth_breaks_equal_occupancy(self):
        r = Router("least_occupancy", affinity_tokens=0)
        a = FakeReplica("a", occ=0.5, queue=8.0)
        b = FakeReplica("b", occ=0.5, queue=1.0)
        assert r.pick([a, b])[0] is b

    def test_weighted_ttft_sheds_slow_replica(self):
        r = Router("weighted_ttft", affinity_tokens=0)
        a = FakeReplica("a", occ=0.5, ttft=0.500)
        b = FakeReplica("b", occ=0.6, ttft=0.001)
        assert r.pick([a, b])[0] is b

    def test_weighted_ttft_cold_degrades_to_occupancy(self):
        r = Router("weighted_ttft", affinity_tokens=0)
        a, b = FakeReplica("a", occ=0.75), FakeReplica("b", occ=0.25)
        assert r.pick([a, b])[0] is b

    def test_affinity_sticks_then_remaps_on_death(self):
        r = Router("least_occupancy", affinity_tokens=4)
        a, b = FakeReplica("a", occ=0.0), FakeReplica("b", occ=0.9)
        tokens = np.arange(8, dtype=np.int32)
        first, how1 = r.pick([a, b], tokens=tokens)
        assert first is a and how1 == "least_occupancy"
        a._snap["slots_occupancy"], b._snap["slots_occupancy"] = 0.9, 0.0
        again, how2 = r.pick([a, b], tokens=tokens)
        assert again is a and how2 == "affinity"
        a.alive = False
        r.forget("a")
        third, how3 = r.pick([a, b], tokens=tokens)
        assert third is b and how3 == "least_occupancy"
        assert r.pick([a, b], tokens=tokens) == (b, "affinity")
        assert r.metrics() == {"fabric_affinity_entries": 1.0}

    def test_prefix_key_only_hashes_leading_tokens(self):
        base = np.arange(32, dtype=np.int32)
        other = base.copy()
        other[20:] += 7
        assert prefix_key(base, 16) == prefix_key(other, 16)
        assert prefix_key(base, 32) != prefix_key(other, 32)

    def test_no_healthy_replica_raises(self):
        with pytest.raises(RuntimeError, match="no healthy replica"):
            Router().pick([FakeReplica("a", alive=False)])

    def test_unknown_policy_rejected(self):
        with pytest.raises(ValueError, match="unknown routing policy"):
            Router("round_robin")


def test_prefix_key_and_score_equal_the_references():
    """CRC32 affinity keys and both policies' scores, on seeded prompts and
    snapshots, equal the reference's (the same floats)."""
    rng = np.random.default_rng(7)
    for _ in range(20):
        toks = rng.integers(0, 256000, int(rng.integers(1, 40))).astype(np.int32)
        for k in (0, 1, 4, 16, 64):
            assert prefix_key(toks, k) == ref_prefix_key(toks, k)
    assert POLICIES == ("least_occupancy", "weighted_ttft")
    for policy in POLICIES:
        ours, theirs = Router(policy), RefRouter(policy)
        for _ in range(50):
            snap = {"slots_total": float(rng.integers(0, 16)), "slots_occupancy": float(rng.random()),
                    "queue_depth": float(rng.integers(0, 64)), "serve_ttft_seconds_p99": float(rng.random() * 0.2)}
            assert ours.score(snap) == theirs.score(snap)


# ---------------------------------------------------------------------------
# Failover controller: edge-triggered staleness on an injectable clock
# ---------------------------------------------------------------------------


class TestFailoverController:
    def test_newly_dead_reports_each_replica_once(self):
        t = {"now": 0.0}
        fc = FailoverController(HeartbeatMonitor(default_timeout_s=5.0, clock=lambda: t["now"]), timeout_s=5.0)
        fc.register("r0")
        fc.register("r1")
        t["now"] = 3.0
        fc.beat("r1")
        t["now"] = 6.0  # r0 stale (6 s), r1 fresh (3 s)
        assert fc.newly_dead(["r0", "r1"]) == ["r0"]
        assert fc.newly_dead(["r0", "r1"]) == []  # edge-triggered
        assert fc.is_dead("r0") and not fc.is_dead("r1")
        assert fc.metrics() == {"fabric_replicas_dead": 1.0}

    def test_revive_rearms_detection(self):
        t = {"now": 0.0}
        fc = FailoverController(HeartbeatMonitor(default_timeout_s=2.0, clock=lambda: t["now"]), timeout_s=2.0)
        fc.register("r0")
        t["now"] = 3.0
        assert fc.newly_dead(["r0"]) == ["r0"]
        fc.revive("r0")
        assert not fc.is_dead("r0")
        t["now"] = 6.0
        assert fc.newly_dead(["r0"]) == ["r0"]


# ---------------------------------------------------------------------------
# ServeFabric end to end (synchronous drive, fake clock), against the
# reference's fabric on the reference's weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma2-2b in both frameworks (the reference's weights)."""
    rcfg = ref_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    cfg = get_config("gemma2-2b").reduced()
    return cfg, params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu"), rcfg, rparams


@pytest.fixture(scope="module")
def ssl_params():
    """The embedding model's reference weights, and the port's model on them."""
    tree = jax.tree.map(np.asarray, init_ssl_params(jax.random.PRNGKey(1), REF_MODEL))
    return tree, ssl_params_from_jax(tree, MODEL, device="cpu")


ENGINE = dict(n_slots=4, max_len=64, max_prompt_len=24, paged=True, page_size=16)


def _lm_factory(gemma):
    cfg, params = gemma[:2]
    return lambda name: LMService(ContinuousLMEngine(cfg, params, device="cpu", **ENGINE), obs=Obs())


def _ref_lm_factory(gemma):
    rcfg, rparams = gemma[2:]
    return lambda name: RefLMService(RefContinuousLMEngine(rcfg, rparams, **ENGINE), obs=RefObs())


def _prompts(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 8).astype(np.int32) for _ in range(n)]


def _failover_run(fabric_cls, cfg_cls, factory, obs, prompts):
    """2 replicas on a fake clock, r0 killed after 3 ticks; returns (tokens, fabric)."""
    t = {"now": 0.0}
    fab = fabric_cls(cfg_cls(replicas=2, heartbeat_timeout_s=5.0), lm_factory=factory, obs=obs,
                     clock=lambda: t["now"])
    futs = [fab.submit_lm(p, 6) for p in prompts]
    for _ in range(3):  # both replicas admit + decode a few ticks
        fab.step()
    fab.kill("r0")
    t["now"] += 10.0  # the heartbeat goes stale; step() declares r0 dead
    fab.drain()
    return [np.asarray(f.result(timeout=60)) for f in futs], fab


@pytest.fixture(scope="module")
def ref_failover(gemma):
    """The reference fabric's failover run: tokens and flight-event counts."""
    obs = RefObs()
    outs, fab = _failover_run(RefServeFabric, RefFabricConfig, _ref_lm_factory(gemma), obs,
                              _prompts(gemma[0].vocab_size))
    return outs, obs.recorder.counts(), fab.requeued_total


class TestServeFabric:
    def test_config_validation(self):
        with pytest.raises(ValueError, match="at least one replica"):
            FabricConfig(replicas=0).validate()
        with pytest.raises(ValueError, match="unknown policy"):
            FabricConfig(policy="nope").validate()
        with pytest.raises(ValueError, match="tp must be"):
            FabricConfig(tp=0).validate()
        with pytest.raises(ValueError, match="heartbeat_timeout_s"):
            FabricConfig(heartbeat_timeout_s=0.0).validate()
        with pytest.raises(ValueError, match="lm_factory"):
            ServeFabric(FabricConfig())

    def test_replica_requires_a_service(self):
        with pytest.raises(ValueError, match="at least one service"):
            Replica("empty")

    def test_kill_rejects_threaded_replicas(self):
        r = Replica("x", lm=object())
        r.started = True  # as if start() ran
        with pytest.raises(RuntimeError, match="synchronous"):
            r.kill()

    def test_failover_requeues_and_tokens_stay_bit_identical(self, gemma, ref_failover):
        cfg = gemma[0]
        prompts = _prompts(cfg.vocab_size)
        oracle_svc = _lm_factory(gemma)("oracle")
        ofuts = [oracle_svc.submit(p, 6) for p in prompts]
        oracle_svc.drain()
        oracle = [f.result(timeout=60) for f in ofuts]

        obs = Obs()
        outs, fab = _failover_run(ServeFabric, FabricConfig, _lm_factory(gemma), obs, prompts)
        assert all(np.array_equal(a, b) for a, b in zip(outs, oracle))
        assert fab.requeued_total >= 1 and fab.dead_total == 1
        assert not fab.replica("r0").alive and fab.replica("r1").alive
        counts = obs.recorder.counts()
        assert counts["replica_join"] == 2 and counts["replica_dead"] == 1
        assert counts["route"] == len(prompts)
        assert counts["requeue"] == counts["requeue_done"] == fab.requeued_total
        # ... and the reference fabric's tokens, on the same stream
        ref_outs, _, _ = ref_failover
        assert all(np.array_equal(a, b) for a, b in zip(outs, ref_outs))

    def test_requests_finished_before_crash_are_delivered(self, gemma):
        (prompt,) = _prompts(gemma[0].vocab_size, n=1)
        t = {"now": 0.0}
        fab = ServeFabric(FabricConfig(replicas=2, heartbeat_timeout_s=5.0), lm_factory=_lm_factory(gemma),
                          clock=lambda: t["now"])
        fut = fab.submit_lm(prompt, 2)
        tracked = next(iter(fab._inflight.values()))
        owner = fab.replica(tracked.replica)
        while not tracked.inner.done():  # finish the decode BEFORE the crash lands
            owner.tick()
        fab.kill(owner.name)
        t["now"] += 10.0
        fab.step()  # _on_dead sees a done inner future: deliver, don't requeue
        assert fab.dead_total == 1 and fab.requeued_total == 0
        assert len(fut.result(timeout=0)) == 2

    def test_mixed_embed_and_lm_routing(self, gemma, ssl_params):
        """Embeddings equal one ``ServeEngine``'s; the LM tokens and the
        embeddings equal the reference fabric's on the same requests."""
        tree, model = ssl_params
        x = np.random.default_rng(3).standard_normal((4, 24)).astype(np.float32)
        prompt = _prompts(gemma[0].vocab_size, n=1)[0]

        def run(fabric_cls, cfg_cls, lm_factory, embed_factory):
            fab = fabric_cls(cfg_cls(replicas=2, heartbeat_timeout_s=5.0), lm_factory=lm_factory,
                             embed_factory=embed_factory)
            efut, lfut = fab.submit_embed(x), fab.submit_lm(prompt, 3)
            fab.drain()
            e = efut.result(timeout=60)
            return np.asarray(e.numpy() if torch.is_tensor(e) else e), np.asarray(lfut.result(timeout=60))

        emb, toks = run(ServeFabric, FabricConfig, _lm_factory(gemma),
                        lambda name: EmbeddingService(ServeEngine(MODEL, model, device="cpu"), obs=Obs()))
        ref_params = jax.tree.map(jax.numpy.asarray, tree)
        ref_emb, ref_toks = run(RefServeFabric, RefFabricConfig, _ref_lm_factory(gemma),
                                lambda name: RefEmbeddingService(RefServeEngine(REF_MODEL, ref_params), obs=RefObs()))
        want = ServeEngine(MODEL, model, device="cpu").encode(x).numpy()
        np.testing.assert_array_equal(emb, want)
        np.testing.assert_allclose(emb, ref_emb, atol=1e-5)
        assert len(toks) == 3 and np.array_equal(toks, ref_toks)

    def test_dead_replica_replacement_rejoins(self, gemma):
        factory = _lm_factory(gemma)
        t = {"now": 0.0}
        fab = ServeFabric(FabricConfig(replicas=2, heartbeat_timeout_s=5.0), lm_factory=factory,
                          clock=lambda: t["now"])
        with pytest.raises(ValueError, match="already joined"):
            fab.add_replica(Replica("r0", lm=factory("dup")))
        fab.kill("r0")
        t["now"] += 10.0
        fab.step()
        assert fab.replica("r0").alive is False
        fab.add_replica(Replica("r0", lm=factory("r0b")))
        assert fab.replica("r0").alive
        fut = fab.submit_lm(_prompts(gemma[0].vocab_size, n=1)[0], 2)
        fab.drain()
        assert len(fut.result(timeout=60)) == 2
        assert len(fab.replicas) == 2

    def test_metrics_labelled_and_legacy_views(self, gemma):
        obs = Obs()
        fab = ServeFabric(FabricConfig(replicas=2, heartbeat_timeout_s=5.0), lm_factory=_lm_factory(gemma), obs=obs)
        fab.step()
        m = fab.metrics()
        assert m["fabric_replicas"] == 2.0 and m["fabric_replicas_alive"] == 2.0
        assert "heartbeat_age_s_fabric_replica_r0" in m
        ad = obs.registry.as_dict()
        for family in ("fabric_replica_alive", "fabric_replica_occupancy", "fabric_replica_outstanding"):
            assert f'{family}{{replica="r0"}}' in ad and f'{family}{{replica="r1"}}' in ad
        assert 'heartbeat_age_s{name="fabric.replica.r1"}' in ad
        assert "heartbeat_age_s_fabric_replica_r0" not in ad
        assert obs.registry.value("fabric_replicas") == 2.0
        per = fab.replica_metrics()
        assert set(per) == {"r0", "r1"} and per["r0"]["replica_alive"] == 1.0

    def test_kill_is_undetected_until_stale(self, gemma):
        t = {"now": 0.0}
        fab = ServeFabric(FabricConfig(replicas=2, heartbeat_timeout_s=5.0), lm_factory=_lm_factory(gemma),
                          clock=lambda: t["now"])
        fab.kill("r1")
        fab.step()
        assert fab.replica("r1").alive  # crashed but not yet declared
        t["now"] += 10.0
        fab.step()
        assert not fab.replica("r1").alive and fab.dead_total == 1


def test_flight_events_equal_the_references(gemma, ref_failover):
    """The failover run's flight recorder counts the reference's events
    (route, requeue, requeue_done, replica_dead, replica_join) one for one."""
    obs = Obs()
    _, fab = _failover_run(ServeFabric, FabricConfig, _lm_factory(gemma), obs, _prompts(gemma[0].vocab_size))
    _, ref_counts, ref_requeued = ref_failover
    assert obs.recorder.counts() == ref_counts
    assert fab.requeued_total == ref_requeued


# ---------------------------------------------------------------------------
# Heartbeat publish_metrics: one labelled family, legacy keys claimed
# ---------------------------------------------------------------------------


class TestHeartbeatLabels:
    def test_publish_metrics_claims_legacy_keys(self):
        from repro_torch.obs.registry import MetricsRegistry

        t = {"now": 0.0}
        hb = HeartbeatMonitor(default_timeout_s=5.0, clock=lambda: t["now"])
        hb.register("serve.dispatch")
        hb.register("serve.lm_decode")
        t["now"] = 1.5
        reg = MetricsRegistry()
        claimed = hb.publish_metrics(reg)
        assert claimed == {"heartbeat_age_s_serve_dispatch", "heartbeat_age_s_serve_lm_decode"}
        assert reg.value("heartbeat_age_s", {"name": "serve.dispatch"}) == 1.5
        assert reg.value("heartbeat_components") == 2.0
        ad = reg.as_dict()
        assert 'heartbeat_age_s{name="serve.lm_decode"}' in ad
        assert "heartbeat_age_s_serve_dispatch" not in ad
        assert hb.metrics()["heartbeat_age_s_serve_dispatch"] == 1.5

    def test_collect_metrics_skips_claimed_keys_in_registry(self):
        from repro_torch.obs.registry import MetricsRegistry
        from repro_torch.serve.service import collect_metrics

        t = {"now": 0.0}
        hb = HeartbeatMonitor(default_timeout_s=5.0, clock=lambda: t["now"])
        hb.register("serve.dispatch")
        reg = MetricsRegistry()
        out = collect_metrics({"queue_depth": 3.0}, hb, registry=reg)
        assert out["queue_depth"] == 3.0
        assert "heartbeat_age_s_serve_dispatch" in out
        assert reg.value("queue_depth") == 3.0
        assert reg.get("heartbeat_age_s_serve_dispatch") is None


# ---------------------------------------------------------------------------
# tp forward: feature-sharded replicas on 4 gloo ranks
# ---------------------------------------------------------------------------


def test_make_replica_mesh_single_device_is_none():
    assert make_replica_mesh(tp=1) is None
    with pytest.raises(ValueError, match="devices"):
        make_replica_mesh(tp=64)  # no process group: a world of one rank


def _tp_job(rank, world, out, store):
    import datetime
    import json

    import torch
    import torch.distributed as dist

    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.serve.fabric import make_replica_mesh
    from repro_torch.serve.loadgen import tp_oracle_err
    from repro_torch.train.ssl import SSLModelConfig, init_ssl_model

    cfg = SSLModelConfig(input_dim=24, backbone_widths=(32,), projector_widths=(48, 48))
    model = init_ssl_model(cfg, seed=0)
    res = {f"tp{tp}_at{offset}": tp_oracle_err(cfg, model, tp=tp, offset=offset, device="cpu")
           for tp, offset in ((2, 0), (2, 2), (4, 0))}
    mesh = make_replica_mesh(tp=2, offset=2)  # every rank builds it; ranks 0, 1 are outside
    res["mesh_axes"] = list(mesh.mesh_dim_names)
    res["mesh_shape"] = list(mesh.shape)
    res["mesh_ranks"] = mesh.mesh.flatten().tolist()
    res["in_mesh"] = mesh.get_coordinate() is not None
    try:
        make_replica_mesh(tp=4, offset=2)
        res["overflow"] = ""
    except ValueError as e:
        res["overflow"] = str(e)
    with open(out, "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fabric_tp"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    src = textwrap.dedent(inspect.getsource(_tp_job))
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen([sys.executable, "-c", src + f"\n_tp_job({r}, 4, {os.path.join(tmp, f'{r}.json')!r}, "
                               f"{store!r})\n"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r in range(4):
        with open(os.path.join(tmp, f"{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("tp,offset", [(2, 0), (2, 2), (4, 0)])
def test_tp_forward_matches_the_unmeshed_engine(tp_runs, tp, offset):
    """Ranks of the (1, tp) sub-mesh get the tp forward within 1e-5 of the
    unmeshed engine; ranks outside it get None (and do not hang)."""
    key = f"tp{tp}_at{offset}"
    for rank, res in enumerate(tp_runs):
        if offset <= rank < offset + tp:
            assert res[key] is not None and res[key] < 1e-5, (rank, res[key])
        else:
            assert res[key] is None


def test_replica_mesh_over_a_subset_of_ranks(tp_runs):
    for rank, res in enumerate(tp_runs):
        assert res["mesh_axes"] == ["data", "model"] and res["mesh_shape"] == [1, 2]
        assert res["mesh_ranks"] == [2, 3] and res["in_mesh"] == (rank >= 2)
        assert "devices [2, 6)" in res["overflow"]


# ---------------------------------------------------------------------------
# Threads, the threaded legs, the launcher and the CLI gate
# ---------------------------------------------------------------------------


def test_launch_counters_lose_no_count_under_threads():
    from repro_torch import kernels
    from repro_torch.kernels.paged_attention.kernel import paged_decode_attention
    from repro_torch.kernels.sumvec_fft.kernel import cmatmul

    kernels.reset_launch_counts()
    start = threading.Barrier(4)

    def work():
        start.wait()
        for _ in range(10000):
            kernels.count_launch(paged_decode_attention)
            kernels.count_launch(cmatmul, bwd_owner=cmatmul)

    threads = [threading.Thread(target=work) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: an unlocked += loses counts here
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    counts, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
    kernels.reset_launch_counts()
    assert counts["paged_attention"] == counts["cmatmul"] == 40000 and bwd["cmatmul"] == 40000


def test_compare_fabric_threaded_and_failover_legs(gemma):
    """The threaded 1- vs 2-replica legs route to identical tokens, the
    failover leg requeues with no token mismatch (``scaling_x`` is reported,
    never gated: CPU threads share the cores)."""
    from repro_torch.serve.loadgen import FabricLoadConfig, LMLoadConfig, compare_fabric

    cfg, params = gemma[:2]
    load = FabricLoadConfig(lm=LMLoadConfig(n_requests=8, prompt_lens=(4, 8, 14), new_tokens=(8, 16)))
    rep = compare_fabric(cfg, params, load, replicas=2, repeats=1, device="cpu")
    g = rep["gate"]
    assert g["token_mismatches"] == 0 and g["requeue_token_mismatches"] == 0
    assert g["requeued"] > 0 and rep["failover"]["replicas_dead"] == 1.0
    assert g["scaling_x"] > 0 and rep["fabric_metrics"]["fabric_replicas"] == 2.0


def test_launch_serve_generates_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "gemma2-2b", "--reduced", "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=gemma2-2b generated (2, 4)" in out and "first row:" in out


def test_serve_cli_fabric_gate(capsys):
    from repro_torch.serve import cli

    rc = cli.main(["--smoke", "--lm-arch", "gemma2-2b", "--continuous", "--paged", "--fabric", "--replicas", "2",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "requeued=" in out and "dead=1" in out and "(requeue token mismatches: 0)" in out
    assert "healthy=True" in out
    with pytest.raises(SystemExit):
        cli.main(["--fabric", "--device", "cpu"])  # needs --lm-arch and --continuous
