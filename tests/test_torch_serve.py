"""The port's embedding-serving slice against the reference: the engine's
embeddings (1e-5), the service end to end (rows and probe metrics), the
host pieces (buckets, batcher, heartbeat), and the no-silent-fallback rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.decorr.config import DecorrConfig as RefConfig  # noqa: E402
from repro.serve import buckets as rbuckets  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.probes import DecorrProbe as RefProbe  # noqa: E402
from repro.serve.service import EmbeddingService as RefService  # noqa: E402
from repro.train.ssl import SSLModelConfig as RefModelConfig  # noqa: E402
from repro.train.ssl import init_ssl_params  # noqa: E402
from repro_torch.decorr.config import DecorrConfig  # noqa: E402
from repro_torch.ft.watchdog import HeartbeatMonitor  # noqa: E402
from repro_torch.serve import buckets  # noqa: E402
from repro_torch.serve.batcher import Backpressure, MicroBatcher  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.loadgen import LoadConfig, request_stream  # noqa: E402
from repro_torch.serve.probes import DecorrProbe  # noqa: E402
from repro_torch.serve.service import EmbeddingService  # noqa: E402
from repro_torch.train.ssl import SSLModelConfig, params_from_jax  # noqa: E402

WIDTHS = dict(input_dim=12, backbone_widths=(16,), projector_widths=(24, 32))
POLICY = dict(max_batch=16, max_wait_ms=0.0)


def _models(seed=0):
    params = init_ssl_params(jax.random.PRNGKey(seed), RefModelConfig(**WIDTHS))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, params_from_jax(tree, SSLModelConfig(**WIDTHS))


def _engines():
    params, model = _models()
    ref = RefEngine(RefModelConfig(**WIDTHS), params, policy=rbuckets.BucketPolicy(**POLICY))
    port = ServeEngine(SSLModelConfig(**WIDTHS), model, policy=buckets.BucketPolicy(**POLICY),
                       device="cpu")
    return ref, port


@pytest.mark.parametrize("n", [1, 5, 8, 13, 16, 21])
def test_encode_matches_reference(n):
    ref, port = _engines()
    x = np.random.default_rng(n).standard_normal((n, WIDTHS["input_dim"])).astype(np.float32)
    want = np.asarray(ref.encode(x))
    got = port.encode(x).numpy()
    assert got.shape == want.shape == (n, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_from_jax_infers_widths():
    _, model = _models()
    assert model.cfg == SSLModelConfig(**WIDTHS)
    assert model.d == 32


def test_service_end_to_end_matches_reference():
    """Serve one seeded stream through both stacks; the rows agree at 1e-5
    and, after two full probe windows, every probe gauge the reference
    exports agrees at 5e-4 relative (the port's probe gets the reference's
    permutation indices, since JAX's threefry stream cannot be reproduced)."""
    ref_engine, port_engine = _engines()
    cfg = dict(style="vic", reg="sum", q=2, block_size=8)
    seed = 5

    def ref_perm(step, d):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(step))
        return torch.from_numpy(np.array(jax.random.permutation(key, d)))

    ref_svc = RefService(ref_engine, probe=RefProbe(RefConfig(**cfg), perm_seed=seed))
    port_svc = EmbeddingService(
        port_engine, probe=DecorrProbe(DecorrConfig(**cfg), permutation=ref_perm, device="cpu")
    )
    xs, _ = request_stream(LoadConfig(n_requests=40, input_dim=WIDTHS["input_dim"], seed=seed))
    results = {}
    for name, svc in (("ref", ref_svc), ("port", port_svc)):
        futures = [svc.submit(x) for x in xs]
        while svc.run_pending():
            pass
        results[name] = np.stack([f.result(timeout=10) for f in futures])
    np.testing.assert_allclose(results["port"], results["ref"], rtol=1e-5, atol=1e-5)

    want, got = ref_svc.metrics(), port_svc.metrics()
    assert got["decorr_probe_steps"] == want["decorr_probe_steps"] == 2.0
    assert got["dispatch_errors"] == want["dispatch_errors"] == 0.0
    assert got["served_total"] == want["served_total"] == 40.0
    probe_keys = [k for k in want if k.startswith("decorr_")]
    assert probe_keys and set(probe_keys) <= set(got)
    for k in probe_keys:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=1e-6, err_msg=k)


def test_threaded_service_serves_everything():
    _, port_engine = _engines()
    svc = EmbeddingService(port_engine, probe=DecorrProbe(DecorrConfig(style="bt"), device="cpu"))
    svc.warmup().start()
    try:
        xs, _ = request_stream(LoadConfig(n_requests=48, input_dim=WIDTHS["input_dim"]))
        futures = [svc.submit(x, block=True, timeout=10) for x in xs]
        rows = [f.result(timeout=30) for f in futures]
    finally:
        svc.stop()
    assert all(r.shape == (32,) for r in rows)
    m = svc.metrics()
    assert m["served_total"] == 48 and m["dispatch_errors"] == 0
    assert m["decorr_probe_steps"] == 3  # 48 rows / 16-row windows
    assert m["compiled_buckets"] == len(buckets.bucket_sizes(buckets.BucketPolicy(**POLICY)))


@pytest.mark.parametrize("max_batch", [1, 8, 30, 64, 256])
def test_bucket_ladder_matches_reference(max_batch):
    ref = rbuckets.BucketPolicy(max_batch=max_batch)
    port = buckets.BucketPolicy(max_batch=max_batch)
    assert buckets.bucket_sizes(port) == rbuckets.bucket_sizes(ref)
    assert [buckets.bucket_for(n, port) for n in range(1, max_batch + 1)] == [
        rbuckets.bucket_for(n, ref) for n in range(1, max_batch + 1)
    ]


def test_batcher_backpressure_and_coalescing():
    b = MicroBatcher(buckets.BucketPolicy(max_batch=4, max_wait_ms=0.0, max_queue=6))
    for i in range(6):
        b.submit(np.full((3,), i, np.float32))
    with pytest.raises(Backpressure):
        b.submit(np.zeros(3, np.float32))
    first = b.next_batch(timeout=0.0)
    assert [int(r.x[0]) for r in first] == [0, 1, 2, 3]
    b.shutdown()
    assert [int(r.x[0]) for r in b.next_batch(timeout=0.0)] == [4, 5]
    assert b.next_batch(timeout=0.0) is None


def test_heartbeat_counts_stale_transitions_once():
    now = [0.0]
    hb = HeartbeatMonitor(clock=lambda: now[0])
    hb.register("serve.dispatch", 1.0)
    now[0] = 2.0
    assert "serve.dispatch" in hb.stale()
    hb.stale()
    assert hb.missed_events == 1
    hb.beat("serve.dispatch")
    assert hb.metrics()["heartbeat_stale"] == 0.0
    assert "heartbeat_age_s_serve_dispatch" in hb.metrics()


def test_no_silent_cpu_fallback(monkeypatch):
    from repro_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, model = _models()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(SSLModelConfig(**WIDTHS), model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecorrProbe()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_cli_smoke_on_cpu(capsys):
    from repro_torch.serve import cli

    assert cli.main(["--smoke", "--device", "cpu", "--requests", "64"]) == 0
    assert "healthy=True" in capsys.readouterr().out
