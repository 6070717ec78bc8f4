"""Generate ``docs/metrics_torch.md`` — the port's metric + alert-rule
reference (port of ``repro/obs/catalog.py``).

The catalog is not hand-written: this module stands up the port's real
telemetry surface (an embedding service, two continuous-batching LM
services — one paged + prefix-cache + chunked, one speculative — a 2-replica
serving fabric, and the train loop with the decorrelation-health monitor),
drives a tiny deterministic workload through each so every metric family
registers exactly the way the serving and training code registers it, then
walks the populated :class:`~repro_torch.obs.MetricsRegistry` plus
:func:`~repro_torch.obs.alerts.default_serve_rules` /
:func:`~repro_torch.obs.alerts.default_train_rules` and renders one
markdown page: name, type, labels, unit, the alert rules that read each
metric, and the registered help text.

Usage::

    PYTHONPATH=src python -m repro_torch.obs.catalog --device cpu            # rewrite docs/metrics_torch.md
    PYTHONPATH=src python -m repro_torch.obs.catalog --check --device cpu    # fail when stale

``--device`` is where the services run (``cuda`` unless ``cpu`` is passed);
the page is the same on both.  ``docs/metrics.md`` is the reference's page
and is never written here.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

GENERATED_BANNER = (
    "<!-- GENERATED by `PYTHONPATH=src python -m repro_torch.obs.catalog`. "
    "Do not edit by hand: `--check` regenerates this page and fails on any diff. -->"
)
DEFAULT_OUT = "docs/metrics_torch.md"

# deterministic repetitive prompts: the n-gram drafter hits on the prompt's
# own repetition, so the speculative verify path runs (and its histogram
# gets observations) regardless of what the tiny random-init model emits
_SPEC_PROMPTS = (
    (3, 4, 5, 3, 4, 5, 3, 4),
    (7, 2, 7, 2, 7, 2),
    (9, 9, 9, 9, 9),
    (1, 6, 1, 6, 1, 6, 1),
)


class _CatalogLMLoad:
    """Minimal deterministic LM workload (duck-types ``LMLoadConfig``)."""

    def __init__(self, prompts=_SPEC_PROMPTS, max_new: int = 8):
        self.prompts = prompts
        self.max_new = int(max_new)

    def request_stream(self, vocab_size: int) -> List[Tuple[np.ndarray, int]]:
        """Deterministic ``(tokens, max_new)`` list, clamped to the vocab."""
        return [
            (np.asarray(p, dtype=np.int32) % vocab_size, self.max_new)
            for p in self.prompts
        ]


def _populate_embedding(obs, device) -> None:
    """Tiny embedding service end to end: buckets, probe, heartbeat, trace."""
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.buckets import BucketPolicy
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.service import EmbeddingService
    from repro_torch.train.ssl import SSLModelConfig, init_ssl_model

    model_cfg = SSLModelConfig(input_dim=8, backbone_widths=(16,), projector_widths=(16, 16))
    policy = BucketPolicy(max_batch=8, max_wait_ms=0.5, max_queue=64)
    engine = ServeEngine(model_cfg, init_ssl_model(model_cfg, seed=0), policy=policy, device=device)
    probe = DecorrProbe(DecorrConfig(style="bt", reg="sum", q=2), device=device)
    svc = EmbeddingService(engine, probe=probe, obs=obs).warmup()
    rng = np.random.default_rng(0)
    futures = [svc.submit(rng.standard_normal(8).astype(np.float32)) for _ in range(8)]
    while svc.run_pending():
        pass
    for f in futures:
        f.result(timeout=60.0)
    svc.metrics()


def _gemma(device):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("gemma2-2b").reduced()
    return cfg, init_params(cfg, seed=0, device=device)


def _populate_lm(obs, device) -> None:
    """Both LM engines: paged + prefix + chunked prefill, then speculative."""
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.loadgen import run_continuous
    from repro_torch.serve.service import LMService

    cfg, params = _gemma(device)
    load = _CatalogLMLoad()
    prefix_svc = LMService(
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16, paged=True, page_size=8,
                           prefill_chunk=4, prefix_cache=True, device=device),
        obs=obs,
    )
    run_continuous(prefix_svc, load)
    prefix_svc.metrics()
    spec_svc = LMService(
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16, paged=True, page_size=8,
                           speculative=True, draft_k=4, device=device),
        obs=obs,
    )
    run_continuous(spec_svc, load)
    spec_svc.metrics()


def _populate_fabric(obs, device) -> None:
    """Fabric routing surface: flat aggregates + per-replica labelled gauges
    (each replica keeps its OWN ``Obs``; only the fabric-level families land
    in the catalog registry)."""
    from repro_torch.obs import Obs
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.fabric import FabricConfig, ServeFabric
    from repro_torch.serve.service import LMService

    cfg, params = _gemma(device)

    def lm_factory(name):
        return LMService(
            ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16, paged=True, page_size=8,
                               device=device),
            obs=Obs(),
        )

    fabric = ServeFabric(FabricConfig(replicas=2, heartbeat_timeout_s=5.0), lm_factory=lm_factory, obs=obs)
    for tokens, max_new in _CatalogLMLoad().request_stream(cfg.vocab_size):
        fabric.submit_lm(tokens, max_new)
    fabric.drain()
    fabric.metrics()


def _populate_train(obs, device) -> None:
    """Train-loop registry surface: phase histograms, health monitor gauges."""
    import torch

    from repro_torch.obs.health import DecorrHealthMonitor
    from repro_torch.train.loop import LoopConfig, run_training

    class _State:
        step = 0

    def train_step(state, batch):
        state.step += 1
        return state, {"loss": 0.5}

    rng = np.random.default_rng(0)

    def batch_fn(step):
        return torch.as_tensor(rng.standard_normal((16, 8)).astype(np.float32), device=device)

    monitor = DecorrHealthMonitor(lambda params, batch: batch, ema=0.5, device=device)
    run_training(
        _State(), train_step, batch_fn, LoopConfig(total_steps=4, log_interval=2),
        registry=obs.registry, monitor=monitor, perf=obs.perf,
    )


def build_populated_obs(device=None):
    """Stand up the full telemetry surface on ``device`` (``cuda`` unless
    ``"cpu"`` is passed) and return the ``Obs`` bundle.

    Every metric family lands in ``obs.registry`` through the exact code
    path serving and training use (service ``metrics()`` republication,
    histogram observes, alert-state publication, derived quantile gauges).
    """
    from repro_torch import resolve_device
    from repro_torch.obs import Obs
    from repro_torch.obs.alerts import AlertManager, default_serve_rules, default_train_rules

    device = resolve_device(device)
    serve_rules = default_serve_rules()
    train_rules = default_train_rules()
    obs = Obs(alerts=AlertManager(serve_rules + train_rules))
    _populate_embedding(obs, device)
    _populate_lm(obs, device)
    _populate_fabric(obs, device)
    _populate_train(obs, device)
    # the scrape derives histogram quantile gauges + per-executable roofline
    # gauges and publishes alert state, exactly like the HTTP endpoint
    obs.scrape()
    return obs, serve_rules, train_rules


_UNIT_RULES: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    (("_seconds",), "seconds"),
    (("_ms",), "milliseconds"),
    (("_bytes",), "bytes"),
    (("_rps", "_per_s", "per_s"), "per second"),
    (("_rate", "_frac", "_fraction", "_utilization", "_occupancy", "_ratio"),
     "ratio"),
    (("_total", "_count", "_events", "_steps", "_updates"), "count"),
)


def infer_unit(name: str) -> str:
    """Unit from the metric-name suffix convention (``*_seconds`` etc.)."""
    for needles, unit in _UNIT_RULES:
        if any(n in name for n in needles):
            return unit
    return "value"


def _rule_cell(rules, metric_name: str) -> str:
    """The alert rules reading one metric, as ``name: op threshold ×window``."""
    from repro_torch.obs.registry import sanitize_name

    cells = [
        f"`{r.name}`: {r.op} {r.threshold:g} ×{r.window} ({r.severity})"
        for r in rules
        if sanitize_name(r.metric) == metric_name
    ]
    return "<br>".join(cells) if cells else ""


def render(registry, serve_rules, train_rules) -> str:
    """Render the populated registry + rule sets as the markdown page."""
    all_rules = list(serve_rules) + list(train_rules)
    lines = [
        GENERATED_BANNER,
        "",
        "# Metrics reference (PyTorch port)",
        "",
        "Every metric the port's serve/train telemetry stack registers, generated",
        "by instantiating the real services of `repro_torch` ([metrics.md](metrics.md) is",
        "the reference's page, [observability.md](observability.md) explains the stack).  Units follow the name-suffix convention",
        "(`*_seconds`, `*_bytes`, `*_total`, ...); histograms additionally",
        "export `_bucket`/`_sum`/`_count` series and scrape-time derived",
        "`_p50`/`_p99` quantile gauges.",
        "",
        "## Alert rules",
        "",
        "Edge-triggered threshold rules evaluated on the scrape path",
        "(`window` consecutive breaches fire once; recovery clears once).",
        "",
    ]
    for title, fn_name, rules in (
        ("Serve", "default_serve_rules()", serve_rules),
        ("Train", "default_train_rules()", train_rules),
    ):
        lines += [
            f"### {title} (`{fn_name}`)",
            "",
            "| rule | metric | condition | window | severity |",
            "|---|---|---|---|---|",
        ]
        lines += [
            f"| `{r.name}` | `{r.metric}` | `{r.op} {r.threshold:g}` "
            f"| {r.window} | {r.severity} |"
            for r in rules
        ]
        lines.append("")
    lines += [
        "## Metrics",
        "",
        "| metric | type | labels | unit | alert rules | help |",
        "|---|---|---|---|---|---|",
    ]
    metrics = sorted(registry.metrics(), key=lambda m: m.name)
    for m in metrics:
        labels = ", ".join(f"`{ln}`" for ln in m.labelnames) or ""
        unit = infer_unit(m.name)
        lines.append(
            f"| `{m.name}` | {m.kind} | {labels} | {unit} "
            f"| {_rule_cell(all_rules, m.name)} | {m.help} |"
        )
    kinds: Dict[str, int] = {}
    for m in metrics:
        kinds[m.kind] = kinds.get(m.kind, 0) + 1
    counts = ", ".join(f"{n} {k}s" for k, n in sorted(kinds.items()))
    lines += [
        "",
        f"{len(metrics)} metric families ({counts}); "
        f"{len(all_rules)} alert rules.",
        "",
    ]
    return "\n".join(lines)


def generate(device=None) -> str:
    """Build the telemetry surface on ``device`` and return the rendered page."""
    obs, serve_rules, train_rules = build_populated_obs(device)
    return render(obs.registry, serve_rules, train_rules)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point: write the page, or ``--check`` it against disk."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=DEFAULT_OUT,
                   help=f"output path (default: {DEFAULT_OUT})")
    p.add_argument("--check", action="store_true",
                   help="regenerate and diff against --out; exit 1 when stale")
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    text = generate(args.device)
    if args.check:
        try:
            with open(args.out) as f:
                on_disk = f.read()
        except FileNotFoundError:
            print(f"[catalog] {args.out} missing; run "
                  f"`PYTHONPATH=src python -m repro_torch.obs.catalog` and commit it")
            return 1
        if on_disk != text:
            print(f"[catalog] {args.out} is STALE: regenerate with "
                  f"`PYTHONPATH=src python -m repro_torch.obs.catalog` and commit the diff")
            return 1
        print(f"[catalog] {args.out} is up to date")
        return 0
    with open(args.out, "w") as f:
        f.write(text)
    print(f"[catalog] wrote {args.out} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
