"""Parity table of the PyTorch port against the JAX reference, on the CPU.

For every ported module, runs the reference function and its port on the
same seeded numpy inputs (the reference's Pallas kernels in interpret mode,
the port's kernels through their plain PyTorch versions, gradients through
the reference's ``custom_vjp``s and the port's autograd rules) and prints
one markdown row per comparison: max absolute and max relative difference.

Run from the repo root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_parity.py
"""

from __future__ import annotations

import numpy as np


def _rows():
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core import regularizers as rregs
    from repro.decorr import DecorrConfig as RefConfig
    from repro.decorr import probe_metrics as ref_probe
    from repro.kernels.grouped_sumvec import kernel as rgk
    from repro.kernels.grouped_sumvec import ops as rgo
    from repro.kernels.sumvec_fft import kernel as rfk
    from repro.kernels.sumvec_fft import ops as rfo
    from repro.serve.buckets import BucketPolicy as RefPolicy
    from repro.serve.engine import ServeEngine as RefEngine
    from repro.train.ssl import SSLModelConfig as RefModelConfig
    from repro.train.ssl import init_ssl_params
    from repro_torch.core import regularizers as tregs
    from repro_torch.decorr import DecorrConfig, probe_metrics
    from repro_torch.kernels.grouped_sumvec import kernel as tgk
    from repro_torch.kernels.grouped_sumvec import ops as tgo
    from repro_torch.kernels.sumvec_fft import kernel as tfk
    from repro_torch.kernels.sumvec_fft import ops as tfo
    from repro_torch.serve.buckets import BucketPolicy
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.ssl import SSLModelConfig, params_from_jax

    rng = np.random.default_rng(0)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    J = lambda *xs: [jnp.asarray(x) for x in xs]
    T = lambda *xs: [torch.from_numpy(x) for x in xs]

    def flat(x):
        if isinstance(x, (tuple, list)):
            return np.concatenate([flat(v) for v in x])
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float64).ravel()

    def row(module, what, got, want):
        g, w = flat(got), flat(want)
        err = np.abs(g - w)
        rel = err / np.maximum(np.abs(w), 1e-30)
        return module, what, float(err.max()), float(rel.max())

    out = []
    a = [arr(40, 33), arr(40, 33), arr(33, 130), arr(33, 130)]
    out.append(row("kernels/sumvec_fft cmatmul", "(40,33)x(33,130)",
                   tfk.cmatmul(*T(*a)), rfk._cmatmul_raw(*J(*a))))
    a = [arr(17, 130), arr(17, 130), arr(130), arr(130)]
    out.append(row("kernels/sumvec_fft ctwiddle", "(17,130)",
                   tfk.ctwiddle(*T(*a)), rfk._ctwiddle_raw(*J(*a))))
    a = [arr(70, 130), arr(130, 9)]
    out.append(row("kernels/grouped_sumvec pmatmul", "(70,130)x(130,9)",
                   tgk.pmatmul(*T(*a)), rgk._pmatmul_raw(*J(*a))))
    a = [arr(2, 20, 16), arr(2, 20, 16)]
    out.append(row("kernels/grouped_sumvec freq_outer", "(2,20,16)",
                   tgk.freq_outer(*T(*a)), rgk._freq_outer_raw(*J(*a))))
    for d, q in ((64, 2), (96, 1), (61, 1), (61, 2)):
        z = [arr(12, d), arr(12, d)]
        out.append(row("kernels/sumvec_fft r_sum_fourstep", f"d={d} q={q}",
                       tfo.r_sum_fourstep(*T(*z), q=q, scale=12.0),
                       rfo.r_sum_fourstep(*J(*z), q=q, scale=12.0)))
    for b, q in ((8, 1), (16, 2)):
        z = [arr(10, 40), arr(10, 40)]
        out.append(row("kernels/grouped_sumvec r_sum_kernel", f"d=40 b={b} q={q}",
                       tgo.r_sum_kernel(*T(*z), block_size=b, q=q, scale=10.0),
                       rgo.r_sum_kernel(*J(*z), block_size=b, q=q, scale=10.0)))
    for b in (None, 1, 8, 64):
        for q in (1, 2):
            z = [arr(10, 40), arr(10, 40)]
            out.append(row("core/regularizers r_sum_auto", f"d=40 b={b} q={q}",
                           tregs.r_sum_auto(*T(*z), q=q, block_size=b, scale=10),
                           rregs.r_sum_auto(*J(*z), q=q, block_size=b, scale=10)))
    key = jax.random.PRNGKey(3)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 32)))
    for style in ("bt", "vic"):
        for b in (None, 8):
            z1 = arr(24, 32)
            kw = dict(style=style, reg="sum", q=2, block_size=b)
            want = ref_probe(jnp.asarray(z1), None, RefConfig(**kw), perm_key=key)
            got = probe_metrics(torch.from_numpy(z1), None, DecorrConfig(**kw), perm)
            keys = sorted(want)
            out.append(row("decorr/probe probe_metrics", f"{style} b={b} ({len(keys)} values)",
                           [float(got[k]) for k in keys], [float(want[k]) for k in keys]))
    widths = dict(input_dim=12, backbone_widths=(16,), projector_widths=(24, 32))
    params = init_ssl_params(jax.random.PRNGKey(0), RefModelConfig(**widths))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), SSLModelConfig(**widths))
    ref = RefEngine(RefModelConfig(**widths), params, policy=RefPolicy(max_batch=16))
    port = ServeEngine(SSLModelConfig(**widths), model, policy=BucketPolicy(max_batch=16), device="cpu")
    x = arr(21, 12)
    out.append(row("serve/engine encode", "n=21 (two buckets)", port.encode(x), np.asarray(ref.encode(x))))
    out.extend(_training_rows(arr, row))
    out.extend(_lm_rows(row))
    return out


def _vjp_row(row, module, what, ref_fn, port_fn, xs, cots, grad_mask):
    """Forward and vjp of every input in ``grad_mask``, reference vs port."""
    import jax
    import jax.numpy as jnp
    import torch

    want_out, vjp = jax.vjp(ref_fn, *(jnp.asarray(x) for x in xs))
    want_g = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1 else jnp.asarray(cots[0]))
    ts = [torch.from_numpy(x).requires_grad_(m) for x, m in zip(xs, grad_mask)]
    got_out = port_fn(*ts)
    got_out = got_out if isinstance(got_out, tuple) else (got_out,)
    got_g = torch.autograd.grad(got_out, [t for t, m in zip(ts, grad_mask) if m], [torch.from_numpy(c) for c in cots])
    return row(module, what, [g.detach() for g in got_out] + list(got_g),
               list(want_out if isinstance(want_out, (tuple, list)) else (want_out,))
               + [w for w, m in zip(want_g, grad_mask) if m])


def _training_rows(arr, row):
    """The training slice: kernel vjps, the fused R_off kernel, the engine's
    losses and gradients, the optimizers, the data and 20-step loss curves."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.data import SSLDataConfig as RefData
    from repro.data import ssl_batch as ref_batch
    from repro.decorr import DecorrConfig as RefConfig
    from repro.decorr import engine as reng
    from repro.kernels.grouped_sumvec import kernel as rgk
    from repro.kernels.sumvec_fft import kernel as rfk
    from repro.kernels.xcorr_offdiag import kernel as rxk
    from repro.kernels.xcorr_offdiag import ops as rxo
    from repro.optim import optimizers as ropt
    from repro_torch.data import SSLDataConfig, ssl_batch
    from repro_torch.decorr import DecorrConfig, apply
    from repro_torch.kernels.grouped_sumvec import kernel as tgk
    from repro_torch.kernels.sumvec_fft import kernel as tfk
    from repro_torch.kernels.xcorr_offdiag import kernel as txk
    from repro_torch.kernels.xcorr_offdiag import ops as txo
    from repro_torch.optim import optimizers as topt

    out = []
    xs = [arr(40, 33), arr(40, 33), arr(33, 130), arr(33, 130)]
    out.append(_vjp_row(row, "kernels/sumvec_fft cmatmul vjp", "(40,33)x(33,130): C, dA, dB", rfk.cmatmul,
                        tfk.cmatmul, xs, [arr(40, 130), arr(40, 130)], (True,) * 4))
    xs = [arr(24, 8), arr(8, 8), arr(8, 8)]
    out.append(_vjp_row(row, "kernels/sumvec_fft cmatmul vjp", "real A (24,8)x(8,8): C, Re dA",
                        lambda a, b, c: rfk.cmatmul(a, jnp.zeros_like(a), b, c),
                        lambda a, b, c: tfk.cmatmul(a, None, b, c), xs, [arr(24, 8), arr(24, 8)], (True, False, False)))
    xs = [arr(17, 130), arr(17, 130), arr(130), arr(130)]
    out.append(_vjp_row(row, "kernels/sumvec_fft ctwiddle vjp", "(17,130): y, dx, dw", rfk.ctwiddle, tfk.ctwiddle,
                        xs, [arr(17, 130), arr(17, 130)], (True,) * 4))
    out.append(_vjp_row(row, "kernels/grouped_sumvec pmatmul vjp", "(70,130)x(130,9): C, dA, dB", rgk.pmatmul,
                        tgk.pmatmul, [arr(70, 130), arr(130, 9)], [arr(70, 9)], (True, True)))
    out.append(_vjp_row(row, "kernels/grouped_sumvec freq_outer vjp", "(2,20,16): G, dA, dB", rgk.freq_outer,
                        tgk.freq_outer, [arr(2, 20, 16), arr(2, 20, 16)], [arr(2, 16, 16)], (True, True)))
    out.append(_vjp_row(row, "kernels/grouped_sumvec freq_mat vjp", "(2,20,16)x(2,16,16): Y, dA, dM", rgk.freq_mat,
                        tgk.freq_mat, [arr(2, 20, 16), arr(2, 16, 16)], [arr(2, 20, 16)], (True, True)))
    for n, d in ((16, 130), (24, 256)):
        z = [arr(n, d), arr(n, d)]
        out.append(row("kernels/xcorr_offdiag off_diagonal_sq_sum_raw", f"({n},{d})",
                       txk.off_diagonal_sq_sum_raw(*(torch.from_numpy(x) for x in z)),
                       rxk.off_diagonal_sq_sum_raw(*(jnp.asarray(x) for x in z))))
    for n, d in ((10, 40), (50, 12)):
        z = [arr(n, d), arr(n, d)]
        out.append(_vjp_row(row, "kernels/xcorr_offdiag off_diagonal_sq_sum vjp",
                            f"({n},{d}) {'Gram' if n <= d else 'matrix'} branch: R, dZ1, dZ2",
                            lambda a, b: rxo.off_diagonal_sq_sum(a, b, scale=9.0),
                            lambda a, b: txo.off_diagonal_sq_sum(a, b, scale=9.0), z, [np.array(1.3, np.float32)], (True, True)))

    key = jax.random.PRNGKey(7)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 32)))
    grid = [dict(style=st, reg="sum", block_size=b, q=q, use_kernel=k)
            for st in ("bt", "vic") for b in (None, 8) for q in (1, 2) for k in (False, True)]
    grid += [dict(style=st, reg="off", use_kernel=k) for st in ("bt", "vic") for k in (False, True)]
    worst = {}
    for kw in grid:
        z = [arr(12, 32), arr(12, 32)]
        (lw, _), gw = jax.value_and_grad(lambda a, b: reng.apply(a, b, RefConfig(**kw), key), argnums=(0, 1),
                                         has_aux=True)(*(jnp.asarray(x) for x in z))
        ts = [torch.from_numpy(x).requires_grad_() for x in z]
        lg, _ = apply(*ts, DecorrConfig(**kw), perm)
        gg = torch.autograd.grad(lg, ts)
        r = row("decorr/engine apply", "", [lg.detach(), *gg], [lw, *gw])
        tag = f"{kw['reg']}, use_kernel={kw['use_kernel']}"
        worst[tag] = max(worst.get(tag, r), r, key=lambda x: x[3])
    for tag, r in worst.items():
        out.append((r[0], f"loss + dZ1 + dZ2, bt/vic x b x q ({tag}; worst)", r[2], r[3]))

    for name in ("lars", "adamw", "sgd_momentum"):
        params = {"w": arr(6, 4), "b": arr(4)}
        ref = getattr(ropt, name)()
        rp = {k: jnp.asarray(v) for k, v in params.items()}
        rs = ref.init(rp)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        opt = getattr(topt, name)().init(tp.values())
        for step in range(5):
            grads = {"w": arr(6, 4), "b": arr(4)}
            rp, rs = ref.update({k: jnp.asarray(v) for k, v in grads.items()}, rs, rp, 0.1)
            for k, p in tp.items():
                p.grad = torch.from_numpy(grads[k])
            opt.step(0.1)
        out.append(row("optim/optimizers", f"{name}, 5 updates", [tp["w"], tp["b"]], [rp["w"], rp["b"]]))

    data = SSLDataConfig(input_dim=256, batch=128)
    out.append(row("data/synthetic ssl_batch", "(128,256) step 3, both views", list(ssl_batch(data, 3)),
                   list(ref_batch(RefData(input_dim=256, batch=128), 3))))
    out.extend(_curve_rows(row))
    return out


def _curve_rows(row):
    """20-step loss curves of make_ssl_train_step, tiny config, three arms."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.data import SSLDataConfig as RefData
    from repro.data import ssl_batch as ref_batch
    from repro.decorr import DecorrConfig as RefConfig
    from repro.optim import lars as rlars
    from repro.optim import warmup_cosine as rwc
    from repro.train.ssl import SSLModelConfig as RefModel
    from repro.train.ssl import init_ssl_params
    from repro.train.ssl import make_ssl_train_step as rmake
    from repro.train.train_state import create_train_state as rcreate
    from repro_torch.decorr import DecorrConfig
    from repro_torch.optim import lars, warmup_cosine
    from repro_torch.train import SSLModelConfig, create_train_state, make_ssl_train_step, params_from_jax

    widths = dict(input_dim=256, backbone_widths=(128,), projector_widths=(256, 256))
    batches = [ref_batch(RefData(input_dim=256, batch=128), s) for s in range(20)]
    params = jax.tree_util.tree_map(np.asarray, init_ssl_params(jax.random.PRNGKey(0), RefModel(**widths)))
    perm_fn = lambda s: torch.from_numpy(np.array(jax.random.permutation(jax.random.fold_in(jax.random.PRNGKey(0), s), 256)))
    arms = {"a: bt r_sum b=128 q=2": dict(style="bt", block_size=128, q=2),
            "b: vic r_sum ungrouped q=1": dict(style="vic", q=1),
            "c: bt r_off use_kernel": dict(style="bt", reg="off", use_kernel=True)}
    out = []
    for arm, kw in arms.items():
        opt = rlars(weight_decay=1e-4)
        st = rcreate(jax.tree_util.tree_map(jnp.asarray, params), opt)
        step = jax.jit(rmake(RefModel(**widths), RefConfig(**kw), opt, rwc(0.2, 2, 20))[0])
        want = []
        for v1, v2 in batches:
            st, m = step(st, {"view1": jnp.asarray(v1), "view2": jnp.asarray(v2)})
            want.append(float(m[f"{kw['style']}_loss"]))
        for impl in ("kernel", "plain"):
            topt_ = lars(weight_decay=1e-4)
            tst = create_train_state(params_from_jax(params, SSLModelConfig(**widths)), topt_)
            tstep, _ = make_ssl_train_step(SSLModelConfig(**widths), DecorrConfig(**kw), topt_, warmup_cosine(0.2, 2, 20),
                                           perm_fn=perm_fn, impl=impl)
            got = []
            for v1, v2 in batches:
                tst, m = tstep(tst, {"view1": torch.from_numpy(v1), "view2": torch.from_numpy(v2)})
                got.append(float(m[f"{kw['style']}_loss"]))
            out.append(row("train/ssl make_ssl_train_step", f"20-step loss curve, {arm}, {impl} route",
                           np.array(got), np.array(want)))
    return out


def _lm_rows(row):
    """The LM serving slice on reduced gemma2-2b (the reference's weights):
    the paged kernel's plain version, the model's forward / prefill /
    decode, and the engine's tokens, paged and dense."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as ref_config
    from repro.kernels.paged_attention import ops as rpo
    from repro.models import init_params as ref_init
    from repro.models.transformer import forward as ref_forward
    from repro.models.transformer import init_caches as ref_caches
    from repro.models.transformer import init_paged_caches as ref_paged
    from repro.serve.engine import LMServeEngine as RefLM
    from repro.train import serve as rserve
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain
    from repro_torch.models import forward, init_caches, params_from_jax
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService
    from repro_torch.train import serve

    rng = np.random.default_rng(5)
    out = []
    b, h, kv, hd, page, nb = 3, 4, 2, 16, 8, 4
    p_total = b * nb + 1
    xs = [rng.standard_normal(s).astype(np.float32) for s in ((b, h, hd), (p_total, page, kv, hd), (p_total, page, kv, hd))]
    xs += [rng.permutation(np.arange(1, p_total))[: b * nb].reshape(b, nb).astype(np.int32), np.asarray([5, 17, 32], np.int32)]
    for softcap, window in ((0.0, 0), (30.0, 0), (0.0, 7), (50.0, 9)):
        kw = dict(scale=0.25, softcap=softcap, window=window)
        out.append(row("kernels/paged_attention paged_decode_plain", f"softcap={softcap:g} window={window} vs Pallas",
                       paged_decode_plain(*(torch.from_numpy(x) for x in xs), **kw),
                       np.asarray(rpo.paged_decode_attention(*(jnp.asarray(x) for x in xs), **kw))))
    rcfg, cfg = ref_config("gemma2-2b").reduced(), get_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, got = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks)), forward(params, cfg, torch.from_numpy(toks))
    out.append(row("models/transformer forward", "score (2,20): logits", got.logits, np.asarray(want.logits)))
    out.append(row("models/transformer forward", "score (2,20): hidden", got.hidden, np.asarray(want.hidden)))
    wl, wc = rserve.make_prefill_step(rcfg)(rparams, ref_caches(rcfg, 2, 32), tokens=jnp.asarray(toks))
    gl, gc = serve.make_prefill_step(cfg)(params, init_caches(cfg, 2, 32, "cpu"), torch.from_numpy(toks))
    out.append(row("train/serve make_prefill_step", "(2,20): logits + k/v caches",
                   [gl] + [v for leafs in gc.values() for v in leafs.values()],
                   [np.asarray(wl)] + [np.asarray(v) for leafs in wc.values() for v in leafs.values()]))
    step, rstep = serve.make_decode_step(cfg, return_hidden=True), rserve.make_decode_step(rcfg, return_hidden=True)
    cl = np.asarray([20, 19], np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    w = rstep(rparams, wc, jnp.asarray(cl), tokens=jnp.asarray(nxt))
    g = step(params, gc, torch.from_numpy(cl), torch.from_numpy(nxt))
    out.append(row("train/serve make_decode_step", "dense, per-slot cache_len: logits + hidden",
                   [g[0], g[1]], [np.asarray(w[0]), np.asarray(w[1])]))
    vals = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), ref_paged(rcfg, b, p_total, page))
    tables, cl = xs[3], np.asarray([4, 27, 17], np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    w = rstep(rparams, jax.tree.map(jnp.asarray, vals), jnp.asarray(cl), tokens=jnp.asarray(nxt),
              block_tables=jnp.asarray(tables))
    for impl in (None, "kernel"):
        pools = {n: {k: torch.from_numpy(v.copy()) for k, v in leafs.items()} for n, leafs in vals.items()}
        g = step(params, pools, torch.from_numpy(cl), torch.from_numpy(nxt), block_tables=torch.from_numpy(tables), impl=impl)
        out.append(row("train/serve make_decode_step",
                       f"paged, {'gather route' if impl is None else 'kernel wrapper (plain)'}: logits + hidden",
                       [g[0], g[1]], [np.asarray(w[0]), np.asarray(w[1])]))
    spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in ((4, 5), (9, 3), (13, 8), (24, 2), (1, 4), (7, 7))]
    steps = RefLM(rcfg).steps
    want = np.concatenate([np.asarray(rserve.greedy_generate(rparams, rcfg, jnp.asarray(t[None]), m, max_len=48,
                                                             steps=steps))[0] for t, m in spec])
    for kw in ({}, dict(paged=True, page_size=16), dict(paged=True, page_size=8)):
        svc = LMService(ContinuousLMEngine(cfg, params, n_slots=4, max_len=48, max_prompt_len=24, device="cpu", **kw)).warmup()
        futs = [svc.submit(t, m) for t, m in spec]
        svc.drain()
        got = np.concatenate([f.result(timeout=30) for f in futs])
        out.append(row("serve/engine ContinuousLMEngine", f"{'paged page ' + str(kw['page_size']) if kw else 'dense'}: "
                       f"{len(got)} greedy tokens vs greedy_generate", got.astype(np.float64), want.astype(np.float64)))
    return out


def main() -> None:
    print("| port module | compared on | max abs diff | max rel diff |")
    print("|---|---|---|---|")
    for module, what, err, rel in _rows():
        print(f"| `{module}` | {what} | {err:.3g} | {rel:.3g} |")


if __name__ == "__main__":
    main()
