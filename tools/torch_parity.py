"""Parity table of the PyTorch port against the JAX reference, on the CPU.

For every ported module, runs the reference function and its port on the
same seeded numpy inputs (the reference's Pallas kernels in interpret mode,
the port's kernels through their plain PyTorch versions, gradients through
the reference's ``custom_vjp``s and the port's autograd rules) and prints
one markdown row per comparison: max absolute and max relative difference.

Run from the repo root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_parity.py

``--only dist_serve,fsdp_tp,serve2d,obs,fabric,tune,launch`` prints the rows of the named sections
alone (the section functions' names without ``_rows``; the base rows run
only without it); ``--only serve2d_recurrent,seqpar`` the cases of
``serve2d`` and ``fsdp_tp`` that place Mamba / RWKV6 state and split the
query rows over ``model``; ``--only core_oracles`` the rest of
``repro.core`` and the four-step kernels' ``choose_factors`` /
``spectrum_ref``.
"""

from __future__ import annotations

import numpy as np


def _row(module, what, got, want):
    """(module, what, max abs diff, max rel diff) of two arrays or nested
    lists of arrays (tensors taken to numpy)."""
    import torch

    def flat(x):
        if isinstance(x, (tuple, list)):
            return np.concatenate([flat(v) for v in x])
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float64).ravel()

    g, w = flat(got), flat(want)
    err = np.abs(g - w)
    rel = err / np.maximum(np.abs(w), 1e-30)
    return module, what, float(err.max()), float(rel.max())


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

    row = _row

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
    out.extend(_serving_option_rows(row))
    out.extend(_family_rows(row))
    out.extend(_arch_rows(row))
    out.extend(_lm_train_rows(row))
    out.extend(_dist_rows(row))
    out.extend(_dist_serve_rows(row))
    out.extend(_fsdp_tp_rows(row))
    out.extend(_serve2d_rows(row))
    out.extend(_obs_rows(row))
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


def _serving_option_rows(row):
    """Slice 3b on reduced gemma2-2b (the reference's weights): sampling
    draws, the chunked prefills (long-prompt and serving), the verify step,
    the warm-template gather, the radix cache, the prefix plan, the drafter,
    and the engine's tokens with each option against the reference engine's."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as ref_config
    from repro.models import attention as rattn
    from repro.models import init_params as ref_init
    from repro.models.transformer import forward as ref_forward
    from repro.models.transformer import init_caches as ref_caches
    from repro.models.transformer import init_paged_caches as ref_paged
    from repro.serve import ContinuousLMEngine as RefEngine
    from repro.serve import LMService as RefService
    from repro.serve import sampling as rsampling
    from repro.serve import spec as rspec
    from repro.serve.paging import PageAllocator as RefAllocator
    from repro.serve.paging import PagedKVManager as RefManager
    from repro.serve.paging import RadixCache as RefRadix
    from repro.train import serve as rserve
    from repro_torch.configs import get_config
    from repro_torch.models import attention as tattn
    from repro_torch.models import forward, init_caches, params_from_jax
    from repro_torch.serve import sampling, spec
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.paging import PageAllocator, PagedKVManager, RadixCache
    from repro_torch.serve.service import LMService
    from repro_torch.train import serve

    rng = np.random.default_rng(7)
    out = []
    f64 = lambda xs: np.asarray(xs, np.float64)  # noqa: E731
    logits = rng.standard_normal((200, 4096)).astype(np.float32) * 3.0
    for temperature, top_k in ((0.8, 50), (1.3, None)):
        p, rp = (m.SamplingParams(temperature=temperature, top_k=top_k, seed=3) for m in (sampling, rsampling))
        g, rg = sampling.make_rng(p, 0), rsampling.make_rng(rp, 0)
        out.append(row("serve/sampling sample_token", f"200 draws, V=4096, T={temperature} top_k={top_k}",
                       f64([sampling.sample_token(x, p, g) for x in logits]),
                       f64([rsampling.sample_token(x, rp, rg) for x in logits])))
    low = dict(attn_chunk_threshold=16, attn_chunk_size=8)
    rcfg = dataclasses.replace(ref_config("gemma2-2b").reduced(), **low)
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), **low)
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    q, k, v = (rng.standard_normal((1, 32, n, 16)).astype(np.float32) * 3.0 for n in (4, 2, 2))
    for bs, rbs in zip(cfg.pattern, rcfg.pattern):
        out.append(row("models/attention _chunked_attention", f"S=32 chunk 8 {bs.attn_type}",
                       tattn._chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)), cfg, bs, 8),
                       np.asarray(rattn._chunked_attention(*(jnp.asarray(x) for x in (q, k, v)), rcfg, rbs, 8))))
        out.append(row("models/attention _offset_prefill_attention", f"8 queries at offset 21 of 32 rows {bs.attn_type}",
                       tattn._offset_prefill_attention(torch.from_numpy(q[:, :8]), torch.from_numpy(k),
                                                       torch.from_numpy(v), 21, cfg, bs),
                       np.asarray(rattn._offset_prefill_attention(jnp.asarray(q[:, :8]), jnp.asarray(k), jnp.asarray(v),
                                                                  21, rcfg, rbs))))
    toks = rng.integers(0, cfg.vocab_size, (1, 32)).astype(np.int32)
    out.append(row("models/transformer forward", "prompt of 32 > threshold 16 (chunked prefill): logits",
                   forward(params, cfg, torch.from_numpy(toks)).logits,
                   np.asarray(ref_forward(rparams, rcfg, tokens=jnp.asarray(toks)).logits)))
    step, rstep = serve.make_chunked_prefill_step(cfg), rserve.make_chunked_prefill_step(rcfg)
    tc, rc = init_caches(cfg, 1, 48, "cpu"), ref_caches(rcfg, 1, 48)
    got, want = [], []
    for off in (0, 8, 16):
        chunk = toks[:, off:off + 8]
        g = step(params, tc, torch.from_numpy(chunk), off, 7)
        w = rstep(rparams, rc, jnp.asarray(chunk), np.int32(off), np.int32(7))
        rc = w[2]
        got += [g[0], g[1]]
        want += [np.asarray(w[0]), np.asarray(w[1])]
    out.append(row("train/serve make_chunked_prefill_step", "3 chunks of 8: logits + hidden", got, want))
    page, width = 8, 5
    vals = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), ref_paged(rcfg, 2, 13, page))
    tables = np.zeros((2 * width, 6), np.int32)
    tables[:width, :3] = [4, 9, 2]
    tables[width, :2] = [7, 5]
    lens = np.zeros((2 * width,), np.int32)
    lens[:width], lens[width] = 13 + np.arange(width), 11
    nxt = rng.integers(0, cfg.vocab_size, (2 * width, 1)).astype(np.int32)
    pools = {n: {k: torch.from_numpy(x.copy()) for k, x in leafs.items()} for n, leafs in vals.items()}
    g = serve.make_verify_step(cfg, return_hidden=True)(params, pools, torch.from_numpy(lens), torch.from_numpy(nxt),
                                                        block_tables=torch.from_numpy(tables))
    w = rserve.make_verify_step(rcfg, return_hidden=True)(rparams, jax.tree.map(jnp.asarray, vals), jnp.asarray(lens),
                                                          tokens=jnp.asarray(nxt), block_tables=jnp.asarray(tables))
    out.append(row("train/serve make_verify_step", "10 lanes, 5 on one table row: logits + hidden",
                   [g[0], g[1]], [np.asarray(w[0]), np.asarray(w[1])]))
    row_ = np.asarray([3, 7, 1, 0, 0, 0], np.int32)
    pools = {n: {k: torch.from_numpy(x.copy()) for k, x in leafs.items()} for n, leafs in vals.items()}
    g = serve.load_template_from_pages(pools, init_caches(cfg, 1, 48, "cpu"), row_)
    w = rserve.load_template_from_pages(jax.tree.map(jnp.asarray, vals), ref_caches(rcfg, 1, 48), jnp.asarray(row_))
    out.append(row("train/serve load_template_from_pages", "6-block row, sentinel tail: k/v",
                   [x for leafs in g.values() for x in leafs.values()],
                   [np.asarray(x) for leafs in w.values() for x in leafs.values()]))
    prompts = [rng.integers(0, 4, int(n)).tolist() for n in rng.integers(4, 30, 30)]
    got, want = [], []
    for cls, alloc_cls, acc in ((RadixCache, PageAllocator, got), (RefRadix, RefAllocator, want)):
        alloc = alloc_cls(200, 4, 1, 50)
        radix = cls(4, alloc)
        nxt_page = 1
        for t in prompts:
            m = radix.match(t)
            acc += list(m.pages) + [m.tokens, -1 if m.partial is None else m.partial]
            full = len(t) // 4
            pages = list(range(nxt_page, nxt_page + full))
            nxt_page += full
            for p_ in pages:
                alloc._refcount[p_] = 1
                alloc._free.remove(p_)
            acc += radix.insert(t[: full * 4], pages)
        acc += [radix.evict(5), radix.cached_pages, radix.nodes, radix.splits_total]
    out.append(row("serve/paging radix RadixCache", "30 prompts: matches, inserts, evict(5), counters",
                   f64(got), f64(want)))
    got, want = [], []
    for mgr, acc in ((PagedKVManager(cfg, 4, 48, 8, prefix_cache=True, prefix_chunk=4), got),
                     (RefManager(rcfg, 4, 48, 8, prefix_cache=True, prefix_chunk=4), want)):
        base = np.arange(24, dtype=np.int32)
        mgr.admit(0, 24, 4, plan=mgr.plan_prefix(base, 24))
        mgr.ensure_rows(0, 24)
        mgr.donate(0, base)
        mgr.release(0)
        for slot, t in enumerate([base, np.concatenate([base[:21], [99, 99, 99]]).astype(np.int32)]):
            plan = mgr.plan_prefix(t, len(t))
            acc += [plan.hit, plan.cow_src, plan.matched_tokens] + list(plan.shared)
            acc += [mgr.admit(slot, len(t), 8, plan=plan)] + list(mgr.table_row(slot)) + list(mgr.scatter_row(slot))
    out.append(row("serve/paging manager PagedKVManager", "prefix plans, bound and scatter rows", f64(got), f64(want)))
    got, want = [], []
    ctx = rng.integers(0, 4, 80).tolist()
    for mod, acc in ((spec, got), (rspec, want)):
        d = mod.SlotDraft(mod.SpecConfig(), ctx[:8])
        for i, t in enumerate(ctx[8:]):
            acc += d.propose(i % 5) + [-1, mod.draft_budget(4, 20, i % 21)]
            d.push(t)
    out.append(row("serve/spec SlotDraft", "72 pushes, propose(0..4), draft_budget", f64(got), f64(want)))
    mix = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in ((4, 12), (9, 8), (13, 8), (24, 6),
                                                                                  (1, 10), (7, 7))]
    prefix = rng.integers(0, cfg.vocab_size, 21).astype(np.int32)
    warm = [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, t).astype(np.int32)]), m)
            for t, m in ((3, 4), (2, 6), (5, 3), (4, 5))]
    sampled = lambda i: dict(temperature=0.8, top_k=8, seed=100 + i)  # noqa: E731
    options = (
        ("chunked prefill, chunk 8", dict(paged=True, page_size=8, prefill_chunk=8), mix, None, 0),
        ("sampled T=0.8 top_k=8, seeded", dict(paged=True, page_size=16, sampling=True), mix, sampled, 0),
        ("warm prefix cache, chunk 4, COW", dict(paged=True, page_size=8, prefill_chunk=4, prefix_cache=True,
                                                max_prompt_len=26), warm, None, 1),
        ("speculative, draft_k 4", dict(paged=True, page_size=8, speculative=True), mix, None, 0),
    )
    for what, kw, stream, submit, n_cold in options:
        toks = []
        for eng_cls, svc_cls, c, p, extra in ((ContinuousLMEngine, LMService, cfg, params, dict(device="cpu")),
                                              (RefEngine, RefService, rcfg, rparams, {})):
            kw2 = dict(dict(n_slots=4, max_len=48, max_prompt_len=24), **kw, **extra)
            svc = svc_cls(eng_cls(c, p, **kw2))
            svc.warmup()
            futs = []
            for i, (t, m) in enumerate(stream):
                futs.append(svc.submit(t, m, **(submit(i) if submit else {})))
                if i < n_cold:
                    svc.drain()
            svc.drain()
            toks.append(np.concatenate([f.result(timeout=60) for f in futs]))
        out.append(row("serve/engine ContinuousLMEngine", f"{what}: {len(toks[0])} tokens vs the reference engine",
                       f64(toks[0]), f64(toks[1])))
    return out


def _family_rows(row):
    """The model families of the other archs, module by module, with the
    reference's weights: M-RoPE, the MoE FFN (one group, grouped, drops),
    Mamba and RWKV6 (scan, chunked, one-step decode with carried state)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as ref_config
    from repro.models import attention as rattn
    from repro.models import moe as rmoe
    from repro.models import ssm as rssm
    from repro_torch.configs import get_config
    from repro_torch.models import attention, moe, ssm

    rng = np.random.default_rng(9)
    out = []

    def tt(tree):
        return {k: tt(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}

    x = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    pos = np.stack([np.broadcast_to(np.arange(10) // d, (2, 10)) for d in (1, 3, 5)]).astype(np.int32)
    out.append(row("models/attention apply_mrope", "(2,10,4,16), 3 streams, sections (4,2,2)",
                   attention.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (4, 2, 2)),
                   np.asarray(rattn.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 2, 2)))))
    for arch in ("arctic-480b", "llama4-scout-17b-a16e", "jamba-v0.1-52b"):
        for what, kw in (("one group", {}), ("grouped G=8", dict(moe_group_size=8)),
                         ("capacity 0.5 (drops)", dict(capacity_factor=0.5))):
            rcfg, cfg = ref_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
            rp = rmoe.moe_init(jax.random.PRNGKey(3), rcfg)
            xm = rng.standard_normal((2, 16, 64)).astype(np.float32)
            w, wa = rmoe.moe_apply(rp, jnp.asarray(xm), rcfg)
            g, ga = moe.moe_apply(tt(rp), torch.from_numpy(xm), cfg)
            out.append(row("models/moe moe_apply", f"{arch} (2,16,64) {what}: out + aux",
                           [g, ga[None]], [np.asarray(w), np.asarray(wa)[None]]))
    rcfg, cfg = ref_config("jamba-v0.1-52b").reduced(), get_config("jamba-v0.1-52b").reduced()
    rp = rssm.mamba_init(jax.random.PRNGKey(1), rcfg)
    for what, s, state in (("full scan", 12, False), ("prefill from a state", 12, True), ("decode step", 1, True)):
        xm = rng.standard_normal((2, s, 64)).astype(np.float32)
        st = {k: rng.standard_normal((2,) + v.shape[1:]).astype(np.float32) * 0.5
              for k, v in rssm.mamba_init_state(rcfg, 1).items()} if state else None
        w, ws = rssm.mamba_apply(rp, jnp.asarray(xm), rcfg, None if st is None else jax.tree.map(jnp.asarray, st))
        g, gs = ssm.mamba_apply(tt(rp), torch.from_numpy(xm), cfg, None if st is None else tt(st))
        got, want = [g], [np.asarray(w)]
        if state:
            got += [gs[k] for k in sorted(gs)]
            want += [np.asarray(ws[k]) for k in sorted(ws)]
        out.append(row("models/ssm mamba_apply", f"jamba (2,{s},64) {what}: out" + (" + state" if state else ""),
                       got, want))
    rcfg, cfg = ref_config("rwkv6-3b").reduced(rwkv_chunk=8), get_config("rwkv6-3b").reduced(rwkv_chunk=8)
    rp = rssm.rwkv_init(jax.random.PRNGKey(2), rcfg)
    for what, s in (("scan", 20), ("chunked (chunk 8)", 24), ("decode step", 1)):
        xm = rng.standard_normal((2, s, 64)).astype(np.float32)
        st = {k: rng.standard_normal((2,) + v.shape[1:]).astype(np.float32) * 0.5
              for k, v in rssm.rwkv_init_state(rcfg, 1).items()}
        w, ws = rssm.rwkv_time_mix(rp, jnp.asarray(xm), rcfg, jax.tree.map(jnp.asarray, st))
        wc, ws = rssm.rwkv_channel_mix(rp, jnp.asarray(xm), rcfg, ws)
        g, gs = ssm.rwkv_time_mix(tt(rp), torch.from_numpy(xm), cfg, tt(st))
        gc, gs = ssm.rwkv_channel_mix(tt(rp), torch.from_numpy(xm), cfg, gs)
        out.append(row("models/ssm rwkv_time_mix + rwkv_channel_mix", f"rwkv6 (2,{s},64) {what}: outs + state",
                       [g, gc] + [gs[k] for k in sorted(gs)],
                       [np.asarray(w), np.asarray(wc)] + [np.asarray(ws[k]) for k in sorted(ws)]))
    return out


def _arch_rows(row):
    """The nine other archs at ``reduced()`` widths with the reference's
    weights: the score forward's logits, prefill + one decode step (logits,
    caches and state), and the continuous engine's tokens on the ``SPEC``
    mix against the reference engine's, dense and (where the reference
    pages) paged; musicgen's ``generate`` codes against the reference's."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as ref_config
    from repro.models import init_params as ref_init
    from repro.models.transformer import forward as ref_forward
    from repro.models.transformer import init_caches as ref_caches
    from repro.serve.engine import ContinuousLMEngine as RefEngine
    from repro.serve.engine import LMServeEngine as RefLM
    from repro.serve.service import LMService as RefService
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import forward, init_caches, params_from_jax
    from repro_torch.serve.engine import ContinuousLMEngine, LMServeEngine
    from repro_torch.serve.service import LMService

    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    out = []
    for arch in list_archs():
        if arch == "gemma2-2b":
            continue
        rng = np.random.default_rng(11)
        rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
        rparams = ref_init(jax.random.PRNGKey(0), rcfg)
        params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
        shape = (2, 12, cfg.n_codebooks) if cfg.frontend == "audio_codes" else (2, 12)
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        want, got = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks)), forward(params, cfg, torch.from_numpy(toks))
        out.append(row("models/transformer forward", f"{arch} score (2,12): logits", got.logits, np.asarray(want.logits)))
        rc, gc = ref_caches(rcfg, 2, 16), init_caches(cfg, 2, 16, "cpu")
        w = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks[:, :11]), caches=rc, cache_len=jnp.asarray(0, jnp.int32))
        forward(params, cfg, torch.from_numpy(toks[:, :11]), caches=gc, cache_len=0)
        w = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks[:, 11:]), caches=w.caches,
                        cache_len=jnp.asarray(11, jnp.int32))
        g = forward(params, cfg, torch.from_numpy(toks[:, 11:]), caches=gc, cache_len=11)
        names = [(n, k) for n in sorted(g.caches) for k in sorted(g.caches[n])]
        out.append(row("models/transformer forward", f"{arch} prefill 11 + decode 1: logits + caches / state",
                       [g.logits] + [g.caches[n][k] for n, k in names],
                       [np.asarray(w.logits)] + [np.asarray(w.caches[n][k]) for n, k in names]))
        spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m)
                for s, m in ((4, 5), (9, 3), (13, 8), (24, 2), (1, 4), (7, 7))]
        if cfg.frontend == "audio_codes":
            prompt = rng.integers(0, cfg.vocab_size, (2, 9, cfg.n_codebooks)).astype(np.int32)
            want = RefLM(rcfg).generate(rparams, jnp.asarray(prompt), 6)
            got = LMServeEngine(cfg, "cpu").generate(params, torch.from_numpy(prompt), 6)
            out.append(row("serve/engine LMServeEngine", f"{arch} generate (2,9,4) -> 6: codes vs the reference's",
                           f64(got), f64(want)))
            continue
        lens = [len(t) for t, _ in spec]
        svc = RefService(RefEngine(rcfg, rparams, n_slots=4, max_len=48, max_prompt_len=24))
        svc.warmup(prompt_lens=lens)
        futs = [svc.submit(t, m) for t, m in spec]
        svc.drain()
        want = np.concatenate([f.result(timeout=60) for f in futs])
        for kw in ({},) if cfg.is_attention_free else ({}, dict(paged=True, page_size=8)):
            svc = LMService(ContinuousLMEngine(cfg, params, n_slots=4, max_len=48, max_prompt_len=24, device="cpu",
                                               **kw)).warmup(prompt_lens=lens)
            futs = [svc.submit(t, m) for t, m in spec]
            svc.drain()
            got = np.concatenate([f.result(timeout=60) for f in futs])
            out.append(row("serve/engine ContinuousLMEngine", f"{arch} {'paged page 8' if kw else 'dense'}: "
                           f"{len(got)} tokens vs the reference engine", f64(got), f64(want)))
    return out


def _lm_train_rows(row):
    """The LM training slice: ``lm_batch``, the aux loss (terms and its
    gradient wrt the hidden states) for each aux arm, step 0's loss terms
    and every parameter gradient of the ten archs (reduced), two
    ``make_train_step`` steps (1 and 2 microbatches), the whitening
    baseline and ``ServeEngine.from_checkpoint``."""
    import dataclasses
    import functools
    import tempfile

    import jax
    import jax.numpy as jnp
    import torch

    from repro.checkpoint import save_checkpoint as ref_save
    from repro.configs import get_config as ref_config
    from repro.core import whitening as rw
    from repro.core.decorrelation import LMDecorrConfig as RefLM
    from repro.core.decorrelation import lm_decorrelation_loss as ref_aux
    from repro.data import LMDataConfig as RefData
    from repro.data import lm_batch as ref_lm_batch
    from repro.decorr import DecorrConfig as RefConfig
    from repro.models import init_params as ref_init
    from repro.optim import adamw as ref_adamw
    from repro.optim import warmup_cosine as ref_wc
    from repro.serve.engine import ServeEngine as RefEngine
    from repro.train import create_train_state as ref_state
    from repro.train import make_train_step as ref_step
    from repro.train.ssl import SSLModelConfig as RefModelConfig
    from repro.train.ssl import init_ssl_params
    from repro.train.step import _lm_loss_fn as ref_loss_fn
    from repro.train.train_state import TrainState as RefTrainState
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config, list_archs
    from repro_torch.core import LMDecorrConfig, lm_decorrelation_loss, whitening
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.decorr import DecorrConfig
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models import ParamTree, params_from_jax
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import create_train_state, make_train_step
    from repro_torch.train.ssl import SSLModelConfig
    from repro_torch.train.ssl import params_from_jax as ssl_params_from_jax
    from repro_torch.train.step import _lm_loss_fn

    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    out = []
    for kw in (dict(vocab_size=256000, batch=8, seq_len=128), dict(vocab_size=2048, batch=2, seq_len=7,
                                                                     n_codebooks=4)):
        got, want = lm_batch(LMDataConfig(**kw), 3), ref_lm_batch(RefData(**kw), 3)
        out.append(row("data/synthetic lm_batch", f"{kw['batch']}x{kw['seq_len']} V={kw['vocab_size']}"
                       + (" 4 codebooks" if "n_codebooks" in kw else ""),
                       [f64(got[k]) for k in sorted(got)], [f64(want[k]) for k in sorted(want)]))
    arms = {"sum": dict(style="vic", reg="sum", q=2), "sum b=128": dict(style="vic", reg="sum", q=2, block_size=128),
            "off fused": dict(style="vic", reg="off", use_kernel=True)}
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 16, 256)).astype(np.float32)
    h[..., :128] += 0.7 * h[..., 128:]
    key = jax.random.PRNGKey(7)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 256)))
    for name, kw in arms.items():
        for permute in (True, False):
            rcfg = RefLM(enabled=True, decorr=RefConfig(**kw, permute=permute), nu=0.5)
            (_, wm), wg = jax.value_and_grad(lambda x: ref_aux(x, rcfg, perm_key=key), has_aux=True)(jnp.asarray(h))
            cfg = LMDecorrConfig(enabled=True, decorr=DecorrConfig(**kw, permute=permute), nu=0.5)
            for impl in (None, "kernel"):
                x = torch.from_numpy(h).requires_grad_()
                aux, gm = lm_decorrelation_loss(x, cfg, perm, impl=impl)
                (g,) = torch.autograd.grad(aux, x)
                keys = sorted(wm)
                out.append(row("core/decorrelation lm_decorrelation_loss",
                               f"(2,16,256) {name} permute={permute} {impl or 'plain'} route: aux, var, reg + grad",
                               [float(gm[k].detach()) for k in keys] + [g], [float(wm[k]) for k in keys] + [wg]))
    for arch in list_archs():
        aux = dict(style="vic", reg="sum", q=2)
        rcfg = dataclasses.replace(ref_config(arch).reduced(), decorr=RefLM(enabled=True, decorr=RefConfig(**aux),
                                                                            nu=0.5, tokens_per_seq=4))
        cfg = dataclasses.replace(get_config(arch).reduced(), decorr=LMDecorrConfig(
            enabled=True, decorr=DecorrConfig(**aux), nu=0.5, tokens_per_seq=4))
        data = LMDataConfig(cfg.vocab_size, 2, 8, seed=1, n_codebooks=cfg.n_codebooks if cfg.frontend == "audio_codes"
                            else 0)
        batch = lm_batch_fn(cfg, data, "cpu")(0)
        rparams = ref_init(jax.random.PRNGKey(0), rcfg)
        grad_fn = jax.jit(jax.value_and_grad(functools.partial(ref_loss_fn, cfg=rcfg), has_aux=True))
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        (_, wm), wg = grad_fn(rparams, jbatch, rng=jax.random.PRNGKey(3))
        want = {".".join(str(k.key) for k in p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(wg)[0]}
        model = ParamTree(params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu"))
        perm = torch.from_numpy(np.array(jax.random.permutation(jax.random.PRNGKey(3), cfg.d_model)))
        loss, gm = _lm_loss_fn(model.tree(), batch, cfg, perm)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        terms = ("loss", "ce", "moe_aux", "decorr_aux")
        out.append(row("train/step _lm_loss_fn", f"{arch} reduced (2,8): loss terms",
                       [float(gm[k].detach()) for k in terms], [float(wm[k]) for k in terms]))
        out.append(row("train/step _lm_loss_fn", f"{arch} reduced: {len(names)} parameter gradients",
                       list(grads), [want[n] for n in names]))
    for arch in ("gemma2-2b", "llama4-scout-17b-a16e"):
        for micro in (1, 2):
            aux = dict(style="vic", reg="sum", q=2)
            rcfg = dataclasses.replace(ref_config(arch).reduced(), decorr=RefLM(
                enabled=True, decorr=RefConfig(**aux), nu=0.5, tokens_per_seq=4))
            cfg = dataclasses.replace(get_config(arch).reduced(), decorr=LMDecorrConfig(
                enabled=True, decorr=DecorrConfig(**aux), nu=0.5, tokens_per_seq=4))
            rs = ref_state(ref_init(jax.random.PRNGKey(0), rcfg), ref_adamw())
            state = create_train_state(ParamTree(params_from_jax(cfg, jax.tree.map(np.asarray, rs.params),
                                                                 device="cpu")), adamw())
            rstep = jax.jit(ref_step(rcfg, ref_adamw(), ref_wc(3e-3, 0, 10), num_microbatches=micro))
            step = make_train_step(cfg, adamw(), warmup_cosine(3e-3, 0, 10), num_microbatches=micro,
                                   perm_fn=lambda s: torch.from_numpy(np.array(jax.random.permutation(
                                       jax.random.fold_in(jax.random.PRNGKey(0), s), cfg.d_model))))
            for s in range(2):
                b = lm_batch(LMDataConfig(cfg.vocab_size, 4, 8), s)
                rs, _ = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
                state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            want = {".".join(str(k.key) for k in p): np.asarray(v)
                    for p, v in jax.tree_util.tree_flatten_with_path(rs.params)[0]}
            got = dict(state.model.named_parameters())
            out.append(row("train/step make_train_step", f"{arch} reduced, 2 AdamW steps, {micro} microbatch(es): "
                           "parameters", [got[n].detach() for n in sorted(got)], [want[n] for n in sorted(got)]))
    z1 = rng.standard_normal((64, 24)).astype(np.float32)
    z2 = (z1 + 0.3 * rng.standard_normal(z1.shape)).astype(np.float32)
    cov = (z1.T @ z1 / 63).astype(np.float32)
    out.append(row("core/whitening newton_schulz_inv_sqrt", "(24,24), 7 iterations",
                   whitening.newton_schulz_inv_sqrt(torch.from_numpy(cov)),
                   rw.newton_schulz_inv_sqrt(jnp.asarray(cov))))
    out.append(row("core/whitening zca_whiten", "(64,24)", whitening.zca_whiten(torch.from_numpy(z1)),
                   rw.zca_whiten(jnp.asarray(z1))))
    out.append(row("core/whitening wmse_loss", "(64,24) x 2", float(whitening.wmse_loss(
        torch.from_numpy(z1), torch.from_numpy(z2))[0]), float(rw.wmse_loss(jnp.asarray(z1), jnp.asarray(z2))[0])))
    widths = dict(input_dim=32, backbone_widths=(48,), projector_widths=(64, 64))
    rp = init_ssl_params(jax.random.PRNGKey(4), RefModelConfig(**widths))
    x = rng.standard_normal((7, 32)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ref_save(f"{tmp}/ref", 3, RefTrainState(jnp.asarray(3), rp, None, jax.random.PRNGKey(0)))
        model = ssl_params_from_jax(jax.tree.map(np.asarray, rp), SSLModelConfig(**widths))
        save_checkpoint(f"{tmp}/port", 3, create_train_state(model, adamw()).state_dict())
        want = RefEngine.from_checkpoint(f"{tmp}/ref", RefModelConfig(**widths)).encode(x)
        got = ServeEngine.from_checkpoint(f"{tmp}/port", SSLModelConfig(**widths), device="cpu").encode(x)
    out.append(row("serve/engine ServeEngine.from_checkpoint", "TrainState checkpoint, n=7: embeddings", got,
                   np.asarray(want)))
    return out


def _dist_rows(row):
    """The distributed slice: the jobs of ``tests/test_torch_distributed.py``
    (the port on 4 gloo ranks, a (4, 1) and a (2, 2) mesh; the reference on
    4 fake XLA devices and on one device) — ``decorr/modes`` and the
    engine's ``global`` / ``tp`` against the reference's sharded forward,
    input gradients and the sharded SSL step against the single-device
    oracle, the compressed all-reduces and the compressed DP step."""
    import os
    import sys
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_distributed as td

    with tempfile.TemporaryDirectory() as tmp:
        runs = td.run_jobs(tmp)
    ref, port = runs["ref"], lambda key: td._port(runs, key)  # noqa: E731
    out = []
    where = {"global": "4 data ranks", "tp": "(2, 2) mesh"}
    for mode in ("global", "tp"):
        keys = [f"apply/{mode}/{s}/q{q}/b{b}" for s, q, b in td.CASES["apply"]]
        out.append(row("decorr/engine apply", f"{mode}, {where[mode]}, bt / vic x q 1, 2 x b None, 8 (n 32, d 32): "
                       "loss vs the reference's sharded forward", [port(k) for k in keys], [ref[k] for k in keys]))
        out.append(row("decorr/engine apply", f"{mode}, the same 8 cases: dL/dz1, dL/dz2 gathered vs jax.grad on one device",
                       [port(f"{k}/dz{i}") for k in keys for i in (1, 2)],
                       [ref[f"oracle/{k.replace(f'/{mode}/', '/')}/dz{i}"] for k in keys for i in (1, 2)]))
    keys = [f"rsum/q{q}/b{b}" for q, b in td.CASES["rsum"]]
    out.append(row("decorr/modes r_sum_global", "4 data ranks, q 1, 2 x b None, 8: value vs sharded forward",
                   [port(k) for k in keys], [ref[k] for k in keys]))
    out.append(row("decorr/modes r_sum_global", "the same: input gradients vs one device",
                   [port(f"{k}/dz{i}") for k in keys for i in (1, 2)], [ref[f"oracle/{k}/dz{i}"] for k in keys for i in (1, 2)]))
    keys = [f"rsum_tp/q{q}/b{b}" for q, b in td.CASES["rsum_tp"]]
    out.append(row("decorr/modes r_sum_tp", "(2, 2) mesh, q 2 ungrouped and q 1 b 8: value vs sharded forward",
                   [port(k) for k in keys], [ref[k] for k in keys]))
    out.append(row("decorr/modes r_sum_tp", "the same: input gradients vs one device",
                   [port(f"{k}/dz{i}") for k in keys for i in (1, 2)],
                   [ref[f"oracle/{k.replace('rsum_tp', 'rsum')}/dz{i}"] for k in keys for i in (1, 2)]))
    out.append(row("decorr/modes r_off_global", "4 data ranks: value, then input gradients vs one device",
                   [port("roff"), port("roff/dz1"), port("roff/dz2")], [ref["roff"], ref["oracle/roff/dz1"], ref["oracle/roff/dz2"]]))
    keys = ["ddof0", "ddof1", "ddofNone", "vicmom"]
    out.append(row("decorr/engine regularizer, vicreg", "global, 4 ranks: ddof 0 / 1 / None scales (n 64, d 16), "
                   "VICReg on global moments (shifted shards)", [port(k) for k in keys], [ref[k] for k in keys]))
    for name in td.CASES["steps"]:
        for mode, job in (("global", "a"), ("local", "a"), ("global", "b"), ("tp", "b")):
            oracle = f"oracle/local/{name}" if mode == "local" else f"oracle/step/{name}"
            key = f"step/{mode}/{name}"
            names = [k.split("/")[-1] for k in ref if k.startswith(f"{oracle}/param/")]
            tag = f"{mode}, {'4 data ranks' if job == 'a' else '(2, 2) mesh'}, {name}"
            out.append(row("train/ssl make_sharded_ssl_train_step", f"{tag}: step-0 gradients, 2 AdamW losses vs "
                           f"{'the mean-gradient step' if mode == 'local' else 'make_ssl_train_step on the whole batch'}",
                           [runs[job][f"{key}/grad0/{n}"] for n in names] + [runs[job][f"{key}/losses"]],
                           [ref[f"{oracle}/grad0/{n}"] for n in names] + [ref[f"{oracle}/losses"]]))
            noise = 1e-6 * max(float(np.abs(ref[f"{oracle}/grad0/{n}"]).max()) for n in names)
            real = [np.abs(ref[f"{oracle}/grad0/{n}"]) > noise for n in names]
            out.append(row("train/ssl make_sharded_ssl_train_step", f"{tag}: parameters after 2 steps "
                           "(entries whose gradient is not a rounding residual)",
                           [runs[job][f"{key}/param/{n}"][m] for n, m in zip(names, real)],
                           [ref[f"{oracle}/param/{n}"][m] for n, m in zip(names, real)]))
    out.append(row("optim/compression int8_psum_ef", "4 ranks, (64,16): int8 sum; carried residuals",
                   [port("int8"), port("int8_err")], [ref["int8"], ref["int8_err"]]))
    out.append(row("optim/compression bf16_psum", "4 ranks, (64,16): the bf16 sum", port("bf16"), ref["bf16"]))
    names = [k.split("/")[-1] for k in ref if k.startswith("oracle/dp/param/")]
    out.append(row("train/step make_compressed_dp_step", "none, 4 ranks, SGD, 2 steps: parameters vs the mean-gradient step",
                   [port(f"dp/none/param/{n}") for n in names], [ref[f"oracle/dp/param/{n}"] for n in names]))
    return out


def _dist_serve_rows(row):
    """Slice 4b: the jobs of ``tests/test_torch_distributed_serve.py`` (the
    port on 4 gloo ranks, (4, 1) and (2, 2) meshes; the reference on 4 fake
    XLA devices and on one device) — the meshed ``ServeEngine``,
    ``probe_metrics`` in ``global`` / ``tp`` against the reference's
    ``shard_map``, the data-parallel LM step against the one-device step on
    the whole batch — and ``tests/test_torch_pipeline_elastic.py``'s
    four-rank prefetch and re-mesh."""
    import os
    import sys
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_distributed_serve as tds
    import test_torch_pipeline_elastic as tpe

    from repro.data import LMDataConfig, lm_batch

    with tempfile.TemporaryDirectory() as tmp:
        runs = tds.run_jobs(tmp)
        four = tpe.run_job(tmp)
    ref, out = runs["ref"], []
    out.append(row("serve/engine ServeEngine(mesh=)", "dp (4, 1), 24 rows of d 64 on every rank vs the reference's "
                   "meshed engine", runs["a"]["serve"], ref["serve/dp"]))
    out.append(row("serve/engine ServeEngine(mesh=, model_axis=)", "tp (2, 2), the same rows vs the reference's",
                   runs["b"]["serve"], ref["serve/tp"]))
    for job, mode, cases in (("a", "global", tds.CASES["probe_global"]), ("b", "tp", tds.CASES["probe_tp"])):
        keys = [k for style, b, v in cases for k in ref if k.startswith(f"probe/{mode}/{style}/b{b}/v{v}/")]
        out.append(row("decorr/probe probe_metrics", f"{mode}, {len(cases)} cases (bt / vic, b, 1 / 2 views; n 32, d 32): "
                       "every output vs the reference under shard_map", [runs[job][k] for k in keys], [ref[k] for k in keys]))
    for arch, cap, arms in tds.CASES["steps"]:
        key = f"step/{arch}@{cap}"
        for arm in arms:
            names = [k.split("/")[-1] for k in runs["a"] if k.startswith(f"{key}/{arm}/param/")]
            got_m = __import__("json").loads(str(runs["a"][f"{key}/{arm}/metrics"]))
            want_m = __import__("json").loads(str(ref[f"{key}/metrics"]))
            mk = ("loss", "ce", "moe_aux", "decorr_aux", "decorr_reg", "grad_norm")
            tag = f"{arch} reduced{'' if cap is None else f' capacity {cap}'}, 4 ranks, 2 microbatches, " + \
                  ("grad_shardings" if arm else "all-reduce")
            out.append(row("train/step make_train_step(mesh=)", f"{tag}: 2 AdamW steps' loss terms vs one device",
                           [m[k] for m in got_m for k in mk], [m[k] for m in want_m for k in mk]))
            out.append(row("train/step make_train_step(mesh=)", f"{tag}: parameters after 2 steps",
                           [runs["a"][f"{key}/{arm}/param/{n}"] for n in names], [ref[f"{key}/param/{n}"] for n in names]))
    cfg = LMDataConfig(vocab_size=101, batch=8, seq_len=6)
    out.append(row("data/pipeline ShardedPrefetcher", "4 ranks, (4, 1): each rank's block of 3 batches vs the reference's "
                   "lm_batch rows", [four[f"r{r}/pf/{s}"] for r in range(4) for s in range(3)],
                   [lm_batch(cfg, s)["tokens"][2 * r:2 * r + 2] for r in range(4) for s in range(3)]))
    full = tpe._state()
    blocks, want = [], []
    for r in range(4):
        di, mi = four[f"r{r}/coords"]
        blocks += [four[f"r{r}/restored/w"], four[f"r{r}/restored/odd"], four[f"r{r}/restored/cols"]]
        want += [full["w"][4 * di:4 * di + 4], full["odd"], full["cols"][:, 4 * mi:4 * mi + 4]]
    out.append(row("ft/elastic elastic_restore", "saved under (4, 1), restored under (2, 2): every rank's blocks "
                   "(an indivisible leaf replicated)", blocks, want))
    return out


def _fsdp_tp_rows(row, case_sets=None):
    """The 2-D (FSDP x TP) LM step: the jobs of ``tests/test_torch_fsdp_tp.py``
    and ``tests/test_torch_fsdp_tp_moe.py`` (the port on 4 gloo ranks a mesh;
    the reference on one device and, one mesh an arch, its GSPMD step on 4
    fake XLA devices) — one row a case and mesh (loss terms and gathered
    parameters after 2 AdamW steps against the one-device step on the whole
    batch), one a case against GSPMD, and the unplaced data-parallel step
    over ("pod", "data")."""
    import json
    import os
    import sys
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_fsdp_tp as tft
    import test_torch_fsdp_tp_moe as tfm

    out = []

    def compare(port, ref, what, module="train/step make_train_step (placed state)"):
        got_m, want_m = json.loads(str(port[0])), json.loads(str(ref[0]))
        names = sorted(port[1])
        out.append(row(module, what, [m[k] for m in got_m for k in tft.METRICS] + [port[1][n] for n in names],
                       [m[k] for m in want_m for k in tft.METRICS] + [ref[1][n] for n in names]))

    def leaves(res, prefix):
        return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}

    def eps(cases, name):
        return cases["eps"].get(name, cases["eps"]["*"])

    for cases in case_sets or (tft.CASES, tfm.CASES):
        with tempfile.TemporaryDirectory() as tmp:
            runs = tft.run_jobs(tmp, cases)
        for mesh, names in cases["runs"].items():
            oracle = f"oracle{tft._batch_ranks(cases, mesh)}"
            for name in names:
                arch, over = cases["variants"][name]
                compare((runs[mesh][f"{name}/metrics"], leaves(runs[mesh], f"{name}/param/")),
                        (runs[name][f"{oracle}/metrics"], leaves(runs[name], f"{oracle}/param/")),
                        f"{arch} reduced{over or ''}, mesh {tuple(cases['meshes'][mesh])}, 2 microbatches, 2 AdamW "
                        f"steps (eps {eps(cases, name)}): loss terms and parameters vs one device")
        for name, mesh in cases["gspmd"].items():
            compare((runs[mesh][f"{name}/metrics"], leaves(runs[mesh], f"{name}/param/")),
                    (runs[name][f"gspmd/{mesh}/metrics"], leaves(runs[name], f"gspmd/{mesh}/param/")),
                    f"{name} reduced, mesh {tuple(cases['meshes'][mesh])}: the same vs the reference's GSPMD step")
        dp = cases["dp"]
        if not dp:
            continue
        oracle = f"oracle{tft._batch_ranks(cases, dp['mesh'])}"
        compare((runs[dp["mesh"]]["dp/metrics"], leaves(runs[dp["mesh"]], "dp/param/")),
                (runs[dp["case"]][f"{oracle}/metrics"], leaves(runs[dp["case"]], f"{oracle}/param/")),
                f"{dp['case']} reduced, unplaced, the batch over {tuple(cases['meshes'][dp['mesh']])} of "
                f"{tft._axes(cases, dp['mesh'])}: the same vs one device",
                module="train/step make_train_step(mesh=, data_axis=(\"pod\", \"data\"))")
    return out


def _seqpar_rows(row):
    """The sequence-split attention: ``tests/test_torch_fsdp_tp.py``'s
    gemma2-2b case with 2 heads and ``seq_shard_attention`` on (data 1,
    model 4), against the one-device and the GSPMD step."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_fsdp_tp as tft

    name = tft.SEQ_SPLIT
    cases = dict(tft.CASES, runs={"b": [name]}, gspmd={name: "b"}, dp=None, ce_cross=None)
    return _fsdp_tp_rows(row, [cases])


def _serve2d_rows(row, archs=None):
    """The 2-D serving steps: the jobs of ``tests/test_torch_serve2d.py``
    (the port's placed prefill and 12 decode steps on 4 gloo ranks a mesh;
    the reference's one-device and GSPMD steps on 4 fake XLA devices) — a
    row a case and mesh against each (the logits of every step), and one
    for the gathered caches and state against the one-device steps'
    (``archs``: those cases alone)."""
    import os
    import sys
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_serve2d as ts

    cases = ts.CASES
    if archs:
        cases = dict(cases, runs={m: [a for a in names if a in archs] for m, names in cases["runs"].items()})
    with tempfile.TemporaryDirectory() as tmp:
        runs = ts.run_jobs(tmp, cases)
    out = []
    module = "train/serve make_prefill_step / make_decode_step (placed params and caches)"
    for key, arch, mesh in ts.cells(cases):
        port, ref = runs[mesh], runs[arch]
        shape = tuple(cases["meshes"][mesh])
        steps = ts._steps(key, cases)
        prompt = cases["short_prompt"] if key.endswith(":short") else cases["prompt"]
        what = f"{key} reduced, mesh {shape}, prefill {prompt} + {len(steps) - 1} decode steps"
        for oracle, name in (("one", "one device"), ("gspmd", "GSPMD")):
            want = ts._reference_key(key, oracle, mesh)
            out.append(row(module, f"{what}: logits vs {name}",
                           [port[f"{key}/logits/{s}"] for s in steps], [ref[f"{want}/logits/{s}"] for s in steps]))
        names = sorted(k.split("/cache/")[1] for k in port if k.startswith(f"{key}/cache/"))
        want = ts._reference_key(key, "one", mesh)
        out.append(row("models/attention _write_prefill / _placed_decode, models/ssm state",
                       f"{what}: gathered caches and state vs one device",
                       [port[f"{key}/cache/{n}"] for n in names], [ref[f"{want}/cache/{n}"] for n in names]))
    return out


def _obs_rows(row):
    """Slice 6a: the same operations on ``repro.obs`` and
    ``repro_torch.obs`` (``tests/test_torch_obs.py``): the exposition, the
    Chrome trace on a stepped clock, the alert events and the flight dump
    compared as strings (1 where they differ), and the health monitor's
    gauges on one batch."""
    import itertools
    import os
    import sys
    import time

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_obs as tob

    import repro.obs as ref_obs
    import repro_torch.obs as port_obs

    real = time.perf_counter
    out = []
    try:
        def clock():
            ticks = itertools.count()
            time.perf_counter = lambda: 1000.0 + 1.5e-3 * next(ticks)

        clock()
        port_trace = tob._trace_ops(port_obs)
        clock()
        ref_trace = tob._trace_ops(ref_obs)
    finally:
        time.perf_counter = real
    for what, got, want in (("registry exposition + as_dict text", tob._registry_ops(port_obs), tob._registry_ops(ref_obs)),
                            ("tracing Chrome trace JSON + metrics", port_trace, ref_trace),
                            ("alerts events, published exposition, active set", tob._alert_ops(port_obs),
                             tob._alert_ops(ref_obs)),
                            ("recorder dump, counts, metrics", tob._flight_ops(port_obs), tob._flight_ops(ref_obs))):
        out.append(row("obs", f"{what}: string mismatches", [float(got != want)], [0.0]))
    rng = np.random.default_rng(4)
    z = (rng.standard_normal((48, 16)) + 0.4 * rng.standard_normal((48, 1))).astype(np.float32)
    got = port_obs.DecorrHealthMonitor(ema=0.0, device="cpu").observe(z)
    want = ref_obs.DecorrHealthMonitor(ema=0.0).observe(z)
    # R_sum and the gap depend on the permutation (JAX's threefry stream, not reproducible in torch)
    keys = sorted(k for k in want if "r_sum" not in k and "relaxation_gap" not in k)
    out.append(row("obs/health DecorrHealthMonitor", f"(48, 16), ema 0: {len(keys)} gauges (R_off, moments, collapse)",
                   [got[k] for k in keys], [want[k] for k in keys]))
    return out


def _fabric_rows(row):
    """Slice 5b: the serving fabric on reduced gemma2-2b (the reference's
    weights, ``tests/test_torch_fabric.py``'s runs): affinity keys and
    router scores on seeded inputs, the failover run's tokens and flight
    counts and the mixed run's embeddings and tokens, port vs reference."""
    import os
    import sys

    import jax
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_fabric as tf

    from repro.configs import get_config as ref_config
    from repro.models import init_params as ref_init
    from repro.obs import Obs as RefObs
    from repro.serve import EmbeddingService as RefEmbeddingService
    from repro.serve import ServeEngine as RefServeEngine
    from repro.serve.fabric import FabricConfig as RefFabricConfig
    from repro.serve.fabric import Router as RefRouter
    from repro.serve.fabric import ServeFabric as RefServeFabric
    from repro.serve.fabric import prefix_key as ref_prefix_key
    from repro.train.ssl import init_ssl_params
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_jax
    from repro_torch.obs import Obs
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.fabric import FabricConfig, Router, ServeFabric, prefix_key
    from repro_torch.serve.service import EmbeddingService
    from repro_torch.train.ssl import params_from_jax as ssl_params_from_jax

    torch.set_num_threads(1)
    out = []
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256000, int(rng.integers(1, 40))).astype(np.int32) for _ in range(100)]
    out.append(row("serve/fabric/router", "prefix_key, 100 seeded prompts x k in (1, 4, 16)",
                   [float(prefix_key(t, k)) for t in prompts for k in (1, 4, 16)],
                   [float(ref_prefix_key(t, k)) for t in prompts for k in (1, 4, 16)]))
    snaps = [{"slots_total": float(rng.integers(0, 16)), "slots_occupancy": float(rng.random()),
              "queue_depth": float(rng.integers(0, 64)), "serve_ttft_seconds_p99": float(rng.random() * 0.2)}
             for _ in range(100)]
    for policy in ("least_occupancy", "weighted_ttft"):
        out.append(row("serve/fabric/router", f"Router.score, {policy}, 100 seeded snapshots",
                       [Router(policy).score(s) for s in snaps], [RefRouter(policy).score(s) for s in snaps]))

    rcfg = ref_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    cfg = get_config("gemma2-2b").reduced()
    gemma = (cfg, params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu"), rcfg, rparams)
    prompts = tf._prompts(cfg.vocab_size)
    obs, ref_obs = Obs(), RefObs()
    mine, fab = tf._failover_run(ServeFabric, FabricConfig, tf._lm_factory(gemma), obs, prompts)
    theirs, ref_fab = tf._failover_run(RefServeFabric, RefFabricConfig, tf._ref_lm_factory(gemma), ref_obs, prompts)
    out.append(row("serve/fabric ServeFabric", f"failover: 6 requests x 6 tokens, 2 replicas, r0 killed "
                   f"({fab.requeued_total} requeued), tokens", [t.astype(np.float64) for t in mine],
                   [t.astype(np.float64) for t in theirs]))
    names = sorted(ref_obs.recorder.counts())
    out.append(row("serve/fabric ServeFabric", f"failover: flight counts {', '.join(names)}",
                   [float(obs.recorder.counts().get(n, 0)) for n in names],
                   [float(ref_obs.recorder.counts()[n]) for n in names]))

    tree = jax.tree.map(np.asarray, init_ssl_params(jax.random.PRNGKey(1), tf.REF_MODEL))
    model = ssl_params_from_jax(tree, tf.MODEL, device="cpu")
    x = np.random.default_rng(3).standard_normal((4, 24)).astype(np.float32)
    res = []
    for fab_cls, cfg_cls, lm, embed in (
        (ServeFabric, FabricConfig, tf._lm_factory(gemma),
         lambda name: EmbeddingService(ServeEngine(tf.MODEL, model, device="cpu"), obs=Obs())),
        (RefServeFabric, RefFabricConfig, tf._ref_lm_factory(gemma),
         lambda name: RefEmbeddingService(RefServeEngine(tf.REF_MODEL, jax.tree.map(jax.numpy.asarray, tree)),
                                          obs=RefObs())),
    ):
        f = fab_cls(cfg_cls(replicas=2, heartbeat_timeout_s=5.0), lm_factory=lm, embed_factory=embed)
        ef, lf = f.submit_embed(x), f.submit_lm(prompts[0], 3)
        f.drain()
        e = ef.result(timeout=60)
        res.append((np.asarray(e.numpy() if torch.is_tensor(e) else e), np.asarray(lf.result(timeout=60))))
    out.append(row("serve/fabric ServeFabric", "mixed: (4, 24) embedding request, 2 replicas", res[0][0], res[1][0]))
    out.append(row("serve/fabric ServeFabric", "mixed: the LM request's 3 tokens", res[0][1].astype(np.float64),
                   res[1][1].astype(np.float64)))
    return out


def _tune_rows(row):
    """Slice 6b: the tuner's analytic choices against ``repro.tune``'s
    (``tests/test_torch_tune.py``): the four-step plans, the pinned-b job
    lists, ``auto_page_size`` and the tp warm-up's shapes."""
    from repro import tune as ref_tune
    from repro.decorr import DecorrConfig as RefDecorrConfig
    from repro.decorr import warmup_tune_cache as ref_warmup
    from repro.kernels.paged_attention.ops import auto_page_size as ref_auto
    from repro.tune.cli import jobs_for as ref_jobs_for
    from repro_torch import tune
    from repro_torch.decorr import DecorrConfig, warmup_tune_cache
    from repro_torch.kernels.paged_attention.ops import auto_page_size
    from repro_torch.tune.cli import jobs_for

    out = []
    ds = (2048, 8192, 2039, 2304, 5120)
    pick = lambda fn, d: [float(fn("sumvec_fft_plan", (d,))[k]) for k in ("dp", "d1", "d2")]  # noqa: E731
    out.append(row("tune/dispatch best_config", "sumvec_fft_plan (dp, d1, d2) at d = 2048, 8192, 2039, 2304, 5120",
                   [pick(tune.best_config, d) for d in ds], [pick(ref_tune.best_config, d) for d in ds]))
    for n, d in ((256, 2048), (256, 8192), (64, 2304)):
        mine = jobs_for(n, d, block_size=128, mode="analytic", persist=False)[1]
        theirs = ref_jobs_for(n, d, block_size=128, mode="analytic", persist=False)[1]
        same = [k for k, _ in mine] == [k for k, _ in theirs]
        out.append(row("tune/cli jobs_for", f"({n}, {d}), b = 128: {len(theirs)} jobs' kernels and shapes",
                       [float(not same)] + [float(v) for _, s in mine for v in s],
                       [0.0] + [float(v) for _, s in theirs for v in s]))
    pools = ((8, 48, 2, 16), (8, 4352, 4, 256), (8, 2048, 8, 128), (40, 4352, 4, 256))
    out.append(row("kernels/paged_attention auto_page_size", "4 pools (slots, max_len, kv, hd)",
                   [float(auto_page_size(*p)) for p in pools], [float(ref_auto(*p)) for p in pools]))
    mine = warmup_tune_cache(256, 2048, DecorrConfig(distributed="tp", block_size=128), data_parallel=2,
                             model_parallel=2)
    theirs = ref_warmup(256, 2048, RefDecorrConfig(distributed="tp", block_size=128), data_parallel=2,
                        model_parallel=2)
    out.append(row("decorr/warmup warmup_tune_cache", "tp on a (2, 2) mesh: rows of the xcorr job, plan",
                   [float(mine[1].shape[0])] + [float(v) for v in mine[0].best.values()],
                   [float(theirs[1].shape[0])] + [float(v) for v in theirs[0].best.values()]))
    return out


def _launch_rows(row):
    """Slice 6c: the launch analysis tools (``tests/test_torch_{launch,
    hlo_cost,lm_train}.py``): the parameter specs of the ten archs at full
    width, the op-level analyzer's product FLOPs against ``analyze_hlo``'s
    dot FLOPs (prefill with the head on every row, one decode step, the
    train step with remat; the MoE archs dispatch by other means), remat's
    gradients and the bf16-moment AdamW."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as ref_config
    from repro.launch import specs as ref_specs
    from repro.launch.hlo_cost import analyze_hlo
    from repro.models import init_params as ref_init
    from repro.models.transformer import init_caches as ref_init_caches
    from repro.optim import adamw as ref_adamw
    from repro.optim import warmup_cosine as ref_warmup_cosine
    from repro.train import create_train_state as ref_create_state
    from repro.train import make_train_step as ref_make_step
    from repro.train.serve import make_decode_step as ref_decode_step
    from repro.train.serve import make_prefill_step as ref_prefill_step
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import hlo_cost, specs
    from repro_torch.models import ParamTree, forward, init_params
    from repro_torch.models.transformer import init_caches
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import create_train_state, make_train_step
    from repro_torch.train.serve import make_decode_step
    from repro_torch.train.step import _lm_loss_fn

    class FakeMesh:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    def norm(spec):
        out = [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e for e in tuple(spec)]
        while out and out[-1] is None:
            out.pop()
        return out

    out = []
    leaves, bad = 0, 0
    for arch in list_archs():
        ref = {tuple(str(k.key) for k in path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(lambda: ref_init(jax.random.PRNGKey(0), ref_config(arch))))[0]}

        def walk(t, path=()):
            for k, v in t.items():
                yield from walk(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)]

        for path, leaf in walk(specs.params_spec_tree(get_config(arch), FakeMesh())):
            r = ref.get(path)
            leaves += 1
            rpath = [jax.tree_util.DictKey(k) for k in path]
            same = (r is not None and tuple(leaf.shape) == tuple(r.shape)
                    and str(leaf.dtype).replace("torch.", "") == str(r.dtype)
                    and norm(specs.param_spec(path, leaf)) == norm(ref_specs.param_spec(rpath, r))
                    and specs._divisible(leaf.shape, specs.param_spec(path, leaf), FakeMesh())
                    == ref_specs._divisible(r.shape, ref_specs.param_spec(rpath, r), FakeMesh()))
            bad += not same
    out.append(row("launch/specs params_spec_tree", f"10 archs full width, {leaves} leaves: shape, dtype, "
                   "param_spec, _divisible on (16, 16) (mismatches)", [float(bad)], [0.0]))

    def ref_dots(fn, *args):
        return float(sum(analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).dot_flops_by_meta.values()))

    for arch in ("gemma2-2b", "codeqwen1.5-7b", "llama4-scout-17b-a16e", "arctic-480b"):
        rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
        rparams = ref_init(jax.random.PRNGKey(0), rcfg)
        rcaches = ref_init_caches(rcfg, 2, 32)
        ref_pre = ref_dots(ref_prefill_step(rcfg), rparams, rcaches, jnp.zeros((2, 16), jnp.int32))
        ref_dec = ref_dots(ref_decode_step(rcfg), rparams, rcaches, jnp.int32(16), jnp.zeros((2, 1), jnp.int32))
        rstate = ref_create_state(rparams, ref_adamw())
        rb = {"tokens": jnp.zeros((2, 32), jnp.int32), "labels": jnp.zeros((2, 32), jnp.int32)}
        ref_train = ref_dots(ref_make_step(rcfg, ref_adamw(), ref_warmup_cosine(3e-3, 0, 10)), rstate, rb)
        params, caches = init_params(cfg, device="cpu"), init_caches(cfg, 2, 32, device="cpu")
        pre = hlo_cost.analyze(torch.no_grad()(lambda p, c, t: forward(p, cfg, t, caches=c, cache_len=0)), params,
                               caches, torch.zeros((2, 16), dtype=torch.int32)).product_flops
        dec = hlo_cost.analyze(torch.no_grad()(make_decode_step(cfg)), params, caches, 16,
                               torch.zeros((2, 1), dtype=torch.int32)).product_flops
        opt = adamw()
        state = create_train_state(ParamTree(params), opt)
        b = {"tokens": torch.zeros((2, 32), dtype=torch.int32), "labels": torch.zeros((2, 32), dtype=torch.int32)}
        train = hlo_cost.analyze(make_train_step(cfg, opt, warmup_cosine(3e-3, 0, 10)), state, b).product_flops
        moe = " (MoE: other dispatch)" if cfg.n_experts else ""
        out.append(row("launch/hlo_cost analyze", f"{arch} reduced product FLOPs vs analyze_hlo dots: prefill 16, "
                       f"decode 1, train step with remat{moe}", [pre, dec, train], [ref_pre, ref_dec, ref_train]))

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), remat=False)
    tree = init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))
    grads = {}
    for name, kw in (("off", dict(remat=False)), ("nothing", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        model = ParamTree(dict(tree))
        loss = _lm_loss_fn(model.tree(), {"tokens": toks, "labels": toks}, dataclasses.replace(cfg, **kw))[0]
        grads[name] = [loss.detach().reshape(1)] + list(torch.autograd.grad(loss, list(model.parameters())))
    for name in ("nothing", "dots"):
        out.append(row("models/transformer remat", f"gemma2-2b reduced: loss and every gradient, remat {name} vs off",
                       grads[name], grads["off"]))

    rng = np.random.default_rng(11)
    init = {"w": rng.standard_normal((8, 16)).astype(np.float32), "b": rng.standard_normal(16).astype(np.float32)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1 for k, v in init.items()} for _ in range(2)]
    ropt = ref_adamw(moment_dtype=jnp.bfloat16)
    rp = {k: jnp.asarray(v) for k, v in init.items()}
    rs = ropt.init(rp)
    for g in gs:
        rp, rs = ropt.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp, 1e-2)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in init]
    opt = adamw(moment_dtype=torch.bfloat16).init(params)
    for g in gs:
        opt.step(1e-2, [torch.from_numpy(g[k]) for k in init])
    out.append(row("optim/optimizers adamw(moment_dtype=bf16)", "two steps on (8, 16) + (16,): parameters, m",
                   [p.detach() for p in params] + [opt.state[p]["m"].float() for p in params],
                   [np.asarray(rp[k]) for k in init] + [np.asarray(rs["m"][k], np.float32) for k in init]))
    return out


def _core_oracle_rows(row):
    """The last slice: the rest of ``repro.core`` (the O(d^2) identities and
    oracles, R_var, the explicit-C R_sum oracles) and the four-step kernels'
    ``choose_factors`` / ``spectrum_ref``, on the inputs of
    ``tests/test_torch_core_identities.py``."""
    import jax.numpy as jnp
    import torch

    from repro.core import regularizers as rregs
    from repro.core import sumvec as rsv
    from repro.kernels.sumvec_fft import ops as rfo
    from repro.kernels.sumvec_fft import ref as rfref
    from repro_torch.core import regularizers as regs
    from repro_torch.core import sumvec as sv
    from repro_torch.kernels.sumvec_fft import ops as tfo
    from repro_torch.kernels.sumvec_fft import ref as tfref

    rng = np.random.default_rng(0)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    T = torch.from_numpy
    out = []
    x, y = arr(12, 13), arr(12, 13)
    out.append(row("core/sumvec involution", "(12, 13)", sv.involution(T(x)), rsv.involution(jnp.asarray(x))))
    for fn in ("circular_convolve", "circular_correlate_naive"):
        out.append(row(f"core/sumvec {fn}", "(12, 13)", getattr(sv, fn)(T(x), T(y)),
                       getattr(rsv, fn)(jnp.asarray(x), jnp.asarray(y))))
    out.append(row("core/sumvec sumvec_direct", "(12, 13), scale 12", sv.sumvec_direct(T(x), T(y), scale=12.0),
                   rsv.sumvec_direct(jnp.asarray(x), jnp.asarray(y), scale=12.0)))
    out.append(row("core/sumvec grouped_sumvec_fft", "(12, 13), b 4, scale 12",
                   sv.grouped_sumvec_fft(T(x), T(y), 4, scale=12.0),
                   rsv.grouped_sumvec_fft(jnp.asarray(x), jnp.asarray(y), 4, scale=12.0)))
    c = arr(13, 13)
    out.append(row("core/sumvec grouped_sumvec_from_matrix", "(13, 13), b 4 (ragged)",
                   sv.grouped_sumvec_from_matrix(T(c), 4), rsv.grouped_sumvec_from_matrix(jnp.asarray(c), 4)))
    z = arr(12, 16) * np.linspace(0.2, 2.0, 16, dtype=np.float32)
    k = (z.T @ z / 11).astype(np.float32)
    out.append(row("core/regularizers r_var", "K (16, 16)", [regs.r_var(T(k))], [rregs.r_var(jnp.asarray(k))]))
    out.append(row("core/regularizers r_var_from_embeddings", "(12, 16)", [regs.r_var_from_embeddings(T(z))],
                   [rregs.r_var_from_embeddings(jnp.asarray(z))]))
    for q in (1, 2):
        out.append(row("core/regularizers r_sum_from_matrix", f"C (13, 13), q {q}", [regs.r_sum_from_matrix(T(c), q)],
                       [rregs.r_sum_from_matrix(jnp.asarray(c), q)]))
        out.append(row("core/regularizers r_sum_grouped_from_matrix", f"C (13, 13), b 4, q {q}",
                       [regs.r_sum_grouped_from_matrix(T(c), 4, q)],
                       [rregs.r_sum_grouped_from_matrix(jnp.asarray(c), 4, q)]))
    ds = (1, 7, 12, 2039, 2048, 6000, 8192)
    out.append(row("kernels/sumvec_fft/ops choose_factors", f"d in {ds}",
                   [np.asarray(tfo.choose_factors(d), np.float64) for d in ds],
                   [np.asarray(rfo.choose_factors(d), np.float64) for d in ds]))
    sp, want = tfref.spectrum_ref(T(x)), rfref.spectrum_ref(jnp.asarray(x))
    out.append(row("kernels/sumvec_fft/ref spectrum_ref", "(12, 13)", [sp.real, sp.imag],
                   [np.real(want), np.imag(want)]))
    return out


SECTIONS = {"dist_serve": _dist_serve_rows, "fsdp_tp": _fsdp_tp_rows, "serve2d": _serve2d_rows, "obs": _obs_rows,
            "fabric": _fabric_rows, "tune": _tune_rows, "launch": _launch_rows,
            "serve2d_recurrent": lambda row: _serve2d_rows(row, ("jamba-v0.1-52b", "rwkv6-3b", "rwkv6-3b@hd32")),
            "seqpar": _seqpar_rows, "core_oracles": _core_oracle_rows}


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma-separated sections: " + ", ".join(SECTIONS))
    args = ap.parse_args(argv)
    rows = _rows() if args.only is None else [r for name in args.only.split(",") for r in SECTIONS[name](_row)]
    print("| port module | compared on | max abs diff | max rel diff |")
    print("|---|---|---|---|")
    for module, what, err, rel in rows:
        print(f"| `{module}` | {what} | {err:.3g} | {rel:.3g} |")


if __name__ == "__main__":
    main()
