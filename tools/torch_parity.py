"""Parity table of the PyTorch port against the JAX reference, on the CPU.

For every ported module, runs the reference function and its port on the
same seeded numpy inputs (the reference's Pallas kernels in interpret mode,
the port's kernels through their plain PyTorch versions) and prints one
markdown row per comparison: max absolute and max relative difference.

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
    return out


def main() -> None:
    print("| port module | compared on | max abs diff | max rel diff |")
    print("|---|---|---|---|")
    for module, what, err, rel in _rows():
        print(f"| `{module}` | {what} | {err:.3g} | {rel:.3g} |")


if __name__ == "__main__":
    main()
