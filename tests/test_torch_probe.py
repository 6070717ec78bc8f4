"""``repro_torch.decorr.probe_metrics`` against ``repro.decorr.probe_metrics``
with the reference's own feature permutation handed in, at 5e-4 relative."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.decorr import DecorrConfig as RefConfig  # noqa: E402
from repro.decorr import probe_metrics as ref_probe_metrics  # noqa: E402
from repro_torch.decorr import DecorrConfig, probe_metrics  # noqa: E402

RTOL, ATOL = 5e-4, 1e-6
N, D = 24, 32


@pytest.mark.parametrize("style", ["bt", "vic"])
@pytest.mark.parametrize("block", [None, 8])
@pytest.mark.parametrize("views", [1, 2])
def test_probe_metrics_match_reference(style, block, views):
    rng = np.random.default_rng(hash((style, block, views)) % 2**32)
    z1 = (rng.standard_normal((N, D)) * 1.5 + 0.3).astype(np.float32)
    z2 = (z1 + 0.5 * rng.standard_normal((N, D))).astype(np.float32) if views == 2 else None
    key = jax.random.PRNGKey(3)
    kw = dict(style=style, reg="sum", q=2, block_size=block)
    want = ref_probe_metrics(jnp.asarray(z1), None if z2 is None else jnp.asarray(z2),
                             RefConfig(**kw), perm_key=key)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, D)))
    got = probe_metrics(torch.from_numpy(z1), None if z2 is None else torch.from_numpy(z2),
                        DecorrConfig(**kw), perm)
    # the reference computes mean_abs and std_err but never puts them in its
    # result (its docstring lists them); the port returns them, checked
    # here against the reference's own formulas in numpy
    assert set(got) == set(want) | {"mean_abs", "std_err"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    mean = z1.mean(axis=0)
    var = ((z1 - mean) ** 2).sum(axis=0) / (N - 1)
    np.testing.assert_allclose(float(got["mean_abs"]), np.abs(mean).mean(), rtol=1e-5)
    np.testing.assert_allclose(float(got["std_err"]), np.abs(np.sqrt(var + 1e-5) - 1.0).mean(), rtol=1e-5)


def test_config_fields_match_reference():
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(RefConfig)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(DecorrConfig)]
    assert port_fields == ref_fields


@pytest.mark.parametrize("mode", ["tp", "global"])
def test_distributed_modes_on_a_one_rank_mesh_equal_local(mode):
    """A group of one in this process: ``probe_metrics`` in ``global`` /
    ``tp`` on a 1 x 1 mesh gives ``local``'s values (``tp`` without r_off,
    which the reference leaves out of that mode).  More ranks:
    ``tests/test_torch_distributed_serve.py``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.parallel import sharding as shd

    rng = np.random.default_rng(7)
    z1 = torch.from_numpy((rng.standard_normal((N, D)) * 1.5 + 0.3).astype(np.float32))
    z2 = z1 + 0.5 * torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(D))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with shd.sharding_context(make_mesh_for_devices(1, 1)):
            for style, block in (("bt", 8), ("vic", None)):
                kw = dict(style=style, reg="sum", q=2, block_size=block)
                want = probe_metrics(z1, z2, DecorrConfig(**kw), perm)
                got = probe_metrics(z1, z2, DecorrConfig(**kw, distributed=mode, axis_name="data",
                                                         model_axis="model" if mode == "tp" else None), perm)
                keys = set(want) - ({"r_off", "r_off_norm"} if mode == "tp" else set())
                assert set(got) == keys
                for k in keys:
                    np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    finally:
        dist.destroy_process_group()
