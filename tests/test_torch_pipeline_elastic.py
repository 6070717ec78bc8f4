"""``repro_torch.data.pipeline.ShardedPrefetcher`` and
``repro_torch.ft.elastic`` on the CPU.

Twins of ``tests/test_data.py``'s prefetcher cases and of
``tests/test_elastic.py``: batches come in order and a worker's error is
raised at the next ``__next__``; a re-mesh keeps every value, re-shards the
leaves that divide the new mesh and replicates the one that does not.  The
multi-rank cases run in one gloo job of 4 ranks started by a module fixture
(``FileStore`` rendezvous under the test's tmp dir): each rank's prefetched
batch is its block of the reference's ``lm_batch``; a checkpoint saved
under a (4, 1) mesh (each rank's block gathered, one rank writing) is
restored under (2, 2), each rank's block compared with the saved array.
The one-rank cases run in this process on a group of one.
"""

import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import LMDataConfig as RefLMDataConfig  # noqa: E402
from repro.data import lm_batch as ref_lm_batch  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.data import LMDataConfig, ShardedPrefetcher, lm_batch, lm_iterator  # noqa: E402
from repro_torch.ft.elastic import _divisible, elastic_restore, reshard_to_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((8, 6)).astype(np.float32),  # divides 2 and 4
        "odd": rng.standard_normal((6, 3)).astype(np.float32),  # divides 2, not 4
        "cols": rng.standard_normal((3, 8)).astype(np.float32),
        "scalar": np.float32(7.5),
    }


# ---------------------------------------------------------------------------
# the prefetcher in this process
# ---------------------------------------------------------------------------


def test_prefetcher_yields_in_order():
    cfg = LMDataConfig(vocab_size=101, batch=2, seq_len=8)
    it = ShardedPrefetcher(lm_iterator(cfg), sharding=None, depth=2, device="cpu")
    first, second = next(it), next(it)
    assert torch.equal(first["tokens"], torch.from_numpy(lm_batch(cfg, 0)["tokens"]))
    assert torch.equal(second["tokens"], torch.from_numpy(lm_batch(cfg, 1)["tokens"]))
    # the port's stream is the reference's
    assert np.array_equal(second["labels"].numpy(), ref_lm_batch(RefLMDataConfig(vocab_size=101, batch=2, seq_len=8),
                                                                 1)["labels"])
    it.close()


def test_prefetcher_propagates_errors():
    def bad_iter():
        yield {"x": np.zeros(2)}
        raise ValueError("source died")

    it = ShardedPrefetcher(bad_iter(), depth=1, device="cpu")
    next(it)
    with pytest.raises(ValueError, match="source died"):
        next(it)
    with pytest.raises(ValueError, match="source died"):  # and at every later call
        next(it)


def test_prefetcher_stops_at_the_end():
    it = ShardedPrefetcher(iter([np.arange(3), np.arange(3) + 1]), depth=4, device="cpu")
    assert [b.tolist() for b in it] == [[0, 1, 2], [1, 2, 3]]
    with pytest.raises(StopIteration):
        next(it)


def test_prefetcher_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedPrefetcher(iter([]), depth=1)


# ---------------------------------------------------------------------------
# elastic re-mesh in this process (a group of one)
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for_devices

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh_for_devices(1, 1)
    finally:
        dist.destroy_process_group()


def test_values_preserved_and_replicated_fallbacks(one_rank_mesh):
    state = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.arange(5, dtype=np.float32)}
    out = reshard_to_mesh(state, one_rank_mesh, lambda path, leaf: None if leaf.ndim == 1 else ("data",))
    for k in state:
        assert np.array_equal(out[k].numpy(), state[k])


def test_divisible_handles_tuple_axes_and_short_specs(one_rank_mesh):
    assert _divisible((8, 6), ("data",), one_rank_mesh)
    assert _divisible((8,), (("data",),), one_rank_mesh)
    assert _divisible((8, 6, 4), ("data",), one_rank_mesh)
    assert _divisible((7, 5), (("data", "model"), "model"), one_rank_mesh)


def test_elastic_restore_defaults_to_replication(tmp_path, one_rank_mesh):
    state = {"w": torch.ones((4, 4)) * 3.0}
    save_checkpoint(str(tmp_path), 1, state)
    restored = elastic_restore(str(tmp_path), 1, state, one_rank_mesh)
    assert torch.equal(restored["w"], state["w"])


def test_restore_onto_one_rank_keeps_every_value(tmp_path, one_rank_mesh):
    """A checkpoint restored under one rank with the specs the (2, 2) mesh
    uses: every block is the whole leaf."""
    state = {k: torch.as_tensor(v) for k, v in _state().items()}
    save_checkpoint(str(tmp_path), 3, state)
    out = elastic_restore(str(tmp_path), 3, state, one_rank_mesh, spec_fn=_specs)
    for k, v in state.items():
        assert torch.equal(torch.as_tensor(out[k]), v), k


def _specs(path, leaf):
    return {"w": ("data",), "odd": (("data", "model"),), "cols": (None, "model")}.get(path[-1])


# ---------------------------------------------------------------------------
# four ranks: prefetching blocks, save under (4, 1), restore under (2, 2)
# ---------------------------------------------------------------------------


def _job(rank, world, ckpt, out, store):
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.data import LMDataConfig, ShardedPrefetcher, lm_batch, lm_iterator
    from repro_torch.ft.elastic import elastic_restore, reshard_to_mesh
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.parallel.sharding import NamedSharding

    res = {}
    m41 = make_mesh_for_devices(4, 1)
    rows = NamedSharding(m41, ("data", None))
    cfg = LMDataConfig(vocab_size=101, batch=8, seq_len=6)
    it = ShardedPrefetcher(lm_iterator(cfg), sharding=rows, depth=2, device="cpu")
    for s in range(3):
        b = next(it)
        res[f"pf/{s}"] = b["tokens"].numpy()
    it.close()
    # the iterator's batch as this rank's own block already
    own = ShardedPrefetcher(iter([{"x": np.full((2, 3), rank, np.float32)}]), sharding=rows, depth=1,
                            process_local=True, device="cpu")
    res["own"] = next(own)["x"].numpy()

    rng = np.random.default_rng(0)
    full = {
        "w": rng.standard_normal((8, 6)).astype(np.float32),
        "odd": rng.standard_normal((6, 3)).astype(np.float32),
        "cols": rng.standard_normal((3, 8)).astype(np.float32),
        "scalar": np.float32(7.5),
    }
    # save under (4, 1): each rank holds its block of the sharded leaves, the
    # checkpoint gets the gathered full tree from one writer
    spec41 = lambda path, leaf: ("data",) if leaf.ndim == 2 else None  # noqa: E731
    blocks = reshard_to_mesh(full, m41, spec41)
    res["save_block_w"] = blocks["w"].numpy()
    res["save_block_odd_shape"] = np.array(blocks["odd"].shape)
    tree = {k: (NamedSharding(m41, ("data", None)).gather(v) if k == "w" else torch.as_tensor(v))
            for k, v in blocks.items()}
    if rank == 0:
        save_checkpoint(ckpt, 1, tree)
    dist.barrier()
    # restore under (2, 2): "w" over data (2 blocks of 4 rows), "odd" over
    # data x model (4 blocks: 6 rows do not split, replicated), "cols" over model
    m22 = make_mesh_for_devices(4, 2)
    specs = {"w": ("data",), "odd": (("data", "model"),), "cols": (None, "model")}
    template = {k: torch.zeros(np.shape(v)) for k, v in full.items()}
    restored = elastic_restore(ckpt, 1, template, m22, spec_fn=lambda path, leaf: specs.get(path[-1]))
    for k, v in restored.items():
        res[f"restored/{k}"] = torch.as_tensor(v).numpy()
    res["coords"] = np.array([m22.get_local_rank(mesh_dim="data"), m22.get_local_rank(mesh_dim="model")])
    every = [None] * world
    dist.all_gather_object(every, res)
    if rank == 0:
        np.savez(out, **{f"r{r}/{k}": v for r, d in enumerate(every) for k, v in d.items()})
    dist.barrier()
    dist.destroy_process_group()


def _python(fn, *args) -> list:
    src = textwrap.dedent(inspect.getsource(fn)) + f"\n{fn.__name__}(*{[str(a) for a in args]!r})\n"
    return [sys.executable, "-c", src]


def run_job(tmp) -> dict:
    """Start the 4 ranks in directory ``tmp``, wait: {"r<rank>/<key>": ...}.
    ``tools/torch_parity.py`` runs it too."""
    out, ckpt, store = (os.path.join(tmp, n) for n in ("out.npz", "ckpt", "store"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(_python(_job, r, 4, ckpt, out, store), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"rank job: exit {p.returncode}\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(np.load(out))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_job(str(tmp_path_factory.mktemp("elastic")))


def test_prefetcher_places_each_ranks_block(four_ranks):
    cfg = RefLMDataConfig(vocab_size=101, batch=8, seq_len=6)
    for r in range(4):
        for s in range(3):
            want = ref_lm_batch(cfg, s)["tokens"][2 * r:2 * r + 2]
            assert np.array_equal(four_ranks[f"r{r}/pf/{s}"], want), (r, s)
        assert np.array_equal(four_ranks[f"r{r}/own"], np.full((2, 3), r, np.float32))


def test_save_under_4x1_restore_under_2x2(four_ranks):
    full = _state()
    for r in range(4):
        assert np.array_equal(four_ranks[f"r{r}/save_block_w"], full["w"][2 * r:2 * r + 2])
        # 6 rows do not split into 4 blocks: replicated under (4, 1) too
        assert tuple(four_ranks[f"r{r}/save_block_odd_shape"]) == (6, 3)
        di, mi = four_ranks[f"r{r}/coords"]
        assert np.array_equal(four_ranks[f"r{r}/restored/w"], full["w"][4 * di:4 * di + 4])
        # 6 rows do not split into 4 blocks: replicated, values intact
        assert np.array_equal(four_ranks[f"r{r}/restored/odd"], full["odd"])
        assert np.array_equal(four_ranks[f"r{r}/restored/cols"], full["cols"][:, 4 * mi:4 * mi + 4])
        assert float(four_ranks[f"r{r}/restored/scalar"]) == 7.5
