"""The reference's 2-D layout of the LM train step: FSDP over ``data``, TP
over ``model``, the batch over ``("pod", "data")``.

The reference gets this layout from GSPMD: it places every parameter and
both AdamW moments by ``launch/specs.param_sharding`` (``"data"`` splits a
weight's input dimension, ``"model"`` its heads, FFN or vocabulary
dimension; a leaf whose split does not divide stays replicated) and the
compiler partitions the one-device program around them.  The port has no
partitioner, so the program is written per rank with explicit collectives,
each an autograd Function with JAX's transpose under ``shard_map``:

  * FSDP gather: all-gather over ``data`` forward, reduce-scatter backward
    (each rank's cotangent is its rows' share; the sum over the axis, cut
    into blocks, is each block's whole gradient);
  * entry to TP: identity forward, all-reduce over ``model`` backward
    (``decorr.modes.pvary_if``): the residual stream, replicated over
    ``model``, feeds each rank's heads or FFN columns;
  * exit from TP: all-reduce over ``model`` forward, identity backward
    (``decorr.modes.psum_if``).

A weight that does not split on a head boundary is gathered over ``model``
as well and computed whole; its cotangent is then this rank's share too
(its output feeds this rank's slice of a row-parallel product), so the
gather's backward is the same reduce-scatter.  A weight gathered over
``model`` into a computation every ``model`` rank repeats whole, whose
cotangent is then the whole one on each rank, takes its own block back
instead (``gather(..., repeated=True)``): summing it over ``model`` would
count it ``model`` times.  No parameter gradient needs a reduction over
``model`` after the backward pass; over the batch axes the step all-reduces
what the gathers did not reduce-scatter (``train/step.py``).

A placed parameter (``place_train_state``) is this rank's block of the
full leaf and carries its ``NamedSharding`` as ``p.placement`` (a layer's
view ``leaf[r]`` of a stacked leaf carries the spec without the stacked
axis, ``models.transformer.layer_params``), and the process groups of the
axes it is split over as ``p.shard_groups`` (the clip's global norm sums a
block's squares over them).  The model code (``models/common.mlp_apply``,
``models/attention.attn_apply``, ``models/transformer``'s embedding and
head, ``models/moe``'s experts, ``models/ssm``'s Mamba channels and RWKV6
heads) reads ``placement``; a tensor without one is a whole leaf.  Every
arch of ``configs`` runs this layout.

Serving runs the same layout without gradients (``torch.no_grad``):
``place_params`` places the parameters alone and ``place_caches`` the
dense decode state by ``models/transformer.cache_shardings_logical`` (the
batch over ``("pod", "data")``; a KV cache's sequence over ``model``, so a
``model`` rank holds rows [idx Lr, (idx + 1) Lr) of every slot, all kv
heads; Mamba state's channels over ``model``; RWKV6 state whole).  A
prefill moves its k / v rows to their ranks (``all_to_all_heads_to_seq``
where the kv heads are split over ``model``), and a decode attends each
rank's rows and merges the ranks' partial softmaxes exactly
(``merge_partials``, after an all-gather of each block's output and
log-sum-exp): flash-decoding, the merge GSPMD derives for the reference's
sequence-split softmax (``models/attention``).  A recurrent layer reads
and writes its state through ``state_block`` / ``state_update``.  These
collectives are forward-only and skip an axis of size 1; the
sequence-split attention's ``all_to_all_seq_to_cols`` has a backward.

Inside a TP region (its input entered with ``enter_tp``) every value is a
share of the region's output, which ``exit_tp`` sums: a leaf the region
reads whole gets ``gather(..., tp=True)`` (its share's gradient summed over
``model``) and a per-channel leaf the rank's slice (``own_slice``).  A
value every rank computes whole and uses outside the region (the MoE
router's softmax, which feeds the load-balance aux) stays outside it: the
TP entry then goes on what the region reads of it (the dispatched rows and
the gate values), not on its inputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.decorr.modes import psum_if, pvary_if
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import NamedSharding, _names

Tensor = torch.Tensor

MODEL = "model"
DATA = "data"


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def gather_dim(x: Tensor, dim: int, group) -> Tensor:
    """Every rank's block of ``group`` concatenated along ``dim`` (rank
    order), contiguous: a product reads it in the whole leaf's layout."""
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] * dist.get_world_size(group),) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(g: Tensor, dim: int, group) -> Tensor:
    """This rank's block along ``dim`` of the sum of ``g`` over ``group``,
    contiguous (the clip's sums and AdamW's slices read it as the block's
    own layout)."""
    gm = g.movedim(dim, 0).contiguous()
    out = gm.new_empty((gm.shape[0] // dist.get_world_size(group),) + tuple(gm.shape[1:]))
    dist.reduce_scatter_tensor(out, gm, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` forward; backward the
    reduce-scatter, or with ``repeated`` this rank's block of the cotangent
    (``index``: its position along the axis)."""

    @staticmethod
    def forward(ctx, x, dim, group, repeated, index):
        ctx.dim, ctx.group, ctx.repeated, ctx.index, ctx.size = dim, group, repeated, index, x.shape[dim]
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.repeated:
            return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None, None
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None, None, None


def placement(x: Tensor) -> Optional[NamedSharding]:
    """The ``NamedSharding`` a placed block carries, or None (a whole leaf)."""
    return getattr(x, "placement", None)


def _has(pl: NamedSharding, axis: str) -> bool:
    return any(axis in _names(e) for e in pl.spec if e is not None)


def split_over(x: Tensor, axis: str) -> bool:
    """True when ``x`` is a block split over mesh axis ``axis``."""
    pl = placement(x)
    return pl is not None and _has(pl, axis)


def split_dim(x: Tensor, axis: str) -> Optional[int]:
    """The dimension of block ``x`` split over ``axis``, or None."""
    pl = placement(x)
    if pl is None:
        return None
    for dim, e in enumerate(pl.spec):
        if e is not None and axis in _names(e):
            return dim
    return None


def gather(x: Tensor, *, model: bool = False, repeated: bool = False, tp: bool = False) -> Tensor:
    """The tensor a rank computes with from its block ``x`` (a whole leaf
    passes through): gathered over ``data`` (FSDP), and over ``model`` too
    when ``model`` is set, else kept as this rank's ``model`` block.
    ``repeated``: every ``model`` rank computes the gathered leaf's result
    whole (its ``model`` gather takes its block back in the backward pass).
    ``tp``: ``x`` feeds this rank's share of a TP region (see the module
    note), so a leaf replicated over ``model`` has its gradient summed over
    ``model`` (``pvary``)."""
    pl = placement(x)
    if pl is None:
        return x
    mesh = pl.mesh
    for dim, entry in enumerate(pl.spec):
        for name in reversed(_names(entry)) if entry is not None else ():
            if name == MODEL and not model:
                continue
            x = _Gather.apply(x, dim, mesh.get_group(name), repeated and name == MODEL,
                              int(mesh.get_local_rank(mesh_dim=name)))
    if tp and not _has(pl, MODEL):
        x = pvary_if(x, MODEL)
    return x


def gather_rows(x: Tensor, axes) -> Tensor:
    """Every rank's rows of ``x`` along dim 0 over the installed mesh's
    ``axes`` (the major axis's blocks outermost), for a computation every
    rank then repeats whole: the backward takes this rank's rows back."""
    mesh = shd.current_mesh()
    for name in reversed(_names(axes)):
        (group,) = shd.axis_groups(name)
        x = _Gather.apply(x, 0, group, True, int(mesh.get_local_rank(mesh_dim=name)))
    return x


def enter_tp(x: Tensor) -> Tensor:
    """Entry to a TP region: identity forward, all-reduce over ``model`` backward."""
    return pvary_if(x, MODEL)


def exit_tp(x: Tensor) -> Tensor:
    """Exit from a TP region: all-reduce over ``model`` forward, identity backward."""
    return psum_if(x, MODEL)


def own_slice(x: Tensor, dim: int) -> Tensor:
    """This ``model`` rank's 1/m of the whole leaf along ``dim`` (contiguous
    blocks in rank order), for its share of a TP region: its block where
    ``x`` is split over ``model`` along ``dim``, else the whole leaf
    (gathered over ``model``, or replicated and ``pvary``'d) cut to it."""
    if split_dim(x, MODEL) == dim:
        return gather(x, tp=True)
    whole = gather(x, model=True, tp=True)
    n = whole.shape[dim] // shd.axis_size(MODEL)
    return whole.narrow(dim, shd.axis_index(MODEL) * n, n)


def layer_view(leaf: Tensor, view: Tensor) -> Tensor:
    """``view`` (= ``leaf[r]``) carrying ``leaf``'s placement without the
    stacked axis."""
    pl = placement(leaf)
    if pl is not None:
        if pl.spec and pl.spec[0] is not None:
            raise ValueError(f"a stacked leaf split over its layer axis: {pl.spec}")
        view.placement = NamedSharding(pl.mesh, tuple(pl.spec[1:]))
    return view


# ---------------------------------------------------------------------------
# The vocabulary-parallel embedding
# ---------------------------------------------------------------------------


def embed_lookup(table: Tensor, ids: Tensor, dtype) -> Tensor:
    """Rows of a (V, d) table block (or an audio (n_q, V, d) block with
    (..., n_q) ids, one table a codebook, summed) for ``ids``, in ``dtype``.
    Split over ``model`` by vocabulary rows: ids outside the rank's rows
    give zero and the ranks' rows are all-reduced over ``model``.  A whole
    table (no placement) is indexed directly."""
    rows_dim = table.dim() - 2
    if split_dim(table, MODEL) != rows_dim:
        whole = gather(table, model=True, repeated=True)
        if table.dim() == 3:
            return sum(whole[q][ids[..., q]].to(dtype) for q in range(table.shape[0]))
        return whole[ids].to(dtype)
    whole = gather(table)
    n = whole.shape[rows_dim]
    lo = shd.axis_index(MODEL) * n

    def rows(t, i):
        local = i.long() - lo
        own = (local >= 0) & (local < n)
        return t[local.clamp(0, n - 1)].to(dtype) * own[..., None].to(dtype)

    if table.dim() == 3:
        out = sum(rows(whole[q], ids[..., q]) for q in range(table.shape[0]))
    else:
        out = rows(whole, ids)
    return exit_tp(out)


def head_columns(w: Tensor, transpose: bool) -> Tuple[Optional[int], Tensor]:
    """(the first vocabulary column this rank computes, or None when it
    computes them all; the weight to multiply by): the tied embedding
    (V, d) (``transpose``) or an (d, C) head block."""
    start = vocab_start(w, transpose)
    if start is None:
        return None, gather(w, model=True, repeated=True)
    return start, gather(w)


def vocab_start(w: Tensor, transpose: bool) -> Optional[int]:
    """The first vocabulary column of a head block ``w`` (see
    ``head_columns``) this rank computes, or None when it is not split
    over ``model`` along the vocabulary."""
    vocab_dim = 0 if transpose else 1
    if split_dim(w, MODEL) != vocab_dim:
        return None
    return shd.axis_index(MODEL) * w.shape[vocab_dim]


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _shard_groups(sharding: NamedSharding):
    return tuple(sharding.mesh.get_group(name) for e in sharding.spec if e is not None for name in _names(e))


def _placed_leaf(x: Tensor, sharding: NamedSharding) -> Tensor:
    """This rank's block of ``x`` under ``sharding``: a new tensor object
    (sharing ``x``'s storage where the block is the whole leaf) carrying
    ``placement`` and ``shard_groups``, so ``x`` itself stays unplaced.  A
    block of leading rows (a contiguous view) is copied out, so that it
    holds only its own bytes."""
    block = sharding.local(x.detach())
    if block.untyped_storage().nbytes() > block.numel() * block.element_size():
        block = block.clone()
    block.placement = sharding
    block.shard_groups = _shard_groups(sharding)
    return block


def place_params(params: Dict, mesh) -> Dict:
    """This rank's block of every leaf of the parameter tree ``params``
    (``init_params`` / ``params_from_jax``) under ``launch/specs.
    param_sharding`` on ``mesh``: the parameter half of
    ``place_train_state``, for the serving steps (``train/serve``), which
    follow the blocks' placements.  ``params`` stays as it was."""
    from repro_torch.launch.specs import _map_tree, param_sharding

    return _map_tree(params, lambda path, x: _placed_leaf(x, param_sharding(path, x, mesh)))


def place_caches(caches: Dict, cfg, mesh) -> Dict:
    """This rank's block of every leaf of the dense decode state ``caches``
    (``models.init_caches``, every slot) under ``launch/specs.
    cache_sharding``: an attention cache's slots over ``("pod", "data")``
    and its rows over ``model``; the batch stays whole where it does not
    split over the batch axes, and a leaf whose split does not divide stays
    whole (Mamba and RWKV6 state by the same rule: ``conv`` / ``ssm``'s
    channels over ``model``, ``wkv`` / ``shift_*`` whole over it).  A block
    that is the whole leaf shares its storage: use only the placed caches
    afterwards (the steps write them in place)."""
    from repro_torch.launch.specs import _map_tree, cache_sharding

    return _map_tree(caches, lambda path, x: _placed_leaf(x, cache_sharding(cfg, path, x.shape, mesh)))


def tree_mesh(tree):
    """The mesh of the first placed leaf of ``tree`` (a dict of tensors), or None."""
    for v in tree.values():
        found = tree_mesh(v) if isinstance(v, dict) else getattr(placement(v), "mesh", None)
        if found is not None:
            return found
    return None


# ---------------------------------------------------------------------------
# Serving collectives (forward only)
# ---------------------------------------------------------------------------


def all_to_all_heads_to_seq(x: Tensor, rows: int, axis: str = MODEL) -> Tensor:
    """(B, S, h, hd), this rank's h heads of rows [0, S) -> (B, n, m h, hd):
    every rank's heads (in rank order) of this rank's sequence block, rows
    [idx rows, idx rows + n) with n = min(rows, S - idx rows) (0 past the
    prompt), over ``axis`` (m ranks, this rank idx).  S <= m rows: the
    prompt is padded to m blocks of ``rows`` and every rank sends block j
    to rank j.  Forward only."""
    m, idx = shd.axis_size(axis), shd.axis_index(axis)
    n = max(0, min(rows, x.shape[1] - idx * rows))
    if m == 1:
        return x[:, :n]
    b, s, h, hd = x.shape
    if s > m * rows:
        raise ValueError(f"{s} rows do not fit {m} blocks of {rows}")
    pad = x.new_zeros((b, m * rows, h, hd))
    pad[:, :s] = x
    send = pad.reshape(b, m, rows, h, hd).movedim(1, 0).contiguous()  # (m, B, rows, h, hd)
    recv = torch.empty_like(send)  # (source rank, B, rows, h, hd)
    (group,) = shd.axis_groups(axis)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, rows, m * h, hd)[:, :n]


class _SeqToCols(torch.autograd.Function):
    """(B, n, W), this rank's query-row block (rows [idx rows, idx rows +
    n)) of every column -> (B, S, W / m), every row of this rank's column
    block, over ``axis`` (m ranks): an all-to-all of the blocks padded to
    ``rows``.  The backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, seq, rows, group, m):
        ctx.shape, ctx.group, ctx.m, ctx.rows = x.shape, group, m, rows
        b, n, w = x.shape
        pad = x.new_zeros((b, rows, w))
        pad[:, :n] = x
        send = pad.reshape(b, rows, m, w // m).movedim(2, 0).contiguous()  # (dest rank, B, rows, W / m)
        recv = torch.empty_like(send)  # (source rank, B, rows, W / m)
        dist.all_to_all_single(recv, send, group=group)
        return recv.movedim(0, 1).reshape(b, m * rows, w // m)[:, :seq]

    @staticmethod
    def backward(ctx, g):
        b, n, w = ctx.shape
        m, rows = ctx.m, ctx.rows
        pad = g.new_zeros((b, m * rows, w // m))
        pad[:, :g.shape[1]] = g
        send = pad.reshape(b, m, rows, w // m).movedim(1, 0).contiguous()  # (dest rank, B, rows, W / m)
        recv = torch.empty_like(send)  # (source rank's columns, B, rows, W / m)
        dist.all_to_all_single(recv, send, group=ctx.group)
        return recv.permute(1, 2, 0, 3).reshape(b, rows, w)[:, :n], None, None, None, None


def all_to_all_seq_to_cols(x: Tensor, seq: int, rows: int, axis: str = MODEL) -> Tensor:
    """(B, n, W): this rank's block of query rows [idx rows, idx rows + n)
    of a length-``seq`` sequence, every column -> (B, seq, W / m): every
    row, this rank's m-th of the columns (blocks in rank order), over
    ``axis`` (m ranks, this rank idx; n = min(rows, seq - idx rows), 0 past
    the end).  The sequence-split attention's exchange
    (``models/attention``): its backward is the inverse all-to-all, each
    rank's rows of every column's cotangent."""
    m = shd.axis_size(axis)
    if m == 1:
        return x
    (group,) = shd.axis_groups(axis)
    return _SeqToCols.apply(x, seq, rows, group, m)


def _splits(leaf: Tensor, dim: int) -> bool:
    return split_dim(leaf, MODEL) == dim


def state_block(leaf: Tensor, dim: int, block: bool) -> Tensor:
    """A layer's decode-state leaf (``place_caches``) as this rank computes
    with it along ``dim``: this ``model`` rank's m-th (``block``: the
    channels or heads a placed Mamba / RWKV6 layer runs) or the whole.  A
    leaf already in that layout passes through; a replicated one is cut to
    the rank's block, a split one all-gathered.  Forward only."""
    if block == _splits(leaf, dim) or shd.axis_size(MODEL) == 1:
        return leaf
    if block:
        n = leaf.shape[dim] // shd.axis_size(MODEL)
        return leaf.narrow(dim, shd.axis_index(MODEL) * n, n)
    (group,) = shd.axis_groups(MODEL)
    return gather_dim(leaf, dim, group)


def state_update(new: Tensor, leaf: Tensor, dim: int, block: bool) -> Tensor:
    """``new``, advanced from ``state_block(leaf, dim, block)``, in
    ``leaf``'s layout: a rank's block of a replicated leaf all-gathered
    (every rank then writes the same whole leaf), the whole cut to a split
    leaf's block.  Forward only."""
    if block == _splits(leaf, dim) or shd.axis_size(MODEL) == 1:
        return new
    if block:
        (group,) = shd.axis_groups(MODEL)
        return gather_dim(new, dim, group)
    n = new.shape[dim] // shd.axis_size(MODEL)
    return new.narrow(dim, shd.axis_index(MODEL) * n, n)


def gather_blocks(x: Tensor, axis: str = MODEL) -> Tensor:
    """(m, *x.shape): every rank's ``x`` over ``axis``, stacked in rank
    order (``x[None]`` on an axis of size 1).  Forward only."""
    if shd.axis_size(axis) == 1:
        return x[None]
    (group,) = shd.axis_groups(axis)
    return gather_dim(x[None], 0, group)


def merge_partials(out: Tensor, lse: Tensor) -> Tensor:
    """The softmax-weighted sum of m blocks' partial attention outputs:
    ``out`` (m, B, H, hd), each block's softmax over its own rows, and
    ``lse`` (m, B, H), the log-sum-exp of its scores (-inf for a block
    with no live row): out = sum_k e^(lse_k - M) out_k / sum_k e^(lse_k -
    M), M = max_k lse_k — the softmax over every block's rows at once."""
    big = lse.amax(dim=0)
    big = torch.where(torch.isfinite(big), big, torch.zeros_like(big))
    w = torch.exp(lse - big)  # (m, B, H): 0 for an empty block
    total = w.sum(dim=0)
    return (out * w[..., None]).sum(dim=0) / torch.clamp(total, min=1e-30)[..., None]


def place_train_state(state, mesh):
    """A ``ShardedTrainState`` holding this rank's block of every parameter
    of ``state`` (a ``TrainState`` of a ``models.ParamTree``) and of each of
    its optimizer buffers, under ``launch/specs.param_sharding`` on
    ``mesh`` (a leaf whose split does not divide stays replicated, as in the
    reference).  Buffers keep their dtype (bf16 moments stay bf16).  The
    placed state may share storage with ``state`` where a block is the whole
    leaf: use only the placed state afterwards.  ``ShardedTrainState.
    state_dict`` gathers the full tree back (``NamedSharding.gather``)."""
    from repro_torch.launch.specs import param_sharding
    from repro_torch.models.transformer import ParamTree
    from repro_torch.train.train_state import ShardedTrainState

    named = list(state.model.named_parameters())
    shardings: Dict[str, NamedSharding] = {name: param_sharding(name, p, mesh) for name, p in named}
    tree: Dict = {}
    for name, p in named:
        node = tree
        *head, leaf = name.split(".")
        for key in head:
            node = node.setdefault(key, {})
        node[leaf] = shardings[name].local(p.detach())
    model = ParamTree(tree)
    for name, p in model.named_parameters():
        p.placement = shardings[name]
        p.shard_groups = _shard_groups(shardings[name])
    old = state.opt_state
    opt = type(old).__new__(type(old))
    torch.optim.Optimizer.__init__(opt, list(model.parameters()), old.defaults)
    for new_group, old_group in zip(opt.param_groups, old.param_groups):
        new_group.update((k, v) for k, v in old_group.items() if k != "params")
    old_params = [p for g in old.param_groups for p in g["params"]]
    by_id = {id(p): name for name, p in named}
    new_params = dict(model.named_parameters())
    for p in old_params:
        name = by_id[id(p)]
        opt.state[new_params[name]] = {
            k: shardings[name].local(v) if isinstance(v, Tensor) and v.dim() > 0 else v
            for k, v in old.state[p].items()}
    return ShardedTrainState(step=state.step, model=model, opt_state=opt, seed=state.seed, shardings=shardings)


def is_placed(state) -> bool:
    """True for a state ``place_train_state`` made (its parameters carry placements)."""
    return bool(getattr(state, "shardings", None)) and all(
        placement(p) is not None for p in state.model.parameters())
