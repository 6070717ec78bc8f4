"""Inputs and weights of a run, made from its seed on its device.

Everything here is drawn by ``torch.Generator``s on the run's device, one
generator a leaf or a batch, each seeded from (run seed, what it makes), so
that any piece can be made again on its own after the timed window: the
reference is handed the same weights and batches the system was.

* SSL views: the two-view stream of the system's ``data/synthetic.ssl_batch``
  (latent factors rendered through a fixed random decoder and ``tanh``;
  per view a channel scale and shift, a coordinate mask, pixel noise),
  with its arithmetic on the device, in a pool of distinct batches.
* LM tokens: ``data/synthetic.lm_batch``'s Markov-like stream,
  t_{i+1} = (31 t_i + noise) mod V with noise in [0, 17), and next-token
  labels.
* Weights: the MLP's normal / sqrt(fan_in) matrices and zero biases; the
  RWKV-6 leaves by the initialisation the system documents (embedding
  normal * 0.02, norms zero, its constants and small normals, the other
  matrices normal / sqrt(rows)).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, List, Tuple

import torch

Tensor = torch.Tensor
_MASK = (1 << 63) - 1


def seed_of(seed: int, *salt) -> int:
    """A 63-bit seed from the run's seed and the names of what it makes."""
    h = int(seed) & ((1 << 64) - 1)
    for s in salt:
        v = zlib.crc32(str(s).encode())
        h = (h * 6364136223846793005 + 1442695040888963407 + v) & ((1 << 64) - 1)
    return h & _MASK


def generator(device, seed: int, *salt) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, *salt))
    return g


# ---------------------------------------------------------------------------
# SSL
# ---------------------------------------------------------------------------


def ssl_batch(traffic: Dict, input_dim: int, seed: int, index: int, device) -> Dict[str, Tensor]:
    """Batch ``index`` of the two-view stream: {"view1", "view2"}, each
    (batch, input_dim) float32."""
    n, latent = int(traffic["batch"]), int(traffic.get("latent_dim", 64))
    jitter, mask_p, noise = (float(traffic.get(k, d)) for k, d in (("jitter", 0.2), ("mask_prob", 0.25),
                                                                    ("noise", 0.1)))
    dec = torch.randn((latent, input_dim), generator=generator(device, seed, "ssl_decoder"), device=device)
    dec /= math.sqrt(latent)
    g = generator(device, seed, "ssl_batch", index)
    base = torch.tanh(torch.randn((n, latent), generator=g, device=device) @ dec)
    views = {}
    for name in ("view1", "view2"):
        scale = 1.0 + jitter * (2 * torch.rand((n, 1), generator=g, device=device) - 1)
        shift = jitter * (2 * torch.rand((n, 1), generator=g, device=device) - 1)
        keep = torch.rand((n, input_dim), generator=g, device=device) > mask_p
        v = (base * scale + shift) * keep
        views[name] = v + noise * torch.randn((n, input_dim), generator=g, device=device)
    return views


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


def lm_batches(traffic: Dict, vocab: int, seed: int, indices, device) -> List[Dict[str, Tensor]]:
    """Batches ``indices`` of the token stream, all built together:
    {"tokens", "labels"}, each (batch, seq) int32."""
    b, s = int(traffic["batch"]), int(traffic["seq"])
    heads, noises = [], []
    for i in indices:
        g = generator(device, seed, "lm_batch", i)
        heads.append(torch.randint(0, vocab, (b,), generator=g, device=device))
        noises.append(torch.randint(0, 17, (b, s + 1), generator=g, device=device))
    noise = torch.cat(noises)
    toks = torch.empty_like(noise)
    toks[:, 0] = torch.cat(heads)
    for i in range(1, s + 1):
        toks[:, i] = (toks[:, i - 1] * 31 + noise[:, i]) % vocab
    toks = toks.to(torch.int32)
    return [{"tokens": toks[j * b:(j + 1) * b, :-1].contiguous(), "labels": toks[j * b:(j + 1) * b, 1:].contiguous()}
            for j in range(len(noises))]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def ssl_leaves(config: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of the MLP's leaves in its parameter order: each
    layer's weight (out, in), then its bias."""
    out = []
    dims = {"backbone": [config["input_dim"], *config["backbone_widths"]]}
    dims["projector"] = [config["backbone_widths"][-1], *config["projector_widths"]]
    for part in ("backbone", "projector"):
        d = dims[part]
        for i, (a, b) in enumerate(zip(d[:-1], d[1:])):
            out += [(f"{part}.{i}.weight", (b, a)), (f"{part}.{i}.bias", (b,))]
    return out


def ssl_leaf(config: Dict, seed: int, name: str, shape, device) -> Tensor:
    """One leaf: a weight normal / sqrt(fan_in), a bias zero (float32)."""
    if name.endswith(".bias"):
        return torch.zeros(shape, device=device)
    w = torch.randn(shape, generator=generator(device, seed, "ssl", name), device=device)
    return w.mul_(1.0 / math.sqrt(shape[1]))


# RWKV-6 initialisation, as the system documents it for its leaves
_F32_LEAVES = ("decay_base", "bonus_u", "ln_x")
_CONST = {"mu_base": 0.5, "mu": 0.5, "decay_base": -5.0, "ln_x": 1.0, "cmix_mu_k": 0.5, "cmix_mu_r": 0.5}
_NORMAL = {"embed": 0.02, "lora_b": 0.01, "decay_lora_b": 0.01, "bonus_u": 0.1}


def lm_leaf_dtype(config: Dict, name: str) -> torch.dtype:
    leaf = name.rsplit(".", 1)[-1]
    return torch.float32 if leaf in _F32_LEAVES else getattr(torch, config["param_dtype"])


def lm_leaf(config: Dict, seed: int, name: str, shape, device, dtype=None) -> Tensor:
    """One RWKV-6 leaf, in ``dtype`` (default: the configuration's).  The
    configuration's ``init`` may set a leaf's normal scale (``normal``) and
    list leaves whose dense scale is divided by sqrt(2 n_layers)
    (``depth_scaled``: the residual branches' output products)."""
    leaf = name.rsplit(".", 1)[-1]
    dtype = dtype or lm_leaf_dtype(config, name)
    init = config.get("init", {})
    if "norm" in leaf:
        return torch.zeros(shape, dtype=dtype, device=device)
    if leaf in _CONST:
        return torch.full(shape, _CONST[leaf], dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator(device, seed, "lm", name), device=device)
    scale = {**_NORMAL, **init.get("normal", {})}.get(leaf, 1.0 / math.sqrt(shape[-2]))
    if leaf in init.get("depth_scaled", ()):
        scale /= math.sqrt(2 * config["n_layers"])
    return w.mul_(scale).to(dtype)


def lm_leaves(config: Dict, shapes: Dict[str, Tuple[int, ...]], seed: int, device, dtype=None
              ) -> Iterator[Tuple[str, Tensor]]:
    """(name, leaf) for every leaf of ``shapes``, one at a time."""
    for name, shape in shapes.items():
        yield name, lm_leaf(config, seed, name, shape, device, dtype)


def nest(flat: Dict[str, Tensor]) -> Dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}."""
    out: Dict = {}
    for name, x in flat.items():
        node = out
        *parts, last = name.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = x
    return out
