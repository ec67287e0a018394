"""The frozen weight generator.

Weights are drawn on the device from the seed, one generator call per
leaf (each leaf is stacked over the layers, so a model is a dozen or so
large calls), in the configuration's storage type. The tree is laid out as
the program takes its parameters, leaf for leaf: ``embed`` (V, D),
``final_norm`` (D,), ``unembed`` (D, V) and ``blocks/0/<leaf>`` stacked on a
leading layer axis. RMSNorm weights are stored as offsets from 1 and start
at 0 (the published init, 1).
"""
from __future__ import annotations

import math

import torch

from bench.reference.dims import Dims
from bench.reference.seeds import sub_seed


def leaf_specs(dm: Dims) -> dict[str, tuple[tuple[int, ...], float | None]]:
    """Each leaf's path, shape and init scale (the std of a normal draw;
    None: zeros)."""
    L, D, H, K, hd, F, V = dm.layers, dm.d, dm.heads, dm.kv_heads, dm.hd, dm.ff, dm.vocab
    block = {
        "ln1": ((L, D), None),
        "ln2": ((L, D), None),
        "wq": ((L, D, H, hd), 1 / math.sqrt(D)),
        "wk": ((L, D, K, hd), 1 / math.sqrt(D)),
        "wv": ((L, D, K, hd), 1 / math.sqrt(D)),
        "wo": ((L, H, hd, D), 1 / math.sqrt(H * hd)),
    }
    if dm.family == "moe":
        E = dm.experts
        block.update({
            "router": ((L, D, E), 1 / math.sqrt(D)),
            "we_g": ((L, 1, E, D, F), 1 / math.sqrt(D)),
            "we_i": ((L, 1, E, D, F), 1 / math.sqrt(D)),
            "we_o": ((L, 1, E, F, D), 1 / math.sqrt(F)),
        })
    else:
        block.update({
            "wi": ((L, D, F), 1 / math.sqrt(D)),
            "wg": ((L, D, F), 1 / math.sqrt(D)),
            "wmo": ((L, F, D), 1 / math.sqrt(F)),
        })
    specs = {"embed": ((V, D), 1.0), "final_norm": ((D,), None)}
    specs.update({f"blocks/0/{k}": v for k, v in block.items()})
    if not dm.tie:
        specs["unembed"] = ((D, V), 1 / math.sqrt(D))
    return specs


def draw_leaf(dm: Dims, seed: int, path: str, device) -> torch.Tensor:
    """Leaf ``path`` of the weights of ``seed``, in ``dm.dtype``."""
    shape, scale = leaf_specs(dm)[path]
    if scale is None:
        return torch.zeros(shape, dtype=dm.dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights", path))
    return torch.randn(shape, generator=gen, device=device, dtype=dm.dtype).mul_(scale)


def draw(dm: Dims, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf, keyed by its path."""
    return {path: draw_leaf(dm, seed, path, device) for path in leaf_specs(dm)}


def nest(flat: dict[str, torch.Tensor]) -> dict:
    """A path-keyed dict as nested dicts (the program's tree)."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dicts as a path-keyed dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
