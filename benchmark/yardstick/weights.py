"""A configuration's parameters, made on the device from the seed.

The layout is the flagship's parameter tree: ``embed (V, d)``, per
layer ``ln1``, ``ln2`` ``(d,)``, ``wq (d, h, hd)``, ``wkv (d, 2, h_kv,
hd)``, ``wo (h, hd, d)`` and either ``w1 (d, ff)``, ``w2 (ff, d)`` or,
in an MoE layer, ``moe: {w_router (d, E), w1 (E, d, ff), w2 (E, ff,
d)}``; then ``ln_f (d,)`` and ``lm_head (d, V)``. Norm scales are 1;
every matrix is normal over sqrt(fan in), drawn in one call on the
device for all of them, in float32 (the parameters' type), and cut into
leaves that are views of that one buffer. The same seed gives the same
weights, so the reference makes them again after the program is gone.
"""

import math

import torch

from . import traffic


def leaf_specs(cfg):
    """``[(dotted name, shape, fan in or None for a norm scale)]`` in the
    tree's leaf order: keys sorted, layers in order."""
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    h, h_kv = cfg["n_heads"], cfg["n_kv_heads"]
    hd, e = d // h, cfg.get("moe_num_experts", 0)
    out = [("embed", (v, d), d)]
    for i in range(cfg["n_layers"]):
        layer = {"ln1": ((d,), None), "ln2": ((d,), None),
                 "wq": ((d, h, hd), d), "wkv": ((d, 2, h_kv, hd), d),
                 "wo": ((h, hd, d), d)}
        if i in cfg.get("moe_layers", []):
            layer["moe.w1"] = ((e, d, ff), d)
            layer["moe.w2"] = ((e, ff, d), ff)
            layer["moe.w_router"] = ((d, e), d)
        else:
            layer["w1"] = ((d, ff), d)
            layer["w2"] = ((ff, d), ff)
        out += [(f"layers.{i}.{k}", *layer[k]) for k in sorted(layer)]
    return out + [("lm_head", (d, v), d), ("ln_f", (d,), None)]


def make(cfg, seed, device):
    """``(tree, named)``: the parameter tree the model takes, and
    ``{dotted name: tensor}`` of the same leaves."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(shape) for _, shape, fan in specs if fan)
    flat = torch.randn(total, generator=traffic.generator(seed, "weights",
                                                          device),
                       dtype=torch.float32, device=device)
    named, at = {}, 0
    for name, shape, fan in specs:
        if fan is None:
            named[name] = torch.ones(shape, dtype=torch.float32,
                                     device=device)
            continue
        n = math.prod(shape)
        named[name] = flat[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan))
        at += n
    return tree(named, cfg), named


def tree(named, cfg):
    """The nested tree of ``{dotted name: leaf}``."""
    layers = [{} for _ in range(cfg["n_layers"])]
    out = {"layers": layers}
    for name, leaf in named.items():
        parts = name.split(".")
        if parts[0] != "layers":
            out[name] = leaf
            continue
        node = layers[int(parts[1])]
        for key in parts[2:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = leaf
    return out


def named_leaves(tree_, prefix=""):
    """``{dotted name: leaf}`` of a tree (the inverse of :func:`tree`)."""
    out = {}
    if isinstance(tree_, dict):
        for k, v in tree_.items():
            out.update(named_leaves(v, f"{prefix}{k}."))
    elif isinstance(tree_, (list, tuple)):
        for i, v in enumerate(tree_):
            out.update(named_leaves(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree_
    return out
