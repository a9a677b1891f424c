"""Tensor-parallel rules: which UNet leaves shard over ``tp``, and along
which axis (counterpart of the tp half of
ai_rtc_agent_tpu/parallel/sharding.py).

The same regexes run over the same leaf paths: the port's parameter trees
keep the JAX names (``bridge.params_from_jax``), so each leaf gets the JAX
answer.  Column-parallel kernels shard their output axis, row-parallel ones
their input axis, a column kernel's bias shards with it, and everything
else replicates (norms, embeddings).  An axis that does not divide the
leaf's dimension falls back to replicated, as in the JAX rules.

:func:`unet_tp_rules` answers in the JAX layout (HWIO convs, [in, out]
linears); :func:`param_shardings` turns the answer into the port's layout
(OIHW convs), one entry per dimension: ``"tp"`` or None, keyed by the
leaf's path (a tuple of dict keys and list indices); :func:`tp_tree` marks
the sharded dicts for the layers, one placement for the trainer and the
serving engine.

The session-axis (dp) helpers are the serving tiers' one recipe: the
batch scheduler's stacked ``[S, ...]`` state and ``--multipeer``'s peer
axis split their leading axis slot-major over a one-process dp mesh
(``mesh.device_mesh``), shard d holding the slots of
:func:`shard_slots` on ``dp_devices(mesh)[d]``, the params replicated.
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np
import torch

from . import collectives as C

_COLUMN_PAT = re.compile(
    r"(to_q|to_k|to_v|q|k|v|fc1|proj|linear_1|conv1|conv_in|downsample)/kernel$"
)
_ROW_PAT = re.compile(r"(to_out|out|fc2|linear_2|conv2|conv_out|upsample)/kernel$")

# JAX HWIO axis -> port OIHW axis: port[i] = jax[_OIHW[i]]
_OIHW = (3, 2, 0, 1)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def unet_tp_rules(path_s: str, ndim: int) -> tuple:
    """The JAX rule's PartitionSpec for the leaf at ``path_s``, as a tuple."""
    if _COLUMN_PAT.search(path_s):
        return tuple([None] * (ndim - 1) + ["tp"])
    if _ROW_PAT.search(path_s):
        if ndim >= 2:
            return tuple([None] * (ndim - 2) + ["tp", None])
    # biases feeding column-parallel outputs
    if _COLUMN_PAT.search(path_s.replace("/bias", "/kernel")) and path_s.endswith("bias"):
        return ("tp",)
    return ()  # replicate (norms, embeddings, everything else)


def leaves_with_paths(tree, path=()):
    """(path, leaf) over a nested dict/list tree, in its order; None skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over every leaf; the tree keeps its shape."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def leaf_spec(mesh, path, shape, rules: Callable = unet_tp_rules) -> tuple:
    """One leaf's placement in the port's layout: a tuple of ``"tp"`` or None
    per dimension, after the JAX rule drops an axis that does not divide."""
    ndim = len(shape)
    spec = list(rules(_path_str(path), ndim)) + [None] * ndim
    spec = spec[:ndim]
    if ndim == 4:
        spec = [spec[j] for j in _OIHW]
    out = []
    for i, ax in enumerate(spec):
        size = mesh.size(ax) if ax is not None else 1
        out.append(ax if ax is not None and shape[i] % size == 0 and shape[i] >= size else None)
    return tuple(out)


def param_shardings(mesh, params, rules: Callable = unet_tp_rules) -> dict:
    """path -> :func:`leaf_spec` for every leaf of ``params``."""
    return {p: leaf_spec(mesh, p, tuple(a.shape), rules) for p, a in leaves_with_paths(params)}


def sharded_dim(spec: tuple):
    """The axis a spec shards over tp, or None when it replicates."""
    return spec.index("tp") if "tp" in spec else None


def shard_leaf(mesh, full: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's tp slice of a whole leaf (the leaf itself if replicated)."""
    dim = sharded_dim(spec)
    if dim is None or mesh.size("tp") == 1:
        return full
    return full.chunk(mesh.size("tp"), dim=dim)[mesh.index("tp")].contiguous()


def unshard_leaf(mesh, local: torch.Tensor, spec: tuple) -> torch.Tensor:
    """A copy of the whole leaf, all-gathered over tp when it is sharded
    (a collective over the tp group)."""
    dim = sharded_dim(spec)
    if dim is None or mesh.size("tp") == 1:
        return local.detach().clone()
    return C.gather(local.detach(), dim, mesh.group("tp"))


def shard_params(mesh, params, rules: Callable = unet_tp_rules):
    """Each rank's local shards of ``params`` by the rules."""
    specs = param_shardings(mesh, params, rules)
    return map_with_path(lambda p, a: shard_leaf(mesh, a, specs[p]), params)


def at(tree, path):
    """The node of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def tp_tree(params, specs: dict, mesh):
    """``params`` with a ``"tp"`` marker, (kind, group), on each dict whose
    kernel is sharded (models/layers.py reads it).  A kernel sharded along
    its output axis is column-parallel and its bias shards with it; along
    its input axis, row-parallel with a replicated bias."""
    if specs is None or mesh.size("tp") == 1:
        return params
    group = mesh.group("tp")

    def walk(node, path):
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, path + (k,)) for k, v in node.items()}
        spec = specs.get(path + ("kernel",))
        dim = None if spec is None else sharded_dim(spec)
        if dim is not None:
            kind = "column" if dim == (0 if len(spec) == 4 else len(spec) - 1) else "row"
            bias = specs.get(path + ("bias",))
            if bias is not None and (kind == "column") != (sharded_dim(bias) is not None):
                raise ValueError(f"a {kind}-parallel kernel at {path} with a bias placed {bias}")
            out["tp"] = (kind, group)
        return out

    return walk(params, ())


# -- the session axis (dp): the serving tiers' rules ---------------------------


def session_axis_spec(mesh, axis: str = "dp") -> tuple:
    """The placement of a leading session/peer axis: ``(axis,)`` (only the
    leading axis shards; trailing axes ride with it) on a mesh whose
    ``axis`` has more than one shard, else ``()`` (replicated)."""
    if mesh is None or mesh.shape.get(axis, 1) <= 1:
        return ()
    return (axis,)


def dp_devices(mesh, axis: str = "dp") -> list:
    """The dp axis's devices in axis order: shard d of a leading-axis
    sharded state lives on ``dp_devices(mesh)[d]`` (a session's H2D copy
    lands on its own shard's)."""
    axes = list(mesh.axis_names)
    arr = np.moveaxis(mesh.devices, axes.index(axis), 0)
    return [arr[d].flat[0] for d in range(mesh.shape.get(axis, 1))]


def slot_shard(slot: int, dp: int, slots: int) -> int:
    """The shard that holds ``slot`` of ``slots``: slot-major, contiguous
    slots/dp blocks per shard (the JAX scheduler's ``_slot_shard``)."""
    return slot * dp // slots


def shard_slots(shard: int, dp: int, slots: int) -> range:
    """The slots shard ``shard`` holds (its rows of the stacked state)."""
    per = slots // dp
    return range(shard * per, (shard + 1) * per)
