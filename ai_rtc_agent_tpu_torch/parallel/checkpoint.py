"""The pytree wire codec and the trainer's checkpoints (counterpart of
ai_rtc_agent_tpu/parallel/checkpoint.py).

The codec: one self-describing blob per nested dict/list/tuple of arrays
and python scalars, bit-exact for every fixed-width dtype, versioned and
checksummed per leaf.  A session migration (stream/scheduler.py
``snapshot_session``/``restore_session``) rides it.

For the same tree the bytes equal the JAX encoder's, so each side decodes
the other's blobs:

* the magic ``TPRTPT01``, a little-endian u32 header length, the JSON
  header (``{"version": 1, "tree": spec, "leaves": [...]}``, compact
  separators) and each leaf's raw C-order bytes;
* a leaf is recorded by its numpy dtype name, shape, byte count, crc32
  and offset; dict keys go in sorted order.

Leaves may be numpy arrays or torch tensors (any device: a device tensor
is pulled to the host here, so a caller snapshotting live state does it
outside its locks).  bfloat16 goes on the wire as its raw 16 bits under
the name ``"bfloat16"``, as ml_dtypes names it on the JAX side; this
module needs no ml_dtypes.  :func:`deserialize_pytree` returns torch CPU
tensors (torch spells bfloat16; numpy does not) and refuses corrupt or
truncated blobs with ``ValueError``.

The trainer's checkpoints (:func:`save_train_state`,
:func:`latest_checkpoint`, :func:`restore_train_state`) keep the JAX
layout of directories, ``<dir>/step_%08d``, and its newest-step choice.
The JAX package writes them with orbax; the port writes the whole train
state (params, optimizer, step; tp shards gathered by the trainer) as one
codec blob inside, so a checkpoint written at one mesh shape restores at
another.  JAX orbax checkpoints are not read.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
import zlib

import numpy as np
import torch

_PYTREE_MAGIC = b"TPRTPT01"

# numpy dtype name <-> torch dtype, every fixed-width kind the state carries
_TORCH_DTYPES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _leaf_bytes(node) -> tuple[str, list, bytes]:
    """(numpy dtype name, shape, raw C-order bytes) of an array leaf."""
    if isinstance(node, torch.Tensor):
        name = _DTYPE_NAMES.get(node.dtype)
        if name is None:
            raise ValueError(f"pytree leaf dtype {node.dtype} has no wire name")
        t = node.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        return name, list(t.shape), raw
    arr = np.asarray(node)
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def _encode_node(node, leaves: list, buffers: list):
    """The JAX encoder's structure spec: dicts by sorted key, list/tuple in
    order, python scalars inline, array leaves by index."""
    if isinstance(node, dict):
        return {"t": "dict", "k": {str(k): _encode_node(node[k], leaves, buffers)
                                   for k in sorted(node)}}
    if isinstance(node, (list, tuple)):
        return {"t": "list" if isinstance(node, list) else "tuple",
                "v": [_encode_node(x, leaves, buffers) for x in node]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"t": "py", "v": node}
    name, shape, raw = _leaf_bytes(node)
    idx = len(leaves)
    leaves.append({"dtype": name, "shape": shape, "nbytes": len(raw),
                   "crc32": zlib.crc32(raw) & 0xFFFFFFFF})
    buffers.append(raw)
    return {"t": "leaf", "i": idx}


def _decode_node(spec, arrays):
    t = spec.get("t")
    if t == "dict":
        return {k: _decode_node(v, arrays) for k, v in spec["k"].items()}
    if t in ("list", "tuple"):
        seq = [_decode_node(v, arrays) for v in spec["v"]]
        return seq if t == "list" else tuple(seq)
    if t == "py":
        return spec.get("v")
    if t == "leaf":
        return arrays[spec["i"]]
    raise ValueError(f"pytree blob spec carries unknown node type {t!r}")


def serialize_pytree(tree) -> bytes:
    """One blob for ``tree`` (the JAX encoder's bytes for the same tree)."""
    leaves: list = []
    buffers: list = []
    spec = _encode_node(tree, leaves, buffers)
    offset = 0
    for leaf, raw in zip(leaves, buffers):
        leaf["offset"] = offset
        offset += len(raw)
    header = json.dumps({"version": 1, "tree": spec, "leaves": leaves},
                        separators=(",", ":")).encode("utf-8")
    return b"".join([_PYTREE_MAGIC, struct.pack("<I", len(header)), header] + buffers)


def _tensor_of(raw: bytes, name: str, shape: tuple) -> torch.Tensor:
    dt = _TORCH_DTYPES.get(name)
    if dt is None:
        raise ValueError(f"pytree blob names unknown dtype {name!r}")
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw else torch.empty(
        0, dtype=torch.uint8)
    return flat.view(dt).reshape(shape)


def deserialize_pytree(data: bytes):
    """Inverse of :func:`serialize_pytree` (and of the JAX encoder): leaves
    come back as torch CPU tensors.  Raises ``ValueError`` on bad magic, a
    truncated header or payload, an undecodable spec or a per-leaf
    checksum mismatch."""
    data = bytes(data)
    if len(data) < len(_PYTREE_MAGIC) + 4:
        raise ValueError("pytree blob truncated (no header)")
    if data[: len(_PYTREE_MAGIC)] != _PYTREE_MAGIC:
        raise ValueError("pytree blob has wrong magic/version")
    hlen = struct.unpack_from("<I", data, len(_PYTREE_MAGIC))[0]
    hstart = len(_PYTREE_MAGIC) + 4
    if hstart + hlen > len(data):
        raise ValueError("pytree blob truncated (header extends past end)")
    try:
        header = json.loads(data[hstart: hstart + hlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"pytree blob header undecodable: {e}") from e
    if not isinstance(header, dict) or header.get("version") != 1:
        version = header.get("version") if isinstance(header, dict) else None
        raise ValueError(f"pytree blob header version {version!r} unsupported "
                         "(this build reads version 1)")
    payload = data[hstart + hlen:]
    arrays = []
    for i, leaf in enumerate(header.get("leaves", [])):
        try:
            name = str(leaf["dtype"])
            shape = tuple(int(s) for s in leaf["shape"])
            off, nbytes = int(leaf["offset"]), int(leaf["nbytes"])
            crc = int(leaf["crc32"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"pytree blob leaf {i} header invalid: {e}") from e
        raw = payload[off: off + nbytes]
        if len(raw) != nbytes:
            raise ValueError(f"pytree blob truncated (leaf {i} wants {nbytes} bytes, "
                             f"{len(raw)} present)")
        if (zlib.crc32(raw) & 0xFFFFFFFF) != crc:
            raise ValueError(f"pytree blob corrupt (leaf {i} checksum mismatch)")
        try:
            arrays.append(_tensor_of(raw, name, shape))
        except RuntimeError as e:  # a byte count that does not fit the shape
            raise ValueError(f"pytree blob leaf {i} does not fit {shape}: {e}") from e
    try:
        return _decode_node(header["tree"], arrays)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"pytree blob structure invalid: {e}") from e


STATE_FILE = "train_state.tprt"


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))


def save_train_state(ckpt_dir: str, state, step: int | None = None) -> str:
    """Persist a whole train state tree; returns the checkpoint path.  An
    existing checkpoint of the same step is replaced, and a reader never
    sees a half-written one (the directory is renamed into place)."""
    if step is None:
        step = int(state["step"])
    path = checkpoint_path(ckpt_dir, step)
    blob = serialize_pytree(state)
    tmp = path + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        f.write(blob)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append((int(m.group(1)), name))
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


def restore_train_state(ckpt_dir: str):
    """The whole train state of the newest checkpoint in ``ckpt_dir``, as
    torch CPU tensors; None when no checkpoint exists."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    with open(os.path.join(path, STATE_FILE), "rb") as f:
        return deserialize_pytree(f.read())
