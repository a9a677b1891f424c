"""Weight loading: HuggingFace safetensors -> the port's param trees.

The port's own copy of ai_rtc_agent_tpu/models/loader.py (the port imports
nothing of the JAX package, even its pure-numpy modules); the tests hold the
two to the same bytes and the same key maps.

* :func:`read_safetensors` / :func:`write_safetensors`: the format written
  by hand (numpy only), since the card's machine may lack the
  ``safetensors`` package.
* :func:`unet_key_map`, :func:`controlnet_key_map`, :func:`taesd_key_map`,
  :func:`clip_key_map`: ``{hf key -> our leaf path}``, derived from the
  config-driven tree; the UNet and the ControlNet share the encoder half
  (:func:`_encoder_keys`).
* :func:`load_into_tree` / :func:`tree_to_state_dict`: the boundary's
  layout rule.  The port keeps conv kernels OIHW, as torch checkpoints
  store them, and linear kernels [in, out] (``models/layers.linear``
  applies ``x @ w``), so a 4-D ``kernel`` leaf crosses unchanged and a 2-D
  one is transposed; every other leaf (norms, biases, embedding tables)
  crosses as it is.  SD1.5's ``proj_in``/``proj_out`` are 1x1 convs and
  stay 4-D.

The SDXL extras (the addition embedding, the text projection of the second
tower) come with their family in a later slice.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator

import numpy as np
import torch

from ..tree import tree_map
from .clip import CLIPTextConfig
from .controlnet import _skip_channels, cond_embed_widths
from .taesd import TAESDConfig
from .unet import UNetConfig

# --------------------------------------------------------------------------
# minimal safetensors reader/writer (numpy only)
# --------------------------------------------------------------------------

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}
_KINDS = {
    np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64",
    np.dtype(np.int32): "I32",
    np.dtype(np.uint8): "U8",
}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file, as numpy arrays over a memory map
    (BF16 widens to f32)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + hlen)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        b0, b1 = info["data_offsets"]
        raw = np.asarray(data[b0:b1])
        if info["dtype"] == "BF16":
            arr = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        else:
            arr = raw.view(_DTYPES[info["dtype"]])
        out[name] = arr.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: dict[str, np.ndarray]) -> None:
    """Write ``tensors`` as safetensors, byte for byte what the JAX package's
    writer makes: the JSON header in insertion order, space-padded to 8."""
    header: dict = {}
    blobs = []
    off = 0
    for name, a in tensors.items():
        a = np.ascontiguousarray(a)
        b = a.tobytes()
        header[name] = {"dtype": _KINDS[a.dtype], "shape": list(a.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    hj = json.dumps(header).encode()
    hj += b" " * ((8 - len(hj) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for b in blobs:
            f.write(b)


# --------------------------------------------------------------------------
# key maps: {hf key -> our path tuple}
# --------------------------------------------------------------------------


def _leaf_keys(prefix: str, our_path: tuple, kind: str) -> Iterator[tuple[str, tuple]]:
    """kind: conv | linear | norm -> (hf key, our leaf path)."""
    yield prefix + ".weight", our_path + ("scale" if kind == "norm" else "kernel",)
    yield prefix + ".bias", our_path + ("bias",)


def _resnet_keys(prefix: str, path: tuple) -> Iterator[tuple[str, tuple]]:
    yield from _leaf_keys(prefix + ".norm1", path + ("norm1",), "norm")
    yield from _leaf_keys(prefix + ".conv1", path + ("conv1",), "conv")
    yield from _leaf_keys(prefix + ".time_emb_proj", path + ("time_emb_proj",), "linear")
    yield from _leaf_keys(prefix + ".norm2", path + ("norm2",), "norm")
    yield from _leaf_keys(prefix + ".conv2", path + ("conv2",), "conv")
    # emitted for every resnet; the loader skips it where the tree has none
    yield from _leaf_keys(prefix + ".conv_shortcut", path + ("conv_shortcut",), "conv")


def _transformer_keys(prefix: str, path: tuple, depth: int) -> Iterator[tuple[str, tuple]]:
    yield from _leaf_keys(prefix + ".norm", path + ("norm",), "norm")
    yield from _leaf_keys(prefix + ".proj_in", path + ("proj_in",), "conv")
    for k in range(depth):
        bp = f"{prefix}.transformer_blocks.{k}"
        op = path + ("blocks", k)
        for norm in ("norm1", "norm2", "norm3"):
            yield from _leaf_keys(bp + "." + norm, op + (norm,), "norm")
        for attn in ("attn1", "attn2"):
            ap = op + (attn,)
            for proj in ("to_q", "to_k", "to_v"):
                yield bp + f".{attn}.{proj}.weight", ap + (proj, "kernel")
            yield from _leaf_keys(bp + f".{attn}.to_out.0", ap + ("to_out",), "linear")
        yield from _leaf_keys(bp + ".ff.net.0.proj", op + ("ff", "proj"), "linear")
        yield from _leaf_keys(bp + ".ff.net.2", op + ("ff", "out"), "linear")
    yield from _leaf_keys(prefix + ".proj_out", path + ("proj_out",), "conv")


def _encoder_keys(cfg: UNetConfig) -> Iterator[tuple[str, tuple]]:
    """The encoder half: conv_in, the time embedding, the down blocks and the
    mid block, named alike in diffusers' UNet2DConditionModel and
    ControlNetModel."""
    yield from _leaf_keys("conv_in", ("conv_in",), "conv")
    yield from _leaf_keys("time_embedding.linear_1", ("time_embedding", "linear_1"), "linear")
    yield from _leaf_keys("time_embedding.linear_2", ("time_embedding", "linear_2"), "linear")
    nb = len(cfg.block_out_channels)
    for i in range(nb):
        base, path = f"down_blocks.{i}", ("down_blocks", i)
        for j in range(cfg.layers_per_block):
            yield from _resnet_keys(f"{base}.resnets.{j}", path + ("resnets", j))
            if cfg.attn_blocks[i]:
                yield from _transformer_keys(f"{base}.attentions.{j}", path + ("attentions", j),
                                             cfg.transformer_layers_per_block[i])
        if i < nb - 1:
            yield from _leaf_keys(f"{base}.downsamplers.0.conv", path + ("downsample",), "conv")
    yield from _resnet_keys("mid_block.resnets.0", ("mid_block", "resnet1"))
    yield from _transformer_keys("mid_block.attentions.0", ("mid_block", "attention"),
                                 cfg.transformer_layers_per_block[-1])
    yield from _resnet_keys("mid_block.resnets.1", ("mid_block", "resnet2"))


def unet_key_map(cfg: UNetConfig) -> dict[str, tuple]:
    """diffusers UNet2DConditionModel -> the UNet tree (models/unet.py)."""
    m: dict[str, tuple] = dict(_encoder_keys(cfg))

    def add(gen):
        m.update(gen)

    nb = len(cfg.block_out_channels)
    for k in range(nb):
        i = nb - 1 - k
        base, path = f"up_blocks.{k}", ("up_blocks", k)
        for j in range(cfg.layers_per_block + 1):
            add(_resnet_keys(f"{base}.resnets.{j}", path + ("resnets", j)))
            if cfg.attn_blocks[i]:
                add(_transformer_keys(f"{base}.attentions.{j}", path + ("attentions", j),
                                      cfg.transformer_layers_per_block[i]))
        if i > 0:
            add(_leaf_keys(f"{base}.upsamplers.0.conv", path + ("upsample",), "conv"))
    add(_leaf_keys("conv_norm_out", ("conv_norm_out",), "norm"))
    add(_leaf_keys("conv_out", ("conv_out",), "conv"))
    return m


def controlnet_key_map(cfg: UNetConfig, num_down: int = 3) -> dict[str, tuple]:
    """diffusers ControlNetModel -> the ControlNet tree (models/controlnet.py).

    The encoder half shares the UNet's names (:func:`_encoder_keys`); the
    extras are the conditioning embedding (diffusers' flat ``blocks.{0..}``:
    even indices the same-width conv1 of a stage, odd ones its stride-2
    conv2) and the zero convs (``controlnet_down_blocks.{i}``,
    ``controlnet_mid_block``).  ``num_down`` is init_controlnet's (3:
    diffusers' ladder)."""
    m: dict[str, tuple] = dict(_encoder_keys(cfg))
    ce = "controlnet_cond_embedding"
    m.update(_leaf_keys(f"{ce}.conv_in", ("cond_embedding", "conv_in"), "conv"))
    for s in range(len(cond_embed_widths(num_down)) - 1):
        m.update(_leaf_keys(f"{ce}.blocks.{2 * s}", ("cond_embedding", "blocks", s, "conv1"),
                            "conv"))
        m.update(_leaf_keys(f"{ce}.blocks.{2 * s + 1}", ("cond_embedding", "blocks", s, "conv2"),
                            "conv"))
    m.update(_leaf_keys(f"{ce}.conv_out", ("cond_embedding", "conv_out"), "conv"))
    for i in range(len(_skip_channels(cfg))):
        m.update(_leaf_keys(f"controlnet_down_blocks.{i}", ("zero_convs", i), "conv"))
    m.update(_leaf_keys("controlnet_mid_block", ("mid_zero_conv",), "conv"))
    return m


def taesd_key_map(cfg: TAESDConfig) -> dict[str, tuple]:
    """diffusers AutoencoderTiny's sequential indices -> the TAESD tree."""
    m: dict[str, tuple] = {}

    def conv(prefix, path):
        m.update(_leaf_keys(prefix, path, "conv"))

    def block(prefix, path):
        # torch Block: conv = Sequential(conv, relu, conv, relu, conv)
        for c in (1, 2, 3):
            conv(f"{prefix}.conv.{(c - 1) * 2}", path + (f"conv{c}",))

    # encoder: 0 conv_in, 1 block_in, then per stage [down, blocks...], conv_out
    conv("encoder.layers.0", ("encoder", "conv_in"))
    block("encoder.layers.1", ("encoder", "block_in"))
    i = 2
    for s in range(cfg.num_stages):
        conv(f"encoder.layers.{i}", ("encoder", "stages", s, "down"))
        i += 1
        for b in range(cfg.blocks_per_stage):
            block(f"encoder.layers.{i}", ("encoder", "stages", s, "blocks", b))
            i += 1
    conv(f"encoder.layers.{i}", ("encoder", "conv_out"))
    # decoder: 0 Clamp, 1 conv_in, 2 ReLU, then per stage [blocks..., Upsample, conv]
    conv("decoder.layers.1", ("decoder", "conv_in"))
    i = 3
    for s in range(cfg.num_stages):
        for b in range(cfg.blocks_per_stage):
            block(f"decoder.layers.{i}", ("decoder", "stages", s, "blocks", b))
            i += 1
        i += 1  # Upsample has no params
        conv(f"decoder.layers.{i}", ("decoder", "stages", s, "up"))
        i += 1
    block(f"decoder.layers.{i}", ("decoder", "block_out"))
    conv(f"decoder.layers.{i + 1}", ("decoder", "conv_out"))
    return m


def clip_key_map(cfg: CLIPTextConfig) -> dict[str, tuple]:
    """transformers CLIPTextModel -> the text tower's tree."""
    m: dict[str, tuple] = {
        "text_model.embeddings.token_embedding.weight": ("token_embedding",),
        "text_model.embeddings.position_embedding.weight": ("position_embedding",),
    }
    pairs = [
        (".layer_norm1", "ln1", "norm"),
        (".self_attn.q_proj", "q", "linear"),
        (".self_attn.k_proj", "k", "linear"),
        (".self_attn.v_proj", "v", "linear"),
        (".self_attn.out_proj", "out", "linear"),
        (".layer_norm2", "ln2", "norm"),
        (".mlp.fc1", "fc1", "linear"),
        (".mlp.fc2", "fc2", "linear"),
    ]
    for i in range(cfg.layers):
        base = f"text_model.encoder.layers.{i}"
        for suffix, ours, kind in pairs:
            m.update(_leaf_keys(base + suffix, ("layers", i, ours), kind))
    m.update(_leaf_keys("text_model.final_layer_norm", ("final_norm",), "norm"))
    return m


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------


def _to_ours(path: tuple, arr: np.ndarray) -> np.ndarray:
    """Checkpoint layout -> the port's: a 2-D ``kernel`` is a torch linear
    [O, I] and becomes [I, O]; a 4-D one is an OIHW conv, as the port keeps
    it; nothing else changes."""
    if path[-1] == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def _lookup(tree, path: tuple):
    """(parent node, True) when every key of ``path`` but the last resolves
    and the last names an existing leaf; else (None, False)."""
    node = tree
    for key in path[:-1]:
        try:
            node = node[key]
        except (KeyError, IndexError, TypeError):
            return None, False
    last = path[-1]
    if isinstance(node, dict):
        return node, last in node
    if isinstance(node, list) and isinstance(last, int):
        return node, last < len(node)
    return None, False


def load_into_tree(params, state_dict: dict, key_map: dict, dtype=torch.float32,
                   strict: bool = True):
    """``(tree, loaded)``: a new tree with leaves replaced from ``state_dict``
    (numpy arrays in the checkpoint's layout), each on the device of the
    leaf it replaces, in ``dtype``.  The input tree is not changed; leaves
    not loaded are shared with it.

    A key whose leaf the tree lacks (a conv_shortcut of a same-width
    resnet) is skipped; a leaf with no key raises KeyError with ``strict``;
    a shape that differs from the leaf's raises ValueError."""
    out = tree_map(lambda a: a, params)  # new containers, the same leaves
    missing, loaded = [], 0
    for hf_key, path in key_map.items():
        node, exists = _lookup(out, path)
        if hf_key not in state_dict:
            if exists and strict:
                missing.append(hf_key)
            continue
        if not exists:
            continue
        arr = _to_ours(path, np.asarray(state_dict[hf_key]))
        old = node[path[-1]]
        if tuple(arr.shape) != tuple(old.shape):
            raise ValueError(
                f"shape mismatch for {hf_key}: checkpoint {arr.shape} vs model "
                f"{tuple(old.shape)}")
        node[path[-1]] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=old.device, dtype=dtype)
        loaded += 1
    if missing and strict:
        raise KeyError(f"{len(missing)} keys missing from checkpoint, e.g. {missing[:5]}")
    return out, loaded


def tree_to_state_dict(params, key_map: dict) -> dict[str, np.ndarray]:
    """Inverse of :func:`load_into_tree`: f32 numpy arrays in the checkpoint
    layout, for the keys whose leaf the tree holds (fixtures, exports)."""
    sd = {}
    for hf_key, path in key_map.items():
        node, exists = _lookup(params, path)
        if not exists:
            continue
        arr = node[path[-1]].detach().float().cpu().numpy()
        sd[hf_key] = np.ascontiguousarray(_to_ours(path, arr), dtype=np.float32)
    return sd


def find_safetensors(model_dir: str, subfolder: str | None = None) -> list[str]:
    """The *.safetensors shards under an HF snapshot dir (or its subfolder)."""
    root = os.path.join(model_dir, subfolder) if subfolder else model_dir
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".safetensors"))
