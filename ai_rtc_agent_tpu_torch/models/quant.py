"""Int8 weight-only quantization (w8a16) of the serving params — counterpart
of ai_rtc_agent_tpu/models/quant.py.

Large kernels are stored as int8 plus a per-output-channel f32 scale; the
two primitives (models/layers.linear / conv2d) dequantize inside the step
(``kernel_q.to(dtype) * scale.to(dtype)``), so the int8 tensor is what sits
in device memory and a captured step carries the dequant.  Per-channel
symmetric max-abs scaling; tensors smaller than ``min_size`` elements stay
dense (norms, biases and embeddings keep full precision).

The output axis follows the port's layout: linear kernels keep the JAX
[in, out] layout (axis -1, as in JAX), conv kernels are OIHW (axis 0, where
the JAX HWIO tree uses axis -1), so ``bridge.params_from_jax`` of a
quantized JAX tree equals ``quantize_params`` of the carried-over dense tree.
The arithmetic is the JAX package's: f32 amax / 127, a zero scale replaced
by 1, round half to even, clip to [-127, 127].
"""

from __future__ import annotations

import torch

#: leaves with at least this many elements are quantized; smaller ones stay dense
MIN_SIZE = 1 << 14


def quantize_tensor(w: torch.Tensor, axis: int = -1) -> tuple:
    """float kernel -> (int8 kernel, f32 per-channel scale along ``axis``,
    keepdims)."""
    w = w.float()
    axis = axis % w.ndim
    amax = w.abs().amax(dim=tuple(i for i in range(w.ndim) if i != axis), keepdim=True)
    scale = amax / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(p: dict, dtype) -> torch.Tensor:
    """The kernel of a {kernel_q, scale} dict in ``dtype`` (the primitives'
    dequant, models/layers.py)."""
    return p["kernel_q"].to(dtype) * p["scale"].to(dtype)


def quantize_params(params, min_size: int = MIN_SIZE) -> tuple:
    """Replace every floating ``kernel`` leaf of rank >= 2 with at least
    ``min_size`` elements by a {kernel_q, scale} pair.  -> (a new tree, the
    number of kernels quantized); every other leaf is the same tensor."""
    n = 0

    def walk(node):
        nonlocal n
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if (k == "kernel" and isinstance(v, torch.Tensor) and v.ndim >= 2
                        and v.numel() >= min_size and v.is_floating_point()):
                    # the output axis: 0 of an OIHW conv, -1 of a linear [in, out]
                    out["kernel_q"], out["scale"] = quantize_tensor(v, 0 if v.ndim == 4 else -1)
                    n += 1
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params), n


def quantized_bytes_saved(params) -> int:
    """Device bytes saved against bf16 storage: one byte per int8 element."""
    if isinstance(params, dict):
        return sum(v.numel() if k == "kernel_q" else quantized_bytes_saved(v)
                   for k, v in params.items())
    if isinstance(params, list):
        return sum(quantized_bytes_saved(v) for v in params)
    return 0


def has_quantized_kernels(tree) -> bool:
    """True when a {kernel_q, scale} pair is reachable through dicts alone:
    the JAX engine's ``_has_quantized_kernels``, which does not descend
    lists, so that the engine key and the snapshot fingerprint say ``quant``
    exactly when the JAX package's do."""
    if isinstance(tree, dict):
        return any(k == "kernel_q" or has_quantized_kernels(v) for k, v in tree.items())
    return False
