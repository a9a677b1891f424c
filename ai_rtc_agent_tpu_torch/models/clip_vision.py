"""CLIP vision tower (ViT) — the safety checker's image embedding.

Counterpart of ai_rtc_agent_tpu/models/clip_vision.py: NHWC patches
through an OIHW patch-embedding conv, non-causal attention as plain
matmuls (f32 softmax), class-token pooling between the pre and post layer
norms, HF's architecture.

:func:`preprocess_clip` resizes as the JAX package's
``jax.image.resize(method="cubic")`` does: Keys' cubic (a = -0.5),
antialiased when downsampling (the kernel widened by the scale), each
output's weights normalised to sum 1 — written out here as the same
separable weight matrices that ``jax.image.scale_and_translate`` builds.
``F.interpolate(mode="bicubic")`` would not do: its cubic has a = -0.75
and no antialias.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .layers import ACTIVATIONS, _normal, conv2d, init_linear, init_norm, layer_norm, linear

# CLIP's pixel normalisation constants (OpenAI ViT-L/14 preprocessing)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    activation: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def vit_l14() -> "CLIPVisionConfig":
        """The safety checker's tower (openai/clip-vit-large-patch14)."""
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=8, width=32, layers=2, heads=4)


def init_clip_vision(gen, cfg: CLIPVisionConfig, device="cpu"):
    w = cfg.width
    p = {
        "patch_embedding": {"kernel": _normal(gen, (w, 3, cfg.patch_size, cfg.patch_size), 0.02,
                                              device)},
        "class_embedding": _normal(gen, (w,), 0.02, device),
        "position_embedding": _normal(gen, (cfg.num_patches + 1, w), 0.01, device),
        "pre_norm": init_norm(w, device),
        "post_norm": init_norm(w, device),
        "layers": [],
    }
    for _ in range(cfg.layers):
        p["layers"].append({
            "ln1": init_norm(w, device),
            **{name: init_linear(gen, w, w, device=device) for name in ("q", "k", "v", "out")},
            "ln2": init_norm(w, device),
            "fc1": init_linear(gen, w, w * 4, device=device),
            "fc2": init_linear(gen, w * 4, w, device=device),
        })
    return p


def _attn(layer, x, heads: int):
    b, n, d = x.shape
    hd = d // heads
    q = linear(layer["q"], x).reshape(b, n, heads, hd)
    k = linear(layer["k"], x).reshape(b, n, heads, hd)
    v = linear(layer["v"], x).reshape(b, n, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd**-0.5
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    return linear(layer["out"], torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, d))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] f32: output j = sum_i w[i, j] * input i, the
    antialiased Keys-cubic resampling of ``jax.image.resize`` (its
    ``compute_weight_mat`` with scale out/in, no translation)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / np.float32(
        kernel_scale)
    weights = _keys_cubic(x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


@lru_cache(maxsize=16)
def _resize_matrix(in_size: int, out_size: int, device: torch.device, dtype: torch.dtype):
    """:func:`resize_weights` as a tensor on ``device``, built and uploaded
    once per (sizes, device, dtype): the served checker resizes every frame
    at the same sizes."""
    # tpurtc: allow[device-transfer] -- a constant placed once per (sizes, device, dtype) by the lru_cache, like a parameter; no frame crosses here
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device=device, dtype=dtype)


def preprocess_clip(img01_nhwc, cfg: CLIPVisionConfig):
    """[N,H,W,3] in [0,1] -> [N,S,S,3], HF ``CLIPFeatureExtractor``'s way:
    a shortest-edge cubic resize to S, a centre crop to SxS (not a squash),
    then CLIP's normalisation."""
    n, h, w, c = img01_nhwc.shape
    s = cfg.image_size
    x = img01_nhwc
    if (h, w) != (s, s):
        if h <= w:
            rh, rw = s, max(s, int(round(w * s / h)))
        else:
            rh, rw = max(s, int(round(h * s / w))), s
        if rh != h:
            x = torch.einsum("nhwc,hy->nywc", x, _resize_matrix(h, rh, x.device, x.dtype))
        if rw != w:
            x = torch.einsum("nywc,wx->nyxc", x, _resize_matrix(w, rw, x.device, x.dtype))
        top, left = (rh - s) // 2, (rw - s) // 2
        x = x[:, top: top + s, left: left + s, :]
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def apply_clip_vision(p, img_nhwc, cfg: CLIPVisionConfig):
    """Preprocessed [N,S,S,3] -> {"hidden": [N,L,width], "pooled": [N,width]}."""
    n = img_nhwc.shape[0]
    patches = conv2d(p["patch_embedding"], img_nhwc, stride=cfg.patch_size, padding=0)
    x = patches.reshape(n, -1, cfg.width)
    cls = p["class_embedding"].to(x.dtype).expand(n, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + p["position_embedding"][: x.shape[1]].to(x.dtype)
    x = layer_norm(p["pre_norm"], x)
    for layer in p["layers"]:
        x = x + _attn(layer, layer_norm(layer["ln1"], x), cfg.heads)
        h = ACTIVATIONS[cfg.activation](linear(layer["fc1"], layer_norm(layer["ln2"], x)))
        x = x + linear(layer["fc2"], h)
    return {"hidden": x, "pooled": layer_norm(p["post_norm"], x[:, 0])}
