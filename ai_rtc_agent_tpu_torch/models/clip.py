"""CLIP text tower — counterpart of ai_rtc_agent_tpu/models/clip.py.

Runs once per prompt (not per frame), so its attention stays plain: an
additive -1e9 causal mask, f32 softmax.  ``hidden`` is the final-normed
sequence when clip_skip == 0, else the hidden state clip_skip layers from
the end; ``pooled`` is the final-normed state at the EOT token (argmax of
the ids); a tower with ``use_text_projection`` (SDXL's second, OpenCLIP
ViT-bigG) also gives ``projected``, the pooled state through its bias-free
``text_projection`` (the pooled embeds of SDXL's addition embedding).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .layers import (
    ACTIVATIONS,
    _normal,
    causal_mask,
    init_linear,
    init_norm,
    layer_norm,
    linear,
)


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    activation: str = "quick_gelu"
    clip_skip: int = 0
    use_text_projection: bool = False
    projection_dim: int = 0

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sd21() -> "CLIPTextConfig":
        return CLIPTextConfig(width=1024, layers=24, heads=16, activation="gelu", clip_skip=1)

    @staticmethod
    def sdxl_g() -> "CLIPTextConfig":
        """SDXL's second tower (OpenCLIP ViT-bigG): penultimate hidden
        states and the projected pooled state."""
        return CLIPTextConfig(width=1280, layers=32, heads=20, activation="gelu", clip_skip=1,
                              use_text_projection=True, projection_dim=1280)

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=256, max_length=16, width=32, layers=2, heads=4)

    @staticmethod
    def tiny_dual() -> "CLIPTextConfig":
        """First tower of the tiny SDXL-style family (half width, so the two
        towers concatenate to tiny_xl's cross dim)."""
        return CLIPTextConfig(vocab_size=256, max_length=16, width=16, layers=2, heads=2)

    @staticmethod
    def tiny_g() -> "CLIPTextConfig":
        """Second (projected) tower of the tiny SDXL-style family."""
        return CLIPTextConfig(vocab_size=256, max_length=16, width=16, layers=2, heads=2,
                              use_text_projection=True, projection_dim=16)


def init_clip_text(gen, cfg: CLIPTextConfig, device="cpu"):
    p = {
        "token_embedding": _normal(gen, (cfg.vocab_size, cfg.width), 0.02, device),
        "position_embedding": _normal(gen, (cfg.max_length, cfg.width), 0.01, device),
        "final_norm": init_norm(cfg.width, device),
        "layers": [],
    }
    for _ in range(cfg.layers):
        p["layers"].append(
            {
                "ln1": init_norm(cfg.width, device),
                **{
                    name: init_linear(gen, cfg.width, cfg.width, device=device)
                    for name in ("q", "k", "v", "out")
                },
                "ln2": init_norm(cfg.width, device),
                "fc1": init_linear(gen, cfg.width, cfg.width * 4, device=device),
                "fc2": init_linear(gen, cfg.width * 4, cfg.width, device=device),
            }
        )
    if cfg.use_text_projection:
        p["text_projection"] = init_linear(gen, cfg.width, cfg.projection_dim, bias=False,
                                           device=device)
    return p


def _attn(layer, x, mask, heads: int):
    b, l, d = x.shape
    hd = d // heads
    q = linear(layer["q"], x).reshape(b, l, heads, hd)
    k = linear(layer["k"], x).reshape(b, l, heads, hd)
    v = linear(layer["v"], x).reshape(b, l, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd**-0.5 + mask
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    return linear(layer["out"], torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, d))


def apply_clip_text(p, token_ids, cfg: CLIPTextConfig, dtype=torch.float32):
    """token_ids [B, L] int -> {"hidden": [B,L,width], "pooled": [B,width]},
    plus "projected" [B,projection_dim] with ``use_text_projection``."""
    b, l = token_ids.shape
    x = p["token_embedding"][token_ids].to(dtype)
    x = x + p["position_embedding"][:l].to(dtype)
    mask = causal_mask(l, device=x.device)
    hiddens = [x]
    for layer in p["layers"]:
        x = x + _attn(layer, layer_norm(layer["ln1"], x), mask, cfg.heads)
        h = ACTIVATIONS[cfg.activation](linear(layer["fc1"], layer_norm(layer["ln2"], x)))
        x = x + linear(layer["fc2"], h)
        hiddens.append(x)
    final = layer_norm(p["final_norm"], x)
    hidden = final if cfg.clip_skip == 0 else hiddens[-1 - cfg.clip_skip]
    eot = torch.argmax(token_ids, dim=-1)
    pooled = final[torch.arange(b, device=final.device), eot]
    out = {"hidden": hidden, "pooled": pooled}
    if cfg.use_text_projection and "text_projection" in p:
        out["projected"] = linear(p["text_projection"], pooled)
    return out
