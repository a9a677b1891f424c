"""Conditional diffusion UNet (SD1.5 / SD2.1 / SD-Turbo / SDXL geometry).

Counterpart of ai_rtc_agent_tpu/models/unet.py: the same config, param
tree and forward, NHWC, with the DeepCache pair (``deep_cache="capture"``
/ ``"use"``), the ControlNet residuals (models/controlnet.py) and SDXL's
``text_time`` addition embedding (``added_cond``: the pooled text embeds
and the six micro-conditioning time ids, added to the timestep embedding).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .layers import (
    attention,
    conv2d,
    geglu_ff,
    group_norm,
    init_attention,
    init_conv,
    init_geglu_ff,
    init_linear,
    init_norm,
    layer_norm,
    linear,
    silu,
    timestep_embedding,
)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads_per_block: tuple = (8, 8, 8, 8)
    attn_blocks: tuple = (True, True, True, False)
    transformer_layers_per_block: tuple = (1, 1, 1, 1)
    use_linear_projection: bool = False
    norm_groups: int = 32
    # SDXL's addition embedding ("text_time"): pooled text + time ids
    addition_embed_type: str | None = None
    addition_time_embed_dim: int = 0
    addition_pooled_dim: int = 0
    addition_num_time_ids: int = 6

    @property
    def temb_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def sd21() -> "UNetConfig":
        """SD2.1 geometry — also SD-Turbo (stabilityai/sd-turbo)."""
        return UNetConfig(
            cross_attention_dim=1024,
            num_heads_per_block=(5, 10, 20, 20),
            use_linear_projection=True,
        )

    @staticmethod
    def sdxl() -> "UNetConfig":
        """SDXL geometry — also SDXL-Turbo: three tiers, no attention at the
        first, transformer depths 1/2/10 (the mid block's is the last)."""
        return UNetConfig(
            block_out_channels=(320, 640, 1280),
            cross_attention_dim=2048,
            num_heads_per_block=(5, 10, 20),
            attn_blocks=(False, True, True),
            transformer_layers_per_block=(1, 2, 10),
            use_linear_projection=True,
            addition_embed_type="text_time",
            addition_time_embed_dim=256,
            addition_pooled_dim=1280,
        )

    @staticmethod
    def tiny(cross_dim: int = 32) -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(8, 16),
            layers_per_block=1,
            cross_attention_dim=cross_dim,
            num_heads_per_block=(2, 2),
            attn_blocks=(True, False),
            transformer_layers_per_block=(1, 1),
            norm_groups=4,
        )

    @staticmethod
    def tiny_xl(cross_dim: int = 32) -> "UNetConfig":
        """Miniature with SDXL's topology and addition embedding."""
        return UNetConfig(
            block_out_channels=(8, 16),
            layers_per_block=1,
            cross_attention_dim=cross_dim,
            num_heads_per_block=(2, 2),
            attn_blocks=(False, True),
            transformer_layers_per_block=(1, 2),
            use_linear_projection=True,
            norm_groups=4,
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            addition_pooled_dim=16,
        )


# --------------------------------------------------------------------------
# init (random weights at full architecture; same tree as the JAX init)
# --------------------------------------------------------------------------


def _init_resnet(gen, in_ch, out_ch, temb_dim, device):
    p = {
        "norm1": init_norm(in_ch, device),
        "conv1": init_conv(gen, in_ch, out_ch, 3, device=device),
        "time_emb_proj": init_linear(gen, temb_dim, out_ch, device=device),
        "norm2": init_norm(out_ch, device),
        "conv2": init_conv(gen, out_ch, out_ch, 3, scale=0.5, device=device),
    }
    if in_ch != out_ch:
        p["conv_shortcut"] = init_conv(gen, in_ch, out_ch, 1, device=device)
    return p


def _init_transformer(gen, ch, cfg: UNetConfig, depth, heads, device):
    proj = (
        (lambda s: init_linear(gen, ch, ch, scale=s, device=device))
        if cfg.use_linear_projection
        else (lambda s: init_conv(gen, ch, ch, 1, scale=s, device=device))
    )
    p = {"norm": init_norm(ch, device), "proj_in": proj(1.0), "blocks": []}
    p["proj_out"] = proj(0.2)
    for _ in range(depth):
        p["blocks"].append(
            {
                "norm1": init_norm(ch, device),
                "attn1": init_attention(gen, ch, None, heads, ch // heads, device),
                "norm2": init_norm(ch, device),
                "attn2": init_attention(
                    gen, ch, cfg.cross_attention_dim, heads, ch // heads, device
                ),
                "norm3": init_norm(ch, device),
                "ff": init_geglu_ff(gen, ch, device=device),
            }
        )
    return p


def init_unet(gen, cfg: UNetConfig, device="cpu"):
    nb = len(cfg.block_out_channels)
    ch0 = cfg.block_out_channels[0]
    p: dict = {
        "conv_in": init_conv(gen, cfg.in_channels, ch0, 3, device=device),
        "time_embedding": {
            "linear_1": init_linear(gen, ch0, cfg.temb_dim, device=device),
            "linear_2": init_linear(gen, cfg.temb_dim, cfg.temb_dim, device=device),
        },
        "down_blocks": [],
        "up_blocks": [],
        "conv_norm_out": init_norm(ch0, device),
        "conv_out": init_conv(gen, ch0, cfg.out_channels, 3, scale=0.2, device=device),
    }
    if cfg.addition_embed_type == "text_time":
        in_dim = cfg.addition_time_embed_dim * cfg.addition_num_time_ids + cfg.addition_pooled_dim
        p["add_embedding"] = {
            "linear_1": init_linear(gen, in_dim, cfg.temb_dim, device=device),
            "linear_2": init_linear(gen, cfg.temb_dim, cfg.temb_dim, device=device),
        }
    out_ch = ch0
    skip_chs = [ch0]
    for i, ch in enumerate(cfg.block_out_channels):
        in_ch, out_ch = out_ch, ch
        blk = {"resnets": [], "attentions": [], "downsample": None}
        for j in range(cfg.layers_per_block):
            blk["resnets"].append(
                _init_resnet(gen, in_ch if j == 0 else out_ch, out_ch, cfg.temb_dim, device)
            )
            if cfg.attn_blocks[i]:
                blk["attentions"].append(
                    _init_transformer(
                        gen, out_ch, cfg, cfg.transformer_layers_per_block[i],
                        cfg.num_heads_per_block[i], device,
                    )
                )
            skip_chs.append(out_ch)
        if i < nb - 1:
            blk["downsample"] = init_conv(gen, out_ch, out_ch, 3, device=device)
            skip_chs.append(out_ch)
        p["down_blocks"].append(blk)

    mid_ch = cfg.block_out_channels[-1]
    p["mid_block"] = {
        "resnet1": _init_resnet(gen, mid_ch, mid_ch, cfg.temb_dim, device),
        "attention": _init_transformer(
            gen, mid_ch, cfg, cfg.transformer_layers_per_block[-1],
            cfg.num_heads_per_block[-1], device,
        ),
        "resnet2": _init_resnet(gen, mid_ch, mid_ch, cfg.temb_dim, device),
    }

    prev_ch = mid_ch
    for i in reversed(range(nb)):
        ch = cfg.block_out_channels[i]
        blk = {"resnets": [], "attentions": [], "upsample": None}
        for _ in range(cfg.layers_per_block + 1):
            skip = skip_chs.pop()
            blk["resnets"].append(_init_resnet(gen, prev_ch + skip, ch, cfg.temb_dim, device))
            prev_ch = ch
            if cfg.attn_blocks[i]:
                blk["attentions"].append(
                    _init_transformer(
                        gen, ch, cfg, cfg.transformer_layers_per_block[i],
                        cfg.num_heads_per_block[i], device,
                    )
                )
        if i > 0:
            blk["upsample"] = init_conv(gen, ch, ch, 3, device=device)
        p["up_blocks"].append(blk)
    assert not skip_chs
    return p


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------


def _resnet(p, x, temb, groups: int = 32):
    h = group_norm(p["norm1"], x, groups)
    h = conv2d(p["conv1"], silu(h))
    h = h + linear(p["time_emb_proj"], silu(temb))[:, None, None, :]
    h = group_norm(p["norm2"], h, groups)
    h = conv2d(p["conv2"], silu(h))
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x)
    return x + h


def _transformer(p, x, context, cfg: UNetConfig, heads: int, attn_impl: str):
    n, h, w, c = x.shape
    residual = x
    z = group_norm(p["norm"], x, cfg.norm_groups)
    if cfg.use_linear_projection:
        z = linear(p["proj_in"], z.reshape(n, h * w, c))
    else:
        z = conv2d(p["proj_in"], z).reshape(n, h * w, c)
    for blk in p["blocks"]:
        z = z + attention(blk["attn1"], layer_norm(blk["norm1"], z), None, heads, attn_impl)
        z = z + attention(blk["attn2"], layer_norm(blk["norm2"], z), context, heads, attn_impl)
        z = z + geglu_ff(blk["ff"], layer_norm(blk["norm3"], z))
    if cfg.use_linear_projection:
        z = linear(p["proj_out"], z).reshape(n, h, w, c)
    else:
        z = conv2d(p["proj_out"], z.reshape(n, h, w, c))
    return z + residual


def upsample2x(x):
    """Nearest 2x upsample, NHWC."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, h * 2, w * 2, c)


def time_cond_embedding(p, cfg: UNetConfig, timesteps, added_cond=None, dtype=torch.float32):
    """The timestep embedding [B, temb_dim], plus SDXL's ``text_time``
    addition: ``added_cond`` {"time_ids": [B, 6], "text_embeds": [B, pooled]}
    (a ``text_time`` config without it raises ValueError)."""
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0], dtype=dtype)
    te = p["time_embedding"]
    temb = linear(te["linear_2"], silu(linear(te["linear_1"], temb)))
    if cfg.addition_embed_type == "text_time":
        if added_cond is None:
            raise ValueError("SDXL-style config requires added_cond")
        time_ids = added_cond["time_ids"]
        b = time_ids.shape[0]
        tid = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                 dtype=dtype).reshape(b, -1)
        add = torch.cat([added_cond["text_embeds"].to(dtype), tid], dim=-1)
        ae = p["add_embedding"]
        temb = temb + linear(ae["linear_2"], silu(linear(ae["linear_1"], add)))
    return temb


def deep_cache_shape(cfg: UNetConfig, x_shape) -> tuple:
    """The shape of the feature ``deep_cache="capture"`` returns for a UNet
    input of ``x_shape`` [n,h,w,c]: the input of the outermost up block, at
    the latent resolution, with the channels of the tier above it."""
    n, h, w = x_shape[:3]
    return (n, h, w, cfg.block_out_channels[min(1, len(cfg.block_out_channels) - 1)])


def apply_unet(p, x, timesteps, context, cfg: UNetConfig, attn_impl: str = "kernel",
               deep_cache: str = "off", cached_h=None, down_residuals=None, mid_residual=None,
               added_cond=None):
    """x [B,h,w,Cin], timesteps [B], context [B,L,cross_dim] -> [B,h,w,Cout];
    ``added_cond``: SDXL's addition conditioning (:func:`time_cond_embedding`).

    ``deep_cache`` (DeepCache, the JAX static-cadence variant: two fixed
    graphs, no data-dependent control flow):
      - "off":     the plain forward;
      - "capture": the plain forward that also returns the feature entering
                   the outermost up block -> (out, deep_h);
      - "use":     only the outermost tier (conv_in, the first down block,
                   the last up block) around ``cached_h``, spliced in for the
                   deep remainder; with identical inputs and a cache captured
                   from them the output equals the full pass exactly.
    ``down_residuals``/``mid_residual`` (ControlNet's, one per skip and one
    for the mid block) are added to the skips and to the mid block's output,
    as in the JAX forward; "use" refuses them (they feed the skipped deep
    blocks)."""
    nb = len(cfg.block_out_channels)
    temb = time_cond_embedding(p, cfg, timesteps, added_cond, dtype=x.dtype)
    context = context.to(x.dtype)
    if deep_cache == "use" and (down_residuals is not None or mid_residual is not None):
        raise ValueError("deep_cache='use' is incompatible with ControlNet residuals "
                         "(they feed the skipped deep blocks)")

    if deep_cache == "use":
        if cached_h is None:
            raise ValueError("deep_cache='use' requires cached_h")
        h = conv2d(p["conv_in"], x)
        skips = [h]
        blk0 = p["down_blocks"][0]
        for j, rn in enumerate(blk0["resnets"]):
            h = _resnet(rn, h, temb, cfg.norm_groups)
            if blk0["attentions"]:
                h = _transformer(blk0["attentions"][j], h, context, cfg,
                                 cfg.num_heads_per_block[0], attn_impl)
            skips.append(h)
        blk = p["up_blocks"][-1]
        if len(blk["resnets"]) != len(skips):
            raise ValueError(
                f"deep-cache skip mismatch: outermost up block wants {len(blk['resnets'])} "
                f"skips, shallow pass made {len(skips)}")
        h = cached_h.to(x.dtype)
        for j, rn in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _resnet(rn, h, temb, cfg.norm_groups)
            if blk["attentions"]:
                h = _transformer(blk["attentions"][j], h, context, cfg,
                                 cfg.num_heads_per_block[0], attn_impl)
        h = group_norm(p["conv_norm_out"], h, cfg.norm_groups)
        return conv2d(p["conv_out"], silu(h))

    h = conv2d(p["conv_in"], x)
    skips = [h]
    for i, blk in enumerate(p["down_blocks"]):
        for j, rn in enumerate(blk["resnets"]):
            h = _resnet(rn, h, temb, cfg.norm_groups)
            if blk["attentions"]:
                h = _transformer(
                    blk["attentions"][j], h, context, cfg, cfg.num_heads_per_block[i], attn_impl
                )
            skips.append(h)
        if blk["downsample"] is not None:
            h = conv2d(blk["downsample"], h, stride=2, padding=1)
            skips.append(h)

    if down_residuals is not None:
        if len(down_residuals) != len(skips):
            raise ValueError(f"expected {len(skips)} down residuals, got {len(down_residuals)}")
        skips = [s + r.to(s.dtype) for s, r in zip(skips, down_residuals)]

    mb = p["mid_block"]
    h = _resnet(mb["resnet1"], h, temb, cfg.norm_groups)
    h = _transformer(mb["attention"], h, context, cfg, cfg.num_heads_per_block[-1], attn_impl)
    h = _resnet(mb["resnet2"], h, temb, cfg.norm_groups)
    if mid_residual is not None:
        h = h + mid_residual.to(h.dtype)

    deep_h = None
    for k, blk in enumerate(p["up_blocks"]):
        i = nb - 1 - k
        if k == len(p["up_blocks"]) - 1 and deep_cache == "capture":
            deep_h = h  # the feature the "use" pass splices back in
        for j, rn in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _resnet(rn, h, temb, cfg.norm_groups)
            if blk["attentions"]:
                h = _transformer(
                    blk["attentions"][j], h, context, cfg, cfg.num_heads_per_block[i], attn_impl
                )
        if blk["upsample"] is not None:
            h = conv2d(blk["upsample"], upsample2x(h))

    h = group_norm(p["conv_norm_out"], h, cfg.norm_groups)
    out = conv2d(p["conv_out"], silu(h))
    return (out, deep_h) if deep_cache == "capture" else out
