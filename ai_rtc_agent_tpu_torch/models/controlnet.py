"""ControlNet — the conditioned branch of the UNet (counterpart of
ai_rtc_agent_tpu/models/controlnet.py).

A ControlNet is the UNet's encoder half with (a) a small conv stack that
embeds the conditioning image into latent space and (b) a 1x1 "zero conv"
on every skip output and on the mid block, zero at init, so an untrained
ControlNet is an exact no-op on the base UNet.  Its residuals feed
``unet.apply_unet(down_residuals=..., mid_residual=...)``.

The same param tree as the JAX package's, in the port's layout (NHWC
activations, OIHW conv kernels).  The transformers are the UNet's own
(``unet._transformer``), so they launch the port's attention kernel.

:func:`canny_soft` is the in-graph annotator the tracked configuration
uses (ControlNet-canny); the HED detector is models/hed.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import conv2d, init_conv, silu
from .unet import UNetConfig, _resnet, _transformer, init_unet, time_cond_embedding


def cond_embed_widths(num_down: int = 3) -> tuple:
    """The conditioning embedding's channel ladder: ``num_down`` stride-2
    convs bring the cond image to latent resolution.  num_down=3 gives
    (16, 32, 96, 256), diffusers' ControlNetConditioningEmbedding."""
    ladder = (16, 32, 96, 256)
    if not 1 <= num_down <= len(ladder) - 1:
        raise ValueError(f"num_down must be in [1,{len(ladder)-1}], got {num_down}")
    return ladder[: num_down + 1]


def _skip_channels(cfg: UNetConfig) -> list:
    """The channels of every skip output of the encoder, in order."""
    chs = [cfg.block_out_channels[0]]
    nb = len(cfg.block_out_channels)
    for i, ch in enumerate(cfg.block_out_channels):
        chs.extend([ch] * cfg.layers_per_block)
        if i < nb - 1:
            chs.append(ch)
    return chs


def _zero_conv(c_in: int, c_out: int, k: int, device) -> dict:
    return {"kernel": torch.zeros((c_out, c_in, k, k), device=device),
            "bias": torch.zeros((c_out,), device=device)}


def init_controlnet(gen, cfg: UNetConfig, cond_channels: int = 3, num_down: int = 3,
                    device="cpu") -> dict:
    """Params from ``gen`` (a torch.Generator on ``device``): the encoder
    half of a UNet, the cond embedding (its ``conv_out`` zero) and the zero
    convs (zero)."""
    unet_p = init_unet(gen, cfg, device)
    p = {k: unet_p[k] for k in ("conv_in", "time_embedding", "down_blocks", "mid_block")}
    ch0 = cfg.block_out_channels[0]
    widths = cond_embed_widths(num_down)
    cond = {"conv_in": init_conv(gen, cond_channels, widths[0], 3, device=device), "blocks": []}
    for i in range(len(widths) - 1):
        cond["blocks"].append({
            "conv1": init_conv(gen, widths[i], widths[i], 3, device=device),
            "conv2": init_conv(gen, widths[i], widths[i + 1], 3, device=device),  # stride 2
        })
    cond["conv_out"] = _zero_conv(widths[-1], ch0, 3, device)
    p["cond_embedding"] = cond
    p["zero_convs"] = [_zero_conv(c, c, 1, device) for c in _skip_channels(cfg)]
    mid = cfg.block_out_channels[-1]
    p["mid_zero_conv"] = _zero_conv(mid, mid, 1, device)
    return p


def apply_controlnet(p, x, timesteps, context, cond_image, cfg: UNetConfig,
                     conditioning_scale=1.0, attn_impl: str = "kernel"):
    """-> (down residuals, one per skip, mid residual) for ``apply_unet``.

    ``cond_image``: [B,H,W,3] in [0,1] at image resolution (2**num_down x
    the latent).  ``conditioning_scale``: a number, a 0-d tensor, or one
    value per row ([B] or [B,1,1,1]: each session's scale on its rows),
    cast to the activation dtype as the JAX forward casts it."""
    temb = time_cond_embedding(p, cfg, timesteps, dtype=x.dtype)
    context = context.to(x.dtype)

    ce = p["cond_embedding"]
    c = silu(conv2d(ce["conv_in"], cond_image.to(x.dtype)))
    for blk in ce["blocks"]:
        c = silu(conv2d(blk["conv1"], c))
        c = silu(conv2d(blk["conv2"], c, stride=2, padding=1))
    c = conv2d(ce["conv_out"], c)

    h = conv2d(p["conv_in"], x) + c
    outs = [h]
    for i, blk in enumerate(p["down_blocks"]):
        for j, rn in enumerate(blk["resnets"]):
            h = _resnet(rn, h, temb, cfg.norm_groups)
            if blk["attentions"]:
                h = _transformer(blk["attentions"][j], h, context, cfg,
                                 cfg.num_heads_per_block[i], attn_impl)
            outs.append(h)
        if blk["downsample"] is not None:
            h = conv2d(blk["downsample"], h, stride=2, padding=1)
            outs.append(h)

    mb = p["mid_block"]
    h = _resnet(mb["resnet1"], h, temb, cfg.norm_groups)
    h = _transformer(mb["attention"], h, context, cfg, cfg.num_heads_per_block[-1], attn_impl)
    h = _resnet(mb["resnet2"], h, temb, cfg.norm_groups)

    scale = torch.as_tensor(conditioning_scale, device=x.device).to(x.dtype)
    if scale.ndim:
        scale = scale.reshape(-1, 1, 1, 1)
    down = [conv2d(zc, o) * scale for zc, o in zip(p["zero_convs"], outs)]
    return down, conv2d(p["mid_zero_conv"], h) * scale


def canny_soft(img_nhwc, low: float = 0.1, high: float = 0.3):
    """The soft-Canny edge map: Sobel gradient magnitude on luma with a
    smooth double threshold, as 3-channel [0,1] NHWC in the input's dtype
    (the JAX annotator; its "SAME" 3x3 conv pads 1 with zeros)."""
    luma = (0.299 * img_nhwc[..., 0] + 0.587 * img_nhwc[..., 1]
            + 0.114 * img_nhwc[..., 2])[:, None]  # [N,1,H,W]
    # Sobel [[-1,0,1],[-2,0,2],[-1,0,1]] / 4 made on the device (no host
    # tensor crosses, so a CUDA graph captures it): [1,2,1] outer [-1,0,1]
    d = torch.arange(-1, 2, dtype=img_nhwc.dtype, device=img_nhwc.device)
    kx = (2 - d.abs())[:, None] * d[None, :] / 4.0
    k = torch.stack([kx, kx.T])[:, None]  # [2,1,3,3]: x then y
    g = F.conv2d(luma, k, padding=1)
    gx, gy = g[:, 0], g[:, 1]
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    edge = torch.sigmoid((mag - low) / max(high - low, 1e-6) * 12.0 - 6.0)
    return edge[..., None].expand(*edge.shape, 3)
