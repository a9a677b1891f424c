"""Plain PyTorch reference of the served networks: the CLIP text tower, the
diffusion UNet (SD1.5 / SD2.1 geometry) and TAESD.

Written from the published architectures (diffusers' UNet2DConditionModel,
transformers' CLIPTextModel, madebyollin/taesd), over parameter trees keyed
as the benchmark's weight maker (params.py) keys them.  NCHW, float32 by
default, no kernels, no cache, no batching tricks: every product is an
einsum, ``@`` or ``F.conv2d`` on float32 tensors.  It imports nothing of
the program under test.

Where the served configuration departs from the published model, this file
follows the program's configuration, not the published model (the
configuration files list each departure under ``departures`` and
``reduced``): the SD2.1 text tower's penultimate hidden state is taken
without the final LayerNorm, the transformers' GroupNorm uses eps 1e-5, and
the token ids come from the hash tokenizer that random weights are served
with.

``Precision("fp8")`` is the control of the correctness check: weights and
the inputs of every product are rounded to float8 e4m3 (one scale per
tensor), the products then run in float32.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Precision:
    """How the reference rounds weights and the operands of its products:
    ``f32`` (the reference) or ``fp8`` (the control)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}: f32 or fp8")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.kind == "f32" or t.device.type == "meta":
            return t
        scale = FP8_MAX / t.abs().amax().clamp(min=1e-12)
        return (t * scale).to(torch.float8_e4m3fn).float() / scale

    def tree(self, tree):
        """The weights as the reference reads them: float32 copies, rounded
        to fp8 for the control."""
        if isinstance(tree, dict):
            return {k: self.tree(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self.tree(v) for v in tree]
        return None if tree is None else self.q(tree)


F32 = Precision("f32")

# -- primitives ------------------------------------------------------------------


def linear(p, x, pr: Precision):
    y = pr.q(x) @ p["kernel"]  # kernels are [in, out]
    return y + p["bias"] if "bias" in p else y


def conv(p, x, pr: Precision, stride: int = 1, padding: int | None = None):
    w = p["kernel"]  # OIHW
    pad = w.shape[-1] // 2 if padding is None else padding
    return F.conv2d(pr.q(x), w, p.get("bias"), stride=stride, padding=pad)


def group_norm(p, x, groups: int, eps: float = 1e-5):
    c = x.shape[1]
    g = min(groups, c)
    while c % g:
        g -= 1
    return F.group_norm(x, g, p["scale"], p["bias"], eps)


def layer_norm(p, x, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def attention_core(q, k, v, pr: Precision, mask=None, block: int = 1024):
    """softmax(q k^T / sqrt(d)) v over [B, L, H, D], float32, in blocks of
    query rows so that a 4096-token self-attention fits."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = pr.q(q), pr.q(k), pr.q(v)
    outs = []
    for s in range(0, q.shape[1], block):
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s:s + block], k) * scale
        if mask is not None:
            logits = logits + mask[..., s:s + block, :]
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", pr.q(w), v))
    return torch.cat(outs, dim=1)


def mha(p, x, context, heads: int, pr: Precision, mask=None):
    ctx = x if context is None else context
    b, lq, _ = x.shape
    q = linear(p["to_q"], x, pr)
    k = linear(p["to_k"], ctx, pr)
    v = linear(p["to_v"], ctx, pr)
    d = q.shape[-1] // heads
    o = attention_core(q.reshape(b, lq, heads, d), k.reshape(b, -1, heads, d),
                       v.reshape(b, -1, heads, d), pr, mask)
    return linear(p["to_out"], o.reshape(b, lq, heads * d), pr)


# -- text tower --------------------------------------------------------------------


def hash_tokens(text: str, vocab_size: int, max_length: int) -> list:
    """The ids that random-weight serving gives a prompt (no vocabulary
    file): BOS, one hashed id per word, EOS, EOS padding."""
    bos, eos = vocab_size - 2, vocab_size - 1
    ids = [bos]
    for word in re.findall(r"\w+", text.lower()):
        h = 0
        for ch in word:
            h = (h * 131 + ord(ch)) % (vocab_size - 2)
        ids.append(h)
    ids = ids[: max_length - 1] + [eos]
    return ids + [eos] * (max_length - len(ids))


def clip_text(p, ids, cfg: dict, pr: Precision = F32):
    """ids [B, L] -> the conditioning [B, L, width]: the final-normed last
    layer (clip_skip 0) or the hidden state clip_skip layers from the end."""
    b, length = ids.shape
    x = p["token_embedding"][ids] + p["position_embedding"][:length]
    mask = torch.full((length, length), -1e9, device=x.device).triu(1)[None, None]
    heads = cfg["heads"]
    act = {"gelu": lambda t: F.gelu(t),
           "quick_gelu": lambda t: t * torch.sigmoid(1.702 * t)}[cfg["activation"]]
    hiddens = [x]
    for layer in p["layers"]:
        h = layer_norm(layer["ln1"], x)
        d = x.shape[-1] // heads
        q, k, v = (linear(layer[n], h, pr).reshape(b, length, heads, d) for n in "qkv")
        o = attention_core(q, k, v, pr, mask).reshape(b, length, -1)
        x = x + linear(layer["out"], o, pr)
        x = x + linear(layer["fc2"], act(linear(layer["fc1"], layer_norm(layer["ln2"], x), pr)), pr)
        hiddens.append(x)
    if cfg["clip_skip"] == 0:
        return layer_norm(p["final_norm"], x)
    return hiddens[-1 - cfg["clip_skip"]]


# -- UNet -------------------------------------------------------------------------------


def timestep_embedding(t, dim: int):
    """[B] -> [B, dim], cos first (flip_sin_to_cos), frequency shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def resnet(p, x, temb, groups: int, pr: Precision):
    h = conv(p["conv1"], F.silu(group_norm(p["norm1"], x, groups)), pr)
    h = h + linear(p["time_emb_proj"], F.silu(temb), pr)[:, :, None, None]
    h = conv(p["conv2"], F.silu(group_norm(p["norm2"], h, groups)), pr)
    if "conv_shortcut" in p:
        x = conv(p["conv_shortcut"], x, pr)
    return x + h


def transformer(p, x, context, heads: int, cfg: dict, pr: Precision):
    n, c, h, w = x.shape
    z = group_norm(p["norm"], x, cfg["norm_groups"])
    if cfg["use_linear_projection"]:
        z = linear(p["proj_in"], z.permute(0, 2, 3, 1).reshape(n, h * w, c), pr)
    else:
        z = conv(p["proj_in"], z, pr).permute(0, 2, 3, 1).reshape(n, h * w, c)
    for blk in p["blocks"]:
        z = z + mha(blk["attn1"], layer_norm(blk["norm1"], z), None, heads, pr)
        z = z + mha(blk["attn2"], layer_norm(blk["norm2"], z), context, heads, pr)
        a, gate = linear(blk["ff"]["proj"], layer_norm(blk["norm3"], z), pr).chunk(2, dim=-1)
        z = z + linear(blk["ff"]["out"], a * F.gelu(gate), pr)
    if cfg["use_linear_projection"]:
        z = linear(p["proj_out"], z, pr).reshape(n, h, w, c).permute(0, 3, 1, 2)
    else:
        z = conv(p["proj_out"], z.reshape(n, h, w, c).permute(0, 3, 1, 2), pr)
    return z + x


def unet(p, x, t, context, cfg: dict, pr: Precision = F32):
    """x [B, 4, h, w], t [B], context [B, L, cross] -> eps [B, 4, h, w]."""
    groups, heads = cfg["norm_groups"], cfg["num_heads_per_block"]
    ch0 = cfg["block_out_channels"][0]
    te = p["time_embedding"]
    temb = linear(te["linear_2"], F.silu(linear(te["linear_1"], timestep_embedding(t, ch0), pr)),
                  pr)
    h = conv(p["conv_in"], x, pr)
    skips = [h]
    for i, blk in enumerate(p["down_blocks"]):
        for j, rn in enumerate(blk["resnets"]):
            h = resnet(rn, h, temb, groups, pr)
            if blk["attentions"]:
                h = transformer(blk["attentions"][j], h, context, heads[i], cfg, pr)
            skips.append(h)
        if blk["downsample"] is not None:
            h = conv(blk["downsample"], h, pr, stride=2, padding=1)
            skips.append(h)
    mb = p["mid_block"]
    h = resnet(mb["resnet1"], h, temb, groups, pr)
    h = transformer(mb["attention"], h, context, heads[-1], cfg, pr)
    h = resnet(mb["resnet2"], h, temb, groups, pr)
    nb = len(cfg["block_out_channels"])
    for k, blk in enumerate(p["up_blocks"]):
        i = nb - 1 - k
        for j, rn in enumerate(blk["resnets"]):
            h = resnet(rn, torch.cat([h, skips.pop()], dim=1), temb, groups, pr)
            if blk["attentions"]:
                h = transformer(blk["attentions"][j], h, context, heads[i], cfg, pr)
        if blk["upsample"] is not None:
            h = conv(blk["upsample"], F.interpolate(h, scale_factor=2.0, mode="nearest"), pr)
    h = F.silu(group_norm(p["conv_norm_out"], h, groups))
    return conv(p["conv_out"], h, pr)


# -- TAESD ------------------------------------------------------------------------------


def taesd_block(p, x, pr: Precision):
    h = F.relu(conv(p["conv1"], x, pr))
    h = F.relu(conv(p["conv2"], h, pr))
    return F.relu(conv(p["conv3"], h, pr) + x)


def taesd_encode(p, img, pr: Precision = F32):
    """img [B, 3, H, W] in [0, 1] -> latents [B, 4, H/2^s, W/2^s]."""
    h = taesd_block(p["block_in"], conv(p["conv_in"], img, pr), pr)
    for stage in p["stages"]:
        h = conv(stage["down"], h, pr, stride=2, padding=1)
        for b in stage["blocks"]:
            h = taesd_block(b, h, pr)
    return conv(p["conv_out"], h, pr)


def taesd_decode(p, z, pr: Precision = F32):
    """latents -> RGB [B, 3, H, W] in [0, 1]."""
    h = F.relu(conv(p["conv_in"], torch.tanh(z / 3.0) * 3.0, pr))
    for stage in p["stages"]:
        for b in stage["blocks"]:
            h = taesd_block(b, h, pr)
        h = conv(stage["up"], F.interpolate(h, scale_factor=2.0, mode="nearest"), pr)
    h = taesd_block(p["block_out"], h, pr)
    return torch.clamp(conv(p["conv_out"], h, pr), 0.0, 1.0)
