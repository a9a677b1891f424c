"""The weights of a configuration, made from the run's seed.

``layout(cfg)`` lists every leaf of the parameter tree (its path, shape and
how it is drawn) in the tree layout the program takes (``params=`` of its
model bundle) and the reference reads: linear kernels [in, out], conv
kernels OIHW, a ``None`` where a block has no down- or upsampler.
``make_tree`` draws the whole tree on the device from one seed in a few
large calls: one normal draw per dtype group (the UNet and TAESD in the
served dtype, the text tower in float32, as it is served), sliced into the
leaves and scaled in place: kernels to fan-in variance, biases and norm
shifts to small spreads about 0, norm scales about 1, so that a bias or a
norm's affine dropped or put on the wrong leaf changes the output.  TAESD's
last convolution is scaled about 0.5 so that decoded frames mostly stay
inside 0..255 rather than clamp.  The same seed gives the same tree, bit
for bit, on a given device.
"""

from __future__ import annotations

import math

import torch


BIAS_STD = 0.05  # biases and norm shifts: normal about 0
NORM_SCALE_STD = 0.1  # norm scales: normal about 1


class Leaf:
    """A leaf drawn as ``mean + std * normal``."""

    __slots__ = ("shape", "std", "mean")

    def __init__(self, shape, std: float, mean: float = 0.0):
        self.shape, self.std, self.mean = tuple(shape), std, mean


def _linear(i, o, bias=True, scale=1.0):
    p = {"kernel": Leaf((i, o), std=scale / math.sqrt(max(i, 1)))}
    if bias:
        p["bias"] = Leaf((o,), BIAS_STD)
    return p


def _conv(i, o, k=3, bias=True, scale=1.0, bias_mean=0.0):
    p = {"kernel": Leaf((o, i, k, k), std=scale / math.sqrt(max(i * k * k, 1)))}
    if bias:
        p["bias"] = Leaf((o,), BIAS_STD, bias_mean)
    return p


def _norm(c):
    return {"scale": Leaf((c,), NORM_SCALE_STD, 1.0), "bias": Leaf((c,), BIAS_STD)}


def _resnet(i, o, temb):
    p = {"norm1": _norm(i), "conv1": _conv(i, o), "time_emb_proj": _linear(temb, o),
         "norm2": _norm(o), "conv2": _conv(o, o, scale=0.5)}
    if i != o:
        p["conv_shortcut"] = _conv(i, o, 1)
    return p


def _attention(q_dim, ctx_dim, inner):
    return {"to_q": _linear(q_dim, inner, bias=False), "to_k": _linear(ctx_dim, inner, bias=False),
            "to_v": _linear(ctx_dim, inner, bias=False), "to_out": _linear(inner, q_dim)}


def _transformer(ch, ucfg, depth):
    proj = ((lambda s: _linear(ch, ch, scale=s)) if ucfg["use_linear_projection"]
            else (lambda s: _conv(ch, ch, 1, scale=s)))
    return {"norm": _norm(ch), "proj_in": proj(1.0),
            "blocks": [{"norm1": _norm(ch), "attn1": _attention(ch, ch, ch), "norm2": _norm(ch),
                        "attn2": _attention(ch, ucfg["cross_attention_dim"], ch),
                        "norm3": _norm(ch),
                        "ff": {"proj": _linear(ch, ch * 8), "out": _linear(ch * 4, ch)}}
                       for _ in range(depth)],
            "proj_out": proj(0.2)}


def unet_layout(u: dict) -> dict:
    chans, nb = u["block_out_channels"], len(u["block_out_channels"])
    ch0, temb = chans[0], chans[0] * 4
    p = {"conv_in": _conv(u["in_channels"], ch0),
         "time_embedding": {"linear_1": _linear(ch0, temb), "linear_2": _linear(temb, temb)},
         "down_blocks": [], "up_blocks": [], "conv_norm_out": _norm(ch0),
         "conv_out": _conv(ch0, u["out_channels"], scale=0.2)}
    out_ch, skips = ch0, [ch0]
    for i, ch in enumerate(chans):
        in_ch, out_ch = out_ch, ch
        blk = {"resnets": [], "attentions": [], "downsample": None}
        for j in range(u["layers_per_block"]):
            blk["resnets"].append(_resnet(in_ch if j == 0 else out_ch, out_ch, temb))
            if u["attn_blocks"][i]:
                blk["attentions"].append(
                    _transformer(out_ch, u, u["transformer_layers_per_block"][i]))
            skips.append(out_ch)
        if i < nb - 1:
            blk["downsample"] = _conv(out_ch, out_ch)
            skips.append(out_ch)
        p["down_blocks"].append(blk)
    mid = chans[-1]
    p["mid_block"] = {"resnet1": _resnet(mid, mid, temb),
                      "attention": _transformer(mid, u, u["transformer_layers_per_block"][-1]),
                      "resnet2": _resnet(mid, mid, temb)}
    prev = mid
    for i in reversed(range(nb)):
        ch = chans[i]
        blk = {"resnets": [], "attentions": [], "upsample": None}
        for _ in range(u["layers_per_block"] + 1):
            blk["resnets"].append(_resnet(prev + skips.pop(), ch, temb))
            prev = ch
            if u["attn_blocks"][i]:
                blk["attentions"].append(_transformer(ch, u, u["transformer_layers_per_block"][i]))
        if i > 0:
            blk["upsample"] = _conv(ch, ch)
        p["up_blocks"].append(blk)
    return p


def clip_layout(c: dict) -> dict:
    w = c["width"]
    return {"token_embedding": Leaf((c["vocab_size"], w), std=0.02),
            "position_embedding": Leaf((c["max_length"], w), std=0.01),
            "final_norm": _norm(w),
            "layers": [{"ln1": _norm(w), "q": _linear(w, w), "k": _linear(w, w),
                        "v": _linear(w, w), "out": _linear(w, w), "ln2": _norm(w),
                        "fc1": _linear(w, 4 * w), "fc2": _linear(4 * w, w)}
                       for _ in range(c["layers"])]}


def taesd_layout(t: dict) -> dict:
    w, n, nb = t["width"], t["num_stages"], t["blocks_per_stage"]

    def block():
        return {f"conv{i}": _conv(w, w) for i in (1, 2, 3)}

    return {"encoder": {"conv_in": _conv(3, w), "block_in": block(),
                        "stages": [{"down": _conv(w, w, bias=False),
                                    "blocks": [block() for _ in range(nb)]} for _ in range(n)],
                        "conv_out": _conv(w, t["latent_channels"])},
            "decoder": {"conv_in": _conv(t["latent_channels"], w),
                        "stages": [{"blocks": [block() for _ in range(nb)],
                                    "up": _conv(w, w, bias=False)} for _ in range(n)],
                        "block_out": block(),
                        "conv_out": _conv(w, 3, scale=0.15, bias_mean=0.5)}}


def layout(cfg: dict) -> dict:
    """The tree of Leafs of a configuration file's ``unet``, ``clip`` and
    ``taesd``."""
    return {"unet": unet_layout(cfg["unet"]), "clip": clip_layout(cfg["clip"]),
            "taesd": taesd_layout(cfg["taesd"])}


def _leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def count(tree) -> int:
    return sum(math.prod(leaf.shape) for leaf in _leaves(tree, []))


def _fill(tree, flat, offset, device, dtype):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out[k], offset = _fill(v, flat, offset, device, dtype)
        return out, offset
    if isinstance(tree, list):
        out = []
        for v in tree:
            leaf, offset = _fill(v, flat, offset, device, dtype)
            out.append(leaf)
        return out, offset
    if tree is None:
        return None, offset
    n = math.prod(tree.shape)
    leaf = flat[offset:offset + n].view(tree.shape).mul_(tree.std)
    return (leaf.add_(tree.mean) if tree.mean else leaf), offset + n


def make_tree(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The configuration's weights from ``seed`` on ``device``: the UNet and
    TAESD in ``dtype`` (the served dtype), the text tower in float32."""
    lay = layout(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    tree = {}
    for names, dt in ((("unet", "taesd"), dtype), (("clip",), torch.float32)):
        flat = torch.randn(sum(count(lay[n]) for n in names), generator=gen, device=device,
                           dtype=dt)
        offset = 0
        for n in names:
            tree[n], offset = _fill(lay[n], flat, offset, device, dt)
    return tree
