"""The ``sd_unet`` family (families.py): one SD-1/2 UNet with one CLIP text
tower, TAESD with 4 latent channels, and the stream-batch img2img step over
a DDPM ladder (LCM or turbo).  The weights are params.py's, the reference
stream.py's over model.py's networks."""

from __future__ import annotations

import torch

from . import model as M
from . import params as P
from .params import make_tree  # noqa: F401  (the family's name)
from .stream import Reference, stateless  # noqa: F401  (the family's names)


def attention_shapes(cfg: dict, rows: int) -> list:
    """(B, Lq, Lk, H, D) of every attention launch of one UNet pass over
    ``rows`` latent rows, in the order the pass runs them (each transformer
    block: self, then cross against the text tower's tokens)."""
    u, s = cfg["unet"], cfg["stream"]
    h, w = s["height"] // s["latent_scale"], s["width"] // s["latent_scale"]
    chans, heads, depth = u["block_out_channels"], u["num_heads_per_block"], \
        u["transformer_layers_per_block"]
    lk_text = cfg["clip"]["max_length"]
    nb = len(chans)

    def tier(i, count, side):
        lq = (h >> i) * (w >> i) if side is None else side
        hh, d = heads[i], chans[i] // heads[i]
        return [shape for _ in range(count * depth[i])
                for shape in ((rows, lq, lq, hh, d), (rows, lq, lk_text, hh, d))]

    out = []
    for i in range(nb):
        if u["attn_blocks"][i]:
            out += tier(i, u["layers_per_block"], None)
    mid = nb - 1
    out += tier(mid, 1, (h >> mid) * (w >> mid))
    for i in reversed(range(nb)):
        if u["attn_blocks"][i]:
            out += tier(i, u["layers_per_block"] + 1, None)
    return out


def frame_flops(cfg: dict) -> float:
    """Floating-point operations of one served frame, counted by
    ``torch.utils.flop_counter`` over the plain reference on the meta
    device: TAESD's encoder on the frame, one UNet pass over the session's
    stage rows, TAESD's decoder on the finished latent.  The same work,
    whatever implements it."""
    from torch.utils.flop_counter import FlopCounterMode

    s = cfg["stream"]
    meta = torch.device("meta")

    def tree(lay):
        if isinstance(lay, dict):
            return {k: tree(v) for k, v in lay.items()}
        if isinstance(lay, list):
            return [tree(v) for v in lay]
        return None if lay is None else torch.empty(lay.shape, device=meta)

    p = tree(P.layout(cfg))
    rows = len(s["t_index_list"])
    h, w = s["height"] // s["latent_scale"], s["width"] // s["latent_scale"]
    img = torch.empty((1, 3, s["height"], s["width"]), device=meta)
    with FlopCounterMode(display=False) as fc:
        M.taesd_encode(p["taesd"]["encoder"], img)
        M.unet(p["unet"], torch.empty((rows, 4, h, w), device=meta),
               torch.zeros(rows, device=meta),
               torch.empty((rows, cfg["clip"]["max_length"], cfg["unet"]["cross_attention_dim"]),
                           device=meta), cfg["unet"])
        M.taesd_decode(p["taesd"]["decoder"], torch.empty((1, 4, h, w), device=meta))
    return float(fc.get_total_flops())
