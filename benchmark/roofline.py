"""The yardstick's arithmetic: the chip's peaks, a kernel's bound, the
attention work of a UNet pass from a configuration's geometry, and the
work of a frame counted over the plain reference.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s in
bf16, 3.35 TB/s of HBM3.  A bound is the larger of operations over the
peak rate and bytes over the bandwidth; each input byte is counted read
once and each output byte written once.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take for this work (s)."""
    return max(flops / peak, nbytes / PEAK_BYTES)


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


def attention_work(shape, elem_bytes: int = 2) -> tuple:
    """(operations, bytes) of one attention launch: 4·B·H·Lq·Lk·D, and Q,
    K, V and O each moved once in bf16."""
    b, lq, lk, hh, d = shape
    return 4.0 * b * hh * lq * lk * d, elem_bytes * b * hh * d * (2 * lq + 2 * lk)


def attention_bound_s(cfg: dict, rows: int) -> float:
    """Σ over one UNet pass's attention launches of each launch's bound (s)."""
    return sum(bound_s(*attention_work(s)) for s in attention_shapes(cfg, rows))


def frame_flops(cfg: dict) -> float:
    """Floating-point operations of one served frame, counted by
    ``torch.utils.flop_counter`` over the plain reference on the meta
    device: TAESD's encoder on the frame, one UNet pass over the session's
    stage rows, TAESD's decoder on the finished latent.  The same work,
    whatever implements it."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import model as M
    from .reference import params as P

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
