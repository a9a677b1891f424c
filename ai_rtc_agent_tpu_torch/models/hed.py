"""The HED edge annotator (Holistically-Nested Edge Detection) — counterpart
of ai_rtc_agent_tpu/models/hed.py.

The reference's ControlNet path supports one conditioning processor, the
HED detector.  This is the public ControlNetHED checkpoint's network
(lllyasviel/Annotators, ControlNetHED.pth) as an apply function that runs
inside the stream step:

    norm                          [1,1,1,3] input bias (NHWC)
    block k = convs (3x3, ReLU after each) + 1x1 projection to 1 channel
    blocks: (3->64 x2) (64->128 x2) (128->256 x3) (256->512 x3) (512->512 x3)
    2x2 max-pool between blocks (the JAX "SAME" window: a partial window
    at an odd edge); each projection bilinearly resized to the input size;
    edge = sigmoid(mean of the side maps)

Conv kernels are OIHW, as the checkpoint stores them.  ``norm`` keeps the
JAX tree's [1,1,1,3] (``bridge.params_from_jax`` carries it unchanged).
The convs read ``kernel`` directly, as the JAX ``_conv`` does: a w8 tree
(QUANT_WEIGHTS) cannot serve HED on either package, and the engine refuses
that combination at build (stream/engine.py).
"""

from __future__ import annotations

import glob
import math
import os

import torch
import torch.nn.functional as F

from ..utils import env

# (in_ch, out_ch, n_convs) per stage: the ControlNetHED geometry
FULL_STAGES = ((3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3))
TINY_STAGES = ((3, 8, 1), (8, 16, 1))  # hermetic tests


def init_hed(gen, stages=FULL_STAGES, device="cpu") -> dict:
    """Random params from ``gen`` (a torch.Generator on ``device``): He-normal
    3x3 convs, zero biases, a zero ``norm``."""
    device = torch.device(device)
    params: dict = {"norm": torch.zeros((1, 1, 1, 3), device=device)}

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    for i, (cin, cout, n) in enumerate(stages, start=1):
        convs, c = [], cin
        for _ in range(n):
            convs.append({"kernel": normal((cout, c, 3, 3), math.sqrt(2.0 / (9 * c))),
                          "bias": torch.zeros((cout,), device=device)})
            c = cout
        params[f"block{i}"] = {
            "convs": convs,
            "projection": {"kernel": normal((1, cout, 1, 1), math.sqrt(1.0 / cout)),
                           "bias": torch.zeros((1,), device=device)},
        }
    return params


def _conv(x, p):
    """NHWC conv at stride 1, "SAME" (odd kernels: k // 2 on every edge)."""
    w = p["kernel"].to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["bias"].to(x.dtype), padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def apply_hed(params: dict, img01_nhwc):
    """[B,H,W,3] in [0,1] -> the 3-channel edge map in [0,1], same size and
    dtype.  Iterates whatever block1..N the tree carries, so the tiny and
    the full geometry share one path."""
    x = img01_nhwc * 255.0 - params["norm"].to(img01_nhwc.dtype)
    b, h, w, _ = x.shape
    side_maps = []
    i = 1
    while f"block{i}" in params:
        if i > 1:  # 2x2 max-pool; an odd edge keeps its partial window
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True).permute(0, 2, 3, 1)
        block = params[f"block{i}"]
        for conv in block["convs"]:
            x = torch.relu(_conv(x, conv))
        proj = _conv(x, block["projection"]).permute(0, 3, 1, 2)  # [B,1,h_i,w_i]
        side_maps.append(F.interpolate(proj, size=(h, w), mode="bilinear", align_corners=False))
        i += 1
    edge = torch.sigmoid(torch.stack(side_maps).mean(dim=0))  # [B,1,H,W]
    return edge.permute(0, 2, 3, 1).expand(b, h, w, 3).to(img01_nhwc.dtype)


# --------------------------------------------------------------------------
# the checkpoint (a torch .pth from lllyasviel/Annotators)
# --------------------------------------------------------------------------


def load_hed_from_torch(params: dict, path: str) -> tuple:
    """Read ControlNetHED.pth into ``params`` (in place, each tensor on its
    leaf's device, f32):

        norm                            [1,3,1,1]
        block{i}.convs.{j}.weight/bias  OIHW conv, kept OIHW
        block{i}.projection.weight/bias

    (the ``netNetwork.`` prefix optional).  A conv weight whose shape is not
    the leaf's is skipped, as in the JAX loader.  -> (params, n_loaded)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("netNetwork."): v for k, v in sd.items()}
    n = 0

    def get(name):
        t = sd.get(name)
        return None if t is None else t.detach().float()

    def put(node, key, t):
        nonlocal n
        node[key] = t.to(node[key].device)
        n += 1

    norm = get("norm")
    if norm is not None and norm.numel() == params["norm"].numel():
        put(params, "norm", norm.reshape(1, 1, 1, 3))
    i = 1
    while f"block{i}" in params:
        block = params[f"block{i}"]
        for j, conv in enumerate(block["convs"]):
            w, b = get(f"block{i}.convs.{j}.weight"), get(f"block{i}.convs.{j}.bias")
            if w is not None and w.shape == conv["kernel"].shape:
                put(conv, "kernel", w)
            if b is not None:
                put(conv, "bias", b)
        w, b = get(f"block{i}.projection.weight"), get(f"block{i}.projection.bias")
        if w is not None:
            put(block["projection"], "kernel", w)
        if b is not None:
            put(block["projection"], "bias", b)
        i += 1
    return params, n


def find_hed_checkpoint() -> str | None:
    """A local ControlNetHED.pth: HED_CHECKPOINT, else a snapshot of
    lllyasviel/Annotators; None when there is none (random weights)."""
    explicit = env.get_str("HED_CHECKPOINT")
    if explicit and os.path.exists(explicit):
        return explicit
    from . import registry

    snap = registry.resolve_snapshot_dir("lllyasviel/Annotators")
    if snap:
        hits = glob.glob(os.path.join(snap, "ControlNetHED*.pth"))
        if hits:
            return hits[0]
    return None
