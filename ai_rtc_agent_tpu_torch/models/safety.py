"""Safety checker — the optional NSFW gate on served frames.

Counterpart of ai_rtc_agent_tpu/models/safety.py (diffusers'
``StableDiffusionSafetyChecker`` with its ``CLIPFeatureExtractor``): the
CLIP ViT-L/14 vision tower, ``visual_projection`` (width -> 768), cosine
similarity against 17 "concept" and 3 "special care" embeddings, each with
a learned threshold; a frame is flagged when any adjusted concept score is
positive, and a flagged frame is blanked to black.

It runs on the card (the caller's device otherwise), in f32 as in the JAX
package: the frames of one call cross to the device once, the check (the
resize, the tower and the heads) runs there, and one [N] bool vector comes
back.  The tree keeps HF's layouts where they are not kernels: the patch
embedding is an OIHW conv kernel, ``visual_projection`` an [in, out]
linear, and ``concept_embeds``/``special_care_embeds`` [K, 768] tables.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..tree import tree_map
from . import clip_vision as CV
from . import loader as LD
from .layers import _normal, init_linear, linear

logger = logging.getLogger(__name__)

PROJECTION_DIM = 768
N_CONCEPTS = 17
N_SPECIAL = 3


def init_safety_checker(gen, cfg: CV.CLIPVisionConfig, projection_dim: int = PROJECTION_DIM,
                        device="cpu"):
    """Random weights; the thresholds start at 1.0, above any cosine
    similarity, so a random checker flags nothing."""
    return {
        "vision": CV.init_clip_vision(gen, cfg, device),
        "visual_projection": init_linear(gen, cfg.width, projection_dim, bias=False,
                                         device=device),
        "concept_embeds": _normal(gen, (N_CONCEPTS, projection_dim), 0.02, device),
        "special_care_embeds": _normal(gen, (N_SPECIAL, projection_dim), 0.02, device),
        "concept_embeds_weights": torch.full((N_CONCEPTS,), 1.0, device=device),
        "special_care_embeds_weights": torch.full((N_SPECIAL,), 1.0, device=device),
    }


def safety_key_map(cfg: CV.CLIPVisionConfig) -> dict[str, tuple]:
    """HF StableDiffusionSafetyChecker state dict -> the checker's tree."""
    vm = "vision_model.vision_model"
    m: dict[str, tuple] = {
        f"{vm}.embeddings.patch_embedding.weight": ("vision", "patch_embedding", "kernel"),
        f"{vm}.embeddings.class_embedding": ("vision", "class_embedding"),
        f"{vm}.embeddings.position_embedding.weight": ("vision", "position_embedding"),
        "visual_projection.weight": ("visual_projection", "kernel"),
        "concept_embeds": ("concept_embeds",),
        "special_care_embeds": ("special_care_embeds",),
        "concept_embeds_weights": ("concept_embeds_weights",),
        "special_care_embeds_weights": ("special_care_embeds_weights",),
    }
    for pre, ours in ((f"{vm}.pre_layrnorm", ("vision", "pre_norm")),
                      (f"{vm}.post_layernorm", ("vision", "post_norm"))):
        m[pre + ".weight"] = ours + ("scale",)
        m[pre + ".bias"] = ours + ("bias",)
    pairs = [
        (".layer_norm1", "ln1", "norm"),
        (".self_attn.q_proj", "q", "linear"),
        (".self_attn.k_proj", "k", "linear"),
        (".self_attn.v_proj", "v", "linear"),
        (".self_attn.out_proj", "out", "linear"),
        (".layer_norm2", "ln2", "norm"),
        (".mlp.fc1", "fc1", "linear"),
        (".mlp.fc2", "fc2", "linear"),
    ]
    for i in range(cfg.layers):
        base = f"{vm}.encoder.layers.{i}"
        for suffix, ours, kind in pairs:
            m.update(LD._leaf_keys(base + suffix, ("vision", "layers", i, ours), kind))
    return m


def check_images(params, img01_nhwc, cfg: CV.CLIPVisionConfig):
    """[N,H,W,3] float in [0,1] -> [N] bool (True = flagged), HF's cosine
    logic: a special-care hit lowers every concept threshold by 0.01, then
    any positive adjusted concept score flags the frame."""
    x = CV.preprocess_clip(img01_nhwc, cfg)
    pooled = CV.apply_clip_vision(params["vision"], x, cfg)["pooled"]
    emb = linear(params["visual_projection"], pooled)
    emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)

    def cos(a, b):  # a [N,D], b [K,D] -> [N,K]
        return a @ (b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)).T

    special = cos(emb, params["special_care_embeds"]) - params["special_care_embeds_weights"][None]
    adjustment = torch.where((special > 0).any(dim=-1), 0.01, 0.0)[:, None]
    concept = (cos(emb, params["concept_embeds"]) - params["concept_embeds_weights"][None]
               + adjustment)
    return (concept > 0).any(dim=-1)


@dataclass
class SafetyChecker:
    """The host-side gate: the check on the device, flagged frames blanked
    on the host.  A repeated batch (a similarity skip on a still scene)
    reuses the last verdict instead of running the tower again (the memo,
    read and written under its lock: fetches run on worker threads)."""

    params: dict
    cfg: CV.CLIPVisionConfig
    loaded_real_weights: bool = False
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    def __post_init__(self):
        self._memo_in = None
        self._memo_flags = None
        self._memo_token = None
        self._memo_leaves = None
        self._memo_lock = threading.Lock()

    @staticmethod
    def load(snapshot_dir: str | None = None, cfg: CV.CLIPVisionConfig | None = None,
             seed: int = 0, device=None) -> "SafetyChecker":
        """From an HF safety-checker snapshot (the ``safety_checker``
        subfolder of an SD repo, or a standalone checkpoint dir) on
        ``device`` (the card unless the caller asks for another); random
        weights with never-flag thresholds when there is none."""
        device = resolve_device(device)
        cfg = cfg or CV.CLIPVisionConfig.vit_l14()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_safety_checker(gen, cfg, device=device)
        loaded = False
        if snapshot_dir:
            files = (LD.find_safetensors(snapshot_dir, "safety_checker")
                     or LD.find_safetensors(snapshot_dir))
            if files:
                sd: dict = {}
                for f in files:
                    sd.update(LD.read_safetensors(f))
                try:
                    params, n = LD.load_into_tree(params, sd, safety_key_map(cfg), strict=False)
                    loaded = n > 0
                    logger.info("safety checker: loaded %d tensors", n)
                except ValueError as e:
                    logger.warning("safety checker weight load failed: %s", e)
        if not loaded:
            logger.warning("safety checker running with RANDOM weights — it will flag nothing "
                           "(thresholds init at 1.0)")
        return SafetyChecker(params=params, cfg=cfg, loaded_real_weights=loaded, device=device)

    @torch.inference_mode()
    def flags(self, batch: np.ndarray) -> np.ndarray:
        """[N,H,W,3] uint8 -> [N] bool, one crossing to the device and back."""
        # tpurtc: allow[device-transfer] -- the gate's own copy of an output batch already read back, kept off the devtel frame meters as the JAX agent keeps it
        img01 = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device).float() / 255.0
        # tpurtc: allow[device-transfer] -- the gate's [N] bool flags back to the host for the blackout, not a frame
        return check_images(self.params, img01, self.cfg).cpu().numpy()

    def __call__(self, frames_u8: np.ndarray) -> np.ndarray:
        """[N,H,W,3] or [H,W,3] uint8 -> the same shape, flagged frames black."""
        squeeze = frames_u8.ndim == 3
        batch = frames_u8[None] if squeeze else frames_u8
        # the memo holds the param leaves, so their ids stay unique while it
        # lives: a params swap misses it
        leaves = []
        tree_map(leaves.append, self.params)
        token = tuple(map(id, leaves))
        with self._memo_lock:
            hit = (self._memo_in is not None and self._memo_token == token
                   and batch.shape == self._memo_in.shape
                   and np.array_equal(batch, self._memo_in))
            flags = self._memo_flags if hit else None
        if flags is None:
            flags = self.flags(batch)
            with self._memo_lock:
                self._memo_in = batch.copy()
                self._memo_flags = flags
                self._memo_token = token
                self._memo_leaves = leaves
        if flags.any():
            batch = batch.copy()
            batch[flags] = 0
            logger.info("safety checker blanked %d frame(s)", int(flags.sum()))
        return batch[0] if squeeze else batch
