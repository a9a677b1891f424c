"""Model registry: model-id -> config + params + apply-fn bundle.

Counterpart of ai_rtc_agent_tpu/models/registry.py, for every family the
JAX package serves: sd15, sd21 / SD-Turbo, sdxl / SDXL-Turbo, and the
hermetic tiny and tinyxl.  As in the JAX package:

1. weights found locally (an HF snapshot under HF_HUB_CACHE, or a snapshot
   directory passed as the model id) stream from safetensors into the
   param trees through the key maps (models/loader.py), in f32;
2. no weights: random init at full architecture, made on the target device
   from a seeded torch.Generator, with a warning.

LoRA files (``lora_dict``: path -> scale) are fused at load, in f32, before
the bundle is cast (models/lora.py).  ``cast_params`` applies QUANT_WEIGHTS
(w8, models/quant.py) to the whole tree, the ControlNet and HED included;
the bundle carries the DeepCache pair (``unet_capture``/``unet_cached``).
``controlnet=`` (a model id or a snapshot dir) adds the ControlNet branch
(models/controlnet.py; random from the seed, its snapshot's safetensors
through ``loader.controlnet_key_map`` where one resolves) and its apply
closure; ``annotator="hed"`` adds the HED detector (models/hed.py; a local
ControlNetHED.pth, HED_CHECKPOINT, where one exists).

The SDXL families carry a second text tower, ``params["clip2"]`` (OpenCLIP
ViT-bigG for sdxl, ``tiny_g`` for tinyxl, random from seed + 5): the
bundle's ``encode_prompt`` concatenates both towers' hidden states on the
last axis and returns ``(cond, uncond, {"pooled": projected})``, bigG's
projected pooled state for the UNet's ``text_time`` addition embedding.
As in the JAX package, SDXL's first tower is ViT-L at ``clip_skip=0`` (the
final layer after its norm), and a snapshot's ``text_encoder_2`` is read
for sdxl only.
"""

from __future__ import annotations

import glob
import logging
import os
from dataclasses import dataclass
from typing import Callable

import torch

from .. import resolve_device
from ..stream.engine import StreamConfig, StreamModels
from ..tree import tree_map
from ..utils import env
from . import clip as C
from . import controlnet as CN
from . import hed as HED
from . import loader as LD
from . import lora as LR
from . import quant as Q
from . import taesd as T
from . import tokenizer as TK
from . import unet as U
from .layers import ATTN_IMPLS

logger = logging.getLogger(__name__)


@dataclass
class ModelBundle:
    params: dict
    stream_models: StreamModels
    encode_prompt: Callable
    unet_cfg: U.UNetConfig
    clip_cfg: C.CLIPTextConfig
    taesd_cfg: T.TAESDConfig
    family: str  # sd15 | sd21 | sdxl | tiny | tinyxl
    device: torch.device
    loaded_real_weights: bool = False


def family_of(model_id: str) -> str:
    m = model_id.lower()
    if ("tiny" in m or "test" in m) and "xl" in m:
        return "tinyxl"
    if "tiny" in m or "test" in m:
        return "tiny"
    if "sdxl" in m:
        return "sdxl"
    if "sd-turbo" in m or "sd21" in m or "stable-diffusion-2" in m:
        return "sd21"
    return "sd15"


TINY_FAMILIES = ("tiny", "tinyxl")


def default_stream_config(model_id: str, device="cuda", **overrides) -> StreamConfig:
    """Per-family serving defaults (the JAX package's), with the kernels on
    (fused epilogue, flash attention) and bf16 on a CUDA device."""
    fam = family_of(model_id)
    m = model_id.lower()
    if "turbo" in m and fam != "sdxl":
        base = dict(
            t_index_list=(0,),
            num_inference_steps=1,
            timestep_spacing="trailing",
            scheduler="turbo",
            cfg_type="none",
        )
    elif fam == "sd21":
        v768 = m.rstrip("/").endswith("2-1") or "768" in m
        base = dict(
            t_index_list=(18, 26, 35, 45),
            num_inference_steps=50,
            scheduler="lcm",
            cfg_type="self",
            **(dict(height=768, width=768, prediction_type="v_prediction") if v768 else {}),
        )
    elif fam == "sdxl":
        base = dict(
            height=1024,
            width=1024,
            t_index_list=(0,),
            num_inference_steps=1,
            timestep_spacing="trailing",
            scheduler="turbo",
            cfg_type="none",
            use_added_cond=True,
        )
    elif fam in TINY_FAMILIES:
        base = dict(height=64, width=64, latent_scale=4)
        if fam == "tinyxl":
            base["use_added_cond"] = True
    else:
        base = dict(
            t_index_list=(18, 26, 35, 45),
            num_inference_steps=50,
            scheduler="lcm",
            cfg_type="self",
        )
    base.update(overrides)
    base.setdefault("use_fused_epilogue", True)
    if "attn_impl" not in base:
        base["attn_impl"] = env.attn_impl()  # ATTN_IMPL: xla is refused here, at boot
    base.setdefault("dtype", "bfloat16" if torch.device(device).type == "cuda" else "float32")
    # DeepCache (UNET_CACHE=N or deepcache:N): the full UNet every Nth step,
    # the outermost tier between; an explicit override wins
    env_cache = env.get_str("UNET_CACHE") or ""
    if env_cache and "unet_cache_interval" not in base:
        prefix, _, n = env_cache.rpartition(":")
        if prefix not in ("", "deepcache"):
            raise ValueError(f"UNET_CACHE={env_cache!r}: expected N or deepcache:N")
        try:
            base["unet_cache_interval"] = int(n)
        except ValueError as e:
            raise ValueError(f"UNET_CACHE={env_cache!r}: expected N or deepcache:N") from e
    cfg = StreamConfig(**base)
    if cfg.unet_cache_interval >= 2 and cfg.use_controlnet:
        raise ValueError("UNET_CACHE is incompatible with ControlNet (residuals feed the "
                         "skipped deep blocks) — unset one")
    if cfg.unet_cache_interval >= 2 and cfg.mode == "txt2img":
        logger.warning(
            "UNET_CACHE with txt2img: consecutive ticks share no input frame, so the "
            "temporal-coherence assumption behind the cache is weak — expect a stronger "
            "approximation than img2img")
    return cfg


def _model_configs(fam: str):
    if fam == "sd15":
        return U.UNetConfig.sd15(), C.CLIPTextConfig.sd15(), T.TAESDConfig()
    if fam == "sd21":
        return U.UNetConfig.sd21(), C.CLIPTextConfig.sd21(), T.TAESDConfig()
    if fam == "sdxl":
        return U.UNetConfig.sdxl(), C.CLIPTextConfig.sd15(), T.TAESDConfig()
    if fam == "tiny":
        return U.UNetConfig.tiny(), C.CLIPTextConfig.tiny(), T.TAESDConfig.tiny()
    if fam == "tinyxl":
        return U.UNetConfig.tiny_xl(), C.CLIPTextConfig.tiny_dual(), T.TAESDConfig.tiny()
    raise ValueError(fam)


def clip2_config(fam: str) -> C.CLIPTextConfig | None:
    """The second (projected) text tower of a dual-tower family, else None."""
    return {"sdxl": C.CLIPTextConfig.sdxl_g, "tinyxl": C.CLIPTextConfig.tiny_g}.get(
        fam, lambda: None)()


def cast_params(params, dtype: str):
    """Cast f32 leaves to the compute dtype (bf16 on the card), then, under
    QUANT_WEIGHTS=w8 (QUANT_MIN_SIZE), store the large kernels as int8 + a
    per-output-channel f32 scale (models/quant.py) — the JAX order: the
    int8 values come from the cast weights.  A w8 pair's ``scale`` stays
    f32, as in the JAX tree (the primitives cast it at use).  Conv kernels,
    int8 ones too, go channels_last so cuDNN runs the NHWC activations as
    they are."""

    def cast(node):
        if isinstance(node, dict):
            keep = "kernel_q" in node  # a w8 pair: its scale stays f32
            return {k: v if keep and k == "scale" else cast(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(cast(v) for v in node)
        if dtype == "bfloat16" and node is not None and node.dtype == torch.float32:
            return node.to(torch.bfloat16)
        return node

    params = cast(params)
    if (env.get_str("QUANT_WEIGHTS") or "").lower() in ("w8", "int8"):
        params, n = Q.quantize_params(params, min_size=env.get_int("QUANT_MIN_SIZE", Q.MIN_SIZE))
        logger.info("quantized %d kernels to int8 (w8a16)", n)

    def layout(a):
        if a.ndim == 4:
            a = a.contiguous(memory_format=torch.channels_last)
        return a

    return tree_map(layout, params)


def init_params(fam: str, seed: int = 0, device="cpu") -> dict:
    """Random params at full architecture for a family, on ``device``
    (a meta device gives shapes only).  A dual-tower family's ``clip2``
    comes from a generator of its own (seed + 5), so the other trees are
    the same as without it."""
    unet_cfg, clip_cfg, taesd_cfg = _model_configs(fam)
    device = torch.device(device)

    def gen_of(s):
        return None if device.type == "meta" else torch.Generator(device=device).manual_seed(s)

    gen = gen_of(seed)
    params = {
        "unet": U.init_unet(gen, unet_cfg, device),
        "clip": C.init_clip_text(gen, clip_cfg, device),
        "taesd": T.init_taesd(gen, taesd_cfg, device),
    }
    clip2_cfg = clip2_config(fam)
    if clip2_cfg is not None:
        params["clip2"] = C.init_clip_text(gen_of(seed + 5), clip2_cfg, device)
    return params


def resolve_snapshot_dir(model_id: str) -> str | None:
    """A local HF snapshot of ``model_id``: the id itself when it is a
    directory, else the newest ``models--<org>--<name>/snapshots/*`` under
    HF_HUB_CACHE (default ``~/.cache/huggingface/hub``).  No network."""
    if os.path.isdir(model_id):
        return model_id
    cache = env.get_str("HF_HUB_CACHE") or os.path.expanduser("~/.cache/huggingface/hub")
    safe = "models--" + model_id.replace("/", "--")
    snaps = sorted(glob.glob(os.path.join(cache, safe, "snapshots", "*")))
    return snaps[-1] if snaps else None


def _try_load_weights(params: dict, snap: str, fam: str, unet_cfg, clip_cfg,
                      taesd_cfg) -> bool:
    """Stream the snapshot's ``unet/``, ``text_encoder/`` and ``vae/``
    safetensors (and sdxl's ``text_encoder_2/``) into ``params`` (in place,
    f32); True when any tensor loaded.  A piece whose shapes do not fit is
    warned about and keeps its random weights, as in the JAX package."""
    any_loaded = False
    pieces = [
        ("unet", "unet", LD.unet_key_map(unet_cfg)),
        ("clip", "text_encoder", LD.clip_key_map(clip_cfg)),
        ("taesd", "vae", LD.taesd_key_map(taesd_cfg)),
    ]
    if fam == "sdxl":  # the JAX package reads no text_encoder_2 for tinyxl
        pieces.append(("clip2", "text_encoder_2", LD.clip_key_map(clip2_config(fam))))
    for ours, sub, km in pieces:
        files = LD.find_safetensors(snap, sub)
        if not files:
            continue
        sd: dict = {}
        for f in files:
            sd.update(LD.read_safetensors(f))
        try:
            params[ours], n = LD.load_into_tree(params[ours], sd, km, strict=False)
            logger.info("loaded %d tensors into %s from %s", n, ours, sub)
            any_loaded = any_loaded or n > 0
        except ValueError as e:
            logger.warning("weight load failed for %s: %s", ours, e)
    return any_loaded


def _controlnet_params(controlnet: str, unet_cfg, num_down: int, fam: str, seed: int,
                       device) -> dict:
    """The ControlNet tree: random from the port's own generator (seed ``seed``
    + 7), then the safetensors of ``controlnet``'s snapshot (its root or its
    ``controlnet/`` subfolder) through ``loader.controlnet_key_map``, not
    strict, in f32; a piece whose shapes do not fit keeps its random weights
    with a warning, as in the JAX package."""
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed + 7)
    p = CN.init_controlnet(gen, unet_cfg, num_down=num_down, device=device)
    snap = resolve_snapshot_dir(controlnet)
    files = (LD.find_safetensors(snap) or LD.find_safetensors(snap, "controlnet")) if snap else []
    if files:
        sd: dict = {}
        for f in files:
            sd.update(LD.read_safetensors(f))
        try:
            p, n = LD.load_into_tree(p, sd, LD.controlnet_key_map(unet_cfg, num_down),
                                     strict=False)
            logger.info("loaded %d tensors into controlnet", n)
        except ValueError as e:
            logger.warning("controlnet weight load failed: %s", e)
    elif fam != "tiny":
        logger.warning("no local weights for controlnet %s (snapshot=%s) — random init",
                       controlnet, snap)
    return p


def _hed_params(fam: str, seed: int, device) -> dict:
    """The HED tree: TINY_STAGES for the tiny family, else FULL_STAGES with a
    local ControlNetHED.pth (models/hed.find_hed_checkpoint) read in; random
    from the port's own generator (seed ``seed`` + 11) otherwise."""
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed + 11)
    stages = HED.TINY_STAGES if fam in TINY_FAMILIES else HED.FULL_STAGES
    params = HED.init_hed(gen, stages=stages, device=device)
    if stages is HED.FULL_STAGES:
        ckpt = HED.find_hed_checkpoint()
        if ckpt:
            try:
                params, n = HED.load_hed_from_torch(params, ckpt)
                logger.info("loaded %d HED tensors from %s", n, ckpt)
            except Exception as e:  # noqa: BLE001 - any unreadable file: random, as in JAX
                logger.warning("HED checkpoint load failed (%s); random init", e)
        else:
            logger.warning("no local HED checkpoint (lllyasviel/Annotators) — random edge "
                           "detector; download on a connected host")
    return params


def fuse_loras(unet_params: dict, unet_cfg, lora_dict: dict) -> dict:
    """Fuse each LoRA file of ``lora_dict`` (path -> scale) into the UNet
    tree, in order; one that matches no module raises ValueError (a
    misnamed adapter would otherwise fuse to a silent no-op)."""
    km = LD.unet_key_map(unet_cfg)
    for path, scale in lora_dict.items():
        groups = LR.parse_lora_state_dict(LD.read_safetensors(path))
        unet_params, n, unmatched = LR.fuse_lora_into_unet(unet_params, groups, km, scale=scale)
        if n == 0:
            raise ValueError(
                f"LoRA {path!r} matched 0 of {len(groups)} modules in this UNet "
                f"({len(unmatched)} unmatched; first: {unmatched[:3]}) — wrong file or "
                "wrong base model")
        logger.info("fused LoRA %s (scale %s): %d modules (%d unmatched)",
                    path, scale, n, len(unmatched))
    return unet_params


def load_model_bundle(
    model_id: str,
    device=None,
    seed: int = 0,
    attn_impl: str = "kernel",
    params: dict | None = None,
    lora_dict: dict | None = None,
    controlnet: str | None = None,
    annotator: str | None = None,
    latent_scale: int = 8,
) -> ModelBundle:
    """Build the bundle on ``device`` (default "cuda"; raises without a
    card).  ``params``: a ready param tree (e.g. ``bridge.params_from_jax``
    of a JAX tree); otherwise random init from ``seed``, overwritten by a
    local snapshot's weights where one resolves (:func:`resolve_snapshot_dir`).
    ``lora_dict`` (path -> scale) fuses LoRA files into the UNet, in f32.
    ``controlnet`` (a ControlNet model id or snapshot dir, as the JAX
    bundle takes it) adds ``params["controlnet"]`` unless ``params`` holds
    one; ``annotator="hed"`` with it adds ``params["hed"]`` the same way.
    ``latent_scale`` sets the cond embedding's downsamples (8 -> 3, 4 -> 2,
    2 -> 1; the tiny family is 4).  ``attn_impl`` ("kernel" | "plain" | "ring" |
    "ulysses") is baked into the UNet and ControlNet closures, as in the
    JAX bundle.
    Real weights with no tokenizer vocab raise."""
    device = resolve_device(device)
    fam = family_of(model_id)
    unet_cfg, clip_cfg, taesd_cfg = _model_configs(fam)
    if attn_impl not in ATTN_IMPLS:
        # fail fast: a typo would otherwise serve through a route nobody asked for
        raise ValueError(f"attn_impl={attn_impl!r} unknown ({' | '.join(ATTN_IMPLS)})")
    if attn_impl in ("ring", "ulysses"):
        # the sp routes need layers.sp_attention_group active around the
        # apply (the trainer's step, or an engine on an sp>1 mesh); without
        # one attention runs whole on this rank: never silent
        logger.warning(
            "attn_impl=%s takes effect only under an active sp_attention_group (the "
            "trainer or an engine over an sp>1 mesh); otherwise attention runs whole on "
            "this rank through the flash-attention kernel (the plain route where a "
            "gradient is needed)", attn_impl)
    if fam in TINY_FAMILIES:
        latent_scale = 4
    cnet_num_down = {8: 3, 4: 2, 2: 1}.get(latent_scale)
    if controlnet is not None and cnet_num_down is None:
        raise ValueError(
            f"latent_scale {latent_scale} unsupported for controlnet (must be 2, 4 or 8)")
    snap = resolve_snapshot_dir(model_id)
    loaded = False
    if params is None:
        params = init_params(fam, seed, device)
        if snap:
            loaded = _try_load_weights(params, snap, fam, unet_cfg, clip_cfg, taesd_cfg)
        if not loaded and fam != "tiny":
            logger.warning("no local weights for %s — serving RANDOM weights", model_id)
    if controlnet is not None:
        params = dict(params)
        if "controlnet" not in params:
            params["controlnet"] = _controlnet_params(controlnet, unet_cfg, cnet_num_down, fam,
                                                      seed, device)
        if annotator == "hed" and "hed" not in params:
            params["hed"] = _hed_params(fam, seed, device)
    if lora_dict:
        params = dict(params)
        params["unet"] = fuse_loras(params["unet"], unet_cfg, lora_dict)
    tok = TK.find_clip_tokenizer(snap or "", max_length=clip_cfg.max_length)
    if fam in TINY_FAMILIES:
        tok = TK.HashTokenizer(vocab_size=clip_cfg.vocab_size, max_length=clip_cfg.max_length)
    elif loaded and isinstance(tok, TK.HashTokenizer):
        # hash ids would index random rows of a real embedding table: every
        # prompt garbage, with only a log line to show for it
        raise FileNotFoundError(
            f"model weights loaded from {snap!r} but no tokenizer vocab.json/merges.txt "
            "found under tokenizer/, tokenizer_2/ or the snapshot root — refusing to serve "
            "real weights with the hermetic HashTokenizer (prompts would be garbage); "
            "re-download the snapshot with its tokenizer files")

    def unet_apply(p, x, t, ctx, down_residuals=None, mid_residual=None, added=None):
        return U.apply_unet(p["unet"], x, t, ctx, unet_cfg, attn_impl=attn_impl,
                            down_residuals=down_residuals, mid_residual=mid_residual,
                            added_cond=added)

    def controlnet_apply(p, x, t, ctx, cond_img, scale, added=None):
        return CN.apply_controlnet(p["controlnet"], x, t, ctx, cond_img, unet_cfg,
                                   conditioning_scale=scale, attn_impl=attn_impl,
                                   added_cond=added)

    def unet_capture(p, x, t, ctx, added=None):
        return U.apply_unet(p["unet"], x, t, ctx, unet_cfg, attn_impl=attn_impl,
                            deep_cache="capture", added_cond=added)

    def unet_cached(p, x, t, ctx, deep_h, added=None):
        return U.apply_unet(p["unet"], x, t, ctx, unet_cfg, attn_impl=attn_impl,
                            deep_cache="use", cached_h=deep_h, added_cond=added)

    def vae_encode(p, img):
        return T.encode(p["taesd"]["encoder"], img, taesd_cfg)

    def vae_decode(p, z):
        return T.decode(p["taesd"]["decoder"], z, taesd_cfg)

    # the text towers run once per prompt on the params as built (f32),
    # like the JAX bundle's closure; the engine casts the embeddings
    clip_params = params["clip"]
    clip2_cfg = clip2_config(fam)
    clip2_params = params["clip2"] if clip2_cfg is not None else None

    @torch.inference_mode()
    def encode_prompt(prompt: str):
        ids = torch.tensor([tok(prompt), tok("")], dtype=torch.int64, device=device)
        hidden = C.apply_clip_text(clip_params, ids, clip_cfg)["hidden"]
        if clip2_params is None:
            return hidden[:1], hidden[1:]
        g = C.apply_clip_text(clip2_params, ids, clip2_cfg)
        hidden = torch.cat([hidden, g["hidden"]], dim=-1)
        return hidden[:1], hidden[1:], {"pooled": g["projected"][:1]}

    return ModelBundle(
        params=params,
        stream_models=StreamModels(
            unet=unet_apply, vae_encode=vae_encode, vae_decode=vae_decode,
            controlnet=controlnet_apply if controlnet is not None else None,
            unet_capture=unet_capture, unet_cached=unet_cached,
            deep_cache_shape=lambda x_shape: U.deep_cache_shape(unet_cfg, x_shape)),
        encode_prompt=encode_prompt,
        unet_cfg=unet_cfg,
        clip_cfg=clip_cfg,
        taesd_cfg=taesd_cfg,
        family=fam,
        device=device,
        loaded_real_weights=loaded,
    )
