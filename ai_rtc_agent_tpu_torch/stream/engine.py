"""The stream-batch denoising engine — counterpart of
ai_rtc_agent_tpu/stream/engine.py.

    step(params, state, frame_u8) -> (state, out_u8)

* The latent ring buffer, stock noise, prompt embeddings and scheduler
  coefficient vectors live in ``state`` (a dict of device tensors).  Where
  the JAX step donated its state, this step updates the ring buffer and the
  stock in place (the fused epilogue writes them; the composed ops
  ``copy_`` into them), so their storage is stable from frame to frame.
* Every state write lands in place: prompt, t_index and guidance updates
  and ``prepare()`` (again, at a restart) copy into the tensors the step
  reads, so a captured step keeps reading the live state.
* uint8 pre/post-processing runs on the device: one uint8 [H,W,3] frame
  crosses each way per step (H2D from pinned memory into the step's static
  frame buffer, non-blocking; the D2H copy is queued at submit and
  resolved in ``fetch``).
* On the card the step is one CUDA graph (aot/cache.py ``CapturedStep``),
  the counterpart of the JAX engine's jitted step: captured before the
  first frame (the pipeline captures at startup, a bare engine at its
  first submit) and replayed per step.  ``graphs=False`` steps eagerly
  over the same buffers, as the CPU always does.

Batch law: B = len(t_index_list) * frame_buffer_size.  Each step takes
fbs new frames at the noisiest sub-timestep, advances every buffered
latent one stage, and emits the frames that finished the last stage.

Modes, as in the JAX engine:
* img2img (the frame is encoded into the ring) or txt2img (fresh noise
  enters the ring; the frame is not read);
* denoising batch (the ring above) or sequential (``use_denoising_batch=
  False``: every stage of the new frames now, n_stages UNet passes of fbs
  rows, the ring buffer untouched);
* cfg_type none, self, initialize or full (2·rows through the UNet, the
  uncond rows first; the stock is left as it is);
* the speed variants: w8 params (models/quant.py; the primitives
  dequantize, the keys gain ``quant-w8``) and DeepCache
  (``unet_cache_interval``: a capture and a cached step over one state, the
  deep feature in ``state["unet_cache"]``, alternated on a host tick);
* ControlNet (``use_controlnet``; the bundle's ``controlnet`` apply): the
  new frames are annotated in the step (``annotator`` canny, hed or
  identity), ride a conditioning ring ``state["cnet_cond"]`` [B-fbs,H,W,3]
  that rotates with the latent ring, and the ControlNet's residuals, scaled
  by ``state["cnet_scale"]``, feed every UNet pass (not a DeepCache pair's,
  which the JAX package refuses as well);
* per-session style adapters (the session step): the stacked state's
  ``adapters`` factor bank (adapters/) is grafted beside the UNet's target
  linears, each row its own session's factors;
* SDXL's addition conditioning (``use_added_cond``): the prompt's pooled
  embeds ``state["added_text"]`` [1,P] and the micro-conditioning
  ``state["added_time_ids"]`` [1,6] (f32, ``[h, w, 0, 0, h, w]``) ride the
  state beside cond/uncond, are broadcast to every UNet row (the
  ControlNet's and the ``initialize`` pass's too) and are written in place
  by a prompt swap.
The post-UNet chain runs as the fused epilogue kernel where the JAX
``fused_ok`` holds (``use_fused_epilogue``, denoising batch, epsilon
prediction, cfg none/self/initialize), otherwise as the composed ops.
"""

from __future__ import annotations

import base64
import binascii
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..adapters.bank import gather_factor_rows, graft_unet_params
from ..aot.cache import GraphCache, stream_engine_key
from ..models import quant as Q
from ..models.controlnet import canny_soft
from ..models.hed import apply_hed
from ..obs import devtel
from ..ops import image as I
from ..ops import lcm as L
from ..ops import rcfg as R
from ..ops import schedule as S
from ..ops.kernels.fused_scheduler import fused_stream_epilogue, write_segments
from ..resilience import faults as _faults
from ..tree import tree_map


@dataclass(frozen=True)
class StreamConfig:
    """Stream configuration (the JAX dataclass's field set)."""

    mode: str = "img2img"  # img2img | txt2img
    height: int = 512
    width: int = 512
    latent_scale: int = 8
    latent_channels: int = 4
    t_index_list: tuple = (18, 26, 35, 45)
    num_inference_steps: int = 50
    frame_buffer_size: int = 1
    cfg_type: str = "self"  # none | full | self | initialize
    use_denoising_batch: bool = True
    do_add_noise: bool = True
    prediction_type: str = "epsilon"
    scheduler: str = "lcm"  # lcm | turbo
    timestep_spacing: str = "leading"
    dtype: str = "float32"  # float32 | bfloat16
    similar_image_filter: bool = False
    similar_image_threshold: float = 0.98
    similar_image_max_skip: int = 10
    use_added_cond: bool = False
    use_controlnet: bool = False
    annotator: str = "canny"
    # post-UNet chain (R-CFG combine -> LCM blend -> ring renoise -> stock
    # update) as ONE kernel launch (ops/kernels/fused_scheduler.py); False
    # runs the composed ops.  epsilon prediction + cfg none/self/initialize.
    use_fused_epilogue: bool = False
    # "kernel" (flash-attention kernel) | "plain"
    attn_impl: str = "kernel"
    # DeepCache (UNET_CACHE / --unet-cache): every Nth step runs the full
    # UNet and keeps the feature entering the outermost up block in the
    # state's ``unet_cache``; the steps between recompute only the
    # outermost tier and splice it in.  0/1: off.  Denoising batch only, no
    # ControlNet (the JAX refusals).
    unet_cache_interval: int = 0

    @property
    def n_stages(self) -> int:
        return len(self.t_index_list)

    @property
    def batch_size(self) -> int:
        return self.n_stages * self.frame_buffer_size

    @property
    def latent_hw(self) -> tuple:
        return (self.height // self.latent_scale, self.width // self.latent_scale)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


@dataclass
class StreamModels:
    """unet(params, x, t, context) -> model_out [B,h,w,4];
    vae_encode(params, img01_nhwc) -> latents; vae_decode(params, z) -> img01.

    The DeepCache pair (None: the family has none), as in the JAX bundle:
    unet_capture(params, x, t, context) -> (model_out, deep_h);
    unet_cached(params, x, t, context, deep_h) -> model_out;
    deep_cache_shape(x_shape) -> deep_h's shape for a UNet input of x_shape
    (what the JAX engine reads off ``jax.eval_shape`` of the capture step).

    ControlNet (None: the bundle has none): controlnet(params, x, t,
    context, cond_img, scale) -> (down residuals, mid residual), which
    ``unet(..., down_residuals=, mid_residual=)`` takes.

    SDXL's addition conditioning reaches every one of these as the keyword
    ``added`` ({"time_ids": [n,6], "text_embeds": [n,P]}), passed only when
    the config has ``use_added_cond``."""

    unet: Callable
    vae_encode: Callable
    vae_decode: Callable
    controlnet: Callable | None = None
    unet_capture: Callable | None = None
    unet_cached: Callable | None = None
    deep_cache_shape: Callable | None = None


UNET_VARIANTS = ("full", "capture", "cached")


def unet_variants(cfg: StreamConfig) -> tuple:
    """The step variants an engine of ``cfg`` alternates: the DeepCache pair
    when ``unet_cache_interval`` >= 2, else the one full step."""
    return ("capture", "cached") if cfg.unet_cache_interval >= 2 else ("full",)


def _check_supported(cfg: StreamConfig, models: StreamModels, unet_variant: str = "full"):
    if unet_variant not in UNET_VARIANTS:
        raise ValueError(f"unet_variant {unet_variant!r} not in {UNET_VARIANTS}")
    if cfg.use_controlnet and models.controlnet is None:
        raise ValueError("cfg.use_controlnet=True but StreamModels.controlnet is None — load the "
                         "bundle with a controlnet model id")
    if unet_variant != "full":  # the JAX make_step_fn's refusals
        if models.unet_capture is None or models.unet_cached is None:
            raise ValueError("unet_cache_interval set but this model bundle has no DeepCache "
                             "apply pair (unet_capture/unet_cached)")
        if cfg.use_controlnet:
            raise ValueError("unet_cache_interval is incompatible with ControlNet (residuals "
                             "feed the skipped deep blocks)")
        if not cfg.use_denoising_batch:
            raise ValueError(
                "unet_cache_interval requires denoising-batch mode (the sequential path runs "
                "multiple timesteps per slot, so the per-slot timestep alignment the cache "
                "relies on is lost)")
    if cfg.cfg_type not in R.CFG_TYPES:
        raise ValueError(f"unknown cfg_type {cfg.cfg_type!r}")


def check_params(cfg: StreamConfig, params):
    """Refuse params that ``cfg`` cannot serve, at engine build: HED's convs
    quantized (QUANT_WEIGHTS=w8 walks the HED tree too, and the HED convs
    read a dense ``kernel``, so the JAX engine fails this combination at
    its first step with a KeyError)."""
    if (cfg.use_controlnet and cfg.annotator == "hed"
            and Q.quantized_bytes_saved(params.get("hed")) > 0):
        raise ValueError(
            "annotator='hed' with QUANT_WEIGHTS=w8 params is not served: the HED annotator's "
            "convs would be int8, which it cannot apply (the JAX package fails the same "
            "combination) — unset QUANT_WEIGHTS or use another annotator")


def _annotate(img01_nhwc, cfg: StreamConfig, params):
    """The in-step conditioning annotator (the JAX ``_annotate``): canny (the
    soft-Canny map the tracked configuration uses), hed (models/hed.py, its
    params in the bundle) or identity."""
    if cfg.annotator == "canny":
        return canny_soft(img01_nhwc)
    if cfg.annotator == "hed":
        if params is None or "hed" not in params:
            raise ValueError("annotator='hed' needs HED params in the bundle — load with "
                             "registry.load_model_bundle(..., annotator='hed')")
        return apply_hed(params["hed"], img01_nhwc)
    if cfg.annotator == "identity":
        return img01_nhwc
    raise ValueError(f"unknown annotator {cfg.annotator!r} (canny|hed|identity)")


def coeff_state(cfg: StreamConfig, schedule: S.NoiseSchedule, t_index_list, device) -> dict:
    bt = S.batched_sub_timesteps(
        list(t_index_list), cfg.num_inference_steps, cfg.frame_buffer_size,
        spacing=cfg.timestep_spacing,
    )
    c = L.make_step_coeffs(schedule, bt, cfg.frame_buffer_size).to(device)
    return c.as_dict()


def t_index_coeffs(cfg: StreamConfig, schedule: S.NoiseSchedule, t_index_list, device,
                   hint: str = "") -> dict:
    """:func:`coeff_state` for a runtime t_index update, which keeps the
    stage count (the compiled batch size); another length raises ValueError
    with the plane's ``hint`` after its text, as each JAX plane words it."""
    t_index_list = tuple(int(t) for t in t_index_list)
    if len(t_index_list) != cfg.n_stages:
        raise ValueError(f"t_index_list length must stay {cfg.n_stages} (compiled batch size)"
                         + hint)
    return coeff_state(cfg, schedule, t_index_list, device)


def _coeffs(d: dict, sl=slice(None)) -> L.StepCoeffs:
    return L.StepCoeffs(
        d["timesteps"][sl], d["alpha"][sl], d["sigma"][sl], d["c_skip"][sl],
        d["c_out"][sl], d["next_alpha"][sl], d["next_sigma"][sl],
    )


def fused_ok(cfg: StreamConfig) -> bool:
    """Whether the post-UNet chain runs as the epilogue kernel (the JAX
    engine's ``fused_ok``): the ring (denoising batch), epsilon prediction
    and cfg none/self/initialize; full CFG and sequential mode run the
    composed ops."""
    return (cfg.use_fused_epilogue and cfg.use_denoising_batch
            and cfg.prediction_type == "epsilon"
            and cfg.cfg_type in ("none", "self", "initialize"))


def unet_runner(models: StreamModels, unet_variant: str = "full") -> Callable:
    """``run(params, x, t, ctx, cache, cnet=None, added=None) -> (model_out,
    deep_h or None)`` for one step variant (the JAX step's ``run_unet``):
    "full" the plain UNet, "capture" the full UNet that also returns the
    deep feature, "cached" the outermost tier around ``cache``.  ``cnet``
    (cond images, scale), the full variant only: the ControlNet's residuals
    feed the UNet.  ``added``: SDXL's addition conditioning of the rows."""
    def run(params, x, t, ctx, cache, cnet=None, added=None):
        a = {} if added is None else {"added": added}
        if cnet is not None:
            down, mid = models.controlnet(params, x, t, ctx, *cnet, **a)
            return models.unet(params, x, t, ctx, down_residuals=down, mid_residual=mid,
                               **a), None
        if unet_variant == "capture":
            return models.unet_capture(params, x, t, ctx, **a)
        if unet_variant == "cached":
            return models.unet_cached(params, x, t, ctx, cache, **a), None
        return models.unet(params, x, t, ctx, **a), None

    return run


def styled_runner(run: Callable, bank, slots, n: int) -> Callable:
    """``run`` with every UNet row meeting its own session's factor rows: a
    pass of m rows is m // (k·n) blocks of the k sessions' n rows each,
    session-major (full CFG: the uncond block, then the cond block).  The
    rows are gathered from the stacked ``bank`` at ``slots`` on the device,
    once for each pass size of the step, so a captured step reads the live
    bank at every replay; a padded bucket's tail repeats its last slot's.
    Only the UNet's params are grafted: the ControlNet, TAESD and the text
    encoder keep their own, as in the JAX step."""
    rows_of: dict = {}

    def run_styled(params, x, t, ctx, cache, cnet=None, added=None):
        m = x.shape[0]
        rows = rows_of.get(m)
        if rows is None:
            index = slots.repeat_interleave(n).repeat(m // (slots.shape[0] * n))
            rows = rows_of[m] = gather_factor_rows(bank, index)
        return run(dict(params, unet=graft_unet_params(params["unet"], rows)), x, t, ctx, cache,
                   cnet, added)

    return run_styled


def _guided(run: Callable, cfg: StreamConfig, params, x, t, cond, uncond, stock,
            coeffs: L.StepCoeffs, guidance, delta, cache=None, cnet=None, added=None):
    """One guided UNet pass over ``x`` [n,h,w,c] with the per-row ``t``,
    ``cond`` and ``uncond`` [n,L,D]: -> (eps, new stock or None when the
    stock stays, the deep feature of a capture or None).  ``run``:
    :func:`unet_runner`; ``cache``: a cached step's deep feature, the pass's
    rows; ``cnet``: (cond images [n,H,W,3], ControlNet scale: a scalar or a
    per-row column) or None.  ``guidance``/``delta``: a scalar or a per-row
    column.  ``added``: SDXL's addition conditioning of the n rows, or None.
    Full CFG runs the 2n rows uncond first and combines them (the JAX
    ``unet_with_guidance``), the cond images, scales and addition
    conditioning doubled alike."""
    if cfg.cfg_type == "full":
        if cnet is not None:
            img, scale = cnet
            cnet = (torch.cat([img, img]), torch.cat([scale, scale]) if scale.ndim else scale)
        if added is not None:
            added = {name: torch.cat([v, v]) for name, v in added.items()}
        out, deep = run(params, torch.cat([x, x]), torch.cat([t, t]), torch.cat([uncond, cond]),
                        cache, cnet, added)
        eps_u, eps_c = out.chunk(2)
        return R.combine_full(eps_u, eps_c, guidance), None, deep
    eps_c, deep = run(params, x, t, cond, cache, cnet, added)
    if cfg.cfg_type == "none":
        return eps_c, None, deep
    eps = R.combine_residual(eps_c, stock, guidance, delta)
    if cfg.cfg_type == "self":
        return eps, R.update_stock_noise(stock, eps_c, coeffs.alpha, coeffs.sigma), deep
    return eps, None, deep


def deep_cache_rows(cfg: StreamConfig) -> int:
    """The UNet rows of one session's step (its deep feature's rows): the
    stream batch, twice over with full CFG."""
    return cfg.batch_size * (2 if cfg.cfg_type == "full" else 1)


def added_cond(cfg: StreamConfig, time_ids, text_embeds, n: int):
    """SDXL's addition conditioning on n UNet rows (the JAX step's
    ``added``), from the state's [1,6] time ids and [1,P] pooled embeds;
    None without ``use_added_cond``.  The time ids stay f32."""
    if not cfg.use_added_cond:
        return None
    return {"time_ids": time_ids.expand(n, *time_ids.shape[1:]),
            "text_embeds": text_embeds.to(cfg.torch_dtype).expand(n, *text_embeds.shape[1:])}


def _denoise(cfg: StreamConfig, x, eps, coeffs: L.StepCoeffs):
    if cfg.scheduler == "turbo":
        return L.turbo_denoise(x, eps, coeffs, cfg.prediction_type)
    return L.lcm_denoise(x, eps, coeffs, cfg.prediction_type)


def make_step_fn(models: StreamModels, cfg: StreamConfig, unet_variant: str = "full"):
    """Build the step function (eager PyTorch; the kernels launch inside).

    ``unet_variant``: "full", or the DeepCache pair — "capture" (the full
    UNet; the deep feature lands in ``state["unet_cache"]``, in place) and
    "cached" (the outermost tier around ``state["unet_cache"]``).  The
    engine alternates the two on a host-side cadence, as the JAX engine
    does."""
    _check_supported(cfg, models, unet_variant)
    B = cfg.batch_size
    fbs = cfg.frame_buffer_size
    dt = cfg.torch_dtype
    fused = fused_ok(cfg)
    run = unet_runner(models, unet_variant)

    @torch.inference_mode()
    def step(params, state, frame_u8):
        """frame_u8: [fbs,H,W,3] (or [H,W,3] when fbs==1) uint8 on the device
        (not read in txt2img, but for the ControlNet's annotator)."""
        coeffs = _coeffs(state["coeffs"])
        noise = state["noise"]
        img = I.preprocess_uint8(frame_u8, dtype=dt) \
            if cfg.mode == "img2img" or cfg.use_controlnet else None

        cnet = None  # (cond images of the B rows, scale)
        if cfg.use_controlnet:
            # the new frames' annotations enter the conditioning ring, which
            # rotates with the latent ring (written in place after the cat)
            cond_full = torch.cat([_annotate(img, cfg, params), state["cnet_cond"].to(dt)])
            if B > fbs:
                state["cnet_cond"].copy_(cond_full[: B - fbs])
            cnet = (cond_full, state["cnet_scale"])

        if cfg.mode == "img2img":
            z0 = models.vae_encode(params, img)
            if cfg.do_add_noise:
                a0 = coeffs.alpha[:fbs].reshape(-1, 1, 1, 1).to(dt)
                s0 = coeffs.sigma[:fbs].reshape(-1, 1, 1, 1).to(dt)
                x_new = a0 * z0 + s0 * noise[:fbs].to(dt)
            else:
                x_new = z0
        else:  # txt2img: fresh noise enters the ring
            x_new = noise[:fbs].to(dt)
        stock = state["stock"].to(dt)
        rows = lambda a, n: a.to(dt).expand(n, *a.shape[1:])  # noqa: E731  [1,L,D] -> [n,L,D]
        added = lambda n: added_cond(  # noqa: E731
            cfg, state.get("added_time_ids"), state.get("added_text"), n)

        if not cfg.use_denoising_batch:
            # sequential: every stage of the new frames now, fbs rows a pass
            x, stocks = x_new, []
            for i in range(cfg.n_stages):
                sl = slice(i * fbs, (i + 1) * fbs)
                sub = _coeffs(state["coeffs"], sl)
                eps, st, _ = _guided(run, cfg, params, x, sub.timesteps, rows(state["cond"], fbs),
                                     rows(state["uncond"], fbs), stock[sl], sub, state["guidance"],
                                     state["delta"],
                                     cnet=None if cnet is None else (cnet[0][:fbs], cnet[1]),
                                     added=added(fbs))
                stocks.append(st)
                x = L.renoise_next(_denoise(cfg, x, eps, sub), noise[sl].to(dt), sub)
            if stocks[0] is not None:
                state["stock"].copy_(torch.cat(stocks))
            out_latent = x
        elif fused:
            x_t = torch.cat([x_new, state["x_buf"].to(dt)]) if B > fbs else x_new
            eps_c, deep = run(params, x_t, coeffs.timesteps, rows(state["cond"], B),
                              state.get("unet_cache"), cnet, added(B))
            # the whole post-UNet chain in one launch: entry b renoises with
            # slot b+fbs's noise (exit entries with 0), the advanced entries
            # land in the ring buffer and the new stock in the stock, in place
            denoised = fused_stream_epilogue(
                x_t, eps_c, stock, noise.to(dt), coeffs, state["guidance"], state["delta"],
                cfg_type=cfg.cfg_type, turbo=cfg.scheduler == "turbo", noise_shift=fbs,
                advanced_out=state["x_buf"], stock_out=state["stock"],
            )[0]
            out_latent = denoised[B - fbs:]
        else:
            x_t = torch.cat([x_new, state["x_buf"].to(dt)]) if B > fbs else x_new
            eps, new_stock, deep = _guided(run, cfg, params, x_t, coeffs.timesteps,
                                           rows(state["cond"], B), rows(state["uncond"], B), stock,
                                           coeffs, state["guidance"], state["delta"],
                                           state.get("unet_cache"), cnet, added(B))
            denoised = _denoise(cfg, x_t, eps, coeffs)
            if B > fbs:
                state["x_buf"].copy_(L.renoise_next(
                    denoised[: B - fbs], noise[fbs:].to(dt),
                    _coeffs(state["coeffs"], slice(0, B - fbs)),
                ))
            if new_stock is not None:
                state["stock"].copy_(new_stock)
            out_latent = denoised[B - fbs:]
        if unet_variant == "capture":
            state["unet_cache"].copy_(deep)

        img_out = models.vae_decode(params, out_latent)
        return state, I.postprocess_uint8(img_out.float())

    return step


def make_session_step_fn(models: StreamModels, cfg: StreamConfig, unet_variant: str = "full"):
    """The step of k sessions at once over a stacked state (counterpart of
    ``jax.vmap(make_step_fn(...), in_axes=(None, 0, 0))`` inside the JAX
    package's ``make_bucket_step``), written out as one batch of k*B rows:

        step(params, states, frames_u8, slots, k_real) -> out_u8

    ``states``: every leaf of the single-session state stacked on a leading
    slot axis [S, ...] (:func:`stack_states`).  ``frames_u8``: uint8 on the
    device, one frame per session [k,H,W,3], or with frame_buffer_size
    fbs > 1 fbs consecutive frames per session [k,fbs,H,W,3]; ``out_u8``
    has the same shape.  ``slots``: int32 [k] on the device, the slot of
    each session (a padded bucket repeats its last real slot at the tail);
    ``k_real``: the real sessions, whose ring rows and stock are advanced
    in place, an int or an int32 scalar on the device (what a captured step
    reads).  The k*B rows (B = n_stages * fbs per session) go through the
    preprocess, TAESD, UNet, epilogue and decode sequence of
    :func:`make_step_fn` once: 32 attention launches and one epilogue
    launch whatever k is, each row with its own session's prompt,
    coefficients, guidance and delta.  A session's fbs new frames take its
    first fbs rows; the renoise moves rows by fbs within each session's
    segment (``noise_shift=fbs``), as the single engine does.

    The fused epilogue reads the stock, noise, coefficients, guidance and
    delta at the slots and writes the ring and stock rows in place; the
    composed ops gather the same rows and write the first k_real back
    (``write_segments``: masked on the device, so they capture too).  The
    other modes batch as the JAX ``vmap`` of the single step does, each
    session's rows keeping their own uncond, cond, stock and coefficients:
    full CFG runs the 2·k·B rows through one UNet pass (every session's
    uncond rows first), sequential mode runs n_stages passes of k·fbs rows,
    txt2img takes each session's first fbs noise rows in place of its
    encoded frames (which it does not read).

    ``unet_variant`` (the DeepCache pair, as :func:`make_step_fn`): each
    session's deep feature is its row of ``states["unet_cache"]`` in the
    single step's layout (full CFG: its uncond rows, then its cond rows); a
    capture writes the real sessions' rows in place.

    ControlNet: each session's fbs new frames are annotated in one batch of
    k·fbs, its conditioning ring (``states["cnet_cond"]`` at its slot)
    follows them, the real sessions' rings are written back in place
    (``write_segments``), and each row's residuals are scaled by its
    session's ``cnet_scale``; sequential mode conditions every stage on the
    new frames, full CFG doubles the cond images as it doubles the rows.

    Style adapters (``states["adapters"]``, the stacked factor bank of
    adapters/): every UNet pass grafts each row's own session's factor rows,
    gathered at ``slots`` in that pass's row order (:func:`styled_runner`),
    in every mode and variant; the ControlNet's params are not grafted."""
    _check_supported(cfg, models, unet_variant)
    B = cfg.batch_size
    fbs = cfg.frame_buffer_size
    dt = cfg.torch_dtype
    fused = fused_ok(cfg)
    run = unet_runner(models, unet_variant)
    split = 2 if cfg.cfg_type == "full" else 1  # a session's cache rows: split blocks of B
    n_pass = B if cfg.use_denoising_batch else fbs  # a session's rows in one UNet pass

    @torch.inference_mode()
    def step(params, states, frames_u8, slots, k_real):
        k = frames_u8.shape[0]
        c = states["coeffs"]
        bank = states.get("adapters")
        run_ = run if bank is None else styled_runner(run, bank, slots, n_pass)
        take = lambda a: a.index_select(0, slots)  # noqa: E731
        rows = lambda a: a.reshape(k * a.shape[1], *a.shape[2:])  # noqa: E731  [k, n, ...] -> [k*n, ...]

        def ctx(name, n):  # each session's [1,L,D] embedding on its n rows
            e = take(states[name]).to(dt)  # [k,1,L,D]
            return rows(e.expand(k, n, *e.shape[2:]))

        def col(v, n):  # each session's scalar on its n rows
            return take(v).repeat_interleave(n).reshape(-1, 1, 1, 1)

        def added(n):  # SDXL: each session's pooled embeds and time ids on its n rows
            if not cfg.use_added_cond:
                return None
            tid, txt = take(states["added_time_ids"]), take(states["added_text"])  # [k,1,...]
            return added_cond(cfg, rows(tid.expand(k, n, *tid.shape[2:])),
                              rows(txt.expand(k, n, *txt.shape[2:])), k * n)

        def co_of(sl):  # the rows' coefficients, stage slice ``sl`` of each session
            return _coeffs({name: take(v)[:, sl].reshape(-1) for name, v in c.items()})

        def cache_in():  # each session's cache rows, in the pass's row order
            if unet_variant != "cached":
                return None
            a = take(states["unet_cache"])  # [k, split*B, ...]
            a = a.reshape(k, split, B, *a.shape[2:]).transpose(0, 1)
            return a.reshape(split * k * B, *a.shape[3:])

        def cache_out(deep):  # a capture's deep feature -> each real session's row
            if unet_variant == "capture":
                d = deep.reshape(split, k, B, *deep.shape[1:]).transpose(0, 1)
                write_segments(states["unet_cache"], d.reshape(k, split * B, *deep.shape[1:]),
                               slots, k_real)

        img = I.preprocess_uint8(frames_u8.reshape(k * fbs, *frames_u8.shape[-3:]), dtype=dt) \
            if cfg.mode == "img2img" or cfg.use_controlnet else None

        def cnet_of(n):  # (each session's first n cond images, its scale on them) or None
            return None if cond_full is None else (rows(cond_full[:, :n]),
                                                   col(states["cnet_scale"], n))

        cond_full = None
        if cfg.use_controlnet:
            # each session's new annotations, then its ring: [k, B, H, W, 3];
            # the real sessions' rings rotate in place, as their latent rings do
            new = _annotate(img, cfg, params).reshape(k, fbs, *img.shape[1:])
            cond_full = torch.cat([new, take(states["cnet_cond"]).to(dt)], dim=1)
            if B > fbs:
                write_segments(states["cnet_cond"], cond_full[:, : B - fbs], slots, k_real)

        if cfg.mode == "img2img":
            z0 = models.vae_encode(params, img)  # [k*fbs,h,w,c]
            z0 = z0.view(k, fbs, *z0.shape[1:])
            if cfg.do_add_noise:
                a0 = take(c["alpha"][:, :fbs]).reshape(k, fbs, 1, 1, 1).to(dt)
                s0 = take(c["sigma"][:, :fbs]).reshape(k, fbs, 1, 1, 1).to(dt)
                x_new = a0 * z0 + s0 * take(states["noise"][:, :fbs]).to(dt)
            else:
                x_new = z0
        else:  # txt2img: each session's fresh noise enters its ring
            x_new = take(states["noise"][:, :fbs]).to(dt)

        if not cfg.use_denoising_batch:
            # sequential: every stage of the new frames now, k*fbs rows a pass
            x, stocks = rows(x_new), []
            for i in range(cfg.n_stages):
                sl = slice(i * fbs, (i + 1) * fbs)
                sub = co_of(sl)
                eps, st, _ = _guided(
                    run_, cfg, params, x, sub.timesteps, ctx("cond", fbs), ctx("uncond", fbs),
                    rows(take(states["stock"][:, sl])).to(dt), sub,
                    col(states["guidance"], fbs), col(states["delta"], fbs), cnet=cnet_of(fbs),
                    added=added(fbs))
                stocks.append(st)
                x = L.renoise_next(_denoise(cfg, x, eps, sub),
                                   rows(take(states["noise"][:, sl])).to(dt), sub)
            if stocks[0] is not None:
                new = torch.cat([st.view(k, fbs, *st.shape[1:]) for st in stocks], dim=1)
                write_segments(states["stock"], new, slots, k_real)
            last = x.view(k, fbs, *x.shape[1:])
        else:
            x_t = rows(torch.cat([x_new, take(states["x_buf"]).to(dt)], dim=1)) \
                if B > fbs else rows(x_new)
            if fused:
                eps_c, deep = run_(params, x_t, take(c["timesteps"]).reshape(-1), ctx("cond", B),
                                  cache_in(), cnet_of(B), added(B))
                denoised = fused_stream_epilogue(
                    x_t, eps_c, states["stock"], states["noise"], _coeffs(c), states["guidance"],
                    states["delta"], cfg_type=cfg.cfg_type, turbo=cfg.scheduler == "turbo",
                    noise_shift=fbs, advanced_out=states["x_buf"], stock_out=states["stock"],
                    slots=slots, k_real=k_real,
                )[0]
            else:
                co = co_of(slice(None))
                eps, new_stock, deep = _guided(
                    run_, cfg, params, x_t, co.timesteps, ctx("cond", B), ctx("uncond", B),
                    rows(take(states["stock"])).to(dt), co, col(states["guidance"], B),
                    col(states["delta"], B), cache_in(), cnet_of(B), added(B))
                if new_stock is not None:
                    write_segments(states["stock"], new_stock.view(k, B, *x_t.shape[1:]), slots,
                                   k_real)
                denoised = _denoise(cfg, x_t, eps, co)
                if B > fbs:
                    advanced = L.renoise_next(
                        rows(denoised.view(k, B, *x_t.shape[1:])[:, : B - fbs]),
                        rows(take(states["noise"])[:, fbs:]).to(dt), co_of(slice(0, B - fbs)))
                    write_segments(states["x_buf"], advanced.view(k, B - fbs, *x_t.shape[1:]),
                                   slots, k_real)
            last = denoised.view(k, B, *x_t.shape[1:])[:, B - fbs:]  # each session's exit rows
            cache_out(deep)
        out_latent = last[:, 0] if fbs == 1 else rows(last)  # a view at fbs == 1

        img_out = I.postprocess_uint8(models.vae_decode(params, out_latent).float())
        return img_out.view(frames_u8.shape)

    return step


def params_variant_extra(params) -> dict:
    """Engine-key extras of the params variant (the JAX engine's): w8
    params (models/quant.py) change the step without touching the config,
    so their keys gain ``quant-w8``; dense params add nothing."""
    return {"quant": "w8"} if Q.has_quantized_kernels(params) else {}


def stack_states(states: list) -> dict:
    """Stack single-session states leaf by leaf on a new leading slot axis."""
    if isinstance(states[0], dict):
        return {key: stack_states([st[key] for st in states]) for key in states[0]}
    return torch.stack(states)


def install_row(stacked: dict, slot: int, state: dict):
    """Write one session's state into row ``slot`` of a stacked state, in
    place (the storage the kernels and a captured step use stays the same)."""
    install_state(tree_map(lambda a: a[slot], stacked), state)


@torch.inference_mode()
def install_state(state: dict, new: dict):
    """Write ``new`` into ``state`` leaf by leaf, in place (inference mode:
    the prompt embeddings come from the text tower as inference tensors)."""
    for key, value in new.items():
        if isinstance(value, dict):
            install_state(state[key], value)
        else:
            state[key].copy_(value)


def stage_into(buf: torch.Tensor, frames: np.ndarray) -> torch.Tensor:
    """Host uint8 frames -> the device buffer ``buf`` (a step's static
    frame buffer), from pinned memory without blocking on the card.  One
    of the two H2D paths of frames, so one of the two H2D meters
    (obs/devtel.py)."""
    devtel.note_h2d(frames.nbytes)
    t = torch.from_numpy(np.ascontiguousarray(frames)).reshape(buf.shape)
    if buf.device.type == "cuda":
        t = t.pin_memory()
    return buf.copy_(t, non_blocking=True)


class SimilarityFilter:
    """Host-side stochastic similar-image filter (same decisions as the JAX
    package's for the same frames and seed): cosine similarity of
    consecutive subsampled frames; skip probability ramps from 0 at the
    threshold to 1 at sim=1, with a max-skip guard."""

    def __init__(self, threshold: float, max_skip: int, seed: int = 0):
        self.threshold = threshold
        self.max_skip = max_skip
        self._rng = np.random.default_rng(seed)
        self._prev_small = None
        self._skip_count = 0

    def should_skip(self, frame_u8, have_output: bool) -> bool:
        small = np.asarray(frame_u8)[..., ::16, ::16, :].astype(np.float32)
        if self._prev_small is not None and have_output:
            a = small.ravel()
            b = self._prev_small.ravel()
            na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
            if na > 0.0 and nb > 0.0:
                sim = float(a @ b) / (na * nb)
            else:
                sim = 1.0 if na == nb else 0.0
            thr = self.threshold
            prob = 0.0 if thr >= 1.0 else max(0.0, 1.0 - (1.0 - sim) / (1.0 - thr))
            if self._rng.random() < prob and self._skip_count < self.max_skip:
                self._skip_count += 1
                return True
        self._prev_small = small
        self._skip_count = 0
        return False

    def export_state(self) -> dict:
        """The filter's decision state as JSON (a session migration): the
        subsampled previous frame, the skip streak and the RNG position, in
        the JAX filter's layout."""
        prev = self._prev_small
        return {
            "skip_count": int(self._skip_count),
            "rng_state": self._rng.bit_generator.state,
            "prev_small": None if prev is None else {
                "shape": list(prev.shape),
                "b64": base64.b64encode(
                    np.ascontiguousarray(prev, dtype=np.float32).tobytes()).decode("ascii"),
            },
        }

    def restore_state(self, state: dict):
        """Inverse of :meth:`export_state`; a bad payload raises ValueError."""
        try:
            self._skip_count = int(state["skip_count"])
            self._rng.bit_generator.state = state["rng_state"]
            prev = state.get("prev_small")
            if prev is None:
                self._prev_small = None
            else:
                raw = base64.b64decode(prev["b64"])
                self._prev_small = np.frombuffer(raw, dtype=np.float32).reshape(
                    [int(s) for s in prev["shape"]]).copy()
        except (KeyError, TypeError, ValueError, binascii.Error) as e:
            raise ValueError(f"similarity-filter state unusable: {e}") from e


class StaleStepError(RuntimeError):
    """A step held past a restart (or a rebuild) is dropped, not replayed."""


class _Poisoned:
    """The ``nan`` fault's output: a float array of NaNs in place of the
    step's frame (what a poisoned latent decodes to)."""

    def __init__(self, out: np.ndarray):
        self.out = out

    def result(self) -> np.ndarray:
        return self.out


class _Readback:
    """A D2H copy queued at submit, right after the step on the same stream
    (a replay overwrites its output: the copy must come before the next);
    ``result()`` waits for it."""

    def __init__(self, out):
        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = out, None

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        out = self.host.numpy()
        devtel.note_d2h(out.nbytes)
        return out


def _sp_wrapped(step: Callable, mesh) -> Callable:
    """``step`` inside ``layers.sp_attention_group(mesh, "sp")`` on a mesh
    whose sp axis has more than one rank (the JAX ``_wrap_sp``), else
    ``step`` itself."""
    if mesh is None or mesh.size("sp") <= 1:
        return step
    from ..models.layers import sp_attention_group

    def wrapped(params, state, frame_u8):
        with sp_attention_group(mesh, axis="sp"):
            return step(params, state, frame_u8)

    return wrapped


def _warm_groups(mesh, device):
    """One eager all-reduce over each process group of ``mesh`` on
    ``device``: a communicator comes up at its first collective, which must
    not be the one a CUDA graph captures."""
    if mesh is None:
        return
    import torch.distributed as dist

    for axis in ("tp", "sp"):
        group = mesh.group(axis) if mesh.size(axis) > 1 else None
        if group is not None:
            dist.all_reduce(torch.zeros(1, device=device), group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StreamEngine:
    """Host-side loop around the step (prompt cache, state, similarity
    filter).  ``encode_prompt``: str -> (cond, uncond) [1,L,D] tensors, or
    (cond, uncond, {"pooled": [1,P]}) for SDXL's addition conditioning.

    Runs on ``device`` ("cuda" unless the caller asks for another; raises
    without a card).  Frames stage host->device from pinned memory without
    blocking, and several steps can be in flight (``submit``/``fetch``).
    ``graphs`` (default: on a CUDA device) steps by replaying one captured
    CUDA graph, keyed by ``stream_engine_key(model_id, cfg)`` (plus the
    params variant, ``quant-w8``); False steps eagerly over the same static
    buffers.

    DeepCache (``cfg.unet_cache_interval`` N >= 2): two steps over the same
    state, the capture and the cached (keys ``variant-capture`` /
    ``variant-cached``), both captured into one pool; a host-side tick picks
    the capture every Nth submit and the cached step between.  ``prepare``,
    ``update_prompt``, ``update_t_index_list`` and ``reset_cache_cadence``
    set the tick back to 0, so the next step captures.

    ``mesh`` (parallel/mesh.py ``make_mesh``, over the world's ranks; every
    rank builds its engine alike): with tp > 1 the params are this rank's
    Megatron shards (``sharding.tp_tree``: each sharded linear and conv
    gathers or sums over the tp group; w8 params are refused, as in the JAX
    engine), and with sp > 1 every step runs inside
    ``layers.sp_attention_group(mesh, "sp")``, so a ring or Ulysses bundle
    routes its attention over the sp group.  Each rank captures its step
    (the collectives inside the graph, the groups warmed eagerly first);
    rank 0 drives the others through parallel/serving.py.  ``on_step``
    (set by parallel/serving.py's ``LockstepEngine``) is called with each
    frame that really steps, under the submit lock, before it is staged."""

    def __init__(
        self,
        models: StreamModels,
        params,
        cfg: StreamConfig,
        encode_prompt: Callable[[str], tuple],
        schedule: S.NoiseSchedule | None = None,
        device=None,
        graphs: bool | None = None,
        model_id: str = "",
        mesh=None,
    ):
        self.device = resolve_device(device)
        check_params(cfg, params)
        self.mesh = mesh
        if mesh is not None and mesh.size("tp") > 1:
            from ..parallel import sharding as SH

            if Q.has_quantized_kernels(params):
                # the rules key on ``kernel`` leaves: int8 pairs would serve
                # whole on every rank, a tp mesh computing single-card
                raise ValueError(
                    "QUANT_WEIGHTS int8 kernels are incompatible with tensor-parallel serving "
                    "(tp>1): quantized leaves have no sharding rules and would replicate. "
                    "Disable one.")
            specs = SH.param_shardings(mesh, params)
            params = SH.tp_tree(SH.shard_params(mesh, params), specs, mesh)
        self.models = models
        self.params = params
        self.cfg = cfg
        self.encode_prompt = encode_prompt
        self.schedule = schedule or S.make_schedule()
        self._t_index_list = tuple(cfg.t_index_list)
        self.variants = unet_variants(cfg)
        self._cache_interval = cfg.unet_cache_interval if cfg.unet_cache_interval >= 2 else 0
        self._tick = 0  # the DeepCache cadence: a capture when tick % N == 0
        self._steps = {v: _sp_wrapped(make_step_fn(models, cfg, unet_variant=v), mesh)
                       for v in self.variants}
        self._step = self._steps[self.variants[0]]  # the full (or capture) step
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        qextra = params_variant_extra(params)
        self.keys = {v: stream_engine_key(model_id, cfg, **({"variant": v} if v != "full" else {}),
                                          **qextra)
                     for v in self.variants}
        self.key = self.keys[self.variants[0]]
        self.graph_cache = GraphCache(self.graphs, self.device)
        self._static_steps = None  # {variant: CapturedStep}
        self._graph_state = None  # the state the graphs were captured over
        self.state = None
        self._last_out = None
        self._last_submitted = None
        self._submit_skip_flag = threading.local()
        self._sim_filter = SimilarityFilter(
            cfg.similar_image_threshold, cfg.similar_image_max_skip, seed=0
        )
        self._submit_lock = threading.Lock()
        # bumped (under the submit lock) by a restart: a step submitted
        # before it, held by a fault or a stall, must not replay into the
        # state the restart installed
        self.epoch = 0
        # compute-path fault injection (resilience/faults.py): None unless
        # a plan targets the engine
        self._fault_scope = _faults.scope("engine")
        self.on_step = None  # callable(frame_u8) before each real step (lockstep serving)

    # -- state construction -------------------------------------------------

    def build_state(
        self,
        prompt: str,
        num_inference_steps: int | None = None,
        guidance_scale: float = 1.2,
        delta: float = 1.0,
        seed: int = 2,
        noise_device=None,
    ) -> dict:
        """A fresh initial state (a new dict; the engine's own is not
        touched); the noise comes from a torch.Generator seeded with
        ``seed`` on ``noise_device`` (default: the engine's device), then
        moves to the engine's device.  A CPU generator draws the same noise
        for an engine on any device (utils/golden.py replays a CPU capture
        on the card so)."""
        cfg = self.cfg
        if num_inference_steps is not None and num_inference_steps != cfg.num_inference_steps:
            raise ValueError("num_inference_steps is fixed per engine; rebuild the engine")
        h, w = cfg.latent_hw
        B, fbs, dt = cfg.batch_size, cfg.frame_buffer_size, cfg.torch_dtype
        gen = torch.Generator(device=noise_device or self.device).manual_seed(seed)
        noise = torch.randn(
            (B, h, w, cfg.latent_channels), generator=gen, device=gen.device
        ).to(self.device, dt)
        cond, uncond, extras = self._encode(prompt)
        state = {
            "x_buf": noise[fbs:].clone(),
            "noise": noise,
            "stock": torch.zeros_like(noise),
            "cond": cond,
            "uncond": uncond,
            "guidance": self._scalar(guidance_scale),
            "delta": self._scalar(delta),
            "coeffs": coeff_state(cfg, self.schedule, self._t_index_list, self.device),
        }
        if cfg.use_added_cond:
            state["added_text"] = extras["pooled"]
            state["added_time_ids"] = extras.get("time_ids", torch.tensor(
                [[cfg.height, cfg.width, 0, 0, cfg.height, cfg.width]], dtype=torch.float32,
                device=self.device))
        if cfg.use_controlnet:
            # the conditioning ring, aligned with x_buf, and its scale
            state["cnet_cond"] = torch.zeros((B - fbs, cfg.height, cfg.width, 3), dtype=dt,
                                             device=self.device)
            state["cnet_scale"] = self._scalar(1.0)
        if cfg.cfg_type == "initialize":
            # Onetime-Negative: seed the stock noise with one real uncond pass
            with torch.inference_mode():
                unc = uncond.expand(B, *uncond.shape[1:])
                added = added_cond(cfg, state.get("added_time_ids"), state.get("added_text"), B)
                state["stock"] = self.models.unet(
                    self.params, noise, state["coeffs"]["timesteps"], unc,
                    **({} if added is None else {"added": added})
                ).to(dt)
        if self._cache_interval:
            # the DeepCache slot, pre-sized (zeros) so that every step sees
            # one state structure; the first step after prepare() captures
            shape = self.models.deep_cache_shape(
                (deep_cache_rows(cfg), h, w, cfg.latent_channels))
            state["unet_cache"] = torch.zeros(shape, dtype=dt, device=self.device)
        return state

    def prepare(self, prompt: str, num_inference_steps: int | None = None,
                guidance_scale: float = 1.2, delta: float = 1.0, seed: int = 2,
                noise_device=None):
        """(Re)build the state from ``prompt`` and ``seed`` (its noise drawn
        on ``noise_device``, :meth:`build_state`): the first call sets it, a
        later one (a restart) writes it in place.  The next step captures
        (DeepCache)."""
        state = self.build_state(prompt, num_inference_steps, guidance_scale, delta, seed,
                                 noise_device)
        if self.state is None:
            self.state = state
        else:
            install_state(self.state, state)
        # tpurtc: allow[lock-discipline] -- prepare() runs at build time, before the engine is shared, or from StreamDiffusionPipeline.restart() under _submit_lock, the lock the other _tick writers take
        self._tick = 0
        return self

    def restart(self, prompt: str, guidance_scale: float = 1.2, delta: float = 1.0,
                seed: int = 2):
        """A fresh stream state in place (``prepare`` under the submit lock).
        A step submitted before it and held past it (a stall, an injected
        fault, a step the supervisor abandoned) is dropped, not replayed:
        the restart bumps the epoch under the lock."""
        if not self._submit_lock.acquire(timeout=10.0):
            raise RuntimeError("engine restart blocked: submit lock still held")
        try:
            self.epoch += 1
            self.prepare(prompt=prompt, guidance_scale=guidance_scale, delta=delta, seed=seed)
        finally:
            self._submit_lock.release()

    def install(self, state: dict):
        """Write ``state`` (a snapshot's leaves, all or some) into the live
        state in place; the next step captures (DeepCache)."""
        with self._submit_lock:
            install_state(self.state, state)
            self._tick = 0

    def _scalar(self, v):
        return torch.tensor(float(v), dtype=torch.float32, device=self.device)

    def _encode(self, prompt: str):
        """-> (cond, uncond, extras) on the device: ``encode_prompt`` may
        return a 2-tuple or, with SDXL's extras, a 3-tuple, as the JAX
        engine takes it.  The embeddings and the pooled embeds in the
        compute dtype; time ids, where given, f32."""
        res = self.encode_prompt(prompt)
        dt = self.cfg.torch_dtype
        extras = {name: torch.as_tensor(v, device=self.device).to(
                      torch.float32 if name == "time_ids" else dt)
                  for name, v in (res[2] if len(res) == 3 else {}).items()}
        return (
            torch.as_tensor(res[0], device=self.device).to(dt),
            torch.as_tensor(res[1], device=self.device).to(dt),
            extras,
        )

    # -- the captured step ----------------------------------------------------

    def capture(self) -> dict:
        """Build the step (each DeepCache variant) over its static buffers
        and, with ``graphs``, capture it now, on the calling thread (the
        counterpart of the JAX engine's compile before the first frame).
        The captures' warm-up steps write the ring, the stock and the deep
        cache; they are put back after.  -> {variant: CapturedStep}."""
        with self._submit_lock:
            return self._static_steps_locked()

    def _static_steps_locked(self) -> dict:
        if self.state is None:
            raise RuntimeError("call prepare() first")
        if self._static_steps is None:
            cfg = self.cfg
            saved = tree_map(lambda a: a.clone(), self.state) if self.graphs else None
            # one frame buffer for every variant: a submit stages once
            frame = torch.zeros((cfg.frame_buffer_size, cfg.height, cfg.width, 3),
                                dtype=torch.uint8, device=self.device)
            if self.graphs:
                _warm_groups(self.mesh, self.device)
            steps = {}
            for v in self.variants:
                with devtel.compile_scope("engine-step"):
                    steps[v] = self.graph_cache.get(self.keys[v], lambda v=v: (
                        lambda inputs: self._steps[v](self.params, self.state, inputs["frame"])[1],
                        {"frame": frame}))
            self._static_steps = steps
            if saved is not None:
                install_state(self.state, saved)
                self._graph_state = self.state
        if self.graphs and self.state is not self._graph_state:
            raise RuntimeError(
                "the engine's state was replaced after its step was captured: write it in "
                "place (prepare(), install_state)")
        return self._static_steps

    def _next_variant_locked(self) -> str:
        """The variant of the next step (DeepCache: the capture every Nth
        step, the cached step between), advancing the cadence."""
        if not self._cache_interval:
            return self.variants[0]
        v = "capture" if self._tick % self._cache_interval == 0 else "cached"
        self._tick += 1
        return v

    # -- hot path -----------------------------------------------------------

    def __call__(self, frame_u8: np.ndarray) -> np.ndarray:
        """One stream step. [H,W,3] uint8 -> [H,W,3] uint8 ([fbs,H,W,3] with
        frame_buffer_size > 1)."""
        return self.fetch(self.submit(frame_u8))

    @property
    def last_submit_was_skip(self) -> bool:
        return getattr(self._submit_skip_flag, "value", False)

    @last_submit_was_skip.setter
    def last_submit_was_skip(self, value: bool):
        self._submit_skip_flag.value = value

    def submit(self, frame_u8: np.ndarray):
        """Queue one step without waiting; returns a handle for :meth:`fetch`.
        Steps from concurrent callers serialize on a lock (host work only):
        the frame goes into the static frame buffer, then the step runs (a
        replay on the card) and its D2H copy is queued."""
        if self.state is None:
            raise RuntimeError("call prepare() first")
        self.last_submit_was_skip = False  # tpurtc: allow[lock-discipline] -- thread-local descriptor: each calling thread writes only its own _submit_skip_flag slot
        squeeze = frame_u8.ndim == 3
        epoch = self.epoch
        if self._fault_scope is not None:
            # before the lock: an injected stall holds this thread only
            if self._fault_scope.step() == "nan":
                h, w = self.cfg.height, self.cfg.width
                shape = (h, w, 3) if squeeze else (frame_u8.shape[0], h, w, 3)
                return _Poisoned(np.full(shape, np.nan, np.float32)), squeeze
        with self._submit_lock:
            if self.epoch != epoch:
                raise StaleStepError("the engine restarted while this step was held")
            if self.cfg.similar_image_filter and self._sim_filter.should_skip(
                frame_u8, have_output=self._last_out is not None
            ):
                self.last_submit_was_skip = True
                if self._last_submitted is not None:
                    return self._last_submitted
                return None, squeeze
            if self.on_step is not None:
                self.on_step(frame_u8)
            step = self._static_steps_locked()[self._next_variant_locked()]
            stage_into(step.inputs["frame"], frame_u8)
            self._last_submitted = (_Readback(step.run()), squeeze)
            return self._last_submitted

    def follow_step(self, frame: torch.Tensor):
        """A follower rank's step (parallel/serving.py): the frame rank 0
        stepped (a uint8 tensor of its shape) into the static buffer, one
        step of the same variant, and no readback.  The similarity filter
        is rank 0's: it sends only the frames that step."""
        with self._submit_lock:
            step = self._static_steps_locked()[self._next_variant_locked()]
            buf = step.inputs["frame"]
            buf.copy_(frame.reshape(buf.shape), non_blocking=True)
            step.run()

    def fetch(self, pending) -> np.ndarray:
        """Resolve a :meth:`submit` handle to a host uint8 array."""
        readback, squeeze = pending
        if readback is None:  # skipped before any frame was stepped
            return self._last_out
        out = readback.result()
        if out.shape[0] == 1 and squeeze:
            out = out[0]
        self._last_out = out
        return out

    # -- control plane (in place: a captured step reads these tensors) -------

    def update_prompt(self, prompt: str):
        """The prompt's embeddings (SDXL: and its pooled embeds), in place;
        DeepCache: the next step captures (stale deep cross-attention
        features never serve under a new prompt)."""
        cond, uncond, extras = self._encode(prompt)
        new = {"cond": cond, "uncond": uncond}
        if self.cfg.use_added_cond and "pooled" in extras:
            new["added_text"] = extras["pooled"]
        with self._submit_lock:
            install_state(self.state, new)
            self._tick = 0

    def update_t_index_list(self, t_index_list):
        """Same-length update = coefficient swap; the length is fixed.
        DeepCache: new timesteps, so the next step captures."""
        coeffs = t_index_coeffs(self.cfg, self.schedule, t_index_list, self.device,
                                hint="; rebuild the engine to change depth")
        self._t_index_list = tuple(int(t) for t in t_index_list)
        with self._submit_lock:
            install_state(self.state, {"coeffs": coeffs})
            self._tick = 0

    def reset_cache_cadence(self):
        """DeepCache: make the next step a capture (after a warm-up, and
        across any known discontinuity)."""
        with self._submit_lock:
            self._tick = 0

    def update_controlnet_scale(self, scale: float):
        """The conditioning strength, in place (no new capture): the JAX
        engine's runtime swap of the reference's fixed scale."""
        if not self.cfg.use_controlnet:
            raise RuntimeError("engine built without use_controlnet")
        with self._submit_lock:
            install_state(self.state, {"cnet_scale": self._scalar(scale)})

    def update_guidance(self, guidance_scale=None, delta=None):
        new = {}
        if guidance_scale is not None:
            new["guidance"] = self._scalar(guidance_scale)
        if delta is not None:
            new["delta"] = self._scalar(delta)
        with self._submit_lock:
            install_state(self.state, new)
