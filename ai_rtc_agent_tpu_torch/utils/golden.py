"""Golden-output fingerprinting — the port's copy of
ai_rtc_agent_tpu/utils/golden.py, with the procedure on the port's engine.

The procedure is deterministic:

    fixed synthetic input -> FRAMES stream steps -> fingerprint(output)

``scripts/torch_golden_capture.py`` runs it and writes
``tests/golden_torch/<model>.json``; a later run on any device replays it
and compares within tolerance.  Fingerprint = per-channel mean/std + an 8x8
normalized luma thumbnail (robust to bf16/device drift, sensitive to
key-map/scale bugs that turn output into noise).

The tiny families' "weights" are the seeded init itself, so their golden is
hermetic: the port's ``tiny-test`` golden is captured on the CPU in f32 and
replayed on the card in bf16, a check of the card against the CPU.  For
that the weights and the stream state's noise are drawn from CPU
generators whatever the device (the serving path draws its noise on the
device).  A real family needs a local snapshot: without one, ``capture``
raises before any full-geometry init.
"""

from __future__ import annotations

import json

import numpy as np

GOLDEN_PROMPT = "a watercolor painting of a lighthouse at dawn"
FRAMES = 2
SEED = 1234


def golden_input(h: int, w: int) -> np.ndarray:
    """Deterministic structured input (gradients + a disc), NOT noise — a
    real model must produce spatially-coherent output from it."""
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    img = np.stack(
        [
            (xx / max(w - 1, 1)) * 255,
            (yy / max(h - 1, 1)) * 255,
            (r < min(h, w) / 4) * 200.0 + 25,
        ],
        axis=-1,
    )
    return img.astype(np.uint8)


def fingerprint(frame_u8: np.ndarray) -> dict:
    f = frame_u8.astype(np.float32)
    luma = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    h, w = luma.shape
    th, tw = h // 8, w // 8
    thumb = luma[: th * 8, : tw * 8].reshape(8, th, 8, tw).mean(axis=(1, 3))
    thumb = (thumb - thumb.mean()) / (thumb.std() + 1e-6)
    return {
        "mean": [round(float(f[..., c].mean()), 2) for c in range(3)],
        "std": [round(float(f[..., c].std()), 2) for c in range(3)],
        "thumb": [round(float(v), 3) for v in thumb.ravel()],
    }


def prepare(eng, noise_device="cpu"):
    """The procedure's state: ``GOLDEN_PROMPT``, guidance 1.0, seed
    ``SEED``, its noise drawn on ``noise_device``."""
    return eng.prepare(GOLDEN_PROMPT, guidance_scale=1.0, seed=SEED, noise_device=noise_device)


def outputs(eng) -> list:
    """``FRAMES`` steps of ``golden_input`` through a prepared engine."""
    cfg = eng.cfg
    frame = golden_input(cfg.height, cfg.width)
    return [eng(frame) for _ in range(FRAMES)]


def record(model_id: str, cfg, out: np.ndarray) -> dict:
    """The golden record of the procedure's last output frame."""
    return {
        "model_id": model_id,
        "prompt": GOLDEN_PROMPT,
        "frames": FRAMES,
        "seed": SEED,
        "hw": [cfg.height, cfg.width],
        "fingerprint": fingerprint(np.asarray(out)),
    }


def capture(model_id: str = "stabilityai/sd-turbo", device=None) -> dict:
    """Run the deterministic procedure on ``device`` (the card unless the
    caller asks for another; bf16 there, f32 on the CPU); raises unless
    REAL weights loaded (a tiny family's seeded init stands in for them)."""
    from .. import resolve_device
    from ..models import registry
    from ..stream.engine import StreamEngine
    from ..tree import tree_map

    device = resolve_device(device)
    fam = registry.family_of(model_id)
    tiny = fam in registry.TINY_FAMILIES
    no_weights = RuntimeError(
        f"no local weights for {model_id} — the golden procedure is "
        "only meaningful with real safetensors (assets/download.py)"
    )
    if not tiny and not registry.resolve_snapshot_dir(model_id):
        # fail fast on the cheap snapshot probe: a full-geometry random init
        # costs seconds before load_model_bundle would notice the absence
        raise no_weights
    cfg = registry.default_stream_config(model_id, device=device)
    # a tiny family's weights from a CPU generator, so every device serves the same tree
    params = (tree_map(lambda a: a.to(device), registry.init_params(fam, 0, "cpu"))
              if tiny else None)
    bundle = registry.load_model_bundle(model_id, device=device, attn_impl=cfg.attn_impl,
                                        params=params, latent_scale=cfg.latent_scale)
    if not bundle.loaded_real_weights and not tiny:
        raise no_weights
    bundle.params = registry.cast_params(bundle.params, cfg.dtype)
    eng = StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                       device=device, model_id=model_id)
    return record(model_id, cfg, outputs(prepare(eng))[-1])


def compare(golden: dict, got: dict, thumb_corr_min: float = 0.9,
            stat_atol: float = 24.0) -> list:
    """-> list of mismatch strings (empty = pass).  Tolerances absorb
    bf16-vs-fp32 and device drift but catch noise output (a random-weight
    run correlates ~0 with any structured golden)."""
    problems = []
    g, t = golden["fingerprint"], got["fingerprint"]
    for k in ("mean", "std"):
        for c in range(3):
            if abs(g[k][c] - t[k][c]) > stat_atol:
                problems.append(
                    f"{k}[{c}]: golden {g[k][c]} vs got {t[k][c]} (atol {stat_atol})"
                )
    a = np.asarray(g["thumb"])
    b = np.asarray(t["thumb"])
    corr = float(np.corrcoef(a, b)[0, 1])
    if not corr >= thumb_corr_min:
        problems.append(f"thumbnail correlation {corr:.3f} < {thumb_corr_min}")
    return problems


def save(result: dict, path: str):
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
