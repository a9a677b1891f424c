"""Image-quality metrics (PSNR / SSIM) and the moving test scene — numpy
only; the port's own copy of ai_rtc_agent_tpu/utils/quality.py.

Used by the port's DeepCache quality gate (tests/test_torch_deepcache.py)
and chip_smoke.py phase 13b.  SSIM follows Wang et al. 2004 with an 8x8
uniform window (the original paper's constants K1=0.01, K2=0.03, L=255)."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def _window_means(x: np.ndarray, win: int) -> np.ndarray:
    """Mean over non-overlapping win x win blocks per channel (uniform
    window; integral-image tricks are overkill at our sizes)."""
    h, w = x.shape[:2]
    hh, ww = h - h % win, w - w % win
    x = x[:hh, :ww]
    blocks = x.reshape(hh // win, win, ww // win, win, -1)
    return blocks.mean(axis=(1, 3))


def ssim(a: np.ndarray, b: np.ndarray, win: int = 8, peak: float = 255.0) -> float:
    """Mean SSIM over non-overlapping windows, averaged across channels."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
    if b.ndim == 2:
        b = b[..., None]
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _window_means(a, win)
    mu_b = _window_means(b, win)
    mu_aa = _window_means(a * a, win)
    mu_bb = _window_means(b * b, win)
    mu_ab = _window_means(a * b, win)
    var_a = mu_aa - mu_a**2
    var_b = mu_bb - mu_b**2
    cov = mu_ab - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(np.mean(s))


def moving_scene(n: int, h: int, w: int, square: int | None = None):
    """Synthetic temporal-change workload: a bright square translating
    3 px/frame over a fixed gradient (the JAX package's generator, so both
    packages' DeepCache gates measure the same scene)."""
    square = square if square is not None else max(8, h // 4)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy * 255 // h + xx * 128 // w) % 256).astype(np.uint8)
    frames = []
    for i in range(n):
        f = np.stack([base, base[::-1], base.T], axis=-1).copy()
        x0 = (5 + 3 * i) % (w - square)
        y0 = (8 + 2 * i) % (h - square)
        f[y0 : y0 + square, x0 : x0 + square] = (250, 40, 40)
        frames.append(f)
    return frames
