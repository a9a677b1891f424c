"""The fused stream-step epilogue: the CUDA C++ kernel for Hopper and its
plain version.

Replaces ai_rtc_agent_tpu/ops/pallas/fused_scheduler.py
(``fused_stream_epilogue``, Pallas body ``_kernel``).  Per batch row b, with
scalars alpha, sigma, c_skip, c_out, next_alpha, next_sigma and (g, delta):

    eps    = g*eps_c - (g-1)*delta*stock     (cfg self/initialize; else eps_c)
    x0     = (x - sigma*eps) / alpha
    den    = c_skip*x + c_out*x0
    adv    = next_alpha*den + next_sigma*noise
    stock' = (eps_c + beta*stock)/(1+beta),  beta = sigma/max(alpha, 1e-6)
             (cfg self; otherwise the stock is returned unchanged)

The kernel source is ``csrc/fused_stream_epilogue.cu``; its header says what
bounds it on the card (the launch: ~96 KB on the main path) and how the
design answers it (one launch, 16-byte vector loads, coefficients read by
pointer from the device).  Built with nvcc (sm_90a) into ``build/`` at
first use, bound with ctypes.

Beyond the JAX function's arguments, keywords let one launch carry the whole
post-UNet chain of the port's step, with no glue around it:

* ``turbo``: the turbo step, pred_x0 == the blend with c_skip=0, c_out=1
  (``coeffs.c_skip``/``c_out`` are not read).
* ``noise_shift``: entry b renoises with row b+shift of ``noise``; entries
  past its last row get 0 (the JAX step's concatenation of
  ``noise[shift:]`` and zeros).
* ``advanced_out``: [R, ...] tensor that receives the advanced rows b < R
  in place and is returned in place of ``advanced``.
* ``stock_out``: receives the new stock in place (cfg self; it may be
  ``stock`` itself).  With cfg none/initialize the stock does not change,
  ``stock_out`` is not written and ``stock`` is returned.
* ``slots``: the session axis of a bucket step (the JAX kernel under
  ``jax.vmap`` over sessions).  An int32 tensor [k] on x's device: the
  R = k*seg rows of x and eps_c are k segments of seg rows, and segment s
  is session slot ``slots[s]`` of the stacked [S, ...] state.  Then stock
  and stock_out are [S, seg, ...], noise [S, noise_rows, ...] (the shift
  applies within each slot's rows), advanced_out [S, adv_rows, ...] (it is
  required), the coefficient vectors [S, seg], guidance and delta [S]; the
  advanced rows and the new stock land in each slot's rows in place.
* ``k_real``: with ``slots``, only the first k_real segments write
  advanced_out and stock_out.  A padded bucket repeats its last real slot
  at the tail; its padding segments compute and write only ``denoised``
  (their rows are discarded), so no slot is written twice.  The first
  k_real slots must be distinct.  An int, or an int32 tensor of one
  element on x's device that the kernel reads: a CUDA graph replays a
  launch with the arguments it was captured with, so a bucket step
  captured once serves every occupancy only with the count as data.

The wrapper does no host sync, so a launch can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, refuse_grad

SOURCE = "fused_stream_epilogue.cu"
CFG_TYPES = ("none", "initialize", "self")  # index = the kernel's cfg code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype code

launches = 0  # kernel launches since the last reset (plain int)

_lib = None


def load():
    """Compile (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE)
        fn = lib.fused_stream_epilogue
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_stream_epilogue_empty.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        lib.fused_stream_epilogue_empty.restype = ctypes.c_int
        lib.fused_stream_epilogue_error_string.argtypes = [ctypes.c_int]
        lib.fused_stream_epilogue_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str):
    if err:
        msg = load().fused_stream_epilogue_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def launch_empty(rows: int, n: int, device=None):
    """Launch an empty kernel on the epilogue's grid for ``rows`` rows of
    ``n`` elements: the launch floor the kernel is timed against."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(load().fused_stream_epilogue_empty(rows, n, stream), "empty kernel")


def write_segments(dst, rows, slots, k_real):
    """``dst[slots[s]] = rows[s]`` for the first ``k_real`` segments s, in
    place, with ``k_real`` an int or a one-element tensor read on the
    device (no host sync, so it can be captured).  Every other row of
    ``dst`` keeps its bits; a slot named twice among the first k_real takes
    its first segment's rows.  ``dst``: [S, ...]; ``rows``: [k, ...]."""
    S, k = dst.shape[0], slots.numel()
    dev = dst.device
    live = torch.arange(k, device=dev) < torch.as_tensor(k_real, device=dev).reshape(())
    hit = (slots.long()[None, :] == torch.arange(S, device=dev)[:, None]) & live[None, :]  # [S, k]
    first = hit.to(torch.int32).argmax(dim=1)  # the first segment that names each slot
    keep = hit.any(dim=1).reshape((S,) + (1,) * (dst.ndim - 1))
    return dst.copy_(torch.where(keep, rows.index_select(0, first).to(dst.dtype), dst))


def epilogue_plain(x_t, eps_c, stock, noise, coeffs, guidance, delta, cfg_type="self", *,
                   turbo=False, noise_shift=0, advanced_out=None, stock_out=None, slots=None,
                   k_real=None):
    """The kernel's math as composed PyTorch ops (f32, cast to x's dtype),
    with the same keywords as :func:`fused_stream_epilogue`."""
    if cfg_type not in CFG_TYPES:
        raise ValueError(f"fused epilogue: unsupported cfg_type {cfg_type!r}")
    f32 = lambda a: torch.as_tensor(a, device=x_t.device).to(torch.float32)
    col = lambda a: f32(a).reshape((-1,) + (1,) * (x_t.ndim - 1))
    R = x_t.shape[0]
    if slots is None:  # one segment: today's shapes, a scalar guidance and delta
        k, seg, idx = 1, R, torch.zeros(1, dtype=torch.long, device=x_t.device)
        rows = lambda a: a[None]
        per_row = lambda a: f32(a).reshape(1)
    else:
        idx = slots.long()
        k = idx.numel()
        seg = R // k
        rows = lambda a: a
        per_row = lambda a: f32(a)
    take = lambda a: rows(a).index_select(0, idx)  # [k, seg or rows, ...]
    cvec = lambda a: col(take(f32(a)).reshape(-1))  # per row
    alpha, sigma = cvec(coeffs.alpha), cvec(coeffs.sigma)
    g = col(per_row(guidance).index_select(0, idx).repeat_interleave(seg))
    d = col(per_row(delta).index_select(0, idx).repeat_interleave(seg))
    x = x_t.float()
    e = eps_c.float()
    s = take(stock).reshape(x.shape).float()
    eps = g * e - (g - 1.0) * d * s if cfg_type != "none" else e
    x0 = (x - sigma * eps) / alpha
    den = x0 if turbo else cvec(coeffs.c_skip) * x + cvec(coeffs.c_out) * x0
    nz = torch.zeros_like(x).reshape(k, seg, *x.shape[1:])
    src = take(noise)
    m = max(0, min(src.shape[1] - noise_shift, seg))
    nz[:, :m] = src[:, noise_shift:noise_shift + m].float()
    adv = (cvec(coeffs.next_alpha) * den + cvec(coeffs.next_sigma) * nz.reshape(x.shape)).to(x_t.dtype)
    k_real = k if k_real is None else k_real
    if advanced_out is not None:
        a_rows = advanced_out.shape[1] if slots is not None else advanced_out.shape[0]
        new_rows = adv.reshape(k, seg, *x.shape[1:])[:, :a_rows]
        if slots is None:
            adv = advanced_out.copy_(new_rows[0])
        else:
            adv = write_segments(advanced_out, new_rows, idx, k_real)
    elif slots is not None:
        raise ValueError("slots need advanced_out (the stacked ring the rows land in)")
    new_stock = stock
    if cfg_type == "self":
        beta = sigma / torch.clamp(alpha, min=1e-6)
        new_stock = ((e + beta * s) / (1.0 + beta)).to(x_t.dtype)
        if slots is not None:
            if stock_out is None:
                raise ValueError("slots with cfg self need stock_out")
            new_stock = write_segments(stock_out, new_stock.reshape(k, seg, *x.shape[1:]), idx,
                                       k_real)
        elif stock_out is not None:
            new_stock = stock_out.copy_(new_stock)
    return den.to(x_t.dtype), adv, new_stock


def _f32_ptr(name, v, numel, device):
    """The device pointer of an f32 coefficient tensor of ``numel`` entries."""
    if not (isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device == device
            and v.numel() == numel and v.is_contiguous()):
        raise TypeError(f"{name}: needs a contiguous f32 tensor of {numel} on {device}")
    return v.data_ptr()


def fused_stream_epilogue(x_t, eps_c, stock, noise, coeffs, guidance, delta, cfg_type="self", *,
                          turbo=False, noise_shift=0, advanced_out=None, stock_out=None,
                          slots=None, k_real=None):
    """x_t/eps_c/stock/noise: [B, h, w, c] -> (denoised, advanced, stock').

    ``coeffs``: ops.lcm.StepCoeffs with [B] vectors; keywords as the module
    docstring says (with ``slots``, the stacked shapes it gives).  A CPU
    tensor takes :func:`epilogue_plain`; a CUDA tensor launches the kernel
    or raises: every tensor must share x's row shape, device and dtype
    (bf16 or f32), the outputs must be contiguous, and the coefficient
    vectors, guidance and delta must be f32 tensors on that device.  A
    call that would need a gradient raises on every device
    (:func:`~ai_rtc_agent_tpu_torch.ops.kernels.refuse_grad`)."""
    global launches
    refuse_grad("fused_stream_epilogue", x_t, eps_c, stock, noise, guidance, delta,
                *(getattr(coeffs, name, None) for name in ("alpha", "sigma", "c_skip", "c_out",
                                                           "next_alpha", "next_sigma")))
    device = x_t.device
    if device.type == "cpu":
        return epilogue_plain(x_t, eps_c, stock, noise, coeffs, guidance, delta, cfg_type,
                              turbo=turbo, noise_shift=noise_shift, advanced_out=advanced_out,
                              stock_out=stock_out, slots=slots, k_real=k_real)
    if device.type != "cuda":
        raise ValueError(f"fused_stream_epilogue: unsupported device {device}")
    if cfg_type not in CFG_TYPES:
        raise ValueError(f"fused epilogue: unsupported cfg_type {cfg_type!r}")
    dtype, shape = x_t.dtype, x_t.shape
    if dtype not in DTYPES:
        raise TypeError(f"fused_stream_epilogue takes bf16 or f32, got {dtype}")
    if x_t.numel() == 0:
        raise ValueError(f"empty x {tuple(shape)}")
    is_self = cfg_type == "self"
    if not is_self:
        stock_out = None  # the stock does not change
    R, row = shape[0], shape[1:]
    if slots is None:
        k, seg, n_slots = 1, R, 1  # one slot, and no slot axis on the tensors
    else:
        if not (isinstance(slots, torch.Tensor) and slots.dtype == torch.int32
                and slots.device == device and slots.ndim == 1 and slots.is_contiguous()):
            raise TypeError(f"slots: needs a contiguous int32 vector on {device}")
        k = slots.numel()
        if k == 0 or R % k:
            raise ValueError(f"{R} rows do not split into {k} sessions")
        seg, n_slots = R // k, stock.shape[0]
        if advanced_out is None or (is_self and stock_out is None):
            raise ValueError("slots need advanced_out (and stock_out with cfg self) in place")
    k_real_dev = 0
    if isinstance(k_real, torch.Tensor):
        if not (slots is not None and k_real.dtype == torch.int32 and k_real.device == device
                and k_real.numel() == 1):
            raise TypeError(f"k_real: with slots, an int or one int32 on {device}")
        k_real_dev, k_real = k_real.data_ptr(), k  # the kernel reads the count
    k_real = k if k_real is None else int(k_real)
    if not 0 <= k_real <= k:
        raise ValueError(f"k_real {k_real} not in [0, {k}]")
    for name, t in (("eps_c", eps_c), ("stock", stock), ("noise", noise),
                    ("advanced_out", advanced_out), ("stock_out", stock_out)):
        if t is None:
            continue
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name} {t.dtype}@{t.device} vs x {dtype}@{device}: mixed dtypes or devices")
        if name == "eps_c" or (slots is None and name in ("stock", "noise", "stock_out")):
            ok = t.shape == shape
        elif slots is None:  # advanced_out: any number of leading rows
            ok = t.shape[1:] == row
        else:
            ok = t.shape[0] == n_slots and t.shape[2:] == row and (
                name == "noise" or name == "advanced_out" or t.shape[1] == seg)
        if not ok:
            raise ValueError(f"{name} {tuple(t.shape)} vs x {tuple(shape)}"
                             + ("" if slots is None else f" in {k} sessions"))
    if advanced_out is None:
        adv_rows = R
    else:
        adv_rows = advanced_out.shape[0 if slots is None else 1]
    if adv_rows > seg:
        raise ValueError(f"advanced_out has {adv_rows} rows, more than {seg}")
    if any(t is not None and not t.is_contiguous() for t in (advanced_out, stock_out)):
        raise ValueError("advanced_out/stock_out must be contiguous")
    if noise_shift < 0:
        raise ValueError(f"noise_shift {noise_shift} < 0")
    numel = n_slots * seg
    alpha, sigma, next_alpha, next_sigma = (
        _f32_ptr(name, getattr(coeffs, name), numel, device)
        for name in ("alpha", "sigma", "next_alpha", "next_sigma"))
    c_skip = 0 if turbo else _f32_ptr("c_skip", coeffs.c_skip, numel, device)
    c_out = 0 if turbo else _f32_ptr("c_out", coeffs.c_out, numel, device)
    g, d = _f32_ptr("guidance", guidance, n_slots, device), _f32_ptr("delta", delta, n_slots, device)
    x, e, s, nz = (t.contiguous() for t in (x_t, eps_c, stock, noise))
    noise_rows = nz.shape[0] if slots is None else nz.shape[1]
    den = torch.empty_like(x)
    adv = torch.empty_like(x) if advanced_out is None else advanced_out
    new_stock = (torch.empty_like(x) if stock_out is None else stock_out) if is_self else stock
    lib = load()
    with torch.cuda.device(device):
        err = lib.fused_stream_epilogue(
            x.data_ptr(), e.data_ptr(), s.data_ptr(), nz.data_ptr(), den.data_ptr(),
            adv.data_ptr(), new_stock.data_ptr() if is_self else 0,
            alpha, sigma, c_skip, c_out, next_alpha, next_sigma, g, d,
            0 if slots is None else slots.data_ptr(), k_real_dev,
            DTYPES[dtype], CFG_TYPES.index(cfg_type), int(turbo), R, x.numel() // R,
            seg, k_real if slots is not None else 1, noise_rows, noise_shift, adv_rows,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check(err, "fused_stream_epilogue")
    launches += 1
    return den, adv, new_stock
