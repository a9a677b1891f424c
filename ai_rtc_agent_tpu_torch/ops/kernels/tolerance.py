"""How close each kernel must come to its plain version on the card.

One definition for ``chip_smoke.py`` and ``tests/test_torch_gpu.py``, so a
kernel is held to the same bound wherever it is checked.

Attention (bf16): the kernel rounds P to bf16 before P.V and the output
rounds to bf16, so its error scales with the output itself.  Each shape is
held to a max abs error of 2^-6 of its own max|ref| and to a relative L2
error of 1e-2.  No absolute floor: at Lq = Lk = 4096 the outputs are small
(max|ref| ~0.26), and a kernel that dropped or mis-rescaled one of the 64
key tiles would miss by ~1/8 in relative L2.

Epilogue (bf16 in, f32 math, bf16 out on both sides): within one bf16 ulp
(2^-7 relative) of each element, plus 1e-6 of the slab's scale for
cancellations.
"""

from __future__ import annotations

import torch

ATTN_REL_MAX_ABS = 2.0**-6
ATTN_REL_L2 = 1e-2


def _to_host(*stats) -> list:
    """Scalar statistics on the host as Python floats, in one copy."""
    # tpurtc: allow[device-transfer] -- a kernel check's statistics, read once after the comparison (chip_smoke.py and the card tests), never on the serving path
    return torch.stack([s.float() for s in stats]).tolist()


def attention_error(out, ref) -> dict:
    """Errors of ``out`` against ``ref`` and whether they are in bounds."""
    out, ref = out.float(), ref.float()
    diff = out - ref
    scale, max_abs, rel_l2, finite = _to_host(ref.abs().max(), diff.abs().max(),
                                              diff.norm() / ref.norm(), out.isfinite().all())
    err = {
        "max_abs": max_abs,
        "tol_abs": ATTN_REL_MAX_ABS * scale,
        "rel_l2": rel_l2,
        "tol_rel_l2": ATTN_REL_L2,
    }
    err["ok"] = bool(finite and err["max_abs"] <= err["tol_abs"]
                     and err["rel_l2"] <= err["tol_rel_l2"])
    return err


def epilogue_error(got, want) -> dict:
    """Errors of one epilogue output slab against the plain version's."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    big = b.abs() > 1e-3 * b.abs().max()  # relative error where it means something
    max_abs, max_rel, finite, within = _to_host(
        diff.max(), torch.where(big, diff / b.abs(), 0.0).max(), a.isfinite().all(),
        (diff <= 2.0**-7 * b.abs() + 1e-6 * b.abs().max()).all())
    return {"max_abs": max_abs, "max_rel": max_rel, "ok": bool(finite and within)}
