"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Wrapper rule shared by every kernel here: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  Nothing falls back.
Each wrapper keeps a plain-int launch count (module global ``launches``)
that it bumps only where it launches its kernel.

The kernels have no backward: a wrapper fills its output through ctypes,
where autograd cannot see it.  So every wrapper refuses, on every device,
a call that would need a gradient (:func:`refuse_grad`); the trainer runs
attention through ``attn_impl="plain"`` (or ring / Ulysses over sp).
"""

import torch


def refuse_grad(name: str, *tensors):
    """Raise when grad mode is on and one of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (the kernel writes its output where autograd cannot "
            'see it): train through attn_impl="plain" (or "ring"/"ulysses" over sp), or '
            "call it under torch.no_grad()/torch.inference_mode()")
