"""AdapterRegistry: the boot-time catalog of per-session style LoRAs
(counterpart of ai_rtc_agent_tpu/adapters/registry.py).

Loads kohya/peft LoRA files through ``models/lora.py``'s parser, resolves
module paths against ``models/loader.unet_key_map``, keeps the 2-D UNet
linears the factors path serves (conv and text-encoder groups are dropped
with a warning that lists them: an offline ``lora_dict`` fusion still
covers those) and zero-pads each adapter's rank to the smallest rank bucket
that holds it.

The closed bucket set keeps the bank's shape fixed: the scheduler sizes its
stacked bank once (``bank_rank``, the largest bucket in use), so every
join, leave and swap is a write of one shape into the captured buffers.
``scale·(alpha/r)`` is folded into the up factor at load, so the runtime
``(x @ down.T) @ up.T`` equals the offline-fused update up to float
association, and zero rows add exactly 0.0.

Factors are held on the host as numpy f32; :meth:`AdapterRegistry.factor_rows`
hands a session's row out as tensors on an explicit device and dtype.  The
dotted paths and ``(in, out)`` dims are the JAX registry's for the same UNet
and catalog, so :meth:`~AdapterRegistry.fingerprint` (and with it a
snapshot's fingerprint) is equal on both packages.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Mapping

import numpy as np
import torch

from ..models import lora as LR

logger = logging.getLogger(__name__)

DEFAULT_RANK_BUCKETS = (4, 8, 16)


def targets_digest(dims: Mapping[str, tuple]) -> str:
    """A short stable digest of a bank's target set and dims: the token a
    snapshot's fingerprint carries (the JAX spelling, so the digests agree)."""
    return hashlib.sha256(
        "|".join(f"{p}:{d[0]}x{d[1]}" for p, d in sorted(dims.items())).encode()
    ).hexdigest()[:16]


class AdapterRegistry:
    """Named LoRA factor banks resolved against one UNet's param tree.

    ``unet_params``: the served ``params["unet"]`` (dims are read from the
    target kernels, so a registry belongs to one base model); ``key_map``:
    ``models/loader.unet_key_map(unet_cfg)``."""

    def __init__(self, unet_params, key_map, rank_buckets=DEFAULT_RANK_BUCKETS):
        if not rank_buckets or any(int(b) < 1 for b in rank_buckets):
            raise ValueError(f"rank_buckets must be positive: {rank_buckets!r}")
        self._unet_params = unet_params
        self._key_map = key_map
        self.rank_buckets = tuple(sorted(int(b) for b in rank_buckets))
        # name -> {dotted path: {"down": np[Rb, in], "up": np[out, Rb]}}
        self._adapters: dict[str, dict] = {}
        self._ranks: dict[str, int] = {}  # name -> its bucket
        # dotted path -> (in_dim, out_dim), the union over the adapters
        self._dims: dict[str, tuple] = {}

    # -- the catalog ----------------------------------------------------------------

    @property
    def names(self) -> list[str]:
        return sorted(self._adapters)

    def __contains__(self, name) -> bool:
        return name in self._adapters

    def __len__(self) -> int:
        return len(self._adapters)

    @property
    def bank_rank(self) -> int:
        """The stacked bank's rank: the largest bucket any adapter occupies
        (0 for an empty catalog: the factors path stays off)."""
        return max(self._ranks.values(), default=0)

    @property
    def targets(self) -> dict[str, tuple]:
        """{dotted module path: (in_dim, out_dim)}, the union over adapters."""
        return dict(self._dims)

    def rank_of(self, name: str) -> int:
        return self._ranks[name]

    def fingerprint(self) -> dict:
        """The bank's shape (not its styles): a snapshot's factor rows only
        land on a scheduler whose bank has the same rank and targets.  The
        names stay out: the factors travel in the row itself."""
        return {"adapter_rank": self.bank_rank, "adapter_targets": targets_digest(self._dims)}

    # -- loading --------------------------------------------------------------------

    def add(self, name: str, lora_groups: Mapping[str, dict], scale: float = 1.0):
        """Resolve and pad one parsed LoRA into the catalog -> ``(applied,
        dropped paths)``.  No match at all, a shape that does not fit the
        base kernels (another base model) and a rank above the largest
        bucket raise: a misnamed or clipped adapter never registers."""
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"bad adapter name {name!r}")
        factors: dict[str, dict] = {}
        dims: dict[str, tuple] = {}
        dropped: list[str] = []
        for path, g in lora_groups.items():
            if path.startswith(("te.", "text_encoder.")):
                dropped.append(path)  # the factors path is unet-only
                continue
            target = LR.resolve_lora_target(path, self._key_map)
            if target is None:
                dropped.append(path)
                continue
            kernel = self._leaf(name, path, target)
            if kernel.ndim != 2:
                dropped.append(path)  # a conv: offline fusion only
                continue
            in_dim, out_dim = kernel.shape
            down = np.asarray(g["down"], np.float32).reshape(g["down"].shape[0], -1)
            up = np.asarray(g["up"], np.float32).reshape(g["up"].shape[0], -1)
            r = down.shape[0]
            if down.shape[1] != in_dim or up.shape != (out_dim, r):
                raise ValueError(
                    f"adapter {name!r} path {path!r}: factors {down.shape}/{up.shape} do not "
                    f"fit kernel [{in_dim},{out_dim}] — wrong base model?")
            bucket = self._bucket_for(name, path, r)
            s = float(scale) * (float(g["alpha"]) / r if g.get("alpha") is not None else 1.0)
            pd = np.zeros((bucket, in_dim), np.float32)
            pd[:r] = down
            pu = np.zeros((out_dim, bucket), np.float32)
            pu[:, :r] = up * s
            mod_path = ".".join(str(p) for p in target[:-1])
            factors[mod_path] = {"down": pd, "up": pu}
            dims[mod_path] = (in_dim, out_dim)
        if not factors:
            raise ValueError(
                f"adapter {name!r}: matched 0 of {len(lora_groups)} modules ({len(dropped)} "
                f"dropped; first: {dropped[:3]}) — wrong file or wrong base model")
        if dropped:
            logger.warning(
                "adapter %r: %d/%d module paths DROPPED (text-encoder/conv/unmatched — runtime "
                "factor banks cover 2-D unet linears only; use offline lora_dict fusion for the "
                "rest). First: %s", name, len(dropped), len(lora_groups), dropped[:5])
        bucket = max(f["down"].shape[0] for f in factors.values())
        self._adapters[name] = factors
        self._ranks[name] = bucket
        self._dims.update(dims)
        logger.info("adapter %r registered: %d modules, rank bucket %d (%d dropped)", name,
                    len(factors), bucket, len(dropped))
        return len(factors), dropped

    def load_file(self, name: str, path: str, scale: float = 1.0):
        from ..models import loader as LD

        return self.add(name, LR.parse_lora_state_dict(LD.read_safetensors(path)), scale=scale)

    def _bucket_for(self, name, path, r):
        for b in self.rank_buckets:
            if r <= b:
                return b
        raise ValueError(
            f"adapter {name!r} path {path!r}: rank {r} exceeds the largest blessed bucket "
            f"{self.rank_buckets[-1]} (ADAPTER_RANK_BUCKETS) — refusing to truncate a style "
            "silently")

    def _leaf(self, name, path, target):
        """The target's kernel.  A w8 module (``kernel_q``) is refused: the
        factors would sit beside an int8 kernel that the JAX registry
        cannot read either (it raises KeyError 'kernel')."""
        node = self._unet_params
        for p in target[:-1]:
            node = node[p]
        if target[-1] == "kernel" and "kernel" not in node and "kernel_q" in node:
            raise ValueError(
                f"adapter {name!r} path {path!r}: ADAPTER_DIR with QUANT_WEIGHTS=w8 is not "
                "served — the target kernel is int8, and the JAX package's registry fails the "
                "same combination; unset QUANT_WEIGHTS (or raise QUANT_MIN_SIZE above the "
                "targets) to serve adapters")
        return node[target[-1]]

    # -- bank rows ------------------------------------------------------------------

    def factor_rows(self, name: str | None, rank: int | None = None,
                    targets: Mapping[str, tuple] | None = None, dtype=torch.float32,
                    device="cpu"):
        """One session row of the stacked bank on ``device`` in ``dtype``:
        adapter ``name``'s factors zero-extended to ``rank`` over the whole
        ``targets`` set (zeros where the adapter touches nothing).  ``None``
        is the all-zero row.  Raises KeyError for an unknown name and
        ValueError for an adapter that does not fit the bound bank."""
        rank = self.bank_rank if rank is None else int(rank)
        targets = self.targets if targets is None else dict(targets)
        if name is None:
            from .bank import zero_factor_rows

            return zero_factor_rows(targets, rank, dtype, device)
        if name not in self._adapters:
            raise KeyError(f"unknown adapter {name!r} (registered: {self.names})")
        if self._ranks[name] > rank:
            raise ValueError(
                f"adapter {name!r} rank bucket {self._ranks[name]} exceeds the bound bank rank "
                f"{rank} — rebuild the scheduler to widen the bank")
        factors = self._adapters[name]
        unknown = set(factors) - set(targets)
        if unknown:
            raise ValueError(
                f"adapter {name!r} touches modules outside the bound bank target set: "
                f"{sorted(unknown)[:3]} — rebuild the scheduler")

        def place(a: np.ndarray) -> torch.Tensor:
            # tpurtc: allow[device-transfer] -- a style's factor rows placed on the device at a swap or a claim (control plane, parameter placement into the bank), not a frame
            return torch.from_numpy(a).to(device=device, dtype=dtype)

        rows = {}
        for path, (in_dim, out_dim) in targets.items():
            f = factors.get(path)
            down = np.zeros((rank, in_dim), np.float32)
            up = np.zeros((out_dim, rank), np.float32)
            if f is not None:
                rb = f["down"].shape[0]
                down[:rb] = f["down"]
                up[:, :rb] = f["up"]
            rows[path] = {"down": place(down), "up": place(up)}
        return rows


def build_registry(unet_params, unet_cfg, directory: str | None = None, rank_buckets=None):
    """The boot-time registry over ``directory``'s ``*.safetensors`` (adapter
    name = file stem).  ``directory=None`` (ADAPTER_DIR unset): an empty
    registry, bank rank 0, the factors path off.  A file that fails to
    parse or resolve refuses the boot with an error naming it (a half-loaded
    catalog would serve wrong styles)."""
    from ..models import loader as LD
    from ..utils import env

    if rank_buckets is None:
        rank_buckets = env.adapter_rank_buckets()
    reg = AdapterRegistry(unet_params, LD.unet_key_map(unet_cfg), rank_buckets=rank_buckets)
    if directory:
        for fname in sorted(f for f in os.listdir(directory) if f.endswith(".safetensors")):
            path = os.path.join(directory, fname)
            try:
                reg.load_file(fname[: -len(".safetensors")], path)
            except (ValueError, KeyError, OSError) as e:
                raise ValueError(f"ADAPTER_DIR file {path}: {e}") from e
        logger.info("adapter registry: %d adapters from %s (bank rank %d, %d target modules)",
                    len(reg), directory, reg.bank_rank, len(reg.targets))
    return reg
