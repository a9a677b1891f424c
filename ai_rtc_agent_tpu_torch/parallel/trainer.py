"""Sharded diffusion trainer: the dp x tp x sp training step (counterpart
of ai_rtc_agent_tpu/parallel/trainer.py), one process per rank.

  dp  each rank steps on its slice of the global batch; gradients and the
      loss are averaged over its dp group
  tp  Megatron column/row shards of the kernels (parallel/sharding.py): a
      sharded linear or conv runs the simple form of models/layers.py
      (output gathered whole, or partial products summed), and every
      activation between layers stays replicated
  sp  ring / Ulysses attention over the sp group: the caller activates
      ``layers.sp_attention_group(mesh, "sp", batch_axis="dp")`` around the
      step and gives a ``unet_apply`` with ``attn_impl="ring"`` or
      ``"ulysses"``, as the JAX caller activates ``sp_attention_mesh``

The loss is the JAX ``loss_fn``: t ~ U[0, T), noise ~ N(0, 1),
x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) noise, mean((eps - noise)^2) in
f32.  t and noise come from an explicit ``torch.Generator`` drawn over the
global batch (the same on every rank), or are given.  The optimizer is
optax's ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, wd))``: the
clip scales by clip/norm when the global norm (over the whole mesh) is not
below clip; Adam's moments are bias-corrected by the step count, eps 1e-8
outside the square root; the decay ``wd * p`` joins the update before the
learning rate scales it.  Everything is f32.

The kernel routes have no backward and refuse a call that needs one
(ops/kernels): attention trains through ``attn_impl="plain"``, or ring /
Ulysses under sp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops import schedule as S
from . import checkpoint as CK
from . import sharding as SH
from .mesh import Mesh, make_mesh

ADAM_EPS = 1e-8


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 1.0
    num_train_steps_schedule: int = 1000


def _place(arr, mesh: Mesh, device, name: str):
    """This rank's dp slice of a global batch array (host-replicated, as the
    JAX ``_place`` reads it on every host), on ``device``."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
    n = mesh.size("dp")
    if t.shape[0] % n:
        raise ValueError(f"{name}: a global batch of {t.shape[0]} does not split over dp={n}")
    if n > 1:
        t = t.chunk(n)[mesh.index("dp")]
    return t.to(device)


def _tp_tree(params, specs: dict, mesh: Mesh):
    """``params`` with a ``"tp"`` marker, (kind, group), on each dict whose
    kernel is sharded (models/layers.py reads it).  A kernel sharded along
    its output axis is column-parallel and its bias shards with it; along
    its input axis, row-parallel with a replicated bias."""
    if specs is None or mesh.size("tp") == 1:
        return params
    group = mesh.group("tp")

    def walk(node, path):
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, path + (k,)) for k, v in node.items()}
        spec = specs.get(path + ("kernel",))
        dim = None if spec is None else SH.sharded_dim(spec)
        if dim is not None:
            kind = "column" if dim == (0 if len(spec) == 4 else len(spec) - 1) else "row"
            bias = specs.get(path + ("bias",))
            if bias is not None and (kind == "column") != (SH.sharded_dim(bias) is not None):
                raise ValueError(f"a {kind}-parallel kernel at {path} with a bias placed {bias}")
            out["tp"] = (kind, group)
        return out

    return walk(params, ())


def make_train_step(unet_apply: Callable, schedule: S.NoiseSchedule,
                    tcfg: TrainerConfig = TrainerConfig(), mesh: Mesh | None = None,
                    specs=None, device=None):
    """-> (init_fn, train_step).  ``unet_apply(params, x, t, ctx, added)``
    returns eps; ``init_fn(params)`` builds the state {"params", "opt":
    {"count", "mu", "nu"}, "step"} from this rank's shards;
    ``train_step(state, batch, t, noise)`` steps it in place and returns the
    global mean loss.  ``specs``: the tp placement of every leaf
    (:func:`sharding.param_shardings`); None replicates all."""
    mesh = mesh or make_mesh()
    device = resolve_device(device)
    ac = torch.as_tensor(schedule.alphas_cumprod, dtype=torch.float32, device=device)
    dp_group = mesh.group("dp")
    tp_group = mesh.group("tp")

    def init_fn(params):
        zeros = lambda tree: SH.map_with_path(lambda _p, a: torch.zeros_like(a), tree)  # noqa: E731
        for _p, a in SH.leaves_with_paths(params):
            a.requires_grad_(True)
        return {"params": params,
                "opt": {"count": torch.zeros((), dtype=torch.int32, device=device),
                        "mu": zeros(params), "nu": zeros(params)},
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def loss_fn(tree, x0, ctx, t, noise, added):
        a = torch.sqrt(ac[t]).reshape(-1, 1, 1, 1).to(x0.dtype)
        s = torch.sqrt(1.0 - ac[t]).reshape(-1, 1, 1, 1).to(x0.dtype)
        x_t = a * x0 + s * noise
        eps = unet_apply(tree, x_t, t, ctx, added)
        return torch.mean((eps.float() - noise.float()) ** 2)

    def train_step(state, batch, t, noise) -> float:
        params = state["params"]
        leaves = [a for _p, a in SH.leaves_with_paths(params)]
        sharded = [specs is not None and SH.sharded_dim(specs[p]) is not None
                   for p, _a in SH.leaves_with_paths(params)]
        x0 = _place(batch["latents"], mesh, device, "latents")
        ctx = _place(batch["context"], mesh, device, "context")
        added = batch.get("added_cond")
        if added is not None:
            added = {k: _place(v, mesh, device, k) for k, v in added.items()}
        t = _place(t, mesh, device, "t").long()
        noise = _place(noise, mesh, device, "noise")
        for a in leaves:
            a.grad = None
        with torch.enable_grad():
            loss = loss_fn(_tp_tree(params, specs, mesh), x0, ctx, t, noise, added)
            loss.backward()
        with torch.no_grad():
            grads = [torch.zeros_like(a) if a.grad is None else a.grad for a in leaves]
            loss = loss.detach().reshape(1)
            if dp_group is not None:  # the global mean: average over dp
                flat = torch.cat([g.reshape(-1) for g in grads] + [loss])
                dist.all_reduce(flat, group=dp_group)
                flat /= mesh.size("dp")
                off = 0
                for g in grads:
                    g.copy_(flat[off: off + g.numel()].view_as(g))
                    off += g.numel()
                loss = flat[-1:]
            for a, g in zip(leaves, grads):
                a.grad = g
            _adamw(state, leaves, grads, sharded, tcfg, tp_group)
        return float(loss)

    return init_fn, train_step


def _adamw(state, leaves, grads, sharded, tcfg: TrainerConfig, tp_group):
    """optax's clip_by_global_norm -> adamw, in place.  The squared norms of
    tp-sharded leaves are summed over tp; replicated leaves count once."""
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    sq_sharded = sum((g.float().square().sum() for g, s in zip(grads, sharded) if s), zero)
    sq_repl = sum((g.float().square().sum() for g, s in zip(grads, sharded) if not s), zero)
    if tp_group is not None:
        dist.all_reduce(sq_sharded, group=tp_group)
    norm = torch.sqrt(sq_sharded + sq_repl)
    keep = norm < tcfg.grad_clip
    opt = state["opt"]
    opt["count"] += 1
    step = opt["count"].float()
    bc1 = 1 - torch.pow(torch.tensor(tcfg.b1, device=step.device), step)
    bc2 = 1 - torch.pow(torch.tensor(tcfg.b2, device=step.device), step)
    mus = [a for _p, a in SH.leaves_with_paths(opt["mu"])]
    nus = [a for _p, a in SH.leaves_with_paths(opt["nu"])]
    for p, g, mu, nu in zip(leaves, grads, mus, nus):
        g = torch.where(keep, g, g / norm * tcfg.grad_clip)
        mu.copy_((1 - tcfg.b1) * g + tcfg.b1 * mu)
        nu.copy_((1 - tcfg.b2) * (g * g) + tcfg.b2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        u = u + tcfg.weight_decay * p
        p.add_(u * -tcfg.learning_rate)
    state["step"] += 1


class ShardedTrainer:
    """Places the params by the tp rules (each rank keeps its shards; the
    optimizer state follows them) and steps on each rank's dp slice of the
    batch.  ``device`` defaults to ``cuda`` and raises without a card;
    ``device="cpu"`` runs the plain PyTorch path (a gloo world over the
    CPU, or one process with no process group)."""

    def __init__(self, unet_apply, schedule, mesh: Mesh, params, tcfg=TrainerConfig(),
                 device=None):
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh.shape}")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.schedule = schedule
        self.specs = SH.param_shardings(mesh, params)
        local = SH.map_with_path(
            lambda p, a: SH.shard_leaf(mesh, a.detach(), self.specs[p]).to(
                self.device, copy=True).contiguous(), params)
        init_fn, self._step = make_train_step(unet_apply, schedule, tcfg, mesh, self.specs,
                                              self.device)
        self.state = init_fn(local)

    def step(self, batch: dict, generator: torch.Generator | None = None, *, t=None,
             noise=None) -> float:
        """One step on the global ``batch`` {"latents" [B,h,w,c], "context"
        [B,L,D], optional "added_cond"}: t and noise drawn from
        ``generator`` over the global batch, or given.  -> the global loss."""
        if t is None or noise is None:
            if generator is None:
                raise ValueError("step needs a generator, or both t and noise")
            x0 = batch["latents"]
            b = x0.shape[0]
            t = torch.randint(0, self.schedule.num_train_steps, (b,), generator=generator,
                              device=generator.device)
            noise = torch.randn(tuple(x0.shape), generator=generator, device=generator.device)
        return self._step(self.state, batch, t, noise)

    # -- the whole state, across mesh shapes ---------------------------------

    def full_state(self) -> dict:
        """The whole state, tp shards all-gathered (every rank of the mesh
        must call it)."""
        def whole(tree):
            return SH.map_with_path(
                lambda p, a: SH.unshard_leaf(self.mesh, a.detach(), self.specs[p]), tree)

        st = self.state
        return {"params": whole(st["params"]),
                "opt": {"count": st["opt"]["count"].clone(), "mu": whole(st["opt"]["mu"]),
                        "nu": whole(st["opt"]["nu"])},
                "step": st["step"].clone()}

    @torch.no_grad()
    def load_state(self, state: dict):
        """Install a whole state (a checkpoint's, or ``bridge.
        train_state_from_jax``'s), re-sharded by this trainer's rules, in
        place."""
        def into(dst, src, what):
            for p, a in SH.leaves_with_paths(dst):
                part = SH.shard_leaf(self.mesh, SH.at(src, p), self.specs[p])
                if tuple(part.shape) != tuple(a.shape):
                    raise ValueError(f"{what} {'/'.join(map(str, p))}: {tuple(part.shape)} "
                                     f"vs {tuple(a.shape)}")
                a.copy_(part)

        into(self.state["params"], state["params"], "params")
        into(self.state["opt"]["mu"], state["opt"]["mu"], "mu")
        into(self.state["opt"]["nu"], state["opt"]["nu"], "nu")
        self.state["opt"]["count"].copy_(torch.as_tensor(state["opt"]["count"]))
        self.state["step"].copy_(torch.as_tensor(state["step"]))

    # -- checkpoint / resume (parallel/checkpoint.py) -----------------------

    def save(self, ckpt_dir: str) -> str:
        """Rank 0 writes the whole state; every rank returns its path."""
        full = self.full_state()
        path = CK.checkpoint_path(ckpt_dir, int(full["step"]))
        if not dist.is_initialized() or dist.get_rank() == 0:
            CK.save_train_state(ckpt_dir, full)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        return path

    def restore(self, ckpt_dir: str) -> bool:
        """Resume from the newest checkpoint under ckpt_dir, whatever mesh
        wrote it.  False when none exists."""
        state = CK.restore_train_state(ckpt_dir)
        if state is None:
            return False
        self.load_state(state)
        return True
