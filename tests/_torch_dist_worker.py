"""One rank of a gloo world for tests/test_torch_parallel.py (imports no JAX).

    python tests/_torch_dist_worker.py TASK DIR [INIT_METHOD RANK WORLD]

Without INIT_METHOD the rank comes up from torchrun's variables (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) through
``mesh.init_distributed``.  DIR holds the inputs the test wrote
(``inputs.npz``, ``params.pt``); each rank writes ``TASK_r<RANK>.pt``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from ai_rtc_agent_tpu_torch.models import layers as L  # noqa: E402
from ai_rtc_agent_tpu_torch.models import unet as U  # noqa: E402
from ai_rtc_agent_tpu_torch.ops import schedule as S  # noqa: E402
from ai_rtc_agent_tpu_torch.parallel import collectives as C  # noqa: E402
from ai_rtc_agent_tpu_torch.parallel import mesh as M  # noqa: E402
from ai_rtc_agent_tpu_torch.parallel import ring_attention as RA  # noqa: E402
from ai_rtc_agent_tpu_torch.parallel import sharding as SH  # noqa: E402
from ai_rtc_agent_tpu_torch.parallel import trainer as TR  # noqa: E402

TIMEOUT_S = 60.0


def _attention_shards(fn, q, k, v, mesh):
    """``fn`` over this rank's token shards of whole q/k/v; the output shard."""
    g = mesh.group("sp")
    return fn(*(C.shard(t, 1, g) for t in (q, k, v)), mesh)


def task_attention(d: Path, rank: int) -> dict:
    """The mesh layout, ring / Ulysses at sp 2, 4, 8, the long-context ring,
    the gradients at sp 2 and the tiny UNet's sp forwards."""
    out = {}
    world = M.make_mesh(dp=2, tp=2, sp=2)
    out["coords"] = (world.coords["dp"], world.coords["tp"], world.coords["sp"])
    out["devices"] = world.devices
    out["group_ranks"] = {a: dist.get_process_group_ranks(world.group(a)) for a in M.AXES}
    try:
        M.make_mesh(dp=16)
    except ValueError as e:
        out["oversubscribed"] = str(e)
    x = np.load(d / "inputs.npz")
    q, k, v = (torch.from_numpy(x[n]) for n in ("q", "k", "v"))
    qh, kh, vh = (torch.from_numpy(x[n]) for n in ("qh", "kh", "vh"))
    for n in (2, 4, 8):
        mesh = M.make_mesh(sp=n)
        if mesh.member:
            out[f"ring{n}"] = _attention_shards(RA.ring_attention, q, k, v, mesh)
            out[f"ulysses{n}"] = _attention_shards(RA.ulysses_attention, qh, kh, vh, mesh)
            try:
                _attention_shards(RA.ulysses_attention, q[:, :, :1], k[:, :, :1], v[:, :, :1],
                                  mesh)
            except ValueError as e:
                out[f"ulysses{n}_refused"] = str(e)
        if n == 8:
            out["long8"] = _attention_shards(
                RA.ring_attention, *(torch.from_numpy(x[name]) for name in ("lq", "lk", "lv")),
                mesh)
        if n == 2 and mesh.member:
            for name, fn, ins, cot in (
                    ("ring", RA.ring_attention, (q, k, v), x["cot"]),
                    ("ulysses", RA.ulysses_attention, (qh, kh, vh), x["coth"])):
                leaves = [t.clone().requires_grad_(True) for t in ins]
                o = C.gather(_attention_shards(fn, *leaves, mesh), 1, mesh.group("sp"))
                (o * torch.from_numpy(cot)).sum().backward()
                out[f"grad_{name}"] = [t.grad for t in leaves]
    cfg = U.UNetConfig.tiny()
    params = torch.load(d / "params.pt")
    for impl, n in (("ring", 8), ("ulysses", 2)):
        mesh = M.make_mesh(sp=n)
        if mesh.member:
            with L.sp_attention_group(mesh, axis="sp"), torch.no_grad():
                out[f"unet_{impl}{n}"] = U.apply_unet(
                    params, torch.from_numpy(x["x"]), torch.from_numpy(x["t"]),
                    torch.from_numpy(x["ctx"]), cfg, attn_impl=impl)
    return out


def _trainer(mesh, params, impl, lr=1e-3):
    cfg = U.UNetConfig.tiny()

    def unet_apply(p, x, t, ctx, added):
        return U.apply_unet(p, x, t, ctx, cfg, attn_impl=impl, added_cond=added)

    return TR.ShardedTrainer(unet_apply, S.make_schedule(), mesh, params,
                             TR.TrainerConfig(learning_rate=lr), device="cpu")


def task_train(d: Path, rank: int) -> dict:
    """The tiny UNet forward at tp=2, then two trainer steps at
    dp=2 tp=2 sp=2 (ring over sp) on the given t/noise, and a checkpoint."""
    out = {}
    x = np.load(d / "inputs.npz")
    params = torch.load(d / "params.pt")
    cfg = U.UNetConfig.tiny()
    mesh = M.make_mesh(tp=2)
    if mesh.member:
        specs = SH.param_shardings(mesh, params)
        local = SH.shard_params(mesh, params)
        with torch.no_grad():
            out["unet_tp2"] = U.apply_unet(
                TR._tp_tree(local, specs, mesh), torch.from_numpy(x["x"]),
                torch.from_numpy(x["t"]), torch.from_numpy(x["ctx"]), cfg, attn_impl="plain")
    mesh = M.make_mesh(dp=2, tp=2, sp=2)
    tr = _trainer(mesh, params, "ring")
    batch = {"latents": x["latents"], "context": x["context"]}
    with L.sp_attention_group(mesh, axis="sp", batch_axis="dp"):
        for i in range(2):
            out[f"loss{i}"] = tr.step(batch, t=x[f"t{i}"], noise=x[f"noise{i}"])
            out[f"state{i}"] = tr.full_state()
    out["ckpt"] = tr.save(str(d / "ckpt"))
    return out


def task_multihost(d: Path, rank: int) -> dict:
    """A dp=2 world from torchrun's variables: two steps on one batch."""
    mesh = M.make_mesh(dp=2)
    params = torch.load(d / "params.pt")
    tr = _trainer(mesh, params, "plain")
    x = np.load(d / "inputs.npz")
    batch = {"latents": x["latents"], "context": x["context"]}
    losses = [tr.step(batch, torch.Generator().manual_seed(0)) for _ in range(2)]
    return {"losses": losses, "world": dist.get_world_size(), "rank": dist.get_rank()}


TASKS = {"attention": task_attention, "train": task_train, "multihost": task_multihost}


def main(argv):
    task, d = argv[0], Path(argv[1])
    torch.set_num_threads(1)
    if len(argv) > 2:
        M.init_distributed(argv[2], int(argv[3]), int(argv[4]), backend="gloo", device="cpu",
                           timeout_s=TIMEOUT_S)
    else:
        M.init_distributed(backend="gloo", device="cpu", timeout_s=TIMEOUT_S)
    rank = dist.get_rank()
    try:
        torch.save(TASKS[task](d, rank), d / f"{task}_r{rank}.pt")
        dist.barrier()
    finally:
        M.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1:])
