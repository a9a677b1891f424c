"""One rank of a lockstep serving world for tests/test_torch_mesh_serving.py
(imports no JAX).

    python tests/_torch_mesh_worker.py TASK DIR INIT_METHOD RANK WORLD

Every rank builds the tiny-test ``StreamDiffusionPipeline`` on the task's
mesh from the params in ``DIR/params.pt``; rank 0 installs the JAX state
(``DIR/state0.pt``) through the lockstep engine, steps the frames of
``DIR/inputs.npz`` with a prompt swap before frame ``SWAP_AT`` and writes
its outputs to ``TASK_r0.pt``; rank 1 follows and writes its step count.
Task ``dead``: rank 1 dies after one step without closing, and rank 0
writes what its next frame raised and after how long.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from ai_rtc_agent_tpu_torch.models import registry as PREG  # noqa: E402
from ai_rtc_agent_tpu_torch.parallel import mesh as M  # noqa: E402
from ai_rtc_agent_tpu_torch.parallel import serving  # noqa: E402
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline  # noqa: E402

TIMEOUT_S = 20.0  # every collective of the world; the dead-follower task waits this long at most
SWAP_AT, SWAP_PROMPT = 2, "a watercolor fox"
# task -> (mesh axes, attention route, config overrides)
TASKS = {
    "tp2": ({"tp": 2}, "kernel", {}),
    "sp2_ring": ({"sp": 2}, "ring", {}),
    "sp2_ulysses": ({"sp": 2}, "ulysses", {}),
    "tp2_deepcache": ({"tp": 2}, "kernel", {"unet_cache_interval": 3}),
    "dead": ({"tp": 2}, "kernel", {}),
}


def main():
    task, d, init = sys.argv[1], Path(sys.argv[2]), sys.argv[3]
    rank, world = int(sys.argv[4]), int(sys.argv[5])
    torch.set_num_threads(1)
    M.init_distributed(init, rank, world, backend="gloo", device="cpu", timeout_s=TIMEOUT_S)
    axes, impl, over = TASKS[task]
    x = np.load(d / "inputs.npz")
    cfg = PREG.default_stream_config("tiny-test", device="cpu", attn_impl=impl,
                                     use_fused_epilogue=bool(x["fused"]), **over)
    mesh = M.make_mesh(**axes)
    pipe = StreamDiffusionPipeline("tiny-test", config=cfg, device="cpu",
                                   params=torch.load(d / "params.pt"), mesh=mesh)
    if rank:
        if task == "dead":
            eng = pipe.engine
            real = eng.follow_step

            def die(frame):
                real(frame)
                os._exit(0)  # gone mid-serve, without a close

            eng.follow_step = die
        torch.save({"steps": serving.follow(pipe.engine)}, d / f"{task}_r{rank}.pt")
        return
    pipe.engine.install(torch.load(d / "state0.pt"))
    frames = list(x["frames"])
    if task == "dead":
        pipe(frames[0])
        t0 = time.monotonic()
        try:
            pipe(frames[1])
            out = {"raised": None}
        except Exception as e:  # noqa: BLE001 - the error is the result
            out = {"raised": repr(e)}
        out["seconds"] = time.monotonic() - t0
        torch.save(out, d / f"{task}_r0.pt")
        os._exit(0)  # the world is broken: no orderly teardown
    outs = []
    for i, f in enumerate(frames):
        if i == SWAP_AT:
            pipe.update_prompt(SWAP_PROMPT)
        outs.append(pipe(f))
    pipe.engine.close()
    torch.save({"outs": np.stack(outs), "wrapped": type(pipe.engine).__name__},
               d / f"{task}_r0.pt")
    M.shutdown_distributed()


if __name__ == "__main__":
    main()
