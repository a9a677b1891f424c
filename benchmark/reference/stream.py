"""Plain PyTorch reference of one session's served stream: the stream-batch
img2img step (StreamDiffusion's denoising batch) over the networks of
model.py, from the configuration's ``stream`` settings.

Per frame, with the B = len(t_index_list) stages of the session's ring:
the frame (uint8 / 255) is encoded by TAESD and noised to the first stage,
x = alpha_0 * z + sigma_0 * noise_0; the B rows [x, ring] go through the
UNet at their stages' timesteps with the session's prompt; cfg ``self``
(residual CFG) guides with the stock noise, eps = g * eps_c - (g - 1) *
delta * stock, and moves the stock, stock' = (eps_c + beta * stock) / (1 +
beta), beta = sigma / alpha; the scheduler step is LCM's boundary blend (or
the turbo step, pred_x0 alone); rows 0..B-2 are renoised to the next
stage's noise level with noise rows 1..B-1 and become the ring; the last
row is decoded by TAESD, clamped, scaled by 255 and rounded half to even.

The state a session starts from is worked out from the run's inputs alone:
the prompt's conditioning from the text tower, the noise from a CUDA (or
CPU) ``torch.Generator`` seeded with the session's seed, the ring = noise
rows 1.., the stock zeros.  Float32 throughout, TF32 off.  It imports
nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model as M


def schedule_coeffs(s: dict) -> dict:
    """Per-stage coefficients (float64 numpy) of the stream settings ``s``:
    timesteps, alpha, sigma, c_skip, c_out, next_alpha, next_sigma."""
    T, n = 1000, s["num_inference_steps"]
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, T, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    if s["timestep_spacing"] == "leading":
        ladder = (np.arange(n) * (T // n))[::-1]
    else:  # trailing (SD-Turbo)
        ladder = np.round(T - np.arange(n) * (T / n)).astype(np.int64) - 1
    t = ladder[np.asarray(s["t_index_list"], dtype=np.int64)]
    scaled = t / 10.0  # the boundary condition's timestep scaling
    nxt = np.concatenate([acp[t[1:]], [1.0]])
    return {"timesteps": t, "alpha": np.sqrt(acp[t]), "sigma": np.sqrt(1.0 - acp[t]),
            "c_skip": 0.25 / (scaled ** 2 + 0.25), "c_out": scaled / np.sqrt(scaled ** 2 + 0.25),
            "next_alpha": np.sqrt(nxt), "next_sigma": np.sqrt(1.0 - nxt)}


def stateless(s: dict) -> bool:
    """A stream whose output depends on the current frame alone (one
    stage, no stock): a sample of frames can be checked one by one."""
    return len(s["t_index_list"]) == 1 and s["cfg_type"] == "none"


class Reference:
    """The reference of a configuration file over a weight tree (the
    benchmark's own, params.make_tree) at a precision."""

    def __init__(self, cfg: dict, tree: dict, device, precision: str = "f32"):
        self.cfg = cfg
        self.s = cfg["stream"]
        self.device = torch.device(device)
        self.pr = M.Precision(precision)
        self.p = self.pr.tree(tree)
        c = schedule_coeffs(self.s)
        self.c = {k: torch.tensor(v, dtype=torch.float32, device=self.device).reshape(-1, 1, 1, 1)
                  for k, v in c.items() if k != "timesteps"}
        self.t = torch.tensor(c["timesteps"], dtype=torch.float32, device=self.device)
        self.B = len(self.s["t_index_list"])
        scale = self.s["latent_scale"]
        self.hw = (self.s["height"] // scale, self.s["width"] // scale)

    @torch.inference_mode()
    def conditioning(self, prompt: str) -> torch.Tensor:
        c = self.cfg["clip"]
        ids = torch.tensor([M.hash_tokens(prompt, c["vocab_size"], c["max_length"])],
                           device=self.device)
        return M.clip_text(self.p["clip"], ids, c, self.pr)

    def start(self, prompt: str, seed: int) -> dict:
        """A session's first state: its conditioning, noise, ring and stock."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        noise = torch.randn((self.B, *self.hw, 4), generator=gen, device=self.device)
        noise = noise.permute(0, 3, 1, 2).contiguous()  # NHWC draw, NCHW math
        return {"cond": self.conditioning(prompt), "noise": noise, "ring": noise[1:].clone(),
                "stock": torch.zeros_like(noise)}

    @torch.inference_mode()
    def step(self, states: list, frames: np.ndarray, decode) -> list:
        """One frame of each session in ``states`` (advanced in place);
        ``frames`` [n, H, W, 3] uint8; ``decode[i]`` says whether session
        i's output is wanted.  -> [H, W, 3] uint8 or None per session."""
        s, c, B, n = self.s, self.c, self.B, len(states)
        img = torch.as_tensor(frames, device=self.device).permute(0, 3, 1, 2).float()
        img = img * (1.0 / 255.0)
        z = M.taesd_encode(self.p["taesd"]["encoder"], img, self.pr)
        noise = torch.stack([st["noise"] for st in states])  # [n, B, 4, h, w]
        x_new = c["alpha"][0] * z + c["sigma"][0] * noise[:, 0]
        x = torch.cat([x_new[:, None], torch.stack([st["ring"] for st in states])], dim=1) \
            if B > 1 else x_new[:, None]
        rows = x.reshape(n * B, *x.shape[2:])
        ctx = torch.cat([st["cond"].expand(B, -1, -1) for st in states])
        eps_c = M.unet(self.p["unet"], rows, self.t.repeat(n), ctx, self.cfg["unet"], self.pr)
        eps_c = eps_c.reshape(n, B, *eps_c.shape[1:])
        col = lambda k: c[k][None]  # noqa: E731  [1, B, 1, 1, 1]
        if s["cfg_type"] == "self":
            stock = torch.stack([st["stock"] for st in states])
            g, d = s["guidance_scale"], s["delta"]
            eps = g * eps_c - (g - 1.0) * d * stock
            beta = col("sigma") / torch.clamp(col("alpha"), min=1e-6)
            new_stock = (eps_c + beta * stock) / (1.0 + beta)
        elif s["cfg_type"] == "none":
            eps, new_stock = eps_c, None
        else:
            raise ValueError(f"cfg_type {s['cfg_type']!r} has no reference here")
        x0 = (x - col("sigma") * eps) / col("alpha")
        den = x0 if s["scheduler"] == "turbo" else col("c_skip") * x + col("c_out") * x0
        for i, st in enumerate(states):
            if B > 1:
                st["ring"] = col("next_alpha")[0, :-1] * den[i, :-1] + \
                    col("next_sigma")[0, :-1] * st["noise"][1:]
            if new_stock is not None:
                st["stock"] = new_stock[i]
        want = [i for i in range(n) if decode[i]]
        outs = [None] * n
        if want:
            img = M.taesd_decode(self.p["taesd"]["decoder"], den[want, B - 1], self.pr)
            u8 = torch.round(torch.clamp(img * 255.0, 0.0, 255.0)).to(torch.uint8)
            u8 = u8.permute(0, 2, 3, 1).cpu().numpy()
            for j, i in enumerate(want):
                outs[i] = u8[j]
        return outs
