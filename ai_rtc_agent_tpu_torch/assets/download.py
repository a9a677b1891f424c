"""Model downloader CLI — the port's copy of ai_rtc_agent_tpu/assets/download.py.

Snapshots the serving model families from the HF hub plus style LoRAs from
Civitai (the Content-Disposition filename is parsed and logged, the file
stored under its canonical name).  Honors HF_HUB_CACHE / CIVITAI_CACHE as
the JAX CLI does; the registry (models/registry.py) finds the snapshots
there.  Network access is required, and ``requests`` and
``huggingface_hub`` are imported only inside the functions that use them:
run this on a connected host and ship the caches to a machine that has
neither.

Usage: python -m ai_rtc_agent_tpu_torch.assets.download
         [--model-set default|sd15|turbo|sdxl|controlnet|safety]
"""

from __future__ import annotations

import argparse
import logging
import os
import re

from ..utils import env

logger = logging.getLogger(__name__)

HF_MODEL_SETS = {
    "sd15": [
        "lykon/dreamshaper-8",
        "latent-consistency/lcm-lora-sdv1-5",
        "madebyollin/taesd",
    ],
    "turbo": ["stabilityai/sd-turbo", "madebyollin/taesd"],
    "sdxl": ["stabilityai/sdxl-turbo", "madebyollin/taesdxl"],
    # conditioned generation + safety; lllyasviel/Annotators carries
    # ControlNetHED.pth for --annotator hed (models/hed.py searches this
    # snapshot unless HED_CHECKPOINT is set)
    "controlnet": [
        "lllyasviel/control_v11p_sd15_canny",
        "lllyasviel/Annotators",
    ],
    "safety": ["CompVis/stable-diffusion-safety-checker"],
}
HF_MODEL_SETS["default"] = (
    HF_MODEL_SETS["sd15"] + HF_MODEL_SETS["turbo"] + HF_MODEL_SETS["sdxl"]
)

# Civitai style LoRAs by version id
CIVITAI_MODELS = {"studio-ghibli-style-lora": "7657"}


def civitai_model_path(name: str) -> str:
    """Where a Civitai LoRA is cached (CIVITAI_CACHE)."""
    return os.path.join(env.civitai_cache(), f"{name}.safetensors")


def download_civitai_model(name: str, version_id: str) -> str | None:
    import requests

    from ..resilience.retry import RetryError, transient_policy

    path = civitai_model_path(name)
    if os.path.exists(path):
        logger.info("civitai %s cached", name)
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    url = f"https://civitai.com/api/download/models/{version_id}"

    def fetch():
        r = requests.get(url, allow_redirects=True, timeout=120)
        if r.status_code != 200:
            # 5xx / 429 are transient; 4xx means the version id is wrong
            # and retrying cannot help
            if r.status_code >= 500 or r.status_code == 429:
                raise requests.RequestException(f"civitai {r.status_code}")
            logger.error("civitai download failed: %s", r.status_code)
            return None
        return r

    try:
        # big-file fetches over flaky links are the canonical retry case:
        # the shared policy, a little more patient than control-plane calls
        r = transient_policy(attempts=4, base_delay_s=2.0).run(
            fetch, retry_on=(requests.RequestException, OSError),
            label=f"civitai {name}",
        )
    except RetryError as e:
        logger.error("civitai download failed after retries: %s", e.last)
        return None
    if r is None:
        return None
    # the filename from Content-Disposition, logged; stored under our canonical name
    cd = r.headers.get("Content-Disposition", "")
    m = re.search(r'filename="?([^";]+)"?', cd)
    logger.info("downloaded %s (%s)", name, m.group(1) if m else "unnamed")
    with open(path, "wb") as f:
        f.write(r.content)
    return path


# repos where only specific files are needed (lllyasviel/Annotators holds a
# dozen unrelated multi-GB annotator checkpoints; we use exactly one)
HF_ALLOW_PATTERNS = {"lllyasviel/Annotators": ["ControlNetHED.pth"]}


def download(model_set: str = "default"):
    from huggingface_hub import snapshot_download

    for repo in HF_MODEL_SETS[model_set]:
        logger.info("snapshot %s", repo)
        snapshot_download(repo, allow_patterns=HF_ALLOW_PATTERNS.get(repo))
    for name, version in CIVITAI_MODELS.items():
        download_civitai_model(name, version)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-set", default="default", choices=sorted(HF_MODEL_SETS))
    args = ap.parse_args()
    download(args.model_set)
