"""Model acquisition: resolve a model *name* to a local checkpoint path.

Copy of ``dynamo_tpu/models/hub.py`` without ``huggingface_hub``, which the
card's machine lacks, and without downloads: a repo id resolves against the
local Hugging Face cache only, as ``snapshot_download(...,
local_files_only=True)`` resolves it.

Resolution order for ``resolve_model_path(model)``:

1. A built-in preset name (``MODEL_PRESETS``) or an existing local path
   (directory or ``.gguf`` file) → returned as-is.
2. Anything not shaped like an HF repo id → returned as-is, for the
   engine's weight probe to report.
3. A repo id (``org/name``) → its snapshot in the HF cache:
   ``$HF_HUB_CACHE`` (else ``$HF_HOME/hub``, else
   ``~/.cache/huggingface/hub``) ``/models--org--name/refs/<revision>``
   names the commit, ``snapshots/<commit>/`` holds the files (a 40-hex
   revision names the commit itself). A GGUF-only snapshot resolves to
   its single ``.gguf`` file. A repo id that is not in the cache is
   refused with the JAX package's offline message: the port downloads
   nothing.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("hub")

DEFAULT_REVISION = "main"
_COMMIT_HASH = re.compile(r"^[0-9a-f]{40}$")


def looks_like_repo_id(model: str) -> bool:
    """``org/name`` shape, not an existing filesystem path."""
    if os.path.exists(model):
        return False
    parts = model.split("/")
    return (
        len(parts) == 2
        and all(p and not p.startswith((".", "~")) for p in parts)
        and not model.endswith(".gguf")
    )


def hub_cache_dir() -> Path:
    """The HF hub cache directory, from the environment as
    ``huggingface_hub.constants`` reads it."""
    home = os.path.expanduser(os.getenv(
        "HF_HOME", os.path.join(os.getenv("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
                                "huggingface")))
    return Path(os.getenv("HF_HUB_CACHE",
                          os.getenv("HUGGINGFACE_HUB_CACHE", os.path.join(home, "hub"))))


def cached_snapshot(model: str, revision: str | None = None) -> str | None:
    """The snapshot directory of repo ``model`` at ``revision`` in the local
    HF cache, or None when it is not there."""
    revision = revision or DEFAULT_REVISION
    storage = hub_cache_dir() / ("models--" + model.replace("/", "--"))
    commit = None
    if _COMMIT_HASH.match(revision):
        commit = revision
    elif (storage / "refs" / revision).exists():
        commit = (storage / "refs" / revision).read_text()
    if commit is None:
        return None
    snap = storage / "snapshots" / commit
    return str(snap) if snap.exists() else None


def resolve_model_path(model: str, revision: str | None = None) -> str:
    """Resolve ``model`` to a local path. Raises ValueError when it names a
    repo id that is not in the local HF cache."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS

    if model in MODEL_PRESETS or os.path.exists(model):
        return model
    if not looks_like_repo_id(model):
        return model  # let the engine's weight probe report the bad path
    path = cached_snapshot(model, revision)
    if path is None:
        raise ValueError(
            f"model {model!r} is not in the local HF cache and the "
            "environment is offline (HF_HUB_OFFLINE / no egress); "
            "pre-download it or pass a local checkpoint path")
    log.info("resolved hub model %s → %s", model, path)

    # GGUF-only snapshots resolve to the single .gguf file (the loader
    # keys its format off the suffix).
    snap = Path(path)
    if not any(snap.glob("*.safetensors")):
        ggufs = sorted(snap.glob("*.gguf"))
        if len(ggufs) == 1:
            return str(ggufs[0])
    return path
