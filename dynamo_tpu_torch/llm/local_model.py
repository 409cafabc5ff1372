"""Model path resolution: local paths only.

The JAX package resolves an ``org/repo`` id through ``huggingface_hub``
(reference lib/llm/src/local_model.rs:27 + hub.rs).  The card's machine has
neither that package nor a network, so the port serves local checkpoint
directories and ``.gguf`` files, and refuses hub ids with an error that
says so.
"""

from __future__ import annotations

import os
import re

# org/name with the HF id charset; a path that exists locally always wins
_REPO_ID_RE = re.compile(r"^[\w.-]+/[\w.-]+$")


def resolve_model_path(model_path: str) -> str:
    """Return ``model_path`` if it is a local directory or a ``.gguf``
    file; raise ``SystemExit`` otherwise."""
    if os.path.isdir(model_path):
        return model_path
    if os.path.isfile(model_path):
        # only .gguf is a single-file model; anything else fails here with
        # a clear message instead of deep in a loader
        if model_path.endswith(".gguf"):
            return model_path
        raise SystemExit(
            f"--model-path {model_path!r} is a file but not a .gguf; pass "
            f"the model directory instead"
        )
    if _REPO_ID_RE.match(model_path):
        raise SystemExit(
            f"--model-path {model_path!r} looks like a Hugging Face repo id; "
            f"the PyTorch port resolves no hub ids (no huggingface_hub, no "
            f"network): pass a local checkpoint directory"
        )
    raise SystemExit(f"--model-path {model_path!r} is not a local directory")
