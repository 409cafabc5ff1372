"""Model Deployment Card (MDC): everything a frontend needs to serve a model.

Reference parity: lib/llm/src/model_card/model.rs:88 (ModelDeploymentCard:
model info, tokenizer kind, context length, kv block size), create.rs
(build from an HF checkout), and the NATS-object-store transport
(``move_from_nats`` in discovery/watcher.rs:193).  Here the card's tokenizer
artifacts travel through the hub object store: a worker publishes once under
``mdc/{slug}``, every frontend downloads on first sight of the model.

Worker-side registration (reference local_model.rs:27 ``attach`` +
discovery.rs ``MODEL_ROOT_PATH``): one kv entry ``models/{slug}/{lease:x}``
scoped to the worker's primary lease, so a dead worker's registration
disappears with its lease and the frontend watcher can react.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .tokenizer import Tokenizer

MODEL_ROOT = "models"  # kv prefix (reference discovery.rs MODEL_ROOT_PATH)
MDC_OBJ_PREFIX = "mdc"  # object-store namespace for card payloads


def slugify(name: str) -> str:
    """Key-safe model name (reference utils/slug.rs semantics)."""
    return name.replace("/", "--").replace(" ", "_").lower()


@dataclass
class ModelEntry:
    """The kv payload under models/{slug}/{lease:x} (reference
    discovery/model_entry.rs)."""

    name: str
    namespace: str
    component: str
    endpoint: str
    model_type: str = "backend"  # backend = token-level worker behind preproc
    # endpoint name (same component) serving pooled embeddings; "" = the
    # worker does not embed.  The frontend watcher builds the /v1/embeddings
    # pipeline iff set (reference ModelType::Embedding, openai.rs:212).
    embed_endpoint: str = ""

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__, sort_keys=True).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "ModelEntry":
        return cls(**json.loads(blob))


@dataclass
class ModelDeploymentCard:
    name: str
    context_length: int = 4096
    kv_block_size: int = 16
    tokenizer_json: bytes = b""
    tokenizer_config: Dict[str, Any] = field(default_factory=dict)

    @property
    def slug(self) -> str:
        return slugify(self.name)

    @property
    def mdcsum(self) -> str:
        h = hashlib.sha256()
        h.update(self.tokenizer_json)
        h.update(json.dumps(self.tokenizer_config, sort_keys=True).encode())
        return h.hexdigest()[:16]

    # -- build ---------------------------------------------------------------

    @classmethod
    def from_model_dir(
        cls,
        path: str,
        name: Optional[str] = None,
        kv_block_size: int = 16,
    ) -> "ModelDeploymentCard":
        tok_file = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tok_file):
            raise FileNotFoundError(f"no tokenizer.json under {path}")
        with open(tok_file, "rb") as f:
            tok_blob = f.read()
        tok_cfg: Dict[str, Any] = {}
        cfg_file = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_file):
            with open(cfg_file) as f:
                tok_cfg = json.load(f)
        context_length = 4096
        model_cfg_file = os.path.join(path, "config.json")
        if os.path.exists(model_cfg_file):
            with open(model_cfg_file) as f:
                mc = json.load(f)
            context_length = int(
                mc.get("max_position_embeddings") or context_length
            )
        return cls(
            name=name or os.path.basename(os.path.normpath(path)),
            context_length=context_length,
            kv_block_size=kv_block_size,
            tokenizer_json=tok_blob,
            tokenizer_config=tok_cfg,
        )

    def tokenizer(self) -> Tokenizer:
        return Tokenizer.from_blobs(self.tokenizer_json, self.tokenizer_config)

    # -- hub transport -------------------------------------------------------

    def to_blob(self) -> bytes:
        return json.dumps(
            {
                "name": self.name,
                "context_length": self.context_length,
                "kv_block_size": self.kv_block_size,
                "tokenizer_json": self.tokenizer_json.decode(),
                "tokenizer_config": self.tokenizer_config,
                "mdcsum": self.mdcsum,
            }
        ).encode()

    @classmethod
    def from_blob(cls, blob: bytes) -> "ModelDeploymentCard":
        d = json.loads(blob)
        return cls(
            name=d["name"],
            context_length=d["context_length"],
            kv_block_size=d["kv_block_size"],
            tokenizer_json=d["tokenizer_json"].encode(),
            tokenizer_config=d.get("tokenizer_config") or {},
        )

    async def publish(self, hub) -> str:
        """Upload the card to the hub object store; returns the object name."""
        obj = f"{MDC_OBJ_PREFIX}/{self.slug}"
        await hub.obj_put(obj, self.to_blob())
        return obj

    @classmethod
    async def download(cls, hub, name: str) -> Optional["ModelDeploymentCard"]:
        blob = await hub.obj_get(f"{MDC_OBJ_PREFIX}/{slugify(name)}")
        return cls.from_blob(blob) if blob is not None else None


async def register_llm(
    runtime,
    endpoint,
    model_path: str,
    model_name: Optional[str] = None,
    model_type: str = "backend",
    kv_block_size: int = 16,
    embed_endpoint: str = "",
) -> ModelDeploymentCard:
    """Worker-side model registration (reference bindings lib.rs:98-160
    ``register_llm``): publish the MDC blob, then create the lease-scoped
    ``models/{slug}/{lease:x}`` entry pointing at this endpoint."""
    card = ModelDeploymentCard.from_model_dir(
        model_path, name=model_name, kv_block_size=kv_block_size
    )
    await card.publish(runtime.hub)
    entry = ModelEntry(
        name=card.name,
        namespace=endpoint.namespace,
        component=endpoint.component,
        endpoint=endpoint.name,
        model_type=model_type,
        embed_endpoint=embed_endpoint,
    )
    lease = runtime.primary_lease
    key = f"{MODEL_ROOT}/{card.slug}/{lease:x}"
    created = await runtime.hub.kv_create(key, entry.to_json(), lease=lease)
    if not created:
        await runtime.hub.kv_put(key, entry.to_json(), lease=lease)
    return card
