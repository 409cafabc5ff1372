"""The port stands alone: every module of ``dynamo_tpu_torch`` imports under
a hook that refuses JAX, the JAX package and the libraries the port must not
need at import (the card's machine has none of them but triton, which the
port may only import inside a launch)."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import dynamo_tpu_torch

REFUSED = (
    "jax", "jaxlib", "dynamo_tpu", "safetensors", "tokenizers",
    "transformers", "prometheus_client", "triton",
)

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = set(sys.argv[1].split(","))

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            # the top-level package decides: dynamo_tpu_torch is not dynamo_tpu
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import dynamo_tpu_torch

    names = [dynamo_tpu_torch.__name__]
    for info in pkgutil.walk_packages(
        dynamo_tpu_torch.__path__, dynamo_tpu_torch.__name__ + "."
    ):
        names.append(info.name)
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print(len(names))
    """
)


def test_port_imports_nothing_refused():
    root = os.path.dirname(os.path.dirname(os.path.abspath(dynamo_tpu_torch.__file__)))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, ",".join(REFUSED)],
        cwd=root, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # the package, its subpackages and every module beneath them
    assert int(out.stdout.strip().splitlines()[-1]) >= 20
