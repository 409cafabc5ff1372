"""The port's metrics catalog: every family minted under
``dynamo_tpu_torch/`` is documented in README's "Metrics catalog" and is
minted by the JAX package under the same name and of the same kind, so
dashboards, the router and the planner read one set of series from either
package's processes.

The mint sites are found with the JAX catalog test's pattern
(``tests/test_metrics_catalog.py``: ``.counter(``/``.gauge(``/
``.histogram(`` with a literal name, one trailing ``_total`` stripped).
"""

from __future__ import annotations

import re

import pytest

from tests.test_metrics_catalog import HELPER, MINT, REPO, _norm, readme_families

KIND = re.compile(r'\.(counter|gauge|histogram)\(\s*f?"([A-Za-z0-9_{}]+)"', re.S)


def mints(package: str) -> dict:
    """family -> (kinds minted under it, first file that mints it)."""
    found: dict = {}
    for path in sorted((REPO / package).rglob("*.py")):
        text = path.read_text()
        names = [m.group(1) for pat in (MINT, HELPER) for m in pat.finditer(text)]
        for name in names:
            found.setdefault(_norm(name.replace("{prefix}", "dynamo")),
                             [set(), str(path.relative_to(REPO))])
        for m in KIND.finditer(text):
            found[_norm(m.group(2).replace("{prefix}", "dynamo"))][0].add(m.group(1))
    return found


PORT = mints("dynamo_tpu_torch")
JAX = mints("dynamo_tpu")


def test_the_port_mints_the_planes_it_serves():
    for family in ("dynamo_engine_tokens_generated", "dynamo_kv_offload_copy_failures",
                   "dynamo_kv_swap_fallbacks", "dynamo_kv_onboard_fallbacks",
                   "dynamo_kv_g4_bytes", "dynamo_spec_folded_verify_steps",
                   "dynamo_tick_phase_seconds", "dynamo_slo_attainment",
                   "dynamo_compile_events", "dynamo_kv_router_decisions",
                   "dynamo_planner_adjustments"):
        assert family in PORT, family
    assert len(PORT) >= 70


@pytest.mark.parametrize("family", sorted(PORT))
def test_port_family_is_documented_and_named_like_jax(family):
    kinds, where = PORT[family]
    assert family in readme_families(), f"{family} ({where}) is not in README's catalog"
    assert family in JAX, f"{family} ({where}) is not a JAX package family"
    assert kinds == JAX[family][0], (family, kinds, JAX[family][0])
