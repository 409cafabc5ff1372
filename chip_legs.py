"""Time the host-bound legs of ``chip_smoke.py``'s serve-disagg (b) and
serve-onboard (b) for one or more checkouts, on one card:

    python3 chip_legs.py CHECKOUT [CHECKOUT ...]

Each checkout runs in a process of its own, from its own
``chip_smoke.py``: the kernels built, then each leg of serve-disagg (b)
(the three transfer paths and the aggregated twins) and of serve-onboard
(b) (the peer and G4 legs, each with its recompute twin) at the depth that
checkout runs it, every check of the leg made as the smoke makes it.  One
line a leg: ``legs: CHECKOUT leg SECONDS s``, beside the card's name and
power limit.  Compare checkouts only within one call.
"""

from __future__ import annotations

import os
import subprocess
import sys

LEGS = r'''
import inspect, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.ops import build, flash_prefill as fp, paged_attention as pa, ragged_attention as ra

card = cs.card_line()
build.build_all([pa.KERNEL, ra.KERNEL, fp.KERNEL, fp.PREFIX_KERNEL, ra.RECT_KERNEL,
                 ra.INT8_KERNEL, ra.RECT_INT8_KERNEL])
tmp = tempfile.mkdtemp(prefix="chip-legs-")
tok_dir = os.path.join(tmp, "llama3")
os.makedirs(tok_dir)
cs.write_tokenizer(tok_dir, 128000, 256)
depth = "layers" in inspect.signature(cs.disagg_full_width).parameters
where = sys.argv[1]


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"legs: {where} {name} {time.perf_counter() - t0:.3f} s on {card}", flush=True)
    return out


shorts, longs = cs.disagg_requests(ModelConfig.llama3_8b().vocab_size)
for mode, kw in cs.DISAGG_PATHS.items():
    args = (mode, kw, tok_dir, shorts, longs) + ((cs.DISAGG_LAYERS[mode],) if depth else ())
    timed(f"serve-disagg (b) {mode}", cs.disagg_full_width, *args)
for layers in (sorted(set(cs.DISAGG_LAYERS.values())) if depth else [None]):
    timed(f"serve-disagg (b) twin at {layers or 32} layers", cs.disagg_twin, shorts, longs,
          *((layers,) if depth else ()))
for leg, run in (("peer", cs.onboard_peer), ("G4", cs.onboard_g4)):
    res = timed(f"serve-onboard (b) {leg}", run, tok_dir)
    timed(f"serve-onboard (b) {leg} twin", cs.onboard_twin, tok_dir, res["reqs"], leg == "G4")
'''


def main(argv) -> int:
    if not argv:
        print("usage: python3 chip_legs.py CHECKOUT [CHECKOUT ...]", file=sys.stderr)
        return 2
    for checkout in argv:
        proc = subprocess.run([sys.executable, "-c", LEGS, checkout],
                              cwd=os.path.abspath(checkout), timeout=1500)
        if proc.returncode != 0:
            print(f"legs: {checkout} failed with exit code {proc.returncode}", file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
