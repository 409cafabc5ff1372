#!/usr/bin/env python3
"""Where serve-geometry (c)'s memory goes: ``chip_smoke.py``'s
``geometry_70b_int8`` (Llama-3-70B, 80 layers, int8 weights, one card)
alone, with the allocator read at every dequantization of the head.

    python3 chip_memory_probe.py CHECKOUT two-copy|own

``CHECKOUT`` is a checkout of the repo (its ``chip_smoke.py`` and
``dynamo_tpu_torch`` are the ones imported: another commit's to compare
two trees on one card).  ``two-copy`` dequantizes as ``quant.mat`` once
did (the cast, then the scaled product: two copies of the weight at
once); ``own`` keeps the checkout's ``quant.mat``.  Prints the phase's
lines, its peak, and at the three largest head dequantizations the bytes
allocated and, by memory pool (a CUDA graph's private pool has an id other
than (0, 0)), the bytes allocated and reserved.  Needs a card.
"""

import sys

root, mode = sys.argv[1], sys.argv[2]
if mode not in ("two-copy", "own"):
    sys.exit("usage: python3 chip_memory_probe.py CHECKOUT two-copy|own")
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.engine import model as tmodel  # noqa: E402
from dynamo_tpu_torch.engine import quant  # noqa: E402
from dynamo_tpu_torch.ops import build  # noqa: E402
from dynamo_tpu_torch.ops import paged_attention as pa  # noqa: E402
from dynamo_tpu_torch.ops import ragged_attention as ra  # noqa: E402

GIB = 2**30


def two_copy_mat(w):
    if isinstance(w, quant.QuantizedTensor):
        return w.q.to(w.s.dtype) * w.s
    return w


def by_pool():
    out = {}
    for seg in torch.cuda.memory_snapshot():
        pool = str(tuple(seg.get("segment_pool_id", (0, 0))))
        used = sum(b["size"] for b in seg["blocks"] if b["state"] == "active_allocated")
        a, r = out.get(pool, (0, 0))
        out[pool] = (a + used, r + seg["total_size"])
    return {k: (round(a / GIB, 3), round(r / GIB, 3)) for k, (a, r) in out.items()}


def main() -> None:
    build.build_all([pa.KERNEL, ra.KERNEL])
    card = cs.card_line()
    print(root, mode, card, flush=True)
    base_mat = two_copy_mat if mode == "two-copy" else quant.mat
    seen = []

    def watched(w):
        # the head: [hidden, vocab] (Llama-3's vocabulary)
        if isinstance(w, quant.QuantizedTensor) and w.q.shape[-1] == 128256:
            capturing = torch.cuda.is_current_stream_capturing()
            seen.append((torch.cuda.memory_allocated(), capturing,
                         None if capturing else by_pool()))
        return base_mat(w)

    tmodel.mat = watched
    try:
        cs.geometry_70b_int8(card)
        status = "ok"
    except torch.OutOfMemoryError as e:
        status = f"out of memory: {str(e)[:400]}"
    print("status", status)
    print("peak_abs_gib", round(torch.cuda.max_memory_allocated() / GIB, 3))
    print("head dequantizations", len(seen), "under capture", sum(1 for s in seen if s[1]))
    for alloc, capturing, pools in sorted(seen, key=lambda s: -s[0])[:3]:
        print("at a head dequantization: allocated GiB", round(alloc / GIB, 3), "capturing",
              capturing, "by pool (allocated, reserved) GiB", pools)


if __name__ == "__main__":
    main()
