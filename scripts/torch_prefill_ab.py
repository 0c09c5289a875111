#!/usr/bin/env python3
"""Time the port's two prefill attention kernels, rows 7 (paged prefill)
and 9 (flash prefill), at every shape ``PERF.md``'s kernel table lists for
them, on one NVIDIA GPU; or two trees of the port in turns.

Run from the root of a checkout:

    python3 scripts/torch_prefill_ab.py --turns OTHER_TREE [--out FILE]
    python3 scripts/torch_prefill_ab.py [--root TREE] [--label NAME]

``--turns OTHER_TREE`` times the tree at OTHER_TREE (e.g. a ``git
archive`` of the parent commit unpacked into a directory ``.gitignore``
lists) and this checkout in turns, other, this, this, other, each in a
process of its own (both packages are named ``omniserve_tpu_torch``), and
prints every shape's four times and the ratio of the means, as one JSON
object on the last line (also written to FILE). Without it, the script
times the kernels of ``--root`` (default: this checkout), built from that
tree's own ``csrc``, and prints one JSON object of milliseconds per shape.

The inputs are ``chip_smoke.py``'s generators from this checkout, made
from seed 0 on the card, so both trees see the same tensors: flash prefill
at 8 x 1,024 tokens and at a 16,384-token prompt with half the kv heads
on the sink + local band (and the dense kernel at that shape); paged
prefill at the bench's last chunk (B=128, Tc=128 after 896) over kv4,
kv8, kv16 and per-tensor kv8 pages, and the ring at phase 7 (a)'s first
chunk (Tc=32,000) and wrapped (context 20,000, Tc=2,048) over kv4, kv8
and per-tensor kv8 pages. Times are CUDA-event means over a few launches
after a warmup (``chip_smoke.time_ms``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # noqa: E402  (input generators and timing)
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import omniserve_tpu_torch
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp

    if not torch.cuda.is_available():
        raise SystemExit("torch_prefill_ab: needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    out = {"package": os.path.dirname(omniserve_tpu_torch.__file__)}

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def flash_inputs(t, n_seg, band):
        g = gen()
        hq, hkv, d = 32, 8, 128
        q = torch.randn((t, hq, d), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((t, hkv, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((t, hkv, d), generator=g, device=dev).to(torch.bfloat16)
        seg_len = t // n_seg
        seg = torch.arange(n_seg, device=dev, dtype=torch.int32) \
            .repeat_interleave(seg_len)
        pos = torch.arange(seg_len, device=dev, dtype=torch.int32).repeat(n_seg)
        kw = {}
        if band:
            kw = dict(head_is_retrieval=(torch.arange(hkv, device=dev)
                                         < hkv // 2).repeat_interleave(4),
                      sink_size=128, local_size=8192)
        return (q, k, v, seg, pos, d ** -0.5), kw

    for name, (t, n_seg, band, reps) in {
        "row9 dense 8x1024": (8192, 8, False, 10),
        "row9 band T=16384": (16384, 1, True, 3),
        "row9 dense T=16384": (16384, 1, False, 3),
    }.items():
        args, kw = flash_inputs(t, n_seg, band)
        out[name] = cs.time_ms(lambda: fa.flash_prefill(*args, **kw), reps,
                               warmup=1)
        del args
        torch.cuda.empty_cache()
    for kv_bits, pt, label in ((4, False, "kv4"), (8, False, "kv8"),
                               (16, False, "kv16"), (8, True, "pt8")):
        args, kw, _, _, _ = cs.dense_chunk_inputs(dev, gen(), kv_bits, pt)
        out[f"row7 bench chunk {label}"] = cs.time_ms(
            lambda: pp.paged_prefill_attention(*args, **kw), 5, warmup=1)
        del args
        torch.cuda.empty_cache()
    for mode in ("kv4", "kv8", "pt8"):
        for label, (context, tc, n_ring) in (
                ("phase 7 (a) first chunk", (32000, 32000, 314)),
                ("wrapped", (20000, 2048, 80))):
            args, kw, _, _, _ = cs.ring_chunk_inputs(dev, gen(), context, tc,
                                                     n_ring, mode)
            out[f"row7 ring {label} {mode}"] = cs.time_ms(
                lambda: pp.paged_prefill_attention(*args, **kw), 3, warmup=1)
            del args
            torch.cuda.empty_cache()
    return out


def turns(other: str, out_path: str) -> dict:
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--label", label], capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise SystemExit(f"torch_prefill_ab: the {label} run failed:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"{label} ({root}): {runs[-1][1]}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result = {"card": card, "order": [label for label, _ in runs],
              "shapes": {}}
    for shape in runs[0][1]:
        if shape == "package":
            continue
        times = [r[shape] for _, r in runs]
        other_ms = (times[0] + times[3]) / 2
        this_ms = (times[1] + times[2]) / 2
        result["shapes"][shape] = {"ms_in_turns": times,
                                   "other_ms": other_ms, "this_ms": this_ms,
                                   "speedup": other_ms / this_ms}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", metavar="OTHER_TREE", default=None)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.turns:
        print(json.dumps(turns(args.turns, args.out)), flush=True)
    else:
        print(json.dumps(measure(args.root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
