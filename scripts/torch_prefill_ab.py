#!/usr/bin/env python3
"""Time the port's kernels at every shape ``PERF.md``'s kernel table lists
for them, on one NVIDIA GPU; or two trees of the port in turns. Rows
(``--rows``, comma-separated; default all): 9 (flash prefill), 7 (paged
prefill), the decode rows 5 (per-head page lists), 6 (kv16 decode) and 4
(the streaming band), 4a (row 4's fused append), 1 (the W4A8
per-channel GEMM), 2 (the g128 W4A8 GEMM), 3 (the W8A8 GEMM at the W8A8
body's shapes), 3h (the W8A8 GEMM at the lm_head), 8 (the single-pass
prefill), 10 (the decode KV append, one pool) and 10d (the LServe decode
step's append into both pools).

Run from the root of a checkout:

    python3 scripts/torch_prefill_ab.py --turns OTHER_TREE [--rows 1,4a]
        [--out FILE]
    python3 scripts/torch_prefill_ab.py [--root TREE] [--rows ...]
        [--label NAME]

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
and per-tensor kv8 pages; row 5 over 4 heads' lists of 32 of 257 pages
(``chip_smoke.decode_ph_inputs``) and row 4's band list of 1 sink + 2 ring
pages (``decode_band_inputs``), each at B=1 and B=8 over kv4, kv8 and
per-tensor kv8 pools; row 6 over kv16 pages at B=8 (lengths 1,000-1,100)
and B=128 (1,045-1,536; ``decode_kv16_inputs``); row 4's fused append
over kv4, kv8 and per-tensor kv4 / kv8 pools at B=8 (lengths 1,000-1,100)
and B=128 (1,024-1,536; ``decode_append_inputs``); row 1 as one layer's
four GEMMs (qkv, o, gate_up, down of Llama-3-8B) at M = 8, 128, 8,192 and
16,384 (``gemm_layer_inputs``; decode M rotates weight copies past L2),
each GEMM timed and the layer's sum reported; rows 2 and 3 the same way
over the same four shapes (``group_layer_inputs`` at g128,
``w8a8_layer_inputs``); row 3h at the lm_head (K=4,096, N=128,256) at
M = 8 and 128 (the lm_head runs at decode M only; one weight copy already
exceeds L2); row 8 at the bench's last chunk over kv4, kv8 and per-tensor
kv8 pages, the last 8,192 tokens of a 32,768-token context over kv4 pages
without and with half the kv heads on the band (128 sink + 8,192 local
tokens), and over the kv4 ring at phase 7 (a)'s first chunk and wrapped;
row 10 over kv4, kv8 and per-tensor kv8 pools at T=8 with 4 pool heads
and K stats and at T=128 with 8 pool heads without (``chip_smoke``'s
``check_kv_append`` shapes); row 10d at T=8 and 128 over the same modes:
Llama-3.1-8B's 8 kv heads, K / V read from a fused qkv row, rows 0, 2, 4,
6 to the retrieval pool (with K stats) and 1, 3, 5, 7 to the streaming
pool, timed as the tree's decode step runs it (a tree with the two-pool
entry: one launch; a tree without: each pool's head gather and its own
launch). Prefill times and the GEMMs above
M=128 are CUDA-event means over a few launches after a warmup
(``chip_smoke.time_ms``); decode times and the GEMMs at M <= 128 are per
call of calls captured in one CUDA graph and replayed
(``chip_smoke.time_graphed_ms``, as the kernel table's decode rows); rows
5, 6 and 4 beside "... sdpa": one ``scaled_dot_product_attention`` over
the same K/V dequantized or gathered beforehand (not counted), the kernel
table's library yardstick (row 4a has none: it also writes the pool; the
GEMMs', ``torch._int_mm`` plus the epilogue, is logged by ``chip_smoke``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ROWS = ("9", "7", "5", "6", "4", "4a", "1", "2", "3", "3h", "8", "10",
        "10d")


def measure(root: str, rows=ROWS) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # noqa: E402  (input generators and timing)
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F

    import omniserve_tpu_torch
    from omniserve_tpu_torch.ops.cuda import decode_attention as da
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa
    from omniserve_tpu_torch.ops.cuda import kv_append as ka
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.cuda import prefill_single_pass as psp
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

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
    }.items() if "9" in rows else ():
        args, kw = flash_inputs(t, n_seg, band)
        out[name] = cs.time_ms(lambda: fa.flash_prefill(*args, **kw), reps,
                               warmup=1)
        del args
        torch.cuda.empty_cache()
    for kv_bits, pt, label in ((4, False, "kv4"), (8, False, "kv8"),
                               (16, False, "kv16"), (8, True, "pt8")
                               ) if "7" in rows else ():
        args, kw, _, _, _ = cs.dense_chunk_inputs(dev, gen(), kv_bits, pt)
        out[f"row7 bench chunk {label}"] = cs.time_ms(
            lambda: pp.paged_prefill_attention(*args, **kw), 5, warmup=1)
        del args
        torch.cuda.empty_cache()
    for mode in ("kv4", "kv8", "pt8") if "7" in rows else ():
        for label, (context, tc, n_ring) in (
                ("phase 7 (a) first chunk", (32000, 32000, 314)),
                ("wrapped", (20000, 2048, 80))):
            args, kw, _, _, _ = cs.ring_chunk_inputs(dev, gen(), context, tc,
                                                     n_ring, mode)
            out[f"row7 ring {label} {mode}"] = cs.time_ms(
                lambda: pp.paged_prefill_attention(*args, **kw), 3, warmup=1)
            del args
            torch.cuda.empty_cache()
    decode = []   # (name, inputs, their arguments, kernel wrapper)
    for row, inputs, fn in (
            ("5", cs.decode_ph_inputs, da.paged_mqa_attention_single_pass_ph),
            ("4", cs.decode_band_inputs, da.paged_mqa_attention_single_pass)):
        decode += [(f"row{row} {mode} B={b}", inputs, (b, mode), fn)
                   for mode in ("kv4", "kv8", "pt8") for b in (1, 8)
                   if row in rows]
    if "6" in rows:
        decode += [(f"row6 kv16 B={b}", cs.decode_kv16_inputs, lens,
                    da.paged_mqa_attention)
                   for b, lens in ((8, (8, 1000, 1100)),
                                   (128, (128, 1045, 1536)))]
    for name, inputs, in_args, fn in decode:
        args, kw = inputs(dev, gen(), *in_args)[:2]
        out[name] = cs.time_graphed_ms(lambda: fn(*args, **kw), 20)
        band_kw = {k: v for k, v in kw.items()
                   if k not in ("sm_scale", "page_size")}
        q, k, v, valid = cs.list_library_inputs(*args, kw["page_size"],
                                                **band_kw)
        out[f"{name} sdpa"] = cs.time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=valid[:, :, None, :],
                scale=kw["sm_scale"]), 20)
        del args, q, k, v, valid
        torch.cuda.empty_cache()
    for label, kv_bits, pt in (("kv4", 4, False), ("kv8", 8, False),
                               ("pt4", 4, True), ("pt8", 8, True)
                               ) if "4a" in rows else ():
        for b, lens in ((8, (1000, 1100)), (128, (1024, 1536))):
            args, kw, _ = cs.decode_append_inputs(dev, gen(), b, *lens,
                                                  kv_bits, pt)
            out[f"row4a {label} B={b}"] = cs.time_graphed_ms(
                lambda: da.paged_decode_attention_fused(*args, **kw), 20)
            del args
            torch.cuda.empty_cache()
    for m in (8, 128, 8192, 16384) if "1" in rows else ():
        total = 0.0
        for name, _, _, a_i8, qws, s1, sz, a_scale, a_sum in \
                cs.gemm_layer_inputs(dev, gen(), m):
            ms = cs.time_gemm_ms(lambda w: qm.w4a8_matmul_per_channel(
                a_i8, w, s1, sz, a_scale, a_sum), qws, m)
            out[f"row1 {name} M={m}"] = ms
            total += ms
            del qws
        out[f"row1 layer M={m}"] = total
        torch.cuda.empty_cache()
    for m in (8, 128, 8192, 16384) if "2" in rows else ():
        total = 0.0
        for name, _, _, a_i8, qws, s1, s2, s2z, a_scale in \
                cs.group_layer_inputs(dev, gen(), m, 128):
            ms = cs.time_gemm_ms(lambda w: qm.w4a8_matmul_per_group(
                a_i8, w, s1, s2, s2z, a_scale, group_size=128), qws, m)
            out[f"row2 g128 {name} M={m}"] = ms
            total += ms
            del qws
        out[f"row2 g128 layer M={m}"] = total
        torch.cuda.empty_cache()
    for m in (8, 128, 8192, 16384) if "3" in rows else ():
        total = 0.0
        for name, _, _, a_i8, ws, sc, a_scale in \
                cs.w8a8_layer_inputs(dev, gen(), m):
            ms = cs.time_gemm_ms(lambda w: qm.w8a8_matmul(
                a_i8, w, sc, a_scale), ws, m)
            out[f"row3 {name} M={m}"] = ms
            total += ms
            del ws
        out[f"row3 layer M={m}"] = total
        torch.cuda.empty_cache()
    for m in (8, 128) if "3h" in rows else ():
        g = gen()
        a_i8, a_scale, _ = quantize_activations(
            torch.randn((m, 4096), generator=g, device=dev))
        w = torch.randint(-127, 128, (4096, 128256), generator=g,
                          dtype=torch.int8, device=dev)
        ws = torch.empty(128256, device=dev).uniform_(0.0003, 0.0006,
                                                      generator=g)
        out[f"row3h lm_head M={m}"] = cs.time_gemm_ms(
            lambda wt: qm.w8a8_matmul(a_i8, wt, ws, a_scale), [w], m)
        del w
        torch.cuda.empty_cache()
    single_pass = []   # (name, args, kw, reps)
    for kv_bits, pt, label in ((4, False, "kv4"), (8, False, "kv8"),
                               (8, True, "pt8")) if "8" in rows else ():
        args, kw = cs.dense_chunk_inputs(dev, gen(), kv_bits, pt)[:2]
        single_pass.append((f"row8 bench chunk {label}", args, kw, 5))
    for band in (False, True) if "8" in rows else ():
        args, kw = cs.dense_chunk_inputs(dev, gen(), 4, False, 1, 24576,
                                         8192)[:2]
        if band:
            hq, hkv = args[0].shape[2], args[1].num_heads
            kw.update(head_is_retrieval=(torch.arange(hkv, device=dev)
                                         < hkv // 2).repeat_interleave(
                                             hq // hkv),
                      sink_size=128, local_size=8192)
        single_pass.append((f"row8 32K last 8192 kv4{' band' if band else ''}",
                            args, kw, 3))
    for label, (context, tc, n_ring) in (
            ("phase 7 (a) first chunk", (32000, 32000, 314)),
            ("wrapped", (20000, 2048, 80))) if "8" in rows else ():
        args, kw = cs.ring_chunk_inputs(dev, gen(), context, tc, n_ring)[:2]
        single_pass.append((f"row8 ring {label} kv4", args, kw, 3))
    for name, args, kw, reps in single_pass:
        out[name] = cs.time_ms(
            lambda: psp.paged_prefill_single_pass(*args, **kw), reps,
            warmup=1)
    del single_pass
    torch.cuda.empty_cache()
    page, d = 128, 128
    for mode in ("kv4", "kv8", "pt8") if "10" in rows else ():
        for t, heads, stats in ((8, 4, True), (128, 8, False)):
            g = gen()
            pool = cs.list_mode_pool(g, dev, 2, 2 * t + 1, heads, page, d,
                                     mode)
            if stats:
                pool = pool._replace(k_stats=torch.randn(
                    (2, 2 * t + 1, heads, 8, d), generator=g, device=dev))
            pages = torch.randperm(2 * t, generator=g, device=dev)[:t].to(
                torch.int32)
            slots = torch.randint(0, page, (t,), generator=g,
                                  device=dev).to(torch.int32)
            k, v = (torch.randn((t, heads, d), generator=g,
                                device=dev).bfloat16() for _ in range(2))
            out[f"row10 {mode} T={t} H={heads}"
                f"{' stats' if stats else ''}"] = cs.time_graphed_ms(
                lambda: ka.append_kv_decode(pool, 1, k, v, pages, slots,
                                            page, update_stats=stats), 20)
    for mode in ("kv4", "kv8", "pt8") if "10d" in rows else ():
        for t in (8, 128):
            g = gen()
            pools, targets = [], []
            for first in (0, 1):
                pool = cs.list_mode_pool(g, dev, 2, 2 * t + 1, 4, page, d,
                                         mode)
                if first == 0:
                    pool = pool._replace(k_stats=torch.randn(
                        (2, 2 * t + 1, 4, 8, d), generator=g, device=dev))
                pools.append(pool)
                pages = torch.randperm(2 * t, generator=g, device=dev)[:t].to(
                    torch.int32)
                slots = torch.randint(0, page, (t,), generator=g,
                                      device=dev).to(torch.int32)
                targets.append((pages, slots,
                                torch.arange(first, 8, 2, device=dev)))
            qkv = torch.randn((t, 48, d), generator=g, device=dev).bfloat16()
            k, v = qkv[:, 32:40], qkv[:, 40:48]
            (rp, sp), (tr, ts) = pools, targets

            if hasattr(ka, "append_kv_decode_pools"):
                def step():
                    ka.append_kv_decode_pools(rp, sp, 1, k, v, tr, ts, page,
                                              update_stats=True)
            else:
                def step():
                    ka.append_kv_decode(rp, 1, k[:, tr[2]].contiguous(),
                                        v[:, tr[2]].contiguous(), tr[0],
                                        tr[1], page, update_stats=True)
                    ka.append_kv_decode(sp, 1, k[:, ts[2]].contiguous(),
                                        v[:, ts[2]].contiguous(), ts[0],
                                        ts[1], page)
            out[f"row10d {mode} T={t} H=4+4"] = cs.time_graphed_ms(step, 20)
    return out


def turns(other: str, out_path: str, rows=ROWS) -> dict:
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--label", label, "--rows", ",".join(rows)],
            capture_output=True, text=True, timeout=1500)
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
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="kernel-table rows to time, of " + ",".join(ROWS))
    args = ap.parse_args()
    rows = tuple(args.rows.split(","))
    if not set(rows) <= set(ROWS):
        ap.error(f"--rows takes some of {','.join(ROWS)}")
    if args.turns:
        print(json.dumps(turns(args.turns, args.out, rows)), flush=True)
    else:
        print(json.dumps(measure(args.root, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
