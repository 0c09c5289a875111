#!/usr/bin/env python3
"""Split the PyTorch port's W8A8 kernels-vs-plain logit gap by attention
kernel, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/torch_w8a8_gap_split.py [--precisions w8a8kv8 ...]
        [--out gap_split.json]

``chip_smoke.py``'s phase 3 holds 2-layer full-width forwards of
``omniserve_tpu_torch`` against their plain versions within max(5e-2, 3 x
floor) of max |logit|, the floor being how far the logits move when the
plain forward's attention outputs get random one-ulp nudges at a share of
4e-4. W8A8 bodies need that floor. This script asks where their gap comes
from, for each precision (by default both W8A8 ones, and w4a8kv8, whose
attention kernels are the same and whose body is W4A8):

1. the gap with only one attention entry point's kernel (every other op
   plain), and with every kernel but that one: flash prefill on the
   whole-prompt logits, the fused decode on the decode step's, paged
   prefill on a chunked prefill's;
2. that kernel's own share of nonzero bf16 outputs that differ from its
   plain version's on identical inputs (the calls of layer 0 of the plain
   forward), and by how many ulps of their row's largest value;
3. the floor at that share: the plain forward with only that entry point's
   outputs nudged by one ulp at that share, over three seeds.

A kernel whose outputs differ by rounding (a few ulps of their row's
scale) and whose gap lies within the nudges' range at its own share moves
the logits as rounding does; a gap far above that range points at the
kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the forwards phase 3 compares)

ENTRIES = {  # entry point -> the logits it moves
    "prefill_attention": "prefill",
    "paged_decode_attention_fused": "decode",
    "paged_prefill_attention": "chunked",
}
SEEDS = (7, 8, 9)


@contextlib.contextmanager
def entry_mode(entry, kernel):
    """Within the block the dispatch entry point ``entry`` runs its kernel
    (``kernel``) or its plain version, whatever the other calls do."""
    from omniserve_tpu_torch.ops import cuda, dispatch

    real = getattr(dispatch, entry)

    def call(*a, **k):
        prev = cuda._force_plain
        cuda._force_plain = not kernel
        try:
            return real(*a, **k)
        finally:
            cuda._force_plain = prev

    setattr(dispatch, entry, call)
    try:
        yield
    finally:
        setattr(dispatch, entry, real)


@contextlib.contextmanager
def recorded_calls(entry, calls):
    """Within the block, append to ``calls`` the arguments of each call of
    ``entry`` at layer 0 (pools copied, so later appends leave them)."""
    from omniserve_tpu_torch.ops import dispatch
    from omniserve_tpu_torch.ops.paged_kv import KVPool

    real = getattr(dispatch, entry)
    sig = inspect.signature(real)

    def record(*a, **k):
        bound = sig.bind(*a, **k)
        layer = bound.arguments.get("layer", None)
        if layer == 0 or (layer is None and not calls):
            calls.append({n: v.clone() if isinstance(v, KVPool) else v
                          for n, v in bound.arguments.items()})
        return real(*a, **k)

    setattr(dispatch, entry, record)
    try:
        yield
    finally:
        setattr(dispatch, entry, real)


def mode_ctx(mode):
    """kernels / plain as phase 3 runs them; "only:E" the plain versions but
    E's kernel; "but:E" the kernels but E's plain version; "nudge:E:rate:
    seed" the plain versions with E's outputs nudged one ulp at ``rate``."""
    from omniserve_tpu_torch.ops import cuda

    stack = contextlib.ExitStack()
    parts = mode.split(":")
    if parts[0] in ("plain", "only", "nudge"):
        stack.enter_context(cuda.plain_versions())
    if parts[0] in ("only", "but"):
        stack.enter_context(entry_mode(parts[1], kernel=parts[0] == "only"))
    if parts[0] == "nudge":
        stack.enter_context(cs.nudged_attention(
            rate=float(parts[2]), seed=int(parts[3]), names=(parts[1],)))
    return stack


class Forwards:
    """Phase 3's 2-layer forwards of one precision: whole-prompt prefill,
    one decode step, and a chunked prefill of the same prompts."""

    def __init__(self, precision, dev):
        from omniserve_tpu_torch.models import llama

        self.dev = dev
        self.spec = cs.precision_spec(precision)
        self.params = llama.make_random_packed_params(self.spec, seed=1,
                                                      device=dev)
        self.prompts, self.tables, self.pre, self.n_pages = (
            cs.forward_batch(self.spec, dev))
        self.kv_scales = None
        if self.spec.kv_bits < 16 and not self.spec.kv_zeros:
            self.kv_scales = cs.calibrate_kv_scales(
                self.spec, self.params, self.pre, self.n_pages, dev)
        self.next = None

    def run(self, mode, record=None):
        """{"prefill", "decode", "chunked"} logits under ``mode``."""
        import torch

        from omniserve_tpu_torch.models import llama
        from omniserve_tpu_torch.worker.model_runner import (
            chunked_prefill_batches,
        )

        out = {}
        with mode_ctx(mode), contextlib.ExitStack() as rec, \
                torch.inference_mode():
            if record is not None:
                for entry, calls in record.items():
                    rec.enter_context(recorded_calls(entry, calls))
            pool = cs.forward_pool(self.spec, self.n_pages, self.dev,
                                   self.kv_scales)
            out["prefill"], pool, _, _ = llama.llama_forward(
                self.params, pool, None, self.pre, self.spec,
                is_prefill=True)
            if self.next is None:       # the plain run's next tokens
                self.next = cs.next_decode_batch(out["prefill"], self.prompts,
                                                 self.tables, self.dev)
            out["decode"], _, _, _ = llama.llama_forward(
                self.params, pool, None, self.next, self.spec,
                is_prefill=False)
            seqs = [(p.tolist(), self.tables[i].tolist())
                    for i, p in enumerate(self.prompts)]
            pool = cs.forward_pool(self.spec, self.n_pages, self.dev,
                                   self.kv_scales)
            final = None
            for batch, ends in chunked_prefill_batches(
                    seqs, 2048, self.spec.page_size, self.dev):
                logits, _, _, _ = llama.llama_forward(
                    self.params, pool, None, batch, self.spec,
                    is_prefill=True)
                final = logits if final is None else torch.where(
                    ends[:, None], logits, final)
            out["chunked"] = final[: len(seqs)]
        return out


def flip_stats(entry, calls):
    """(share of the nonzero bf16 outputs that differ, largest difference
    in ulps of its row's largest value) of the kernel against its plain
    version on the recorded calls."""
    import torch

    from omniserve_tpu_torch.ops import cuda, dispatch
    from omniserve_tpu_torch.ops.paged_kv import KVPool

    fn = getattr(dispatch, entry)
    n_diff = n_live = 0
    ulps = 0.0
    for args in calls:
        def call():
            kw = {n: v.clone() if isinstance(v, KVPool) else v
                  for n, v in args.items()}
            out = fn(**kw)
            return out[0] if isinstance(out, tuple) else out

        with torch.inference_mode():
            got = call().float()
            with cuda.plain_versions():
                want = call().float()
        n_diff += int((got != want).sum())
        n_live += int((want != 0).sum())
        row_max = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
        ulps = max(ulps, float(((got - want).abs() / ulp).max()))
    return n_diff / max(n_live, 1), ulps


def gap(logits, plain):
    return float((logits - plain).abs().max()) / float(plain.abs().max())


def split(precision, dev):
    from omniserve_tpu_torch.ops import cuda

    t0 = time.time()
    fw = Forwards(precision, dev)
    calls = {e: [] for e in ENTRIES}
    base = {"plain": fw.run("plain", record=calls),
            "kernels": fw.run("kernels")}
    row = {"precision": precision, "kernels_gap": {
        step: gap(base["kernels"][step], base["plain"][step])
        for step in ("prefill", "decode", "chunked")}}
    cs.log(f"{precision}: kernels vs plain over max |logit|: "
           + ", ".join(f"{s} {g:.4g}" for s, g in row["kernels_gap"].items()))
    for entry, step in ENTRIES.items():
        plain = base["plain"][step]
        only = gap(fw.run(f"only:{entry}")[step], plain)
        but = gap(fw.run(f"but:{entry}")[step], plain)
        share, ulps = flip_stats(entry, calls[entry])
        nudged = [gap(fw.run(f"nudge:{entry}:{share!r}:{s}")[step], plain)
                  for s in SEEDS] if share > 0 else [0.0]
        row[entry] = dict(step=step, only=only, but=but, flip_share=share,
                          max_row_ulps=ulps, n_calls=len(calls[entry]),
                          nudged_at_share=nudged)
        cs.log(f"  {entry} ({step} logits): only its kernel {only:.4g}, "
               f"every kernel but it {but:.4g}; its bf16 outputs differ "
               f"from plain in {share:.4g} of {len(calls[entry])} layer-0 "
               f"calls' nonzero elements, by at most {ulps:.3g} ulp of "
               f"their row's largest value; plain with one-ulp nudges of "
               f"its outputs at that share: "
               + ", ".join(f"{g:.4g}" for g in nudged)
               + f" (seeds {list(SEEDS)})")
    del fw
    cuda.reset_launch_counts()
    cs.log(f"  [{precision} {time.time() - t0:.1f} s]")
    return row


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precisions", nargs="+",
                    default=["w8a8kv8", "w8a8kv8-pt", "w4a8kv8"],
                    choices=sorted(cs.PRECISIONS))
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_w8a8_gap_split: CUDA is not available", file=sys.stderr)
        return 2
    from omniserve_tpu_torch.csrc import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cs.log(f"card: {cs.card_line()}")
    cs.log(f"kernels built in {build.build_all():.1f} s")
    rows = []
    for precision in args.precisions:
        rows.append(split(precision, dev))
        torch.cuda.empty_cache()
    print(json.dumps({"gap_split": rows}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
