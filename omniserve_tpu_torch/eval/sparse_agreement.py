"""Sparse-vs-dense greedy-token agreement at depth, through the port.

The reference's LServe accuracy claim is parity between dense attention
and the hybrid sparse path at sparsity 0.5 on long contexts
(reference README.md:391-396, NIAH + LongBench). Absolute NIAH scores
need an instruction-tuned model; this harness measures the claim
directly on any checkpoint: build NIAH-style (context x depth) prompts,
decode N tokens greedily once with the dense engine and once with the
sparse engine (static sparsity + dynamic page selection), and report
per-position token agreement. Sparse ≈ dense  ⇔  agreement stays high.

    python -m omniserve_tpu_torch.eval.sparse_agreement --model <path> \
        --contexts 8192 16384 32768 --depths 10 50 90 --gen-len 32 \
        --static-sparsity 0.5 --output sparse_agreement.json

``main`` builds the prompts with the model's tokenizer; ``run_mode`` and
``agreement_result`` take prompt token ids, so a caller without a
tokenizer (the card's smoke run) drives the same engines and schema.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.eval.needle import QUESTION, build_haystack

Key = Tuple[int, float]    # (context, depth_pct)


def build_engine(args, sparse: bool, **engine_kwargs) -> LLMEngine:
    """The dense engine, or the sparse one (``sparse``); ``engine_kwargs``
    go to ``EngineArgs`` beside the harness's own settings (a caller's
    ``load_format``, ``tokenizer_mode``, ``device``)."""
    max_ctx = max(args.contexts) + args.gen_len + 256
    ea = EngineArgs(
        model=args.model,
        precision=(
            args.control_precision
            if sparse and args.control_precision else args.precision
        ),
        block_size=128,
        max_num_seqs=1,
        max_num_batched_tokens=max(4096, max_ctx),
        max_model_len=max_ctx,
        num_retrieval_blocks=max_ctx // 128 + 8,
        chunk_prefill_size=args.chunk_prefill_size,
        ifb_mode=True,
        disable_log_stats=True,
        **engine_kwargs,
    )
    if sparse and args.control_precision:
        return LLMEngine.from_engine_args(ea)  # dense noise-floor control
    if sparse:
        # Static streaming-head sparsity only with a calibration pattern:
        # assigning retrieval/streaming heads uniformly on an UNCALIBRATED
        # model discards real attention mass and legitimately diverges
        # (the reference's parity claim rides DuoAttention-calibrated
        # patterns, attn_patterns/*). The query-aware dynamic page
        # selection is calibration-free and is always on here.
        if args.attn_pattern_path:
            ea.sparse_context_mode = True
            ea.attn_pattern_path = args.attn_pattern_path
            ea.static_sparsity = args.static_sparsity
        ea.sparse_decode_mode = True
        ea.sparse_kv_cache_budget = args.sparse_kv_cache_budget
        ea.selector_update_interval = args.selector_update_interval
    return LLMEngine.from_engine_args(ea)


def greedy(engine: LLMEngine, prompt_ids, gen_len: int) -> List[int]:
    engine.add_request(
        f"r{time.monotonic_ns()}", prompt_token_ids=list(prompt_ids),
        sampling_params=SamplingParams(
            temperature=0.0, max_tokens=gen_len, ignore_eos=True
        ),
    )
    out = None
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out = o
    return list(out.outputs[0].token_ids)


def run_mode(args, sparse: bool, prompts: Dict[Key, Sequence[int]],
             mode: Optional[str] = None, **engine_kwargs) -> Dict[Key, Dict]:
    """Greedy tokens and seconds of each prompt (token ids) through one
    engine: {key: {"tokens", "seconds"}}."""
    mode = mode or ("sparse" if sparse else "dense")
    engine = build_engine(args, sparse, **engine_kwargs)
    runs = {}
    for key, ids in prompts.items():
        t0 = time.time()
        toks = greedy(engine, ids, args.gen_len)
        runs[key] = {"tokens": toks, "seconds": round(time.time() - t0, 1)}
        print(f"{mode} ctx {key[0]} depth {key[1]}: "
              f"{runs[key]['seconds']}s", flush=True)
    del engine
    return runs


def agreement_result(args, dense: Dict[Key, Dict],
                     sparse: Dict[Key, Dict]) -> Dict:
    """The JSON result: per-cell agreement of two runs' tokens."""
    cells = []
    for ctx, depth in sorted(dense):
        a = dense[(ctx, depth)]["tokens"]
        b = sparse[(ctx, depth)]["tokens"]
        n = min(len(a), len(b))
        agree = sum(x == y for x, y in zip(a[:n], b[:n])) / max(n, 1)
        cells.append({
            "context": ctx, "depth_pct": depth,
            "agreement": round(agree, 4),
            "dense_tokens": a, "sparse_tokens": b,
            "dense_seconds": dense[(ctx, depth)]["seconds"],
            "sparse_seconds": sparse[(ctx, depth)]["seconds"],
        })
        print(f"ctx {ctx:>6} depth {depth:>5.1f}%: agreement {agree:.3f}")

    mean = sum(c["agreement"] for c in cells) / len(cells)
    return {
        "model": args.model,
        "precision": args.precision,
        "static_sparsity": args.static_sparsity,
        "budget": args.sparse_kv_cache_budget,
        "selector_update_interval": args.selector_update_interval,
        "gen_len": args.gen_len,
        "mean_agreement": round(mean, 4),
        "cells": cells,
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True)
    ap.add_argument("--precision", default="w4a8kv4")
    ap.add_argument("--contexts", type=int, nargs="+",
                    default=[8192, 16384, 32768])
    ap.add_argument("--depths", type=float, nargs="+", default=[10, 50, 90])
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--static-sparsity", type=float, default=0.5)
    ap.add_argument("--sparse-kv-cache-budget", type=int, default=4096)
    ap.add_argument("--selector-update-interval", type=int, default=4)
    ap.add_argument("--attn-pattern-path", type=str, default=None)
    ap.add_argument("--control-precision", type=str, default=None,
                    help="noise-floor control: the 'sparse' engine is "
                    "DENSE at this precision (e.g. w8a8kv8) — measures "
                    "how much greedy divergence a tiny perturbation "
                    "causes on this model at these context lengths")
    ap.add_argument("--chunk-prefill-size", type=int, default=8192)
    ap.add_argument("--output", type=str,
                    default="sparse_agreement.json")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    from omniserve_tpu_torch.utils.tokenizer import get_tokenizer

    tokenizer = get_tokenizer(args.model)
    prompts = {}
    for ctx in args.contexts:
        for depth in args.depths:
            text = build_haystack(tokenizer, ctx, depth)
            ids = tokenizer.encode(
                text + "\n\n" + QUESTION + "\nAnswer:"
            )[: ctx]
            prompts[(ctx, depth)] = ids

    dense = run_mode(args, False, prompts)
    sparse = run_mode(args, True, prompts)
    result = agreement_result(args, dense, sparse)
    with open(args.output, "w") as f:
        json.dump(result, f, indent=1)
    print(f"\nmean sparse-vs-dense agreement: "
          f"{result['mean_agreement']:.3f} -> {args.output}")
    return result


if __name__ == "__main__":
    main()
