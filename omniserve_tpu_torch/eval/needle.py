"""Needle-in-a-Haystack accuracy sweep through the port's engine.

Same protocol as the reference ``eval/needle/needle_in_haystack.py``:
sweep (context length x needle depth), insert the needle sentence at the
target depth in a haystack of filler text, ask the retrieval question,
score the answer (rouge-1 recall against the needle), and dump a results
table for heatmap rendering (reference :23-476, visualize.py).

    python -m omniserve_tpu_torch.eval.needle --model <path> \
        --precision w8a8kv8 --kv-quant-granularity per_tensor \
        --sparse-context-mode --sparse-decode-mode --static-sparsity 0.5 \
        --min-context 1024 --max-context 65536 --intervals 6 --depths 5

The haystack is the repository's Paul Graham essays
(``eval/needle/PaulGrahamEssays``), read by path. The sweep needs the
model's tokenizer (``transformers``); ``rouge_score`` is used when it is
installed, else a word-overlap F1.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams

NEEDLE = (
    "The best thing to do in San Francisco is eat a sandwich and sit in "
    "Dolores Park on a sunny day."
)
QUESTION = (
    "What is the best thing to do in San Francisco? Answer based only on "
    "the context above."
)
ESSAY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "eval", "needle", "PaulGrahamEssays")
FILLER_SENTENCES = [
    "The quick brown fox jumps over the lazy dog near the riverbank. ",
    "Markets fluctuated modestly as investors awaited new economic data. ",
    "The recipe calls for two cups of flour and a pinch of salt. ",
    "Mountains rose in the distance, their peaks dusted with fresh snow. ",
    "The committee postponed its decision until the following quarter. ",
]

_corpus_cache = {}
_scorer_cache = {}


def _essay_corpus() -> str:
    """The reference haystack: the concatenated Paul Graham essays."""
    if "text" not in _corpus_cache:
        parts = []
        if os.path.isdir(ESSAY_DIR):
            for name in sorted(os.listdir(ESSAY_DIR)):
                if name.endswith(".txt"):
                    with open(os.path.join(ESSAY_DIR, name),
                              errors="ignore") as f:
                        parts.append(f.read())
        _corpus_cache["text"] = "\n".join(parts)
    return _corpus_cache["text"]


def build_haystack(tokenizer, context_len: int, depth_pct: float) -> str:
    corpus = _essay_corpus()
    if corpus:
        # generous char slice (~6 chars/token), then trim to token budget
        head = corpus[: (context_len - 64) * 6]
        ids = tokenizer.encode(head)[: context_len - 64]
        filler = tokenizer.decode(ids)
    else:  # no corpus: synthetic filler
        filler = ""
        i = 0
        while len(tokenizer.encode(filler)) < context_len - 64:
            filler += FILLER_SENTENCES[i % len(FILLER_SENTENCES)]
            i += 1
    cut = int(len(filler) * depth_pct / 100.0)
    # snap to sentence boundary (reference insert_needle behavior)
    cut = filler.rfind(". ", 0, max(cut, 1)) + 2 if cut > 2 else 0
    return filler[:cut] + NEEDLE + " " + filler[cut:]


def _scorer():
    if "rouge" not in _scorer_cache:
        try:
            from rouge_score import rouge_scorer

            _scorer_cache["rouge"] = rouge_scorer.RougeScorer(
                ["rouge1"], use_stemmer=True)
        except ImportError:
            _scorer_cache["rouge"] = None
    return _scorer_cache["rouge"]


def score_answer(answer: str) -> float:
    """rouge-1 f-measure vs the needle, scaled to [0, 10] like the
    reference (needle_in_haystack.py:257)."""
    scorer = _scorer()
    if scorer is not None:
        return scorer.score(NEEDLE, answer)["rouge1"].fmeasure * 10
    ref = set(NEEDLE.lower().split())
    hyp = answer.lower().split()
    if not hyp:
        return 0.0
    overlap = sum(1 for w in hyp if w in ref)
    p = overlap / len(hyp)
    r = len(set(hyp) & ref) / len(ref)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r) * 10


def run_test(engine: LLMEngine, tokenizer, context_len: int,
             depth_pct: float) -> dict:
    haystack = build_haystack(tokenizer, context_len, depth_pct)
    prompt = (
        f"Context: {haystack}\n\nQuestion: {QUESTION}\n"
        f"Answer:"
    )
    t0 = time.time()
    engine.add_request(
        f"niah-{context_len}-{depth_pct}",
        prompt,
        SamplingParams(temperature=0.0, max_tokens=48),
    )
    answer = ""
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                answer = out.outputs[0].text
    return {
        "context_length": context_len,
        "depth_percent": depth_pct,
        "answer": answer.strip(),
        "score": score_answer(answer),
        "seconds": round(time.time() - t0, 2),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    EngineArgs.add_cli_args(parser)
    parser.add_argument("--min-context", type=int, default=1024)
    parser.add_argument("--max-context", type=int, default=65536)
    parser.add_argument("--intervals", type=int, default=6)
    parser.add_argument("--depths", type=int, default=5)
    parser.add_argument("--output", type=str, default="niah_results.jsonl")
    args = parser.parse_args()

    engine = LLMEngine.from_engine_args(EngineArgs.from_cli_args(args))
    tokenizer = engine.tokenizer
    assert tokenizer is not None, "NIAH needs a real tokenizer"

    lengths = [
        int(
            args.min_context
            * (args.max_context / args.min_context)
            ** (i / max(args.intervals - 1, 1))
        )
        for i in range(args.intervals)
    ]
    depths = [
        round(100.0 * i / max(args.depths - 1, 1), 1)
        for i in range(args.depths)
    ]
    results = []
    with open(args.output, "a") as f:
        for L in lengths:
            for d in depths:
                r = run_test(engine, tokenizer, L, d)
                results.append(r)
                f.write(json.dumps(r) + "\n")
                f.flush()
                print(
                    f"ctx {L:>7} depth {d:>5.1f}%: score {r['score']:.2f} "
                    f"({r['seconds']}s) — {r['answer'][:60]!r}"
                )
    avg = sum(r["score"] for r in results) / len(results)
    print(f"\nmean NIAH score: {avg:.3f} over {len(results)} cells")


if __name__ == "__main__":
    main()
