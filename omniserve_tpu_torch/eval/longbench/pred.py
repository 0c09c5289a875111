"""Generate LongBench predictions with the port's engine.

Same protocol as the reference ``eval/LongBench/pred.py``: load THUDM
LongBench tasks, middle-truncate prompts to the context budget
(reference pred.py:66-72), format per-dataset prompts (:163-178), run the
engine greedily, dump jsonl predictions. Without ``--data-dir`` the
corpus comes from the ``datasets`` package and the network; with it,
``{task}.jsonl`` files are read from that directory (the repository's
``eval/LongBench/data_tiny`` holds three).

    python -m omniserve_tpu_torch.eval.longbench.pred --model <path> ... \
        --datasets hotpotqa [--data-dir DIR] [--device cpu]
"""

import argparse
import json
import os
from typing import Optional, Sequence

from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams

DATASET_PROMPTS = {
    "narrativeqa": (
        "You are given a story and a question. Answer the question "
        "concisely.\n\nStory: {context}\n\nQuestion: {input}\n\nAnswer:"
    ),
    "qasper": (
        "Answer the question based on the paper.\n\n{context}\n\n"
        "Question: {input}\n\nAnswer:"
    ),
    "multifieldqa_en": (
        "Read the following text and answer briefly.\n\n{context}\n\n"
        "Question: {input}\nAnswer:"
    ),
    "hotpotqa": (
        "Answer the question based on the given passages.\n\n{context}\n\n"
        "Question: {input}\nAnswer:"
    ),
    "2wikimqa": (
        "Answer the question based on the given passages.\n\n{context}\n\n"
        "Question: {input}\nAnswer:"
    ),
    "musique": (
        "Answer the question based on the given passages.\n\n{context}\n\n"
        "Question: {input}\nAnswer:"
    ),
    "gov_report": (
        "Write a one-page summary of the report.\n\n{context}\n\n"
        "Summary:"
    ),
    "qmsum": (
        "Answer the query based on the meeting transcript.\n\n{context}\n\n"
        "Query: {input}\nAnswer:"
    ),
    "multi_news": (
        "Write a one-page summary of the news articles.\n\n{context}\n\n"
        "Summary:"
    ),
    "trec": (
        "Classify the question. {context}\n{input}"
    ),
    "triviaqa": (
        "Answer the question based on the passage.\n\n{context}\n\n"
        "Question: {input}\nAnswer:"
    ),
    "samsum": (
        "Summarize the dialogue.\n\n{context}\n\nSummary:"
    ),
    "passage_retrieval_en": (
        "Which paragraph does the abstract come from?\n\n{context}\n\n"
        "Abstract: {input}\n\nParagraph number:"
    ),
    "passage_count": (
        "Count the number of unique paragraphs.\n\n{context}\n\n"
        "Number of unique paragraphs:"
    ),
    "lcc": "{context}",
    "repobench-p": "{context}{input}",
}

MAX_GEN = {
    "narrativeqa": 128, "qasper": 128, "multifieldqa_en": 64,
    "hotpotqa": 32, "2wikimqa": 32, "musique": 32, "gov_report": 512,
    "qmsum": 512, "multi_news": 512, "trec": 64, "triviaqa": 32,
    "samsum": 128, "passage_retrieval_en": 32, "passage_count": 32,
    "lcc": 64, "repobench-p": 64,
}


def middle_truncate(tokenizer, prompt: str, max_len: int) -> str:
    """Keep head and tail, drop the middle (reference pred.py:66-72).
    skip_special_tokens drops the BOS text that decode() would otherwise
    re-inject (the engine's encode adds its own BOS again)."""
    ids = tokenizer.encode(prompt)
    if len(ids) <= max_len:
        return prompt
    half = max_len // 2
    return (tokenizer.decode(ids[:half], skip_special_tokens=True)
            + tokenizer.decode(ids[-half:], skip_special_tokens=True))


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    EngineArgs.add_cli_args(parser)
    parser.add_argument("--datasets", nargs="+",
                        default=list(DATASET_PROMPTS))
    parser.add_argument(
        "--max-prompt-len", type=int, default=None,
        help="truncation budget; defaults to the engine's max_model_len "
        "minus the generation budget (an over-budget prompt would be "
        "silently IGNORED by the scheduler, scoring 0)",
    )
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--out-dir", type=str, default="pred")
    parser.add_argument(
        "--data-dir", type=str, default=None,
        help="load {task}.jsonl from this directory instead of "
        "downloading THUDM/LongBench (offline runs)",
    )
    args = parser.parse_args(argv)

    if args.data_dir is None:
        try:
            from datasets import load_dataset
        except ImportError:
            raise SystemExit(
                "the `datasets` package is required for LongBench; "
                "install it, pass --data-dir with local jsonl files, or "
                "run the NIAH eval instead"
            )

    engine = LLMEngine.from_engine_args(EngineArgs.from_cli_args(args))
    tokenizer = engine.tokenizer
    os.makedirs(args.out_dir, exist_ok=True)
    max_gen_all = max(MAX_GEN.values())
    if args.max_prompt_len is None:
        args.max_prompt_len = (
            engine.model_config.max_model_len - max_gen_all - 8
        )

    for name in args.datasets:
        if args.data_dir is not None:
            with open(os.path.join(args.data_dir, f"{name}.jsonl")) as f:
                data = [json.loads(line) for line in f if line.strip()]
        else:
            data = load_dataset("THUDM/LongBench", name, split="test")
        out_path = os.path.join(args.out_dir, f"{name}.jsonl")
        with open(out_path, "w") as f:
            for i, sample in enumerate(data):
                if args.limit and i >= args.limit:
                    break
                prompt = DATASET_PROMPTS[name].format(**sample)
                prompt = middle_truncate(
                    tokenizer, prompt, args.max_prompt_len
                )
                engine.add_request(
                    f"{name}-{i}", prompt,
                    SamplingParams(temperature=0.0,
                                   max_tokens=MAX_GEN[name]),
                )
                pred = ""
                while engine.has_unfinished_requests():
                    for out in engine.step():
                        if out.finished:
                            pred = out.outputs[0].text
                f.write(json.dumps({
                    "pred": pred,
                    "answers": sample["answers"],
                    "all_classes": sample.get("all_classes"),
                    "length": sample.get("length"),
                }) + "\n")
        print(f"{name}: wrote {out_path}")


if __name__ == "__main__":
    main()
