"""Offline throughput benchmark of the port (QServe path, non-IFB static
batch), with the flags, environment variables and CSV row of the root
``qserve_benchmark.py``.

GLOBAL_BATCH_SIZE identical random-token requests of GLOBAL_PROMPT_LEN
tokens generate GLOBAL_GENERATE_LEN tokens in a static batch (scheduled
once); each round reports decode tokens/s, and the best round is appended
to the results CSV. Runs on ``cuda:0`` (``--device cpu`` runs the plain
versions):

    GLOBAL_BATCH_SIZE=128 python -m omniserve_tpu_torch.qserve_benchmark \\
        --model <path> --precision w4a8kv4 --load-format dummy \\
        --tokenizer-mode skip --chunk-prefill-size 8192 \\
        --decode-multi-step 32 --lm-head-precision w8a8

A Mixtral config directory (``MixtralForCausalLM``) serves the same way
with ``--lm-head-precision fp16``: the JAX package's Mixtral has no W8A8
lm_head, and the engine refuses that pairing at build.
"""

import argparse
import csv
import os
import time

from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.config import ProfilingConfig


def run_round(engine: LLMEngine, batch: int, prompt_len: int,
              gen_len: int) -> float:
    for i in range(batch):
        engine.add_request(
            f"bench-{i}",
            sampling_params=SamplingParams(
                temperature=0.0, max_tokens=gen_len, ignore_eos=True
            ),
            profiling_config=ProfilingConfig(prompt_len, gen_len),
        )
    # prefill step
    engine.step()
    t0 = time.time()
    for _ in range(gen_len - 1):
        engine.step()
    dt = time.time() - t0
    toks = batch * (gen_len - 1)
    # reset static-batch state for the next round
    engine._static_metadata = None
    engine._static_outputs = None
    for g in list(engine.scheduler.running):
        for seq in g.get_seqs():
            engine.scheduler.free_seq(seq)
            engine.worker.free_seq(seq.seq_id)
    engine.scheduler.running.clear()
    return toks / dt


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    EngineArgs.add_cli_args(parser)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--output", type=str, default="results.csv")
    args = parser.parse_args()
    args.ifb_mode = False
    args.benchmarking_mode = True

    batch = int(os.environ.get("GLOBAL_BATCH_SIZE", 64))
    prompt_len = int(os.environ.get("GLOBAL_PROMPT_LEN", 1024))
    gen_len = int(os.environ.get("GLOBAL_GENERATE_LEN", 512))
    if args.num_retrieval_blocks is None and \
            "NUM_RETRIEVAL_GPU_PAGE_BLOCKS" not in os.environ:
        blocks = (prompt_len + gen_len + args.block_size - 1) \
            // args.block_size + 1
        # +2: one reserved trash page (block manager) + one spare
        args.num_retrieval_blocks = blocks * batch + 2
    args.max_num_seqs = max(args.max_num_seqs, batch)
    args.max_num_batched_tokens = max(
        args.max_num_batched_tokens, batch * prompt_len
    )

    engine = LLMEngine.from_engine_args(EngineArgs.from_cli_args(args))
    results = []
    for r in range(args.rounds):
        toks = run_round(engine, batch, prompt_len, gen_len)
        print(f"round {r}: {toks:.1f} tok/s")
        results.append(toks)

    best = max(results)
    print(f"best throughput: {best:.1f} tok/s (batch {batch}, "
          f"{prompt_len} in / {gen_len} out)")
    new_file = not os.path.exists(args.output)
    with open(args.output, "a", newline="") as f:
        w = csv.writer(f)
        if new_file:
            w.writerow(["model", "precision", "batch", "prompt_len",
                        "gen_len", "tok_per_s"])
        precision = args.precision
        if getattr(args, "group_size", -1) and args.group_size > 0:
            precision += f"-g{args.group_size}"
        if getattr(args, "kv_quant_granularity", "") == "per_tensor":
            precision += "-pt"
        w.writerow([args.model, precision, batch, prompt_len, gen_len,
                    round(best, 1)])


if __name__ == "__main__":
    main()
