"""Long-context benchmark of the port with split prefill/decode timing
(LServe path), with the protocol, flags, environment variables and CSV row
of the root ``lserve_benchmark.py``: GLOBAL_BATCH_SIZE requests (default 1)
of GLOBAL_PROMPT_LEN prompt tokens generate GLOBAL_GENERATE_LEN tokens;
the context stage (the prefill step) and the decode stage are timed
apart, a warmup round first. Runs on ``cuda:0`` (``--device cpu`` runs the
plain versions):

    GLOBAL_PROMPT_LEN=32768 GLOBAL_GENERATE_LEN=128 \\
    python -m omniserve_tpu_torch.lserve_benchmark --model <path> \\
        --precision w8a8kv8 --kv-quant-granularity per_tensor \\
        --load-format dummy --tokenizer-mode skip \\
        --sparse-context-mode --sparse-decode-mode --static-sparsity 0.5 \\
        --block-size 128

(the reference's LServe flags and precision: streaming heads keep a ctx
sink + local band at prefill, a prompt above ``--chunk-prefill-size``
prefills in chunks over the streaming ring, and decode is dynamic-sparse;
kv4 and kv8 pools, fine-grained or per-tensor, and kv16 pools, the
default ``--precision w16a16kv16``, serve under them). A Mixtral config
directory serves the same way, with the bf16 lm_head (the default
``--lm-head-precision fp16``).
"""

import argparse
import csv
import os
import time

import torch

from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.config import ProfilingConfig


def _sync(engine: LLMEngine) -> None:
    device = engine.worker.model_runner.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def process_requests_split_stage(engine: LLMEngine, batch: int,
                                 prompt_len: int, gen_len: int):
    """One round: (prefill seconds, decode seconds, decode steps)."""
    for i in range(batch):
        engine.add_request(
            f"lbench-{i}",
            sampling_params=SamplingParams(
                temperature=0.0, max_tokens=gen_len, ignore_eos=True
            ),
            profiling_config=ProfilingConfig(prompt_len, gen_len),
        )
    _sync(engine)
    t0 = time.time()
    engine.step()  # prefill
    _sync(engine)
    t_prefill = time.time() - t0
    t0 = time.time()
    steps = 0
    while engine.has_unfinished_requests():
        engine.step()
        steps += 1
    _sync(engine)
    t_decode = time.time() - t0
    return t_prefill, t_decode, steps


def size_pool(args, batch: int, prompt_len: int, gen_len: int) -> None:
    """Batch limits and a retrieval pool that hold the round, unless the
    caller sized them."""
    args.max_num_seqs = max(args.max_num_seqs, batch)
    args.max_num_batched_tokens = max(
        args.max_num_batched_tokens, batch * prompt_len
    )
    if args.num_retrieval_blocks is None and \
            "NUM_RETRIEVAL_GPU_PAGE_BLOCKS" not in os.environ:
        blocks = (prompt_len + gen_len + args.block_size - 1) \
            // args.block_size + 1
        need = blocks * batch
        # headroom must exceed the allocator's watermark (1% of the pool)
        # or long prompts are refused as never-allocatable
        args.num_retrieval_blocks = need + max(4, need // 50)


def check_round(engine: LLMEngine, batch: int, prompt_len: int, gen_len: int,
                t_prefill: float, t_decode: float, steps: int):
    """Reject physically impossible rows instead of logging them; returns
    (prefill tok/s, decode tok/s)."""
    min_decode_steps = gen_len - 1 if engine.ifb_config.ifb_mode else 1
    if steps < min_decode_steps:
        raise RuntimeError(
            f"bogus measurement: only {steps} decode steps ran for "
            f"gen_len={gen_len}: requests were ignored or finished early"
        )
    if t_prefill < batch * prompt_len * 1e-7:  # >10 Gtok/s is not real
        raise RuntimeError(
            f"bogus measurement: prefill of {batch * prompt_len} tokens "
            f"in {t_prefill * 1e3:.2f} ms exceeds any physical bound"
        )
    prefill_tps = batch * prompt_len / t_prefill
    decode_tps = batch * max(gen_len - 1, 1) / t_decode
    if decode_tps > 1e6 * batch:
        raise RuntimeError(
            f"bogus measurement: decode at {decode_tps:.0f} tok/s"
        )
    return prefill_tps, decode_tps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    EngineArgs.add_cli_args(parser)
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args()

    batch = int(os.environ.get("GLOBAL_BATCH_SIZE", 1))
    prompt_len = int(os.environ.get("GLOBAL_PROMPT_LEN", 4096))
    gen_len = int(os.environ.get("GLOBAL_GENERATE_LEN", 128))
    size_pool(args, batch, prompt_len, gen_len)

    engine = LLMEngine.from_engine_args(EngineArgs.from_cli_args(args))
    # warmup round (kernel builds, first launches, graph captures)
    process_requests_split_stage(engine, batch, prompt_len, gen_len)
    t_prefill, t_decode, steps = process_requests_split_stage(
        engine, batch, prompt_len, gen_len
    )
    prefill_tps, decode_tps = check_round(
        engine, batch, prompt_len, gen_len, t_prefill, t_decode, steps)
    device = engine.worker.model_runner.device
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu").replace(" ", "_")
    print(
        f"prefill {prompt_len} tok: {t_prefill:.2f}s ({prefill_tps:.0f} "
        f"tok/s); decode: {decode_tps:.1f} tok/s"
    )
    out = args.output or f"lserve_results_{name}.csv"
    new_file = not os.path.exists(out)
    with open(out, "a", newline="") as f:
        w = csv.writer(f)
        if new_file:
            w.writerow([
                "model", "precision", "sparsity", "batch", "prompt_len",
                "gen_len", "prefill_s", "prefill_tok_s", "decode_tok_s",
            ])
        w.writerow([
            args.model, args.precision, args.static_sparsity, batch,
            prompt_len, gen_len, round(t_prefill, 3),
            round(prefill_tps, 1), round(decode_tps, 1),
        ])


if __name__ == "__main__":
    main()
