"""Teacher-forced perplexity (WikiText-2 protocol, reference README:283-301).

Evaluates any HF or packed checkpoint through the port's model-level
forward: non-overlapping seqlen-2048 windows, next-token NLL averaged over
all predicted positions — the protocol behind the reference's QoQ table
(fp16 6.14 vs W4A8KV4 6.89 for Llama-3-8B).

    python -m omniserve_tpu_torch.eval.ppl --model <ckpt> \
        --precision w4a8kv4 --text wikitext2.raw [--seqlen 2048] \
        [--max-windows N] [--device cpu]

``--text`` takes a raw text file (e.g. WikiText-2's wiki.test.raw), read
through the checkpoint's tokenizer, or a ``.npy`` file of token ids (no
tokenizer needed). ``--compare-hf`` also runs the ``transformers``
implementation on the same windows (tractable for small models) and
prints the delta. Runs on ``cuda:0`` unless ``--device cpu`` is given.

Each window is one whole-window prefill through ``llama_forward`` with
``return_hidden``; the lm_head is applied in vocab chunks of 16,384
columns with an online log-sum-exp, so the [T, V] logits are never held.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omniserve_tpu_torch.config import ModelConfig
from omniserve_tpu_torch.engine.arg_utils import resolve_device
from omniserve_tpu_torch.models.llama import (
    LlamaSpec,
    PrefillBatch,
    llama_forward,
)
from omniserve_tpu_torch.models.weight_loader import load_llama_params
from omniserve_tpu_torch.ops.paged_kv import KVPool, make_kv_pool

CHUNK = 16384


def token_windows(path: str, tokenizer, seqlen: int,
                  max_windows: int) -> List[List[int]]:
    """``seqlen + 1``-token windows (inputs and their next tokens)."""
    if path.endswith(".npy"):
        ids = np.load(path).astype(np.int64).tolist()  # pre-tokenized
    else:
        with open(path, "r", errors="ignore") as f:
            text = f.read()
        ids = tokenizer.encode(text)
    n = (len(ids) - 1) // seqlen
    if max_windows:
        n = min(n, max_windows)
    if n == 0:
        raise SystemExit(
            f"text too short: {len(ids)} tokens < seqlen+1 ({seqlen + 1})"
        )
    return [ids[i * seqlen: (i + 1) * seqlen + 1] for i in range(n)]


def window_hidden(params, pool: KVPool, spec: LlamaSpec,
                  tokens: torch.Tensor, page_size: int
                  ) -> Tuple[torch.Tensor, KVPool]:
    """One whole-window prefill; returns the final-norm hidden states of
    every token ([T, D]) and the pool (pages 0 .. T / page_size - 1)."""
    t = tokens.shape[0]
    dev = tokens.device
    n_blocks = t // page_size
    pages = torch.arange(n_blocks, dtype=torch.int32, device=dev)
    batch = PrefillBatch(
        token_ids=tokens,
        positions=torch.arange(t, dtype=torch.int32, device=dev),
        segment_ids=torch.zeros(t, dtype=torch.int32, device=dev),
        block_tables=pages[None, :],
        last_token_idx=torch.tensor([t - 1], device=dev),
        seq_lens=torch.tensor([t], dtype=torch.int32, device=dev),
        streaming_block_tables=torch.zeros((1, 1), dtype=torch.int32,
                                           device=dev),
        new_page_ids=pages,
    )
    h, pool, _, _ = llama_forward(params, pool, None, batch, spec=spec,
                                  is_prefill=True, return_hidden=True)
    return h, pool


def chunked_nll(h: torch.Tensor, lm_head: torch.Tensor,
                targets: torch.Tensor, vocab: int,
                chunk: int = CHUNK) -> torch.Tensor:
    """Per-token NLL [T] f32 of ``targets`` under ``h @ lm_head``, one
    ``min(chunk, Vpad)`` vocab columns at a time (online log-sum-exp).
    ``lm_head`` [D, Vpad] is padded to a multiple of that; columns at or past
    ``vocab`` are masked. The logits are the bf16 operands' exact products
    summed in f32."""
    chunk = min(chunk, lm_head.shape[1])
    hf = h.to(torch.bfloat16).float()
    t = hf.shape[0]
    m = torch.full((t,), float("-inf"), device=h.device)
    s = torch.zeros(t, device=h.device)
    tgt = torch.zeros(t, device=h.device)
    for i in range(lm_head.shape[1] // chunk):
        lg = hf @ lm_head[:, i * chunk:(i + 1) * chunk].float()
        col = torch.arange(i * chunk, (i + 1) * chunk, device=h.device)
        valid_col = col < vocab
        lg = torch.where(valid_col, lg, float("-inf"))
        m_new = torch.maximum(m, lg.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.where(
            torch.isneginf(m_new), 0.0,
            torch.exp(lg - m_new[:, None]).sum(dim=1))
        hit = (col[None, :] == targets[:, None].long()) & valid_col
        tgt = tgt + torch.where(hit, lg, 0.0).sum(dim=1)
        m = m_new
    return m + torch.log(s) - tgt


def pad_lm_head(lm_head: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """[D, V] -> [D, Vpad] with zero columns up to a multiple of the
    vocab chunk (``min(chunk, V)``)."""
    v = lm_head.shape[1]
    chunk = min(chunk, v)
    if v % chunk:
        lm_head = torch.nn.functional.pad(lm_head, (0, chunk - v % chunk))
    return lm_head


def load_model(args, device: str) -> Tuple[Dict, LlamaSpec, KVPool]:
    """Params (lm_head padded to the vocab chunk), spec and a pool that
    holds one window."""
    mc = ModelConfig(
        model=args.model, precision=args.precision,
        kv_quant_granularity=args.kv_quant_granularity,
        group_size=args.group_size,
    )
    spec = LlamaSpec.from_model_config(mc, page_size=args.page_size)
    spec.check_supported(device)
    params, kv_scales = load_llama_params(mc, spec, device=device)
    params["lm_head"] = pad_lm_head(params["lm_head"])
    pool = make_kv_pool(
        spec.num_layers, args.seqlen // args.page_size + 1,
        spec.num_kv_heads, args.page_size, spec.head_dim,
        kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros, device=device,
    )
    if kv_scales is not None and pool.k_scale_per_tensor is not None:
        pool.k_scale_per_tensor.copy_(kv_scales[0])
        pool.v_scale_per_tensor.copy_(kv_scales[1])
    return params, spec, pool


def evaluate(params, spec: LlamaSpec, pool: KVPool,
             windows: Sequence[Sequence[int]], page_size: int, device,
             verbose: bool = True) -> Dict:
    """Returns {"ppl", "nll", "tokens", "window_seconds"} over
    ``windows``."""
    total_nll, total_tok = 0.0, 0
    seconds = []
    for i, w in enumerate(windows):
        t0 = time.perf_counter()
        tokens = torch.tensor(w[:-1], dtype=torch.int64, device=device)
        targets = torch.tensor(w[1:], dtype=torch.int64, device=device)
        h, pool = window_hidden(params, pool, spec, tokens, page_size)
        nll = float(chunked_nll(h, params["lm_head"], targets,
                                spec.vocab).sum())
        seconds.append(time.perf_counter() - t0)
        total_nll += nll
        total_tok += len(w) - 1
        if verbose:
            print(f"window {i + 1}/{len(windows)}: "
                  f"ppl so far {np.exp(total_nll / total_tok):.4f}",
                  flush=True)
    return {"ppl": float(np.exp(total_nll / total_tok)), "nll": total_nll,
            "tokens": total_tok, "window_seconds": seconds}


def hf_ppl(model_path: str, windows: Sequence[Sequence[int]]) -> float:
    """Perplexity of the ``transformers`` fp32 model on the same
    windows."""
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(model_path)
    model.eval()
    nll_t, tok_t = 0.0, 0
    with torch.no_grad():
        for w in windows:
            ids = torch.tensor([w[:-1]])
            tg = torch.tensor(w[1:])
            logits = model(ids).logits[0].float()
            lsm = torch.log_softmax(logits, dim=-1)
            nll_t += float(-lsm[torch.arange(len(tg)), tg].sum())
            tok_t += len(tg)
    return float(np.exp(nll_t / tok_t))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True)
    parser.add_argument("--precision", default="w4a8kv4")
    parser.add_argument("--kv-quant-granularity", default="fine_grained")
    parser.add_argument("--group-size", type=int, default=-1)
    parser.add_argument("--text", required=True)
    parser.add_argument("--seqlen", type=int, default=2048)
    parser.add_argument("--max-windows", type=int, default=0)
    parser.add_argument("--page-size", type=int, default=128)
    parser.add_argument("--compare-hf", action="store_true")
    parser.add_argument("--device", default="auto",
                        help="auto / cuda[:N] (the default: cuda:0) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    tokenizer = None
    if not args.text.endswith(".npy"):
        from omniserve_tpu_torch.utils.tokenizer import get_tokenizer

        tokenizer = get_tokenizer(args.model)
    windows = token_windows(args.text, tokenizer, args.seqlen,
                            args.max_windows)
    params, spec, pool = load_model(args, device)
    with torch.no_grad():
        res = evaluate(params, spec, pool, windows, args.page_size, device)
    print(f"FINAL ppl ({args.precision}, seqlen {args.seqlen}, "
          f"{res['tokens']} tokens): {res['ppl']:.4f}")
    if args.compare_hf:
        hppl = hf_ppl(args.model, windows)
        res["hf_ppl"] = hppl
        print(f"HF torch fp32 ppl: {hppl:.4f} "
              f"(delta {res['ppl'] - hppl:+.4f})")
    return res


if __name__ == "__main__":
    main()
