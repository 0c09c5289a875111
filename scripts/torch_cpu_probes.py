#!/usr/bin/env python3
"""Two CPU probes behind PERF.md §7 and ROADMAP.md queue 3's F5, run on
the CPU like the tests (the JAX package is the reference the port is held
to; the port itself never imports it):

    JAX_PLATFORMS=cpu python3 scripts/torch_cpu_probes.py chunk-gap
    JAX_PLATFORMS=cpu python3 scripts/torch_cpu_probes.py nudge

``chunk-gap``: both engines serve ``tests/test_torch_head_dim64_engine``'s
LServe requests (both flags, w4a8kv4, 48-token chunks) at hidden 512 and
each head dim of ``--head-dims``; for each forward it prints the port's
logits' largest difference to the JAX engine's (a decode step's active
rows only), as a share of max |logit|, whether the argmaxes agree and the
port's smallest top-2 margin. ``tests/test_torch_lserve_chunks.py``
replays the same chunks from the JAX engine's pools: where the two part,
an int8 activation code flipped (ROADMAP.md F5).

``nudge``: ``chip_smoke.check_sparse_forward`` at Llama-3.2-1B's widths on
the CPU, with the "kernels" run replaced by the plain run whose decode
attention outputs move by one bf16 ulp in a ``--rate`` share of their
elements: how far one-ulp attention differences move this 2-layer random
model's decode logits (~5 min).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def chunk_gap(head_dims, hidden):
    import jax
    import numpy as np
    from _pytest.monkeypatch import MonkeyPatch

    from omniserve_tpu import EngineArgs as JEngineArgs
    from omniserve_tpu import LLMEngine as JLLMEngine
    from omniserve_tpu import SamplingParams as JSamplingParams
    from omniserve_tpu.models import llama as j_llama
    from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
    from omniserve_tpu_torch.models import llama as t_llama
    from omniserve_tpu_torch.models.convert import params_from_numpy
    from tests.test_torch_lserve_prefill import engine_kwargs, requests
    from tests.test_torch_precision_engine import serve

    for d in head_dims:
        model = tempfile.mkdtemp()
        with open(os.path.join(model, "config.json"), "w") as f:
            json.dump(dict(
                architectures=["LlamaForCausalLM"], model_type="llama",
                hidden_size=hidden, head_dim=d, intermediate_size=256,
                num_attention_heads=8, num_key_value_heads=2,
                num_hidden_layers=2, vocab_size=256,
                max_position_embeddings=131072, rms_norm_eps=1e-5,
                rope_theta=500000.0, rope_scaling=dict(
                    rope_type="llama3", factor=32.0, low_freq_factor=1.0,
                    high_freq_factor=4.0,
                    original_max_position_embeddings=8192)), f)
        kw = engine_kwargs(model, chunk_prefill_size=96)
        reqs = requests(5, (200, 120), 6)
        seen = {"jax": [], "torch": []}
        mp = MonkeyPatch()
        for mod, key in ((j_llama, "jax"), (t_llama, "torch")):
            def rec(*a, _real=mod.llama_forward, _out=seen[key], **k):
                out = _real(*a, **k)
                logits = np.asarray(out[0], np.float32)
                active = getattr(a[3], "active", None)   # decode steps
                _out.append(logits if active is None
                            else logits[np.asarray(active)])
                return out
            mp.setattr(mod, "llama_forward", rec)
        jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        with jax.disable_jit():
            serve(jeng, JSamplingParams, reqs)
        teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
        teng.worker.model_runner.load_params(
            params_from_numpy(jparams, "cpu"))
        serve(teng, SamplingParams, reqs)
        mp.undo()
        print(f"head_dim {d}, hidden {hidden}:")
        for i, (a, b) in enumerate(zip(seen["jax"], seen["torch"])):
            if a.shape != b.shape:
                break
            top = np.sort(b, -1)
            margin = float(((top[..., -1] - top[..., -2])
                            / np.abs(b).max()).min())
            print(f"  forward {i}: logits {a.shape}, largest difference "
                  f"{np.abs(a - b).max() / np.abs(a).max():.3g} of max "
                  f"|logit|, argmax equal {bool((a.argmax(-1) == b.argmax(-1)).all())}, "
                  f"smallest top-2 margin {margin:.3g}")


def nudge(rate, precision):
    import torch

    import chip_smoke as cs
    from omniserve_tpu_torch.ops import cuda

    real_ctx = cs._mode_ctx

    def ctx(mode, nudged=None):
        stack = real_ctx(mode, nudged)
        if mode == "kernels":     # the plain run, its decode outputs nudged
            stack.enter_context(cuda.plain_versions())
            stack.enter_context(cs.nudged_attention(
                rate=rate, seed=3, names=("paged_decode_attention",)))
        return stack

    cs._mode_ctx = ctx
    cs.lserve_decode_names = lambda suffix, head_dim=128: ()
    try:
        cs.check_sparse_forward(torch.device("cpu"), precision,
                                geometry=cs.LLAMA32_1B)
    except AssertionError as e:
        print(f"gate: {e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("probe", choices=("chunk-gap", "nudge"))
    ap.add_argument("--head-dims", default="64,16,32")
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--rate", type=float, default=0.3)
    ap.add_argument("--precision", default="w4a8kv8")
    args = ap.parse_args()
    if args.probe == "chunk-gap":
        chunk_gap([int(x) for x in args.head_dims.split(",")], args.hidden)
    else:
        nudge(args.rate, args.precision)


if __name__ == "__main__":
    main()
