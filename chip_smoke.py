#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``omniserve_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero before the last line):

1. header: the card's name and power limit (``nvidia-smi``), then the
   kernels built from ``omniserve_tpu_torch/csrc/*.cu`` (one ``nvcc`` per
   source, all at once) and the build time;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with its time, the plain version's time, the bound
   (bytes over 3.35 TB/s or operations over the tensor-core peak) and one
   PyTorch library call's time where one computes the same function (the
   prefill attention kernels also with their achieved TFLOP/s, share of
   the operations bound, and ptxas's registers and spills); the
   band mode of flash prefill at 16K tokens and the ring mode of paged
   prefill at phase 7's first chunk and on a wrapped ring; the three int8
   GEMMs on their wgmma body (per channel, g128 and W8A8 at a layer's
   four shapes and W8A8 at the lm_head, each with its plan, decode M by
   graph replay on weight copies rotated past L2, a flipped weight byte
   and a wrong s2 refused) and the mma.sync body at N % 16 != 0; the
   kv16 and per-tensor modes (the kv16 decode and append, the per-tensor
   fused decode, kv16 and per-tensor paged prefill); rows 4-9 at GQA
   groups of 7 (Yi-34B's 56 q heads over 8 kv heads), each beside the same
   kernel at n_rep 8 on the same KV, the decode rows refusing a dead row's
   output planted over the next group's first row; rows 4 (append) and 9
   at Qwen1.5-72B's 64 / 64 heads (n_rep 1) and phase 12's shapes; rows 1
   and 3 at phase 12's GEMM shapes, with their plans; LServe over kv16
   pools: row 6's per-head lists and band, row 7's kv16 ring and row 10's
   two-pool kv16 append with K stats, at phase 6 / 7's shapes; head_dim
   64 at phase 14's shapes: row 6's kv4 / kv8 / per-tensor / kv16 modes
   (dense list, per-head lists, band; also kv4 at head_dim 128 over
   64-token pages), rows 7, 9 and 10, and rows 1 and 3 at Llama-3.2-1B's
   GEMM shapes (the list a page short, the band moved by a page, the
   nibble halves swapped and a token a slot late refused);
3. a full-width, depth-cut Llama-3-8B forward (2 layers): whole-prompt
   prefill and one decode step, a chunked prefill of the same prompts, and
   an 8-step decode window replayed from a captured CUDA graph against the
   eager loop, each with kernels against the plain versions; then the same
   under LServe's sparse decode (dual pools, page selector): prefill and
   two decode steps kernels against plain, and a 10-step window (refresh
   and reuse graphs) against the eager loop; then under both sparse modes,
   whole-prompt (flash band) and chunked (ring) prefill, kernels against
   plain; the same forwards across the precision matrix (kv16 and
   per-tensor KV with calibrated scales included), the sparse forwards
   (and a 10-step window) at w16a16kv16 too, and the whole-prompt,
   decode and chunked forwards at phase 12's models' widths (Yi-34B at
   n_rep 7; Qwen1.5-72B with its QKV bias, whose effect must show); and
   at Llama-3.2-1B's (head_dim 64): the dense forwards at w4a8kv4 and the
   sparse decode side at w8a8kv8 per-tensor and w16a16kv16, each decode
   call held in place against its plain version;
4. the engine at full Llama-3-8B W4A8KV4 width (32 layers, random weights
   from a seed): 8 requests of 1024 prompt tokens, 32 greedy tokens each,
   through ``LLMEngine.add_request`` / ``step()``, with every kernel's
   launch count read from that run alone;
5. ``bench.py``'s protocol through the port's engine and
   ``omniserve_tpu_torch.qserve_benchmark.run_round``: static batch 128,
   1024 prompt tokens, 512 greedy tokens, chunked prefill of 8192 tokens,
   32-step decode windows, two rounds (the first is warmup), then a
   traced chunked prefill and decode window;
6. ``lserve_benchmark.py``'s protocol through the port's engine and
   ``omniserve_tpu_torch.lserve_benchmark``: batch 1, a 32,768-token
   prompt, 128 greedy tokens, ``--sparse-decode-mode --static-sparsity
   0.5`` at Llama-3.1-8B's published config (128K context, llama3 rope
   scaling), a warmup and a measured round in 16-step decode windows,
   then a measured round in single decode steps;
7. the same protocol with ``--sparse-context-mode --sparse-decode-mode
   --static-sparsity 0.5`` (LServe's prefill side) in 16-step windows: a
   32,768-token prompt (two chunks over the ring) and a 16,384-token
   prompt (whole-prompt band), a warmup and a measured round each, then
   one traced prefill step of each;
8. phase 5's protocol at ``--precision w4a8kv4 --group-size 128`` (a
   warmup and a measured round) and at ``w4a8kv8`` (one round);
9. phase 5's protocol at ``--precision w16a16kv16`` (a warmup and a
   measured round, then a traced prefill step and window) and at
   ``w8a8kv8 --kv-quant-granularity per_tensor`` (one round);
10. the JAX dispatch's two switches on (``OMNISERVE_PREFILL_SINGLE_PASS=1``,
    ``OMNISERVE_EMBED_DMA=1``, restored after): (a) the single-pass
    prefill kernel (row 8) against its plain version and timed beside row
    7 on the same inputs, at the bench's last chunk (fine-grained kv4, kv8
    and per-tensor kv8), the last 8,192 tokens of a 32K context (dense and
    with the band), phase 7's ring chunk and a wrapped ring; the row
    gather (row 11) at B=8 and 128 over the 128,256 x 4,096 table; (b)
    phase 5's protocol, then the 2-layer chunked forwards at w4a8kv8 and
    w8a8kv8 per-tensor; (c) phase 7 (a)'s LServe command; each beside
    the switch-off figures of the same run;
11. phase 7 (a)'s protocol at the reference's own LServe precision,
    ``--precision w8a8kv8 --kv-quant-granularity per_tensor`` (both flags,
    32,768 in / 128 out, a warmup and a measured round, a traced prefill
    step and decode window), then at ``w4a8kv8`` (32,768 in / 32 out, a
    warmup and a measured round): the kv8 and per-tensor modes of rows 4 (band/ring), 5, 7
    (ring) and 10, which phase 2 holds against their plain versions and
    phase 3 runs in 2-layer sparse forwards at both precisions;
12. phase 5's protocol (a warmup round cut to 32 output tokens, then the
    measured round) on Yi-34B at batch 64 (GQA groups of 7: row 7 and row
    4's append at n_rep 7) and Qwen1.5-72B at batch 4 (64 / 64 heads and
    the QKV bias; its whole-prompt batch through row 9), full width and
    depth, each with its prefill step, decode tok/s, graphs and peak
    memory;
13. phase 7 (a)'s protocol at ``--precision w16a16kv16``, the default of
    both packages (both LServe flags, 32,768 in / 128 out, a warmup and a
    measured round, untraced): row 6's per-head and band modes, row 7's
    kv16 ring and row 10's two-pool kv16 append, which phase 2 holds
    against their plain versions and phase 3 runs in 2-layer sparse
    forwards at w16a16kv16;
14. Llama-3.2-1B (head_dim 64) at full width and depth: (a) phase 5's
    protocol at w4a8kv4 (a warmup and a measured round) and phase 4's IFB
    engine (row 9), (b) phase 7's protocol at w8a8kv8 per-tensor (both
    flags): every decode through row 10's append and row 6, no call
    reaching rows 4 / 5 or a plain version;
15. Llama-3.2-1B served from files (no kernel of its own): (a) a seeded
    draw written as an HF checkpoint (bf16 safetensors in two shards, tied
    embeddings) and served through ``load_format="auto"`` at w4a8kv4, full
    width and depth, its packed layers 0 and 15 and lm_head equal to the
    CPU quantization of the draw byte for byte and its greedy tokens those
    of the same weights quantized in memory; (b) the draw's first
    ``PACKED_LAYERS`` layers through the port's fake-quant dump (g128,
    per-tensor KV) and converter, served at w4a8kv8 per-tensor with the
    file's KV scales; load seconds, peak host RSS and device memory;
16. Mixtral-8x7B (8 experts, top-2; ``models/mixtral.py``) at full width,
    random weights from a seed, the bf16 lm_head: (a) phase 5's protocol
    at w4a8kv4, full depth (a warmup round cut to 32 output tokens, the
    measured round, a traced decode window and a traced prefill of two
    8,192-token chunks, split into expert GEMMs, attention GEMMs,
    attention kernels and the MoE torch ops), with the weights' GiB, peak memory, the expert GEMMs' launches
    and the decode step's bytes bound; (b) 2-layer forwards at w4a8kv4,
    g128 and w8a8kv8 per-tensor, kernels against plain (logits gated on
    rows that routed alike; under 1% of layer 0's routing choices may
    differ) and an 8-step window replayed against the eager loop; (c)
    phase 7 (a)'s LServe command at w4a8kv4, 32,736 in / 32 out (the
    model's whole context), full depth.
    Phase 2 holds rows 1-3 at its expert GEMMs (M = 64, 4,096, 8,192;
    stack indices 0 and 255 of a 256-matrix stack);
then a ``{"kernels": [...]}`` line, the card line, and
``{"ok": true, "device": ...}`` as the last line.

Exits 2 without CUDA or without the repository's package beside this
file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
BAND_ROW_RTOL = 1e-2             # flash band: per-row error over row norm
# kv16 and per-tensor attention modes against their plain versions: the
# per-element gate (kv16 ~10x the error these checks read on the card) and
# the per-row one, which a length off by one on these inputs fails by ~10x
KV16_TOL = 5e-3
ATTN_ROW_RTOL = 1e-2
# row 7's kv16 ring: the first rows of a chunk that starts the prompt
# attend a few keys, so their outputs reach |x| ~ 4, where one bf16 ulp
# (2^-7 |x|) passes 5e-3 + 5e-3 |x|; its element gate is KV16_TOL plus
# one ulp of the value
BF16_ULP_RTOL = 2.0 ** -7

# Llama-3-8B geometry (public model card), as scripts/make_bench_config.py
LLAMA3_8B = dict(
    architectures=["LlamaForCausalLM"], hidden_size=4096,
    intermediate_size=14336, num_attention_heads=32,
    num_key_value_heads=8, num_hidden_layers=32, vocab_size=128256,
    rope_theta=500000.0, max_position_embeddings=8192,
    rms_norm_eps=1e-5, model_type="llama",
)
# Llama-3.1-8B (public config.json): the same widths, a 128K context
LLAMA31_8B = dict(
    LLAMA3_8B, max_position_embeddings=131072,
    rope_scaling=dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192,
                      rope_type="llama3"),
)
LAYER_GEMMS = [  # (name, K, N) of one layer's W4A8 projections
    ("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 28672),
    ("down", 14336, 4096),
]
# Yi-34B (public config.json; mit-han-lab/QServe-benchmarks' stub, as
# scripts/make_bench_config.py:56-62): 56 q heads over 8 kv heads, GQA
# groups of 7
YI_34B = dict(
    architectures=["LlamaForCausalLM"], hidden_size=7168,
    intermediate_size=20480, num_attention_heads=56,
    num_key_value_heads=8, num_hidden_layers=60, vocab_size=64000,
    rope_theta=5000000.0, max_position_embeddings=4096,
    rms_norm_eps=1e-5, model_type="llama",
)
# Qwen1.5-72B (public config.json; the same stubs, scripts/
# make_bench_config.py:91-97): 64 / 64 heads and Qwen2's QKV bias
QWEN15_72B = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=8192,
    intermediate_size=24576, num_attention_heads=64,
    num_key_value_heads=64, num_hidden_layers=80, vocab_size=152064,
    rope_theta=1000000.0, max_position_embeddings=32768,
    rms_norm_eps=1e-6, model_type="qwen2",
)
# Llama-3.2-1B (public config.json): 16 layers, hidden 2048, 32 q heads
# over 8 kv heads of 64 (n_rep 4), vocab 128,256, rope theta 500,000 with
# llama3 scaling (factor 32, low 1, high 4, original 8,192), tied
# embeddings (no part with random weights); phase 14's model
LLAMA32_1B = dict(
    architectures=["LlamaForCausalLM"], hidden_size=2048,
    intermediate_size=8192, num_attention_heads=32, num_key_value_heads=8,
    num_hidden_layers=16, vocab_size=128256, rope_theta=500000.0,
    max_position_embeddings=131072, rms_norm_eps=1e-5, model_type="llama",
    tie_word_embeddings=True,
    rope_scaling=dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192,
                      rope_type="llama3"),
)
# phase 12's models: (config, batch, one layer's W4A8 projections (name,
# K, N), the lm_head's (K, N), the GEMMs' M at a decode step and a
# prefill step: Yi's chunks of 64 x 128 tokens, Qwen's whole prompts of
# 4 x 1,024)
FAMILIES = {
    "Yi-34B": (YI_34B, 64, [("qkv", 7168, 9216), ("o", 7168, 7168),
                            ("gate_up", 7168, 40960), ("down", 20480, 7168)],
               (7168, 64000), (64, 8192)),
    "Qwen1.5-72B": (QWEN15_72B, 4,
                    [("qkv", 8192, 24576), ("o", 8192, 8192),
                     ("gate_up", 8192, 49152), ("down", 24576, 8192)],
                    (8192, 152064), (4, 4096)),
}
# phase 14's head_dim-64 model, in FAMILIES' layout: the bench's batch
# 128, decode M 128 and prefill chunks of 8,192 tokens
D64_FAMILIES = {
    "Llama-3.2-1B": (LLAMA32_1B, 128, [("qkv", 2048, 3072), ("o", 2048, 2048),
                                       ("gate_up", 2048, 16384),
                                       ("down", 8192, 2048)],
                     (2048, 128256), (128, 8192)),
}


def head_dim_of(config) -> int:
    return config["hidden_size"] // config["num_attention_heads"]


def log(*args):
    print(*args, flush=True)


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


@contextlib.contextmanager
def card_samples(label: str, period_ms: int = 500):
    """Sample the card's SM clock, power draw and temperature every
    ``period_ms`` with ``nvidia-smi`` while the block runs; print their
    range and median after it (the sampler is stopped in every case)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", f"--loop-ms={period_ms}"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        yield
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    if not rows:
        log(f"  card during {label}: no nvidia-smi samples")
        return
    cols = list(zip(*rows))
    desc = []
    for name, unit, col in zip(("SM clock", "power draw", "temperature"),
                               ("MHz", "W", "C"), cols):
        c = sorted(col)
        desc.append(f"{name} {c[0]:g}-{c[-1]:g} {unit} (median "
                    f"{c[len(c) // 2]:g})")
    log(f"  card during {label}, {len(rows)} samples: " + ", ".join(desc))


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graphed_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured into one CUDA
    graph and replayed, so the host's per-call cost (tens of microseconds
    of wrapper checks and ctypes) does not hide a kernel of a few
    microseconds. ``fn`` must be safe to repeat and allocate nothing that
    outlives it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, replays, warmup=1) / reps


def bound_ms(n_bytes: float, ops: float, peak: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rate_note(ops: float, ms: float, bnd: float) -> str:
    """Achieved TFLOP/s of a kernel time and its share of the operations
    bound (the tensor cores' bf16 peak) and of bound_ms."""
    t_ops = ops / BF16_FLOPS_PER_S * 1e3
    return (f"achieved {ops / ms / 1e9:.1f} TFLOP/s = {100 * t_ops / ms:.1f}% "
            f"of the operations bound ({100 * bnd / ms:.1f}% of bound_ms)")


def ptxas_report(src: str):
    """``-Xptxas -v``'s registers and spills for each kernel function of
    ``src`` in this run's build, one line each (template arguments of the
    paged prefill kernel spelled out, the others' values listed)."""
    import re

    from omniserve_tpu_torch.csrc import build

    text = build.build_log.get(src)
    if not text:
        return [f"{src}: no ptxas report (built before this run)"]
    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
            # the last <length><identifier> of the mangled nested name
            rest, ident = re.sub(r"^_ZN?", "", name), name
            while True:
                t = re.match(r"(\d+)", rest)
                if not t:
                    break
                n, k = int(t.group(1)), len(t.group(1))
                ident, rest = rest[k:k + n], rest[k + n:]
            t = re.match(r"ILb(\d)ELi(\d+)ELb(\d)E", rest)
            args = re.match(r"I((?:L[a-z]+\d+E)+)", rest)
            name = (f"{ident}<SPARSE={t.group(1)}, KV_BITS={t.group(2)}, "
                    f"PT={t.group(3)}>" if t else
                    f"{ident}<" + ", ".join(re.findall(
                        r"L[a-z]+(\d+)E", args.group(1))) + ">" if args
                    else ident)
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def allclose_err(got, want, atol: float, rtol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol*|want|; returns max abs err."""
    import torch

    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements beyond atol {atol} rtol "
            f"{rtol} (max abs err {float(diff.max()):.3g})"
        )
    return float(diff.max())


def row_rel_err(got, want) -> float:
    """Largest ||got - want|| / ||want|| over the rows of the last dim."""
    import torch

    got, want = got.float(), want.float()
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)
    return float((num / den).max())


def hold(got, want, atol, rtol, row_rtol, what, planted=()):
    """``allclose_err``, then every row's error within ``row_rtol`` of its
    norm. Each of ``planted`` ((label, the plain version's output with a
    fault planted in its inputs)) must fail the same gate: proof that the
    gate sees such a fault on these inputs. Returns (max abs err, largest
    row error)."""
    import torch

    err = allclose_err(got, want, atol, rtol, what)
    row = row_rel_err(got, want)
    if row > row_rtol:
        raise AssertionError(f"{what}: a row's error is {row:.3g} of its "
                             f"norm (limit {row_rtol})")
    for label, bad in planted:
        diff = (bad.float() - want.float()).abs()
        n_out = int((diff > atol + rtol * want.float().abs()).sum())
        bad_row = row_rel_err(bad, want)
        if n_out == 0 and bad_row <= row_rtol:
            raise AssertionError(f"{what}: the gate passes the plain version "
                                 f"with {label}")
        log(f"    {what}: planted {label} refused ({n_out} elements beyond "
            f"atol {atol} rtol {rtol}; largest row error {bad_row:.3g}, "
            f"limit {row_rtol})")
    return err, row


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def gemm_layer_inputs(dev, gen, m):
    """Row 1's operands for one layer's four GEMMs at M rows: (name, K, N,
    a_i8, [packed weights], s1, s1_szero, a_scale, a_sum) each; decode M
    (<= 128) rotates copies of the weights past the 50 MB L2, as a layer
    finds them cold."""
    import torch

    from omniserve_tpu_torch.ops.quantization import quantize_activations

    out = []
    for name, k, n in LAYER_GEMMS:
        x = torch.randn((m, k), generator=gen, device=dev)
        a_i8, a_scale, a_sum = quantize_activations(x, fuse_sum=True)
        n_copies = max(1, math.ceil(120e6 / (k // 2 * n))) if m <= 128 else 1
        qws = [torch.randint(0, 256, (k // 2, n), generator=gen,
                             dtype=torch.uint8, device=dev)
               for _ in range(n_copies)]
        s1 = torch.empty(n, device=dev).uniform_(0.003, 0.006, generator=gen)
        out.append((name, k, n, a_i8, qws, s1, 8.0 * s1, a_scale, a_sum))
    return out


def time_gemm_ms(fn, qws, m):
    """Row 1's time on rotating weight copies: at decode M (<= 128) by
    graph replay (the host's per-call cost exceeds the kernel's there),
    else by CUDA events over eager calls."""
    it = iter(range(10 ** 9))

    def call():
        return fn(qws[next(it) % len(qws)])

    if m <= 128:
        return time_graphed_ms(call, 4 * len(qws))
    return time_ms(call, 10)


def int_mm_ms(a_i8, w_i8, epilogue, reps):
    """The library yardstick of an int8 GEMM: one ``torch._int_mm`` plus
    the epilogue ``epilogue(psum, m)``. ``_int_mm`` needs M > 16, so at
    M <= 16 the rows are zero-padded to 32 (labelled "padded" in the log
    and the table) and the epilogue reads the first M rows."""
    import torch

    m = a_i8.shape[0]
    a = a_i8 if m > 16 else torch.cat(
        [a_i8, a_i8.new_zeros((32 - m, a_i8.shape[1]))])
    return time_ms(lambda: epilogue(torch._int_mm(a, w_i8)[:m], m), reps)


def padded_note(m) -> str:
    return " (rows zero-padded to 32)" if m <= 16 else ""


def plan_note(plan) -> str:
    """A GEMM's plan (``quant_matmul.gemm_plan``) as one phrase."""
    if plan is None:
        return "the mma.sync body (N % 16 != 0)"
    return (f"plan M tile {plan.mt} x {128 * plan.n_wg} channels, "
            f"{plan.splits} split(s) of {plan.per_split} stages, "
            f"{plan.blocks} blocks")


def expect_body(mode, m, n, k, body, what):
    """Raise unless ``quant_matmul.gemm_plan`` sends this shape to the
    __global__ function ``body`` of csrc/quant_gemm.cu: the wgmma body
    (a plan) or, at N % 16 != 0, the mma.sync body (None). The launchers
    branch on the same N % 16; the card tests read the launched kernel's
    name from the profiler."""
    import torch

    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm

    plan = qm.gemm_plan(mode, m, n, k, cuda.sm_count(torch.device("cuda")))
    got = "quant_gemm_kernel" if plan is None else "int8_wgmma_kernel"
    if got != body:
        raise AssertionError(f"{what}: expected {body}, the plan gives {got}")


def flip_weight_byte(w):
    """A copy of an int8 / packed-u4 weight with one byte changed (bits 0
    and 4 of row 1, column 3: both nibbles of a packed byte)."""
    bad = w.clone()
    bad[1, 3] ^= 0x11
    return bad


def w8a8_layer_inputs(dev, gen, m):
    """Row 3's operands for the W8A8 body's four GEMMs at M rows: (name, K,
    N, a_i8, [int8 weights], w_scale, a_scale) each; decode M (<= 128)
    rotates weight copies past the 50 MB L2, as a layer finds them."""
    import torch

    from omniserve_tpu_torch.ops.quantization import quantize_activations

    out = []
    for name, k, n in LAYER_GEMMS:
        a_i8, a_scale, _ = quantize_activations(
            torch.randn((m, k), generator=gen, device=dev))
        n_copies = max(1, math.ceil(120e6 / (k * n))) if m <= 128 else 1
        ws = [torch.randint(-127, 128, (k, n), generator=gen,
                            dtype=torch.int8, device=dev)
              for _ in range(n_copies)]
        sc = torch.empty(n, device=dev).uniform_(0.0003, 0.0006,
                                                 generator=gen)
        out.append((name, k, n, a_i8, ws, sc, a_scale))
    return out


def group_layer_inputs(dev, gen, m, gs=128):
    """Row 2's operands for the g``gs`` body's four GEMMs at M rows: (name,
    K, N, a_i8, [packed weights], s1, s2, s2_zero, a_scale) each, s2 over
    the derived quantizer's whole range [1, 17] and zeros over the whole
    int8 range (the wrap included); decode M rotates weight copies."""
    import torch

    from omniserve_tpu_torch.ops.quantization import quantize_activations

    out = []
    for name, k, n in LAYER_GEMMS:
        a_i8, a_scale, _ = quantize_activations(
            torch.randn((m, k), generator=gen, device=dev))
        w_bytes = k // 2 * n + 2 * (k // gs) * n
        n_copies = max(1, math.ceil(120e6 / w_bytes)) if m <= 128 else 1
        qws = [torch.randint(0, 256, (k // 2, n), generator=gen,
                             dtype=torch.uint8, device=dev)
               for _ in range(n_copies)]
        s1 = torch.empty(n, device=dev).uniform_(0.003, 0.006, generator=gen)
        s2 = torch.randint(1, 18, (k // gs, n), generator=gen,
                           dtype=torch.int8, device=dev)
        s2z = torch.randint(-128, 128, (k // gs, n), generator=gen,
                            dtype=torch.int8, device=dev)
        out.append((name, k, n, a_i8, qws, s1, s2, s2z, a_scale))
    return out


def check_quant_gemms(dev, gen):
    """The per-channel body's four GEMM shapes at M = 8, 128, 8192, 16384,
    kernel against plain within 1e-5; logs each GEMM's tile plan, achieved
    rate and share of its bound; returns the rows and the largest error."""
    import torch

    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm

    rows = []
    worst = 0.0
    # decode at batch 8 and 128; a whole-prompt prefill of 8 x 1024 and
    # a [128, 128] chunk of the bench's chunked prefill
    for m in (8, 128, 8192, 16384):
        for name, k, n, a_i8, qws, s1, sz, a_scale, a_sum in \
                gemm_layer_inputs(dev, gen, m):
            w_bytes = k // 2 * n
            got = qm.w4a8_matmul_per_channel(a_i8, qws[0], s1, sz, a_scale,
                                             a_sum, out_dtype=torch.float32)
            want = qm.w4a8_matmul_per_channel_plain(
                a_i8, qws[0], s1, sz, a_scale, a_sum, out_dtype=torch.float32)
            err = allclose_err(got, want, 1e-5, 1e-5,
                               f"w4a8 M={m} K={k} N={n}")
            worst = max(worst, err)
            ms = time_gemm_ms(lambda w: qm.w4a8_matmul_per_channel(
                a_i8, w, s1, sz, a_scale, a_sum), qws, m)
            plain = time_ms(lambda: qm.w4a8_matmul_per_channel_plain(
                a_i8, qws[0], s1, sz, a_scale, a_sum), 3, warmup=1)
            w_i8 = torch.cat([(qws[0] & 0xF), (qws[0] >> 4)]).to(torch.int8)
            lib = int_mm_ms(
                a_i8, w_i8, lambda p, mm: (
                    p.float() * s1[None] * a_scale[:mm, None]
                    - sz[None] * a_sum[:mm, None]).to(torch.bfloat16),
                50 if m <= 128 else 10)
            n_bytes = m * k + w_bytes + 8 * n + 8 * m + 2 * m * n
            ops = 2.0 * m * n * k
            bnd, by = bound_ms(n_bytes, ops, INT8_OPS_PER_S)
            plan = qm.channel_plan(m, n, k, cuda.sm_count(dev))
            rate = (f"{n_bytes / ms / 1e6:.1f} GB/s" if by == "bytes" else
                    f"{ops / ms / 1e9:.1f} TOP/s")
            rows.append(dict(m=m, name=name, k=k, n=n, ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             max_abs_err=err))
            log(f"  w4a8 {name:7s} M={m:5d} K={k:5d} N={n:5d}: "
                f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms {bnd:.4f} "
                f"({by}) library_ms {lib:.4f}{padded_note(m)} "
                f"max_abs_err {err:.3g}; {plan_note(plan)}; {rate} = "
                f"{100 * bnd / ms:.1f}% of the bound")
            del qws, w_i8
    for m in (8, 128, 8192, 16384):
        r = layer_row(rows, m)
        log(f"  w4a8 layer of 4 GEMMs M={m}: kernel_ms {r['ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) = "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound")
    return rows, worst


def check_per_group_gemms(dev, gen, group_size=128):
    """The g128 body's four GEMM shapes at M = 8, 128 (decode), 8192 and
    16384 (prefill): kernel equal to its plain version (max error 0), with
    s2 drawn over the derived quantizer's whole range [1, 17] and zeros over
    the whole int8 range (the wrap included), a flipped weight byte and a
    wrong s2 refused at M = 8 and 8192; decode M timed by graph replay on
    rotating weight copies (the eager time logged beside); then once at the
    edge: every code 15, every s2 17."""
    import torch

    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    rows = []
    gs = group_size
    kw = dict(group_size=gs)
    for m in (8, 128, 8192, 16384):
        for name, k, n, a_i8, qws, s1, s2, s2z, a_scale in \
                group_layer_inputs(dev, gen, m, gs):
            w_bytes = k // 2 * n + 2 * (k // gs) * n
            got = qm.w4a8_matmul_per_group(a_i8, qws[0], s1, s2, s2z,
                                           a_scale, out_dtype=torch.float32,
                                           **kw)
            want = qm.w4a8_matmul_per_group_plain(
                a_i8, qws[0], s1, s2, s2z, a_scale, out_dtype=torch.float32,
                **kw)
            planted = ()
            if m in (8, 8192) and name == "qkv":
                bad_s2 = s2.clone()
                bad_s2[0, 5] = 17 if int(bad_s2[0, 5]) < 17 else 16
                planted = [(label, qm.w4a8_matmul_per_group_plain(
                    a_i8, w, s1, s, s2z, a_scale, out_dtype=torch.float32,
                    **kw)) for label, w, s in (
                        ("one flipped weight byte", flip_weight_byte(qws[0]),
                         s2), ("one wrong s2", qws[0], bad_s2))]
                expect_body("group", m, n, k, "int8_wgmma_kernel",
                            f"w4a8 g{gs} M={m}")
            err, _ = hold(got, want, 0.0, 0.0, 0.0,
                          f"w4a8 g{gs} M={m} K={k} N={n}", planted)
            del got, want, planted
            ms = time_gemm_ms(lambda w: qm.w4a8_matmul_per_group(
                a_i8, w, s1, s2, s2z, a_scale, **kw), qws, m)
            eager = ""
            if m <= 128:
                it = iter(range(10 ** 9))
                eager = " eager_ms {:.4f}".format(time_ms(
                    lambda: qm.w4a8_matmul_per_group(
                        a_i8, qws[next(it) % len(qws)], s1, s2, s2z,
                        a_scale, **kw), 50))
            plain = time_ms(lambda: qm.w4a8_matmul_per_group_plain(
                a_i8, qws[0], s1, s2, s2z, a_scale, **kw), 3, warmup=1)
            # yardstick: int8 weights dequantized BEFOREHAND (progressive
            # dequant not counted), one torch._int_mm and the epilogue
            w_i8 = qm.dequant_per_group(qws[0], s2, s2z, gs)
            lib = int_mm_ms(a_i8, w_i8, lambda p, mm: (
                p.float() * s1[None] * a_scale[:mm, None]).to(
                    torch.bfloat16), 50 if m <= 128 else 10)
            n_bytes = m * k + w_bytes + 4 * n + 4 * m + 2 * m * n
            ops = 2.0 * m * n * k
            bnd, by = bound_ms(n_bytes, ops, INT8_OPS_PER_S)
            plan = qm.gemm_plan("group", m, n, k, cuda.sm_count(dev))
            rows.append(dict(m=m, name=name, k=k, n=n, ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             max_abs_err=err))
            log(f"  w4a8 g{gs} {name:7s} M={m:5d} K={k:5d} N={n:5d}: "
                f"kernel_ms {ms:.4f}{eager} plain_ms {plain:.4f} bound_ms "
                f"{bnd:.4f} ({by}) library_ms {lib:.4f}{padded_note(m)} "
                f"max_abs_err {err:g}; {plan_note(plan)}; "
                f"{100 * bnd / ms:.1f}% of the bound")
            del qws, w_i8
    for m in (8, 128, 8192, 16384):
        r = layer_row(rows, m)
        log(f"  w4a8 g{gs} layer of 4 GEMMs M={m}: kernel_ms {r['ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) = "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; library_ms "
            f"{r['library_ms']:.4f}{padded_note(m)}")
    # the edge: u4 = 15, s2 = 17 (255 before the zero), wrapping zeros
    m, k, n = 128, 4096, 6144
    a_i8, a_scale, _ = quantize_activations(
        torch.randn((m, k), generator=gen, device=dev))
    qw = torch.full((k // 2, n), 0xFF, dtype=torch.uint8, device=dev)
    s1 = torch.full((n,), 0.004, device=dev)
    s2 = torch.full((k // gs, n), 17, dtype=torch.int8, device=dev)
    zeros = torch.tensor([-128, -8, 0, 100, 127], dtype=torch.int8,
                         device=dev)
    s2z = zeros[torch.randint(0, 5, s2.shape, generator=gen, device=dev)]
    args = (a_i8, qw, s1, s2, s2z, a_scale)
    err = allclose_err(
        qm.w4a8_matmul_per_group(*args, group_size=gs,
                                 out_dtype=torch.float32),
        qm.w4a8_matmul_per_group_plain(*args, group_size=gs,
                                       out_dtype=torch.float32),
        0.0, 0.0, "w4a8 per-group s2 = 17 edge")
    log(f"  w4a8 g{gs} s2 = 17, codes 15, zeros in {zeros.tolist()} "
        f"(M={m} K={k} N={n}): max_abs_err {err:g}")
    return rows


def layer_row(rows, m):
    """The kernels-line entry of a GEMM: one layer's four GEMMs at M."""
    pre = [r for r in rows if r["m"] == m]
    lib = [r["library_ms"] for r in pre]
    return dict(
        ms=sum(r["ms"] for r in pre),
        plain_ms=sum(r["plain_ms"] for r in pre),
        bound_ms=sum(r["bound_ms"] for r in pre),
        bound_by="operations" if all(
            r["bound_by"] == "operations" for r in pre) else "bytes",
        library_ms=None if None in lib else sum(lib),
        max_abs_err=max(r["max_abs_err"] for r in rows),
    )


def check_w8a8(dev, gen, m=8, k=4096, n=128256):
    """Row 3 at the lm_head (Llama-3-8B's K=4,096, N=128,256 unless given),
    M rows: equal to its plain
    version (max error 0; a flipped weight byte refused), timed by graph
    replay (the eager time logged beside: the host's per-call cost)."""
    import torch

    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    x = torch.randn((m, k), generator=gen, device=dev)
    a_i8, a_scale, _ = quantize_activations(x)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8,
                      device=dev)
    ws = torch.empty(n, device=dev).uniform_(0.0003, 0.0006, generator=gen)
    got = qm.w8a8_matmul(a_i8, w, ws, a_scale, out_dtype=torch.float32)
    want = qm.w8a8_matmul_plain(a_i8, w, ws, a_scale, out_dtype=torch.float32)
    bad = flip_weight_byte(w)
    planted = [("one flipped weight byte", qm.w8a8_matmul_plain(
        a_i8, bad, ws, a_scale, out_dtype=torch.float32))]
    del bad
    err, _ = hold(got, want, 0.0, 0.0, 0.0, f"w8a8 lm_head M={m}", planted)
    del got, want, planted
    expect_body("w8", m, n, k, "int8_wgmma_kernel", f"w8a8 lm_head M={m}")
    ms = time_gemm_ms(lambda wt: qm.w8a8_matmul(
        a_i8, wt, ws, a_scale, out_dtype=torch.float32), [w], m)
    eager = time_ms(lambda: qm.w8a8_matmul(a_i8, w, ws, a_scale,
                                           out_dtype=torch.float32), 20)
    plain = time_ms(lambda: qm.w8a8_matmul_plain(
        a_i8, w, ws, a_scale, out_dtype=torch.float32), 3, warmup=1)
    lib = int_mm_ms(a_i8, w, lambda p, mm: p.float() * ws[None]
                    * a_scale[:mm, None], 20)
    n_bytes = m * k + k * n + 4 * n + 4 * m + 4 * m * n
    bnd, by = bound_ms(n_bytes, 2.0 * m * n * k, INT8_OPS_PER_S)
    plan = qm.gemm_plan("w8", m, n, k, cuda.sm_count(dev))
    log(f"  w8a8 lm_head M={m} K={k} N={n}: kernel_ms {ms:.4f} (graph "
        f"replay; eager_ms {eager:.4f}) plain_ms {plain:.4f} bound_ms "
        f"{bnd:.4f} ({by}) library_ms {lib:.4f}{padded_note(m)} "
        f"max_abs_err {err:.3g}; {plan_note(plan)}; "
        f"{100 * bnd / ms:.1f}% of the bound")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err)


def check_w8a8_body_gemms(dev, gen):
    """The W8A8 body's four GEMM shapes (row 3's kernel, as phase 9 (b)
    runs it) at the bench's decode M=128 (graph replay on weight copies
    rotated past L2, as a layer finds them; the eager time logged beside)
    and chunk M=8192, equal to plain (max error 0; a flipped weight byte
    refused at the split decode and the two-warpgroup prefill); logs each
    GEMM's plan and share of its bound, and the layer's sum."""
    import torch

    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm

    for m in (128, 8192):
        tot = dict(ms=0.0, plain=0.0, bound=0.0, lib=0.0)
        for name, k, n, a_i8, ws, sc, a_scale in \
                w8a8_layer_inputs(dev, gen, m):
            got = qm.w8a8_matmul(a_i8, ws[0], sc, a_scale,
                                 out_dtype=torch.float32)
            want = qm.w8a8_matmul_plain(a_i8, ws[0], sc, a_scale,
                                        out_dtype=torch.float32)
            planted = ()
            if name == "o":      # split at M=128, two warpgroups at 8192
                planted = [("one flipped weight byte", qm.w8a8_matmul_plain(
                    a_i8, flip_weight_byte(ws[0]), sc, a_scale,
                    out_dtype=torch.float32))]
                expect_body("w8", m, n, k, "int8_wgmma_kernel", f"w8a8 M={m}")
            hold(got, want, 0.0, 0.0, 0.0, f"w8a8 M={m} K={k} N={n}",
                 planted)
            del got, want, planted
            ms = time_gemm_ms(lambda w: qm.w8a8_matmul(
                a_i8, w, sc, a_scale), ws, m)
            eager = ""
            if m <= 128:
                it = iter(range(10 ** 9))
                eager = " eager_ms {:.4f}".format(time_ms(
                    lambda: qm.w8a8_matmul(a_i8, ws[next(it) % len(ws)], sc,
                                           a_scale), 50))
            plain = time_ms(lambda: qm.w8a8_matmul_plain(
                a_i8, ws[0], sc, a_scale), 3, warmup=1)
            lib = int_mm_ms(a_i8, ws[0], lambda p, mm: (
                p.float() * sc[None] * a_scale[:mm, None]).to(
                    torch.bfloat16), 50 if m <= 128 else 10)
            n_bytes = m * k + k * n + 4 * n + 4 * m + 2 * m * n
            bnd, by = bound_ms(n_bytes, 2.0 * m * n * k, INT8_OPS_PER_S)
            plan = qm.gemm_plan("w8", m, n, k, cuda.sm_count(dev))
            for key, val in (("ms", ms), ("plain", plain), ("bound", bnd),
                             ("lib", lib)):
                tot[key] += val
            log(f"  w8a8 {name:7s} M={m:5d} K={k:5d} N={n:5d}: kernel_ms "
                f"{ms:.4f}{eager} plain_ms {plain:.4f} bound_ms {bnd:.4f} "
                f"({by}) library_ms {lib:.4f} (torch._int_mm + epilogue); "
                f"{plan_note(plan)}; {100 * bnd / ms:.1f}% of the bound")
            del ws
        log(f"  w8a8 body layer (4 GEMMs) M={m}: kernel_ms {tot['ms']:.4f} "
            f"plain_ms {tot['plain']:.4f} bound_ms {tot['bound']:.4f} "
            f"library_ms {tot['lib']:.4f} = "
            f"{100 * tot['bound'] / tot['ms']:.1f}% of the bound")


def check_narrow_gemms(dev, gen):
    """Rows 3 and 2 at N % 16 != 0 (no supported model's shape) take the
    mma.sync body (``quant_gemm_kernel``): equal to plain, max error 0."""
    import torch

    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    for m in (8, 300):
        a_i8, a_scale, _ = quantize_activations(
            torch.randn((m, 512), generator=gen, device=dev))
        w = torch.randint(-127, 128, (512, 260), generator=gen,
                          dtype=torch.int8, device=dev)
        ws = torch.empty(260, device=dev).uniform_(0.0003, 0.0006,
                                                   generator=gen)
        args = (a_i8, w, ws, a_scale)
        expect_body("w8", m, 260, 512, "quant_gemm_kernel",
                    f"w8a8 N=260 M={m}")
        err = allclose_err(qm.w8a8_matmul(*args, out_dtype=torch.float32),
                           qm.w8a8_matmul_plain(*args,
                                                out_dtype=torch.float32),
                           0.0, 0.0, f"w8a8 N=260 M={m}")
        qw = torch.randint(0, 256, (256, 68), generator=gen,
                           dtype=torch.uint8, device=dev)
        s1 = torch.empty(68, device=dev).uniform_(0.003, 0.006,
                                                  generator=gen)
        s2 = torch.randint(1, 18, (4, 68), generator=gen, dtype=torch.int8,
                           device=dev)
        s2z = torch.randint(-128, 128, (4, 68), generator=gen,
                            dtype=torch.int8, device=dev)
        gargs = (a_i8, qw, s1, s2, s2z, a_scale)
        expect_body("group", m, 68, 512, "quant_gemm_kernel",
                    f"w4a8 g128 N=68 M={m}")
        gerr = allclose_err(
            qm.w4a8_matmul_per_group(*gargs, out_dtype=torch.float32),
            qm.w4a8_matmul_per_group_plain(*gargs, out_dtype=torch.float32),
            0.0, 0.0, f"w4a8 g128 N=68 M={m}")
        log(f"  narrow N, mma.sync body (quant_gemm_kernel), M={m}: w8a8 "
            f"K=512 N=260 max_abs_err {err:g}; w4a8 g128 K=512 N=68 "
            f"max_abs_err {gerr:g}")


def check_flash(dev, gen, hq=32, hkv=8, n_seg=8, ptxas=False, d=128):
    """Row 9 on ``n_seg`` x 1,024 tokens at ``hq`` / ``hkv`` heads of ``d``
    (Llama-3-8B's 32 / 8 by default; Yi-34B's 56 / 8, Qwen1.5-72B's 64 /
    64; Llama-3.2-1B's 32 / 8 of 64); ``ptxas``: log ptxas's registers and
    spills of its source."""
    import torch
    import torch.nn.functional as F

    from omniserve_tpu_torch.ops.cuda import flash_attention as fa

    seg_len = 1024
    t = n_seg * seg_len
    q = torch.randn((t, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    seg = torch.arange(n_seg, device=dev, dtype=torch.int32).repeat_interleave(
        seg_len)
    pos = torch.arange(seg_len, device=dev, dtype=torch.int32).repeat(n_seg)
    sm = d ** -0.5
    got = fa.flash_prefill(q, k, v, seg, pos, sm)
    want = fa.prefill_attention_plain(q, k, v, seg, pos, sm)
    err = allclose_err(got, want, 2e-2, 2e-2, "flash prefill")
    ms = time_ms(lambda: fa.flash_prefill(q, k, v, seg, pos, sm), 10)
    plain = time_ms(lambda: fa.prefill_attention_plain(q, k, v, seg, pos, sm),
                    2, warmup=1)
    # the same function as one library call: equal-length segments as a batch
    qb = q.view(n_seg, seg_len, hq, d).transpose(1, 2)
    kb = k.view(n_seg, seg_len, hkv, d).transpose(1, 2)
    vb = v.view(n_seg, seg_len, hkv, d).transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True, scale=sm, enable_gqa=True), 10)
    pairs = n_seg * seg_len * (seg_len + 1) / 2
    n_bytes = 2 * (2 * t * hq * d + 2 * t * hkv * d) + 8 * t
    ops = 4.0 * d * hq * pairs
    bnd, by = bound_ms(n_bytes, ops, BF16_FLOPS_PER_S)
    log(f"  flash prefill T={t} ({n_seg}x{seg_len}) Hq={hq} Hkv={hkv} D={d}: "
        f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms {bnd:.4f} ({by}) "
        f"library_ms {lib:.4f} max_abs_err {err:.3g}; "
        f"{rate_note(ops, ms, bnd)}")
    if ptxas:
        for line in ptxas_report("flash_prefill.cu"):
            log(f"    ptxas {line}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err)


def decode_append_inputs(dev, gen, b=8, lens_from=1000, lens_to=1100,
                         kv_bits=4, per_tensor=False, n_rep=4, hkv=8):
    """Row 4's fused append over a dense list: kv4 or kv8 pages (``hkv`` kv
    heads, ``n_rep`` q heads each, pages of 128, lengths drawn from
    [lens_from, lens_to]),
    fine-grained or (``per_tensor``) per-tensor with scales calibrated on
    this call's new K/V, so the codes span their range. Returns (args, kw,
    pt scales or None): ``fused(*args, **kw)`` and ``fused_plain`` on a
    clone of args[1], with ``kv_zeros`` added."""
    import torch

    d, page, layers = 128, 128, 2
    lens = torch.randint(lens_from, lens_to + 1, (b,), generator=gen,
                         device=dev).to(torch.int32)
    w = int((int(lens.max()) + page - 1) // page)
    n_pages = b * w + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = perm[: b * w].view(b, w).to(torch.int32)
    q = torch.randn((b, hkv * n_rep, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k_new = torch.randn((b, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    v_new = torch.randn((b, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    pt = (calibrated_pt_scales(layers, kv_bits, k_new, v_new)
          if per_tensor else None)
    pool = random_kv_pool(gen, dev, layers, n_pages, hkv, page, d, kv_bits,
                          pt_scales=pt)
    return ((q, pool, 1, tables, lens, k_new, v_new),
            dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits), pt)


def check_decode(dev, gen, b=8, lens_from=1000, lens_to=1100, kv_bits=4,
                 per_tensor=False, n_rep=4, hkv=8):
    """The fused decode (row 4's append mode) over a dense list: kv4 or kv8
    pages, fine-grained or (``per_tensor``) per-tensor with scales
    calibrated on this run's new K/V, so the codes span their range, at
    ``hkv`` kv heads of ``n_rep`` q heads. Timed by graph replay
    (re-appending the same token writes the same bytes)."""
    import torch

    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    args, kw, pt = decode_append_inputs(dev, gen, b, lens_from, lens_to,
                                        kv_bits, per_tensor, n_rep, hkv)
    q, pool_k, layer, tables, lens, k_new, v_new = args
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    n_rep, page = hq // hkv, kw["page_size"]
    pool_p = pool_k.clone()
    label = f"kv{kv_bits}{' per-tensor' if per_tensor else ''}"
    planted = ()
    if per_tensor:    # the plain version one token short, on a fresh copy
        planted = (("lengths one short",
                    da.paged_decode_attention_fused_plain(
                        q, pool_k.clone(), layer, tables, lens - 1, k_new,
                        v_new, kv_zeros=False, **kw)),)
    got = da.paged_decode_attention_fused(*args, **kw)
    want = da.paged_decode_attention_fused_plain(
        q, pool_p, layer, tables, lens, k_new, v_new,
        kv_zeros=not per_tensor, **kw)
    what = f"decode attention {label} B={b}"
    if per_tensor:
        err, row = hold(got, want, 5e-2, 5e-2, ATTN_ROW_RTOL, what, planted)
    else:
        err, row = allclose_err(got, want, 5e-2, 5e-2, what), None
    pools_equal(pool_k, pool_p, f"decode append {label}")
    if per_tensor:     # the appended token's codes span their range
        from omniserve_tpu_torch.ops.quantization import (
            kv_quantize_per_tensor,
        )

        codes = kv_quantize_per_tensor(k_new, pt[0][layer], kv_bits)
        span = int(codes.max()) - int(codes.min())
        if span < 3 * 2 ** kv_bits // 4:
            raise AssertionError(f"per-tensor decode check: the new K codes "
                                 f"span {span} levels only")
    # re-appending the same token writes the same bytes: safe to repeat
    ms = time_graphed_ms(lambda: da.paged_decode_attention_fused(
        *args, **kw), 20)
    plain = time_ms(lambda: da.paged_decode_attention_fused_plain(
        q, pool_p, layer, tables, lens, k_new, v_new,
        kv_zeros=not per_tensor, **kw), 5, warmup=1)
    n_tok = float(lens.sum())
    # K+V codes (+ 4 f32 planes when fine-grained)
    tok_bytes = d * kv_bits // 4 + (0 if per_tensor else 16)
    n_bytes = (hkv * (n_tok - b) * tok_bytes
               + 2 * b * hkv * n_rep * d * 2    # q in, out
               + 2 * b * hkv * d * 2            # new k, v
               + b * hkv * tok_bytes)           # the appended token
    bnd, by = bound_ms(n_bytes, 4.0 * d * n_rep * hkv * n_tok,
                       BF16_FLOPS_PER_S)
    log(f"  decode attention+append {label} B={b} Hkv={hkv} "
        f"n_rep={n_rep} D={d} "
        f"page={page} lens {int(lens.min())}-{int(lens.max())}: kernel_ms "
        f"{ms:.4f} (graph replay) plain_ms {plain:.4f} bound_ms {bnd:.4f} "
        f"({by}) library_ms None (the function also writes the pool) "
        f"max_abs_err {err:.3g}" + ("" if row is None else
                                    f" (row error {row:.3g} of its norm)")
        + "; pool bytes equal; "
        + split_note(b, hkv, tables.shape[1], ms, n_bytes))
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None, max_abs_err=err)


def decode_kv16_inputs(dev, gen, b=8, lens_from=1000, lens_to=1100,
                       n_rep=4, mode="kv16", d=128, page=128):
    """Row 6's call over the dense list of a ``LIST_MODES`` pool (kv16 by
    default; 8 kv heads, ``n_rep`` q heads each, head dim ``d``, pages of
    ``page`` tokens, lengths drawn from [lens_from, lens_to]): (args, kw,
    tables)."""
    import torch

    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    hkv, layers = 8, 2
    lens = torch.randint(lens_from, lens_to + 1, (b,), generator=gen,
                         device=dev).to(torch.int32)
    w = int((int(lens.max()) + page - 1) // page)
    n_pages = b * w + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = perm[: b * w].view(b, w).to(torch.int32)
    pool = list_mode_pool(gen, dev, layers, n_pages, hkv, page, d, mode)
    q = torch.randn((b, hkv, n_rep, d), generator=gen, device=dev).to(
        torch.bfloat16)
    lists = da.dense_page_lists(tables, lens, page)
    return ((q, pool, 1, *lists, lens),
            dict(sm_scale=d ** -0.5, page_size=page), tables)


def split_note(b, heads, tp, ms, n_bytes) -> str:
    """The split kernels' S (``split_plan`` on this card), then the achieved
    device-memory rate of ``n_bytes`` in ``ms`` and its share of the bytes
    bound."""
    import torch

    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    from omniserve_tpu_torch.ops import cuda

    n_split = da.split_plan(b, heads, tp, cuda.sm_count(
        torch.device("cuda", torch.cuda.current_device())))[0]
    rate = n_bytes / (ms * 1e-3)
    return (f"S {n_split}; {rate / 1e9:.1f} GB/s = "
            f"{100 * rate / HBM_BYTES_PER_S:.1f}% of the bytes bound")


def swap_nibbles(pool):
    """A planted fault: a kv4 pool with the two nibbles of every code byte
    swapped (each page's halves exchanged)."""
    def swap(x):
        return ((x & 0x0F) << 4) | (x >> 4)

    return pool._replace(k_data=swap(pool.k_data), v_data=swap(pool.v_data))


def check_decode_kv16(dev, gen, b=8, lens_from=1000, lens_to=1100,
                      mode="kv16", d=128, page=128):
    """Row 6 over the dense list (``paged_mqa_attention``): a kv16 pool by
    default, the split path's attention half (its append is
    ``kv_append_decode``'s mode); with ``mode`` a kv4 / kv8 / per-tensor
    pool, the two-stage decode's quantized modes where the JAX package's
    supports rule sends them (head_dim 64, pages not a multiple of 128).
    Held at KV16_TOL (kv16) or the decode gate 5e-2, and 1e-2 of each row's
    norm; the plain version with the lengths one short and the partial
    last page dropped (kv4 also with the nibble halves swapped) is
    refused. The library yardstick is SDPA over K/V gathered (dequantized)
    BEFOREHAND into [B, H, Tmax, D] bf16 with a length mask (the gather is
    not in its time)."""
    import torch
    import torch.nn.functional as F

    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    args, kw, tables = decode_kv16_inputs(dev, gen, b, lens_from, lens_to,
                                          mode=mode, d=d, page=page)
    q, pool, layer, sel_phys, sel_logic, lens = args
    _, hkv, n_rep, d = q.shape
    page, sm, w = kw["page_size"], kw["sm_scale"], tables.shape[1]
    kv_bits, pt = LIST_MODES[mode]

    def fn():
        return da.paged_mqa_attention(*args, **kw)

    def plain_fn(n=lens, p=pool):
        return da.page_list_attention_plain(
            q, p, layer, *da.dense_page_lists(tables, n, page), n, **kw)

    planted = [("lengths one short", plain_fn(lens - 1)),
               ("the partial last page dropped",
                plain_fn(lens // page * page))]
    if kv_bits == 4:
        planted.append(("the nibble halves swapped",
                        plain_fn(p=swap_nibbles(pool))))
    tol = KV16_TOL if kv_bits == 16 else 5e-2
    name = da.two_stage_name("dense", pool, page, d)
    before = dict(cuda.LAUNCHES)
    err, row = hold(fn(), plain_fn(), tol, tol, ATTN_ROW_RTOL,
                    f"{mode} decode (row 6) B={b} D={d} page={page}",
                    planted=planted)
    moved = {k for k, n in cuda.LAUNCHES.items() if n != before[k]}
    if moved != {name}:
        raise AssertionError(f"row 6's {mode} call launched {moved}")
    del planted
    ms = time_graphed_ms(fn, 20)
    call_ms = time_ms(fn, 50)
    plain = time_ms(plain_fn, 3, warmup=1)
    k, v, valid = da.page_list_kv(pool, layer, sel_phys, sel_logic, lens,
                                  hkv, page_size=page)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    mask = valid[:, :, None, :]
    del k, v
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, kb, vb, attn_mask=mask, scale=sm), 20)
    del kb, vb
    n_tok = float(lens.sum())
    tok_bytes = 2 * d * kv_bits // 8 + (16 if kv_bits < 16 and not pt else 0)
    n_bytes = (hkv * n_tok * tok_bytes               # K and V (+ planes)
               + 2 * b * hkv * n_rep * d * 2         # q in, out
               + 2 * b * w * 4 + 4 * b)              # lists, lengths
    bnd, by = bound_ms(n_bytes, 4.0 * d * n_rep * hkv * n_tok,
                       BF16_FLOPS_PER_S)
    log(f"  {mode} decode (row 6) B={b} Hkv={hkv} n_rep={n_rep} D={d} "
        f"page={page} lens {int(lens.min())}-{int(lens.max())} "
        f"({n_bytes / 1e6:.1f} MB): kernel_ms {ms:.4f} (graph replay; "
        f"{call_ms:.4f} per eager wrapper call) plain_ms {plain:.4f} "
        f"bound_ms {bnd:.4f} ({by}) library_ms {lib:.4f} (SDPA over K/V "
        f"gathered beforehand, gather not counted) max_abs_err {err:.3g} "
        f"(row error {row:.3g} of its norm); "
        f"{split_note(b, hkv, w, ms, n_bytes)}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err)


def random_kv_pool(gen, dev, layers, n_pages, hkv, page, d, kv_bits,
                   pt_scales=None):
    """A pool as ``append_kv`` would leave it: kv16 pages of N(0, 1) bf16
    values; kv4 or kv8 pages of random codes, either with folded planes
    (scales in [0.1, 0.4] / 2**(kv_bits - 4), integer zeros within the
    levels) or, given ``pt_scales`` ((k [L], v [L])), per-tensor."""
    import torch

    from omniserve_tpu_torch.ops.paged_kv import KVPool

    if kv_bits == 16:
        shape = (layers, n_pages, hkv, page, d)
        return KVPool(*(torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2)), None)
    levels = 2 ** kv_bits
    rows = page // 2 if kv_bits == 4 else page
    shape = (layers, n_pages, hkv, rows, d)
    k_data = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                           device=dev)
    v_data = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                           device=dev)
    if pt_scales is not None:
        return KVPool(k_data, v_data, None, k_scale_per_tensor=pt_scales[0],
                      v_scale_per_tensor=pt_scales[1])
    planes = torch.empty((layers, n_pages, 4, hkv, page), device=dev)
    lo, hi = 0.1 * 16 / levels, 0.4 * 16 / levels
    ks = torch.empty(planes[:, :, 0].shape, device=dev).uniform_(
        lo, hi, generator=gen)
    kz = torch.randint(0, levels, ks.shape, generator=gen, device=dev).float()
    vs = torch.empty_like(ks).uniform_(lo, hi, generator=gen)
    vz = torch.randint(0, levels, ks.shape, generator=gen, device=dev).float()
    planes[:, :, 0], planes[:, :, 1] = ks, ks * (kz + 128.0)
    planes[:, :, 2], planes[:, :, 3] = vs, vz + 128.0
    return KVPool(k_data, v_data, planes)


def calibrated_pt_scales(layers, kv_bits, k, v):
    """Per-layer per-tensor scales max |x| / qmax of ``k`` and ``v``, so
    the codes of these values span their whole range."""
    import torch

    qmax = 7 if kv_bits == 4 else 127
    return tuple(torch.full((layers,), float(x.float().abs().max()) / qmax,
                            device=x.device) for x in (k, v))


def pools_equal(got, want, what, skip_trash=False) -> float:
    """Raise unless every field of two pools holds the same values (but the
    trash page, with ``skip_trash``); returns the largest difference (0)."""
    import torch

    err = 0.0
    for name, a, b_ in zip(got._fields, got, want):
        if a is None:
            continue
        if skip_trash and a.dim() > 1:
            a, b_ = a[:, :-1], b_[:, :-1]
        if not torch.equal(a, b_):
            raise AssertionError(f"{what}: pool {name} differs from the plain "
                                 f"version's in {int((a != b_).sum())} "
                                 "elements")
        err = max(err, float((a.float() - b_.float()).abs().max()))
    return err


def dense_chunk_inputs(dev, gen, kv_bits=4, per_tensor=False, b=128,
                       history=896, tc=128, page=128, n_rep=4, d=128):
    """Chunked prefill's last chunk over a dense table: ``b`` sequences x
    ``tc`` chunk tokens after ``history`` tokens, 8 kv heads of ``n_rep``
    q heads each (Llama-3-8B's 4, Yi-34B's 7), pages
    of ``page`` tokens, the tables a permutation of the pool's pages; a
    kv4 or kv8 pool, fine-grained or (``per_tensor``, random codes over
    their whole range, scales 3.5 / qmax) per-tensor, or a kv16 pool.
    Returns (args, kw, label, bytes and (query, key) pairs the function
    needs)."""
    import torch

    hkv = 8
    ctx_len = history + tc
    w = -(-ctx_len // page)
    pt = None
    if per_tensor:
        qmax = 7 if kv_bits == 4 else 127
        pt = (torch.full((1,), 3.5 / qmax, device=dev),
              torch.full((1,), 3.0 / qmax, device=dev))
    pool = random_kv_pool(gen, dev, 1, b * w + 1, hkv, page, d, kv_bits,
                          pt_scales=pt)
    perm = torch.randperm(b * w, generator=gen, device=dev)
    tables = perm.view(b, w).to(torch.int32)
    q = torch.randn((b, tc, hkv * n_rep, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q_pos = (history + torch.arange(tc, device=dev, dtype=torch.int32)
             ).repeat(b, 1).contiguous()
    ctx = torch.full((b,), ctx_len, dtype=torch.int32, device=dev)
    label = f"kv{kv_bits}{' per-tensor' if per_tensor else ''}"
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
              kv_zeros=not per_tensor)
    pairs = b * (tc * history + tc * (tc + 1) // 2)
    planes = 0 if per_tensor or kv_bits == 16 else 4 * 4   # a token
    kv_bytes = b * ctx_len * hkv * (d * kv_bits // 4 + planes)
    n_bytes = kv_bytes + 2 * (2 * b * tc * hkv * n_rep * d) + 8 * b * tc
    return (q, pool, 0, tables, q_pos, ctx), kw, label, n_bytes, pairs


def dense_sdpa_ms(args, kw, head_mask=None, reps=5):
    """Library yardstick of a dense-table chunk: SDPA over K/V dequantized
    BEFOREHAND (the dequantization and the gather are left out of its
    time), with the causal mask of the first sequence's positions (every
    sequence's) and, given ``head_mask`` ([Hq, Tc, ctx] -> bool), that
    per-head mask on top. None if it does not fit."""
    import torch
    import torch.nn.functional as F

    from omniserve_tpu_torch.ops.paged_kv import gather_kv_for_seq

    q, pool, layer, tables, q_pos, ctx = args
    ctx_len = int(ctx[0])
    try:
        k, v = gather_kv_for_seq(pool, layer, tables, kw["page_size"],
                                 kw["kv_bits"], kw["kv_zeros"])  # [B,T,H,D]
        # the table's pages may run past the context: keys up to it only
        kb = k[:, :ctx_len].to(torch.bfloat16).transpose(1, 2).contiguous()
        vb = v[:, :ctx_len].to(torch.bfloat16).transpose(1, 2).contiguous()
        del k, v
        qb = q.transpose(1, 2)
        mask = (torch.arange(ctx_len, device=q.device)[None, :]
                <= q_pos[0][:, None])                      # [Tc, ctx]
        if head_mask is not None:
            mask = (mask[None] & head_mask(mask.shape))[None]
        return time_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, scale=kw["sm_scale"],
            enable_gqa=True), reps, warmup=1)
    except RuntimeError as e:
        log(f"  SDPA over the dense chunk: {str(e).splitlines()[0]}")
        return None
    finally:
        torch.cuda.empty_cache()


def check_paged_prefill(dev, gen, kv_bits=4, per_tensor=False, b=128,
                        d=128):
    """The bench's last chunk (``dense_chunk_inputs``) through row 7, at
    head dim ``d``."""
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp

    args, kw, label, n_bytes, pairs = dense_chunk_inputs(
        dev, gen, kv_bits, per_tensor, b, d=d)
    q, pool, _, tables, q_pos, ctx = args
    got = pp.paged_prefill_attention(*args, **kw)
    want = pp.paged_prefill_attention_plain(*args, **kw)
    what, row = f"paged prefill {label}", None
    if kv_bits == 16 or per_tensor:
        tol = KV16_TOL if kv_bits == 16 else 2e-2
        err, row = hold(got, want, tol, tol, ATTN_ROW_RTOL, what, planted=(
            ("contexts one short", pp.paged_prefill_attention_plain(
                q, pool, 0, tables, q_pos, ctx - 1, **kw)),
            ("the causal frontier one short",
             pp.paged_prefill_attention_plain(q, pool, 0, tables, q_pos - 1,
                                              ctx, **kw))))
    else:
        err = allclose_err(got, want, 2e-2, 2e-2, what)
    ms = time_ms(lambda: pp.paged_prefill_attention(*args, **kw), 5,
                 warmup=1)
    plain = time_ms(lambda: pp.paged_prefill_attention_plain(*args, **kw), 1,
                    warmup=0)
    lib = dense_sdpa_ms(args, kw)
    hq, d = q.shape[2], q.shape[3]
    ops = 4.0 * d * hq * pairs
    bnd, by = bound_ms(n_bytes, ops, BF16_FLOPS_PER_S)
    log(f"  paged prefill {label} B={b} Tc={q.shape[1]} history="
        f"{int(q_pos[0, 0])} Hq={hq} Hkv={pool.num_heads} D={d} page="
        f"{kw['page_size']}: kernel_ms {ms:.4f} plain_ms "
        f"{plain:.4f} bound_ms {bnd:.4f} ({by}) library_ms "
        f"{lib if lib is None else f'{lib:.4f}'} "
        f"(SDPA over pre-dequantized K/V, dequantization not counted) "
        f"max_abs_err {err:.3g}" + ("" if row is None else
                                    f" (row error {row:.3g} of its norm)")
        + f"; {rate_note(ops, ms, bnd)}")
    if kv_bits == 4 and not per_tensor and d == 128:
        for line in ptxas_report("paged_prefill.cu"):
            log(f"    ptxas {line}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err)


def band_pairs(q_pos, kv_pos, sink: int, local: int, chunk: int = 2048):
    """(query, key) pairs a streaming head attends: the data's own count,
    for the operations bound. q_pos [Tq], kv_pos [S] (-1 = no token)."""
    import torch

    n = 0
    for i0 in range(0, q_pos.shape[0], chunk):
        qp = q_pos[i0:i0 + chunk, None].long()
        kp = kv_pos[None, :].long()
        ok = (kp >= 0) & (kp <= qp) & ((kp < sink) | (qp - kp < local))
        n += int(ok.sum())
    return n


def check_flash_band(dev, gen, d=128):
    """Whole-prompt prefill of LServe's sparse-context mode at the phase-7
    (b) shape: one 16,384-token prompt, 32/8 heads, 4 of the 8 kv heads
    streaming with 128 sink + 8,192 local tokens. The dense kernel is timed
    at the same shape to show what the band's tile skip saves; the library
    yardstick is one ``scaled_dot_product_attention`` call with the same
    boolean mask (K/V heads expanded beforehand, not timed)."""
    import torch
    import torch.nn.functional as F

    from omniserve_tpu_torch.ops.cuda import flash_attention as fa

    t, hq, hkv, sink, local = 16384, 32, 8, 128, 8192
    n_rep = hq // hkv
    q = torch.randn((t, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    seg = torch.zeros(t, dtype=torch.int32, device=dev)
    pos = torch.arange(t, dtype=torch.int32, device=dev)
    flags = (torch.arange(hkv, device=dev) < hkv // 2).repeat_interleave(
        n_rep)                                     # kv heads 4-7 stream
    sm = d ** -0.5
    band = dict(head_is_retrieval=flags, sink_size=sink, local_size=local)
    got = fa.flash_prefill(q, k, v, seg, pos, sm, **band)
    want = fa.prefill_attention_plain(q, k, v, seg, pos, sm, **band)
    err = allclose_err(got, want, 2e-2, 2e-2, "flash prefill band")
    # a row that averages ~8K random values is ~0.011 per element, about
    # the elementwise bound itself: each (token, head) row is also held to
    # its own norm. bf16 rounding of the output alone is ~2e-3 of it; a
    # streaming row that lost its 128 sinks moves by ~sqrt(128 / 8320) =
    # 0.12, and the plain version without sinks shows that this check sees it
    rel = row_rel_err(got, want)
    del got
    if rel > BAND_ROW_RTOL:
        raise AssertionError(f"flash prefill band: a row differs by {rel:.3g}"
                             f" of its norm > {BAND_ROW_RTOL}")
    no_sink = fa.prefill_attention_plain(q, k, v, seg, pos, sm,
                                         head_is_retrieval=flags,
                                         sink_size=0, local_size=local)
    miss = row_rel_err(no_sink, want)
    del no_sink, want
    if miss <= BAND_ROW_RTOL:
        raise AssertionError(f"flash prefill band: dropping the sinks moves "
                             f"a row by only {miss:.3g} of its norm")
    ms = time_ms(lambda: fa.flash_prefill(q, k, v, seg, pos, sm, **band), 3,
                 warmup=1)
    dense_ms = time_ms(lambda: fa.flash_prefill(q, k, v, seg, pos, sm), 3,
                       warmup=1)
    plain = time_ms(lambda: fa.prefill_attention_plain(q, k, v, seg, pos, sm,
                                                       **band), 1, warmup=0)
    lib = None
    try:
        i = torch.arange(t, device=dev)
        causal = i[None, :] <= i[:, None]
        in_band = (i[None, :] < sink) | (i[:, None] - i[None, :] < local)
        mask = torch.where(flags[:, None, None], causal[None],
                           (causal & in_band)[None])[None]   # [1, Hq, T, T]
        del causal, in_band
        qb = q.transpose(0, 1)[None]
        kb = k.repeat_interleave(n_rep, dim=1).transpose(0, 1)[None]
        vb = v.repeat_interleave(n_rep, dim=1).transpose(0, 1)[None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, scale=sm), 2, warmup=1)
        del mask, qb, kb, vb
    except RuntimeError as e:
        log(f"  SDPA with a [1, {hq}, {t}, {t}] mask: "
            f"{str(e).splitlines()[0]}")
    torch.cuda.empty_cache()
    n_stream = int((~flags).sum())
    pairs = ((hq - n_stream) * t * (t + 1) / 2
             + n_stream * band_pairs(pos, pos, sink, local))
    n_bytes = 2 * (2 * t * hq * d + 2 * t * hkv * d) + 8 * t
    bnd, by = bound_ms(n_bytes, 4.0 * d * pairs, BF16_FLOPS_PER_S)
    dense_ops = 4.0 * d * hq * t * (t + 1) / 2
    log(f"  flash prefill band: {rate_note(4.0 * d * pairs, ms, bnd)}; the "
        f"dense kernel at the same shape "
        f"{rate_note(dense_ops, dense_ms, dense_ops / BF16_FLOPS_PER_S * 1e3)}")
    log(f"  flash prefill band T={t} Hq={hq} Hkv={hkv} D={d} ({hkv // 2} kv heads "
        f"streaming, sink {sink}, local {local}): kernel_ms {ms:.4f} (dense "
        f"kernel at the same shape {dense_ms:.4f}) plain_ms {plain:.4f} "
        f"bound_ms {bnd:.4f} ({by}) library_ms "
        f"{lib if lib is None else f'{lib:.4f}'} (SDPA with the boolean "
        f"mask) max_abs_err {err:.3g}, largest row error {rel:.3g} of the "
        f"row's norm (limit {BAND_ROW_RTOL}; the plain version without "
        f"sinks: {miss:.3g})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err)


def ring_chunk_inputs(dev, gen, context, tc, n_ring, mode="kv4", d=128):
    """The streaming heads' call of a chunked sparse prefill: B=1, a chunk
    of ``tc`` queries ending at ``context`` over a 1 + ``n_ring`` slot ring
    (4 streaming kv heads, n_rep 4, pages of 128 tokens, 128 sink + 8,192
    local tokens, a ``LIST_MODES`` pool: layer 0 of one layer, fine-grained
    kv4, else layer 1 of two), slots resolved by ``ring_logical_blocks``.
    Returns (args, kw, bytes and (query, key) pairs the function needs, a
    note on the ring)."""
    import torch

    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import ring_logical_blocks

    hs, n_rep, page, sink, local = 4, 4, 128, 128, 8192
    n_slots = 1 + n_ring
    layers = 1 if mode == "kv4" else 2
    pool = list_mode_pool(gen, dev, layers, n_slots + 1, hs, page, d, mode)
    kv_bits, pt = LIST_MODES[mode]
    table = torch.randperm(n_slots, generator=gen, device=dev).view(
        1, n_slots).to(torch.int32)
    ctx = torch.tensor([context], dtype=torch.int32, device=dev)
    q_pos = (context - tc + torch.arange(tc, dtype=torch.int32,
                                         device=dev))[None]
    q = torch.randn((1, tc, hs * n_rep, d), generator=gen, device=dev).to(
        torch.bfloat16)
    sel = ring_logical_blocks(ctx, n_slots, 1, n_ring, page)
    kw = dict(sm_scale=d ** -0.5, page_size=page,
              head_is_retrieval=torch.zeros(hs * n_rep, dtype=torch.bool,
                                            device=dev),
              sink_size=sink, local_size=local, sel_logic=sel,
              ring_span_pages=n_ring, ring_sink_tokens=page)
    if mode != "kv4":
        kw.update(kv_bits=kv_bits, kv_zeros=not pt)
    kv_pos = pp.kv_positions_of(sel, ctx, page, n_ring, page)[0]
    stale = int(((kv_pos >= 0) & (kv_pos // page != sel[0].repeat_interleave(
        page))).sum())
    pairs = band_pairs(q_pos[0], kv_pos, sink, local)
    live_slots = int((sel >= 0).sum())
    n_bytes = (live_slots * hs * page_bytes(mode, page, d)  # codes, planes
               + 2 * (2 * tc * hs * n_rep * d) + 4 * tc)
    note = (f"{mode} D={d} context {context} Tc={tc} ring 1+{n_ring} slots "
            f"({live_slots} live, {stale} relabelled stale rows) Hs={hs} "
            f"n_rep={n_rep}")
    return (q, pool, layers - 1, table, q_pos, ctx), kw, n_bytes, pairs, note


def ring_sdpa_ms(args, kw, reps=3):
    """Library yardstick of a ring chunk: ``scaled_dot_product_attention``
    over K/V dequantized and expanded BEFOREHAND with the boolean band mask
    (neither counted); None if it does not fit."""
    import torch
    import torch.nn.functional as F

    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import gather_kv_for_seq

    q, pool, layer, table, q_pos, ctx = args
    page, sel = kw["page_size"], kw["sel_logic"]
    n_rep = q.shape[2] // pool.num_heads
    sink, local = kw["sink_size"], kw["local_size"]
    kv_pos = pp.kv_positions_of(sel, ctx, page, kw["ring_span_pages"],
                                kw["ring_sink_tokens"])[0]
    try:
        k, v = gather_kv_for_seq(pool, layer, table, page,
                                 kw.get("kv_bits", 4),
                                 kw.get("kv_zeros", True))   # [1, S, Hs, D]
        kb = k.to(torch.bfloat16).repeat_interleave(n_rep, dim=2) \
            .transpose(1, 2).contiguous()
        vb = v.to(torch.bfloat16).repeat_interleave(n_rep, dim=2) \
            .transpose(1, 2).contiguous()
        del k, v
        qp, kp = q_pos[0, :, None].long(), kv_pos[None, :].long()
        mask = (kp >= 0) & (kp <= qp) & ((kp < sink) | (qp - kp < local))
        qb = q.transpose(1, 2)
        return time_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, scale=kw["sm_scale"]), reps,
            warmup=1)
    except RuntimeError as e:
        log(f"  SDPA over the ring: {str(e).splitlines()[0]}")
        return None
    finally:
        torch.cuda.empty_cache()


def check_paged_ring(dev, gen, context, tc, n_ring, label, mode="kv4",
                     d=128):
    """The ring chunk of ``ring_chunk_inputs`` through row 7. kv8 and
    per-tensor modes also hold each row within 1e-2 of its norm and refuse
    the plain version with the other layer's scales or planes; kv16 holds
    ``KV16_TOL`` plus one bf16 ulp of each value (``BF16_ULP_RTOL``) and
    each row's norm, and refuses it with the band's local window moved by
    a page."""
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp

    args, kw, n_bytes, pairs, note = ring_chunk_inputs(dev, gen, context, tc,
                                                       n_ring, mode, d)
    q = args[0]
    got = pp.paged_prefill_attention(*args, **kw)
    want = pp.paged_prefill_attention_plain(*args, **kw)
    what = f"paged prefill ring {mode} {label}"
    if mode == "kv4":
        err = allclose_err(got, want, 2e-2, 2e-2, what)
    else:
        atol, rtol = (KV16_TOL, BF16_ULP_RTOL) if mode == "kv16" else (
            2e-2, 2e-2)
        bad = (pp.paged_prefill_attention_plain(*args, **dict(
            kw, local_size=kw["local_size"] - kw["page_size"]))
            if mode == "kv16" else pp.paged_prefill_attention_plain(
                q, wrong_layer(args[1], mode), *args[2:], **kw))
        err, row = hold(got, want, atol, rtol, ATTN_ROW_RTOL, what,
                        [("the band's window moved by a page"
                          if mode == "kv16"
                          else "the other layer's scales"
                          if LIST_MODES[mode][1]
                          else "the other layer's planes", bad)])
        note = f"{note} (row error {row:.3g} of its norm)"
        del bad
    del got, want
    ms = time_ms(lambda: pp.paged_prefill_attention(*args, **kw), 3,
                 warmup=1)
    plain = time_ms(lambda: pp.paged_prefill_attention_plain(*args, **kw), 1,
                    warmup=0)
    lib = ring_sdpa_ms(args, kw)
    ops = 4.0 * q.shape[3] * q.shape[2] * pairs
    bnd, by = bound_ms(n_bytes, ops, BF16_FLOPS_PER_S)
    log(f"  paged prefill ring ({label}) {note}: kernel_ms {ms:.4f} "
        f"plain_ms {plain:.4f} "
        f"bound_ms {bnd:.4f} ({by}) library_ms "
        f"{lib if lib is None else f'{lib:.4f}'} (SDPA over pre-dequantized "
        f"K/V with the band mask) max_abs_err {err:.3g}; "
        f"{rate_note(ops, ms, bnd)}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err)


def check_kv_append(dev, gen, mode="kv4", d=128, kept_shape=None):
    """The decode append at the LServe path's shapes, through both entries
    of row 10. The single-pool entry at 8 rows (the padded batch) and 128,
    4 pool heads (retrieval, with K stats; streaming, without) and 8; then
    the two-pool entry (``check_kv_append_pools``), which the LServe decode
    step launches. Pool bytes, planes (fine-grained) and stats must equal
    the plain version's on every page but the trash page. kv8 and
    per-tensor modes also refuse a plain append that writes each token one
    slot late and, per-tensor, one with the other layer's scales. The row
    kept for the kernels line is the two-pool entry's at T=8, or, given
    ``kept_shape`` ((T, heads)), that single-pool shape's with stats
    (without at 8 heads). ``d``: the head dim."""
    import torch

    from omniserve_tpu_torch.ops.cuda import kv_append as ka

    page, n_sub = 128, 4
    kept = None
    kv_bits, pt = LIST_MODES[mode]
    for t, heads, with_stats in ((8, 4, True), (8, 4, False), (128, 4, True),
                                 (128, 8, False)):
        n_pages = 2 * t + 1
        base = list_mode_pool(gen, dev, 2, n_pages, heads, page, d, mode)
        stats = torch.randn((2, n_pages, heads, 2 * n_sub, d), generator=gen,
                            device=dev) if with_stats else None
        pool_k = base._replace(k_stats=stats)
        pool_p = pool_k.clone()
        pages = torch.randperm(n_pages - 1, generator=gen, device=dev)[:t].to(
            torch.int32)
        pages[1::5] = -1                       # inactive rows
        slots = torch.randint(0, page, (t,), generator=gen, device=dev).to(
            torch.int32)
        k = torch.randn((t, heads, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((t, heads, d), generator=gen, device=dev).bfloat16()
        args = (1, k, v, pages, slots, page)
        kw = dict(update_stats=with_stats, kv_bits=kv_bits, kv_zeros=not pt)
        planted = {"each token one slot late": (
            pool_k.clone(), (1, k, v, pages, (slots + 1) % page, page))}
        if mode != "kv4":
            if pt:
                planted["the other layer's scales"] = (
                    wrong_layer(pool_k.clone(), mode), args)
        ka.append_kv_decode(pool_k, *args, update_stats=with_stats)
        ka.append_kv_decode_plain(pool_p, *args, **kw)
        sync(dev)
        what = f"kv append {mode} D={d} T={t} H={heads}"
        err = pools_equal(pool_k, pool_p, what, skip_trash=True)
        for label, (bad, bad_args) in planted.items():
            ka.append_kv_decode_plain(bad, *bad_args, **kw)
            try:
                pools_equal(pool_k, bad._replace(
                    k_scale_per_tensor=pool_k.k_scale_per_tensor,
                    v_scale_per_tensor=pool_k.v_scale_per_tensor),
                    what, skip_trash=True)
            except AssertionError as e:
                log(f"    {what}: planted {label} refused ({e})")
            else:
                raise AssertionError(f"{what}: equal bytes with {label}")

        # the same token again writes the same bytes: safe to repeat
        def call():
            ka.append_kv_decode(pool_k, *args, update_stats=with_stats)

        ms = time_graphed_ms(call, 20)
        call_ms = time_ms(call, 50)
        plain = time_ms(lambda: ka.append_kv_decode_plain(
            pool_p, *args, **kw), 5, warmup=1)
        rw = 2 * 2 * d if kv_bits == 4 else 2 * d   # kv4 bytes read + written
        per_head = (2 * d * 2            # k, v in (bf16)
                    + rw                 # K and V code rows
                    + (0 if pt else 16)  # four plane lanes
                    + (2 * 2 * d * 4 if with_stats else 0))  # min/max rows RMW
        bnd, by = bound_ms(t * heads * per_head + 8 * t,
                           t * heads * d * 8.0, BF16_FLOPS_PER_S)
        log(f"  {what} stats={with_stats}: "
            f"kernel_ms {ms:.4f} (graph replay; {call_ms:.4f} per eager "
            f"wrapper call) plain_ms {plain:.4f} bound_ms {bnd:.6f} ({by}) "
            f"library_ms None max_abs_err {err:g}; pool bytes"
            f"{'' if pt else ', planes'}{' and stats' if with_stats else ''} "
            "equal")
        if kept is None and kept_shape == (t, heads):
            kept = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                        library_ms=None, max_abs_err=err)
    pools = check_kv_append_pools(dev, gen, mode, 8, d)
    check_kv_append_pools(dev, gen, mode, 128, d)
    return pools if kept is None else kept


def check_kv_append_pools(dev, gen, mode, t, d=128):
    """Row 10's two-pool entry as the LServe decode step calls it: ``t``
    tokens of Llama-3.1-8B's 8 kv heads, K and V read in place from a
    fused qkv row, rows 0, 2, 4, 6 to the retrieval pool (with K stats)
    and 1, 3, 5, 7 to the streaming pool, one launch. Both pools must equal
    the two plain appends' (each on its gathered heads) on every page but
    the trash page; the plain versions with each token one slot late, the
    pools' head maps swapped and (per tensor) the other layer's scales are
    refused. Timed by graph replay beside the plain version and beside
    what the decode step ran before, per layer: two single-pool launches
    on head-gathered copies (``gathered_ms``)."""
    import torch

    from omniserve_tpu_torch.ops.cuda import kv_append as ka

    page, n_sub, heads = 128, 4, 4
    kv_bits, pt = LIST_MODES[mode]
    n_pages = 2 * t + 1
    rpool = list_mode_pool(gen, dev, 2, n_pages, heads, page, d, mode)
    rpool = rpool._replace(k_stats=torch.randn(
        (2, n_pages, heads, 2 * n_sub, d), generator=gen, device=dev))
    spool = list_mode_pool(gen, dev, 2, n_pages, heads, page, d, mode)
    targets = []
    for first in (0, 1):
        pages = torch.randperm(n_pages - 1, generator=gen, device=dev)[:t].to(
            torch.int32)
        pages[1::5] = -1                       # inactive rows
        slots = torch.randint(0, page, (t,), generator=gen, device=dev).to(
            torch.int32)
        src = torch.arange(first, 2 * heads, 2, device=dev)
        targets.append((pages, slots, src))
    tr, ts = targets
    qkv = torch.randn((t, 48, d), generator=gen, device=dev).bfloat16()
    k, v = qkv[:, 32:40], qkv[:, 40:48]      # views: 32 q, 8 k, 8 v heads
    kw = dict(update_stats=True, sub_chunks=n_sub)
    plain_kw = dict(kw, kv_bits=kv_bits, kv_zeros=not pt)
    got = (rpool.clone(), spool.clone())
    want = (rpool.clone(), spool.clone())
    ka.append_kv_decode_pools(*got, 1, k, v, tr, ts, page, **kw)
    ka.append_kv_decode_pools_plain(*want, 1, k, v, tr, ts, page, **plain_kw)
    sync(dev)
    what = f"two-pool kv append {mode} D={d} T={t} H=4+4"
    err = max(pools_equal(a, b_, what, skip_trash=True)
              for a, b_ in zip(got, want))
    faults = {
        "each token one slot late": ((rpool, spool),
                                     (tr[0], (tr[1] + 1) % page, tr[2]),
                                     (ts[0], (ts[1] + 1) % page, ts[2])),
        "the pools' head maps swapped": ((rpool, spool),
                                         (tr[0], tr[1], ts[2]),
                                         (ts[0], ts[1], tr[2])),
    }
    if pt:
        faults["the other layer's scales"] = (
            (wrong_layer(rpool, mode), wrong_layer(spool, mode)), tr, ts)
    for label, (pools, a, b_) in faults.items():
        bad = tuple(p.clone() for p in pools)
        ka.append_kv_decode_pools_plain(*bad, 1, k, v, a, b_, page,
                                        **plain_kw)
        try:
            for x, y in zip(got, bad):
                pools_equal(x, y._replace(
                    k_scale_per_tensor=x.k_scale_per_tensor,
                    v_scale_per_tensor=x.v_scale_per_tensor), what,
                    skip_trash=True)
        except AssertionError as e:
            log(f"    {what}: planted {label} refused ({e})")
        else:
            raise AssertionError(f"{what}: equal pools with {label}")

    # the same token again writes the same bytes: safe to repeat
    def call():
        ka.append_kv_decode_pools(*got, 1, k, v, tr, ts, page, **kw)

    def gathered():
        ka.append_kv_decode(got[0], 1, k[:, tr[2]], v[:, tr[2]], tr[0],
                            tr[1], page, **kw)
        ka.append_kv_decode(got[1], 1, k[:, ts[2]], v[:, ts[2]], ts[0],
                            ts[1], page)

    ms = time_graphed_ms(call, 20)
    call_ms = time_ms(call, 50)
    gathered_ms = time_graphed_ms(gathered, 20)
    plain = time_ms(lambda: ka.append_kv_decode_pools_plain(
        *want, 1, k, v, tr, ts, page, **plain_kw), 5, warmup=1)
    # K and V rows written (kv4: its bytes read and written; kv16: bf16)
    rw = 2 * d if kv_bits == 8 else 2 * 2 * d
    per_row = 2 * d * 2 + rw + (0 if pt or kv_bits == 16 else 16)
    n_bytes = (t * 2 * heads * per_row + t * heads * 2 * 2 * d * 4
               + 2 * (8 * t + 8 * heads))
    bnd, by = bound_ms(n_bytes, t * 2 * heads * d * 8.0, BF16_FLOPS_PER_S)
    log(f"  {what} stats on the retrieval pool: kernel_ms {ms:.4f} (graph "
        f"replay; {call_ms:.4f} per eager wrapper call; the two "
        f"single-pool launches on gathered heads {gathered_ms:.4f}) "
        f"plain_ms {plain:.4f} bound_ms {bnd:.6f} ({by}) library_ms None "
        f"max_abs_err {err:g}; both pools' bytes"
        f"{'' if pt or kv_bits == 16 else ', planes'} and stats equal")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None, max_abs_err=err)


def check_kv_append_kv16(dev, gen):
    """Row 10's kv16 mode, the append half of the kv16 split decode, at the
    bench's decode shape (128 rows, all 8 kv heads into the dense pool) and
    at 8 rows: pool bytes equal the plain version's on every page but the
    trash page. No library call computes it (it writes the pool). The row
    kept for the kernels line is T=128."""
    import torch

    from omniserve_tpu_torch.ops.cuda import kv_append as ka

    page, d, heads = 128, 128, 8
    kept = None
    for t in (128, 8):
        n_pages = 2 * t + 1
        pool_k = random_kv_pool(gen, dev, 2, n_pages, heads, page, d, 16)
        pool_p = pool_k.clone()
        pages = torch.randperm(n_pages - 1, generator=gen, device=dev)[:t].to(
            torch.int32)
        pages[1::5] = -1                       # inactive rows
        slots = torch.randint(0, page, (t,), generator=gen, device=dev).to(
            torch.int32)
        k = torch.randn((t, heads, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((t, heads, d), generator=gen, device=dev).bfloat16()
        args = (1, k, v, pages, slots, page)
        ka.append_kv_decode(pool_k, *args)
        ka.append_kv_decode_plain(pool_p, *args, kv_bits=16)
        torch.cuda.synchronize()
        err = pools_equal(pool_k, pool_p, f"kv16 append T={t}",
                          skip_trash=True)

        def call():
            ka.append_kv_decode(pool_k, *args)

        ms = time_graphed_ms(call, 20)
        call_ms = time_ms(call, 50)
        plain = time_ms(lambda: ka.append_kv_decode_plain(
            pool_p, *args, kv_bits=16), 5, warmup=1)
        bnd, by = bound_ms(t * heads * 2 * d * 2 * 2 + 8 * t, 0.0,
                           BF16_FLOPS_PER_S)
        log(f"  kv16 append (row 10) T={t} H={heads}: kernel_ms {ms:.4f} "
            f"(graph replay; {call_ms:.4f} per eager wrapper call) plain_ms "
            f"{plain:.4f} bound_ms {bnd:.6f} ({by}) library_ms None (it "
            f"writes the pool) max_abs_err {err:g}; pool bytes equal")
        if kept is None:
            kept = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                        library_ms=None, max_abs_err=err)
    return kept


# LServe's pool modes of the page-list kernels, rows 10 and 7's ring:
# label -> (kv bits, per-tensor)
LIST_MODES = {"kv4": (4, False), "kv8": (8, False), "pt8": (8, True),
              "kv16": (16, False)}


def kv_suffix(kv_bits, per_tensor) -> str:
    """The launch-name suffix of a pool mode: "" (fine-grained kv4),
    "_kv8", "_pt" (per-tensor kv4 or kv8) or "_kv16"."""
    return ("_kv16" if kv_bits == 16 else "_pt" if per_tensor
            else "_kv8" if kv_bits == 8 else "")


def dense_prefill_name(suffix) -> str:
    """Row 7's launch name over a dense table of a pool mode."""
    return "paged_prefill" + suffix if suffix else "paged_prefill_attention"


def list_mode_pool(gen, dev, layers, n_pages, heads, page, d, mode):
    """``random_kv_pool`` in a list mode; per-tensor pools take per-layer
    scales that span N(0, 1) values and differ by layer (so a scale read
    from the wrong layer is a fault a gate sees)."""
    import torch

    kv_bits, pt = LIST_MODES[mode]
    scales = None
    if pt:
        qmax = 7 if kv_bits == 4 else 127
        scales = (torch.linspace(3.0, 4.2, layers, device=dev) / qmax,
                  torch.linspace(3.6, 2.6, layers, device=dev) / qmax)
    return random_kv_pool(gen, dev, layers, n_pages, heads, page, d, kv_bits,
                          pt_scales=scales)


def page_bytes(mode, page, d) -> int:
    """Bytes of one page of one kv head: K+V codes (kv16: bf16 values),
    and the four f32 plane rows of a fine-grained kv4 / kv8 page."""
    kv_bits, pt = LIST_MODES[mode]
    return page * d * kv_bits // 4 + (0 if pt or kv_bits == 16
                                      else 16 * page)


def wrong_layer(pool, mode):
    """A planted fault: the pool with every layer's per-tensor scales (or,
    fine-grained, planes) taken from the other layer (layers reversed)."""
    if LIST_MODES[mode][1]:
        return pool._replace(
            k_scale_per_tensor=pool.k_scale_per_tensor.flip(0).contiguous(),
            v_scale_per_tensor=pool.v_scale_per_tensor.flip(0).contiguous())
    return pool._replace(kv_scales=pool.kv_scales.flip(0).contiguous())


def _list_kernel_row(label, fn, plain_fn, n_pages_read, b, heads, n_rep, d,
                     page, tp, tol=5e-2, library=None, mode="kv4",
                     planted=()):
    """Check + time one page-list decode call; ``n_pages_read`` = the
    (sequence, head) pages this run's lists make the kernel read.
    ``library`` = (q, k, v, valid) for the SDPA yardstick over the listed
    pages dequantized beforehand (not counted). With ``planted`` ((label,
    plain call with a fault)), also within 1e-2 of each row's norm, and
    each fault refused by the same gate. ``tp`` = entries of each list
    (split over blocks by ``split_plan``)."""
    import torch.nn.functional as F

    got, want = fn(), plain_fn()
    if planted:
        err, row = hold(got, want, tol, tol, ATTN_ROW_RTOL, label,
                        [(what, bad()) for what, bad in planted])
        label = f"{label} (row error {row:.3g} of its norm)"
    else:
        err = allclose_err(got, want, tol, tol, label)
    ms = time_graphed_ms(fn, 20)
    call_ms = time_ms(fn, 50)
    plain = time_ms(plain_fn, 3, warmup=1)
    lib = None
    if library is not None:
        q, k, v, valid = library
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid[:, :, None, :], scale=d ** -0.5), 20)
    n_bytes = (n_pages_read * page_bytes(mode, page, d)  # codes (+ planes)
               + 2 * b * heads * n_rep * d * 2)          # q in, out
    bnd, by = bound_ms(n_bytes, 4.0 * d * n_rep * n_pages_read * page,
                       BF16_FLOPS_PER_S)
    log(f"  {label}: kernel_ms {ms:.4f} (graph replay; {call_ms:.4f} per "
        f"eager wrapper call) plain_ms {plain:.4f} bound_ms {bnd:.5f} ({by}) "
        f"library_ms {lib if lib is None else f'{lib:.4f}'} (SDPA over the "
        f"listed pages dequantized beforehand, not counted) max_abs_err "
        f"{err:.3g}; {split_note(b, heads, tp, ms, n_bytes)}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err)


def list_library_inputs(q, pool, layer, sel_phys, sel_logic, lengths, page,
                        **list_kw):
    """(q, k, v, valid) of the SDPA yardstick: the listed pages dequantized
    to bf16 BEFOREHAND, each slot live as the list contract says."""
    import torch

    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    k, v, valid = da.page_list_kv(pool, layer, sel_phys, sel_logic, lengths,
                                  q.shape[1], page_size=page, **list_kw)
    return q, k.to(torch.bfloat16), v.to(torch.bfloat16), valid


def decode_ph_inputs(dev, gen, b, mode="kv4", n_rep=4, d=128):
    """Dynamic-sparse decode at the LServe path's shape: 4 retrieval heads,
    ``n_rep`` q heads each, a budget of 32 pages out of a 32K-token
    context (257 pages, the last one partly filled): the newest page
    first, then 31 others in no order, a different list per head; a
    2-layer pool but under kv4 (layer 1 read). Returns (args, kw)."""
    import torch

    hr, page, budget = 4, 128, 32
    ctx_pages = 257
    lens = (32768 + torch.randint(1, page, (b,), generator=gen, device=dev)
            ).to(torch.int32)
    layers = 1 if mode == "kv4" else 2
    pool = list_mode_pool(gen, dev, layers, b * ctx_pages + 1, hr, page, d,
                          mode)
    tables = torch.randperm(b * ctx_pages, generator=gen, device=dev).view(
        b, ctx_pages)
    picks = torch.stack([torch.stack([
        torch.randperm(ctx_pages - 1, generator=gen, device=dev)[:budget - 1]
        for _ in range(hr)]) for _ in range(b)])          # [B, Hr, 31]
    sel_logic = torch.cat([torch.full((b, hr, 1), ctx_pages - 1, device=dev),
                           picks], dim=2)
    sel_phys = torch.gather(tables[:, None, :].expand(-1, hr, -1), 2,
                            sel_logic)
    sel_logic = sel_logic.to(torch.int32).contiguous()
    sel_phys = sel_phys.to(torch.int32).contiguous()
    q = torch.randn((b, hr, n_rep, d), generator=gen, device=dev).bfloat16()
    return ((q, pool, layers - 1, sel_phys, sel_logic, lens),
            dict(sm_scale=d ** -0.5, page_size=page))


def check_decode_ph(dev, gen, b, mode="kv4", d=128):
    """Row 5 at ``decode_ph_inputs``' shape (kv16, and every mode at head
    dim 64: row 6's per-head mode, ``paged_mqa_attention_ph``). kv8 and
    per-tensor modes (layer 1 of a 2-layer pool) also hold each row within
    1e-2 of its norm and refuse the plain version with the other layer's
    scales or planes; kv16 holds ``KV16_TOL``; row 6 refuses it with the
    lengths a page short."""
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    args, kw = decode_ph_inputs(dev, gen, b, mode, d=d)
    q, pool, layer, sel_phys, sel_logic, lens = args
    _, hr, n_rep, d = q.shape
    budget, page = sel_logic.shape[-1], kw["page_size"]
    tol = KV16_TOL if mode == "kv16" else 5e-2
    two_stage = da.uses_two_stage(pool, page, d)
    if two_stage:
        kernel = da.paged_mqa_attention_ph
        planted = (("the lengths a page short",
                    lambda: da.page_list_attention_plain(
                        *args[:5], lens - page, **kw)),)
    else:
        kernel = da.paged_mqa_attention_single_pass_ph
        planted = () if mode == "kv4" else (
            ("the other layer's scales" if LIST_MODES[mode][1]
             else "the other layer's planes",
             lambda: da.page_list_attention_plain(
                 q, wrong_layer(pool, mode), layer, *args[3:], **kw)),)
    return _list_kernel_row(
        f"decode per-head lists (row {6 if two_stage else 5}) {mode} D={d} "
        f"B={b} Hr={hr} n_rep={n_rep} budget {budget} pages of 257",
        lambda: kernel(*args, **kw),
        lambda: da.page_list_attention_plain(*args, **kw),
        b * hr * budget, b, hr, n_rep, d, page, budget, tol=tol, mode=mode,
        planted=planted, library=list_library_inputs(
            q, pool, layer, sel_phys, sel_logic, lens, page))


def decode_band_inputs(dev, gen, b, mode="kv4", n_rep=4, d=128):
    """The streaming call at the LServe path's shape: 4 streaming heads
    (``n_rep`` q heads each), the
    compact list of 1 sink page + 2 ring pages after the ring has wrapped
    (32K-token contexts), band = 128 sink tokens + the last 256. Returns
    (args, kw)."""
    import torch

    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    hs, page = 4, 128
    lens = (32768 + torch.randint(1, page, (b,), generator=gen, device=dev)
            ).to(torch.int32)
    layers = 1 if mode == "kv4" else 2
    pool = list_mode_pool(gen, dev, layers, 3 * b + 1, hs, page, d, mode)
    stables = torch.randperm(3 * b, generator=gen, device=dev).view(b, 3).to(
        torch.int32)
    sel_phys, sel_logic, span = da.streaming_page_lists(stables, lens, 1,
                                                        page, 256)
    if sel_logic.shape != (b, 3) or int(sel_logic.min()) < 0:
        raise AssertionError(f"streaming list {sel_logic.tolist()}")
    q = torch.randn((b, hs, n_rep, d), generator=gen, device=dev).bfloat16()
    return ((q, pool, layers - 1, sel_phys, sel_logic, lens),
            dict(sm_scale=d ** -0.5, page_size=page, band_sink_tokens=128,
                 band_local_tokens=256, ring_span_pages=span,
                 ring_sink_tokens=page))


def check_decode_band(dev, gen, b, mode="kv4", d=128):
    """Row 4's band at ``decode_band_inputs``' shape (kv16, and every mode
    at head dim 64: row 6's band mode, ``paged_mqa_attention_band``). kv8
    and per-tensor modes as ``check_decode_ph``; kv16 holds ``KV16_TOL``;
    row 6 refuses the plain version with the band's local window moved by
    a page."""
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    args, kw = decode_band_inputs(dev, gen, b, mode, d=d)
    q, pool, layer, sel_phys, sel_logic, lens = args
    _, hs, n_rep, d = q.shape
    page = kw["page_size"]
    tol = KV16_TOL if mode == "kv16" else 5e-2
    two_stage = da.uses_two_stage(pool, page, d)
    if two_stage:
        kernel = da.paged_mqa_attention_band
        planted = (("the band's window moved by a page",
                    lambda: da.page_list_attention_plain(*args, **dict(
                        kw, band_local_tokens=kw["band_local_tokens"]
                        - page))),)
    else:
        kernel = da.paged_mqa_attention_single_pass
        planted = () if mode == "kv4" else (
            ("the other layer's scales" if LIST_MODES[mode][1]
             else "the other layer's planes",
             lambda: da.page_list_attention_plain(
                 q, wrong_layer(pool, mode), layer, *args[3:], **kw)),)
    return _list_kernel_row(
        f"decode band+ring (row {6 if two_stage else 4}) {mode} D={d} B={b} "
        f"Hs={hs} n_rep={n_rep} list 1 sink + 2 ring pages",
        lambda: kernel(*args, **kw),
        lambda: da.page_list_attention_plain(*args, **kw),
        b * hs * 3, b, hs, n_rep, d, page, sel_logic.shape[-1], tol=tol,
        mode=mode,
        planted=planted, library=list_library_inputs(
            q, pool, layer, sel_phys, sel_logic, lens, page,
            **{k: v for k, v in kw.items() if k != "sm_scale"
               and k != "page_size"}))


# ---------------------------------------------------------------------------
# phase 2: GQA groups of 7 (Yi-34B) and the GEMM shapes of phase 12's models
# ---------------------------------------------------------------------------


def dead_row_written(want, uniform):
    """A planted fault: the plain output [B, H, n_rep, D] as a decode kernel
    whose first dead row wrote its result would leave it. Row n_rep of
    block (b, h) is flat row (b, h + 1, 0), and a dead row scores a zero q,
    so it holds the mean of the live V rows of kv head h (``uniform``: the
    plain version at q = 0)."""
    b, h, n_rep, d = want.shape
    w = want.reshape(b * h, n_rep, d).clone()
    w[1:, 0] = uniform.reshape(b * h, n_rep, d)[:-1, 0]
    return w.view(b, h, n_rep, d)


def widen_group(q4):
    """q [B, H, 7, D] -> [B, H, 8, D]: one more q row a group (its first
    again), so the kernel at n_rep 8 reads the same KV."""
    import torch

    return torch.cat([q4, q4[:, :, :1]], dim=2).contiguous()


def gqa_row(label, call, plain, q4, n_bytes, ops, tol, library=None,
            planted=True):
    """One kernel at n_rep 7 (``call(q4)`` / ``plain(q4)``, q4 [B, H, 7,
    D]) against its plain version at atol = rtol = ``tol``; with
    ``planted`` that gate refuses a dead row's output written over the
    next group's first row (``dead_row_written``). Timed by graph replay
    at n_rep 7 and, on the same KV, at n_rep 8 (``widen_group``; also
    within ``tol`` of its plain version). ``library()`` gives SDPA's ms
    on the same inputs, or None. Returns the kernels-line entry, with the
    n_rep 8 time beside."""
    import torch

    got, want = call(q4), plain(q4)
    faults = []
    if planted:
        faults = [("a dead row's output over the next group's first row",
                   dead_row_written(want.view(q4.shape), plain(
                       torch.zeros_like(q4)).view(q4.shape)).view(
                           want.shape))]
    # no per-row limit here (math.inf): the element gate alone refuses
    err, _ = hold(got, want, tol, tol, math.inf, label, faults)
    q8 = widen_group(q4)
    allclose_err(call(q8), plain(q8), tol, tol, f"{label} at n_rep 8")
    ms = time_graphed_ms(lambda: call(q4), 20)
    ms8 = time_graphed_ms(lambda: call(q8), 20)
    plain_ms = time_ms(lambda: plain(q4), 3, warmup=1)
    lib = None if library is None else library()
    bnd, by = bound_ms(n_bytes, ops, BF16_FLOPS_PER_S)
    log(f"  {label} n_rep=7: kernel_ms {ms:.4f} (graph replay; n_rep 8 on "
        f"the same KV {ms8:.4f}, 7 / 8 = {ms / ms8:.3f}) plain_ms "
        f"{plain_ms:.4f} bound_ms {bnd:.5f} ({by}) library_ms "
        f"{lib if lib is None else f'{lib:.4f}'} max_abs_err {err:.3g}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err, n_rep8_ms=ms8)


def list_sdpa(q4, k, v, valid, d):
    """SDPA over the listed pages dequantized beforehand (not counted)."""
    import torch.nn.functional as F

    return lambda: time_ms(lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=valid[:, :, None, :], scale=d ** -0.5), 20)


def check_gqa7(dev, gen):
    """Rows 4-9 at GQA groups of 7 (Yi-34B's 56 q heads over 8 kv heads),
    each in the row capacity 8, beside the same kernel at n_rep 8 on the
    same KV: row 4's fused append (kv4) at phase 12's decode step (B = 64,
    lengths 1,024-1,536), row 7 at its bench chunk (64 x 128 tokens after
    896), rows 5 and 4's band at phase 2's LServe shapes, row 6 (kv16) at
    B = 64, row 8 at the bench chunk (beside row 7), row 9 at 56 / 8 heads.
    Returns the kernels-line entries of the two that phase 12 launches."""
    import torch

    from omniserve_tpu_torch.ops.cuda import decode_attention as da
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp

    entries = {}
    # row 4's fused append (re-appending the same token writes the same
    # bytes, so the kernel and the plain version run again and again)
    args, kw, _ = decode_append_inputs(dev, gen, 64, 1024, 1536, n_rep=7)
    q, pool, layer, tables, lens, k_new, v_new = args
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    twin = pool.clone()
    n_tok = float(lens.sum())
    tok_bytes = d + 16          # kv4 K + V codes and four f32 planes
    n_bytes = (hkv * (n_tok - b) * tok_bytes + 2 * b * hq * d * 2
               + 2 * b * hkv * d * 2 + b * hkv * tok_bytes)
    entries["decode_attention_append_n7"] = gqa_row(
        f"decode attention+append kv4 B={b} Hkv={hkv} lens "
        f"{int(lens.min())}-{int(lens.max())} (library: none, it writes "
        "the pool)",
        lambda q4: da.paged_decode_attention_fused(
            q4.reshape(b, -1, d), pool, layer, tables, lens, k_new, v_new,
            **kw),
        lambda q4: da.paged_decode_attention_fused_plain(
            q4.reshape(b, -1, d), twin, layer, tables, lens, k_new, v_new,
            **kw),
        q.view(b, hkv, 7, d), n_bytes, 4.0 * d * hq * n_tok, 5e-2)
    pools_equal(pool, twin, "decode append kv4 n_rep 7")
    del pool, twin
    torch.cuda.empty_cache()

    # rows 5 and 4's band over page lists, row 6 over kv16 pages
    for name, inputs, fn, tp_pages in (
            ("decode per-head lists kv4 B=8 Hr=4 budget 32 pages of 257",
             decode_ph_inputs, da.paged_mqa_attention_single_pass_ph, 32),
            ("decode band+ring kv4 B=8 Hs=4 list 1 sink + 2 ring pages",
             decode_band_inputs, da.paged_mqa_attention_single_pass, 3)):
        args, kw = inputs(dev, gen, 8, n_rep=7)
        q4, pool, layer, sel_phys, sel_logic, lens = args
        bb, heads, _, d = q4.shape
        page = kw["page_size"]
        list_kw = {k: v for k, v in kw.items()
                   if k not in ("sm_scale", "page_size")}
        _, k, v, valid = list_library_inputs(q4, pool, layer, sel_phys,
                                             sel_logic, lens, page, **list_kw)
        n_read = bb * heads * tp_pages
        gqa_row(name, lambda qq: fn(qq, *args[1:], **kw),
                lambda qq: da.page_list_attention_plain(qq, *args[1:], **kw),
                q4, n_read * page_bytes("kv4", page, d)
                + 2 * bb * heads * 7 * d * 2,
                4.0 * d * 7 * n_read * page, 5e-2,
                library=list_sdpa(q4, k, v, valid, d))
        del k, v, valid
    args, kw, tables = decode_kv16_inputs(dev, gen, 64, 1024, 1536, n_rep=7)
    q4, pool, layer, sel_phys, sel_logic, lens = args
    bb, heads, _, d = q4.shape
    k, v, valid = da.page_list_kv(pool, layer, sel_phys, sel_logic, lens,
                                  heads, page_size=kw["page_size"])
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    del k, v
    n_tok = float(lens.sum())
    gqa_row(f"kv16 decode (row 6) B={bb} Hkv={heads} lens "
            f"{int(lens.min())}-{int(lens.max())}",
            lambda qq: da.paged_mqa_attention(qq, *args[1:], **kw),
            lambda qq: da.page_list_attention_plain(qq, *args[1:], **kw),
            q4, heads * n_tok * d * 4 + 2 * bb * heads * 7 * d * 2,
            4.0 * d * 7 * heads * n_tok, KV16_TOL,
            library=list_sdpa(q4, kb, vb, valid, d))
    del pool, kb, vb, valid
    torch.cuda.empty_cache()

    # row 7 at the bench chunk of Yi-34B's chunked prefill (dead rows
    # 126, 127 of each block write nothing: a plain output with them
    # written would hold the next block's first token, computed over the
    # same keys, so no planted fault can tell; the rows are compared)
    args, kw, label, n_bytes, pairs = dense_chunk_inputs(
        dev, gen, 4, False, b=64, n_rep=7)
    q, pool, layer, tables, q_pos, ctx = args
    bb, tc, hq, d = q.shape
    hkv = pool.num_heads

    def prefill(qq):
        return pp.paged_prefill_attention(
            qq.reshape(bb, tc, -1, d), pool, layer, tables, q_pos, ctx, **kw)

    def prefill_plain(qq):
        return pp.paged_prefill_attention_plain(
            qq.reshape(bb, tc, -1, d), pool, layer, tables, q_pos, ctx, **kw)

    q4 = q.view(bb * tc, hkv, 7, d)
    err = allclose_err(prefill(q4), prefill_plain(q4), 2e-2, 2e-2,
                       "paged prefill kv4 n_rep 7")
    q8 = widen_group(q4)
    allclose_err(prefill(q8), prefill_plain(q8), 2e-2, 2e-2,
                 "paged prefill kv4 n_rep 8")
    ms = time_ms(lambda: prefill(q4), 5, warmup=1)
    ms8 = time_ms(lambda: prefill(q8), 5, warmup=1)
    plain = time_ms(lambda: prefill_plain(q4), 1, warmup=0)
    lib = dense_sdpa_ms(args, kw)
    ops = 4.0 * d * hq * pairs
    bnd, by = bound_ms(n_bytes, ops, BF16_FLOPS_PER_S)
    log(f"  paged prefill {label} B={bb} Tc={tc} history="
        f"{int(q_pos[0, 0])} Hq={hq} Hkv={hkv} n_rep=7 (18 tokens a block, "
        f"rows 126-127 dead): kernel_ms {ms:.4f} (n_rep 8 on the same KV "
        f"{ms8:.4f}, 7 / 8 = {ms / ms8:.3f}) plain_ms {plain:.4f} bound_ms "
        f"{bnd:.4f} ({by}) library_ms "
        f"{lib if lib is None else f'{lib:.4f}'} (SDPA over pre-dequantized "
        f"K/V) max_abs_err {err:.3g}; {rate_note(ops, ms, bnd)}")
    entries["paged_prefill_attention_n7"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        max_abs_err=err, n_rep8_ms=ms8)
    del pool, args
    torch.cuda.empty_cache()
    check_single_pass_dense(dev, gen, b=64, n_rep=7)
    check_flash(dev, gen, hq=56, hkv=8)
    return entries


def check_mha_rows(dev, gen):
    """Rows 4 and 9 at the shapes phase 12's Qwen1.5-72B round gives them
    (64 q heads over 64 kv heads, n_rep 1, in the row capacity 1): row
    4's fused append (kv4) at the decode step (B = 4, lengths 1,024 -
    1,536) and row 9 on the whole-prompt batch (4 x 1,024 tokens), each
    against its plain version at its gate. Returns their kernels-line
    entries."""
    return {
        "decode_attention_append_mha": check_decode(
            dev, gen, b=4, lens_from=1024, lens_to=1536, n_rep=1, hkv=64),
        "flash_prefill_mha": check_flash(dev, gen, hq=64, hkv=64, n_seg=4),
    }


def check_family_gemms(dev, gen, families=FAMILIES):
    """Rows 1 and 3 at the shapes phase 12's models (or ``families``') give
    them (FAMILIES):
    each layer projection of the per-channel body at the decode step's M
    (graph replay on weight copies rotated past the 50 MB L2) and the
    prefill step's M, equal to its plain version within 1e-5, with its
    plan; then the W8A8 lm_head at the decode M (``check_w8a8``)."""
    import torch

    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    for family, (_, _, gemms, (hk, hn), m_steps) in families.items():
        for m in m_steps:
            total = bound_total = 0.0
            for name, k, n in gemms:
                a_i8, a_scale, a_sum = quantize_activations(
                    torch.randn((m, k), generator=gen, device=dev),
                    fuse_sum=True)
                n_copies = (max(1, math.ceil(120e6 / (k // 2 * n)))
                            if m <= 128 else 1)
                qws = [torch.randint(0, 256, (k // 2, n), generator=gen,
                                     dtype=torch.uint8, device=dev)
                       for _ in range(n_copies)]
                s1 = torch.empty(n, device=dev).uniform_(0.003, 0.006,
                                                         generator=gen)
                sz = 8.0 * s1
                got = qm.w4a8_matmul_per_channel(
                    a_i8, qws[0], s1, sz, a_scale, a_sum,
                    out_dtype=torch.float32)
                want = qm.w4a8_matmul_per_channel_plain(
                    a_i8, qws[0], s1, sz, a_scale, a_sum,
                    out_dtype=torch.float32)
                err = allclose_err(got, want, 1e-5, 1e-5,
                                   f"{family} w4a8 {name} M={m}")
                del got, want
                ms = time_gemm_ms(lambda w: qm.w4a8_matmul_per_channel(
                    a_i8, w, s1, sz, a_scale, a_sum), qws, m)
                n_bytes = m * k + k // 2 * n + 8 * n + 8 * m + 2 * m * n
                bnd, by = bound_ms(n_bytes, 2.0 * m * n * k, INT8_OPS_PER_S)
                total += ms
                bound_total += bnd
                plan = qm.channel_plan(m, n, k, cuda.sm_count(dev))
                log(f"  {family} w4a8 {name:7s} M={m:5d} K={k:5d} N={n:5d}: "
                    f"kernel_ms {ms:.4f} bound_ms {bnd:.4f} ({by}) "
                    f"max_abs_err {err:.3g}; {plan_note(plan)}; "
                    f"{100 * bnd / ms:.1f}% of the bound")
                del qws
            log(f"  {family} w4a8 layer of 4 GEMMs M={m}: kernel_ms "
                f"{total:.4f} bound_ms {bound_total:.4f} = "
                f"{100 * bound_total / total:.1f}% of the bound")
        check_w8a8(dev, gen, m=m_steps[0], k=hk, n=hn)
        torch.cuda.empty_cache()


def time_selector(dev, gen):
    """The page selector (plain PyTorch in the port, as XLA code in the JAX
    package) at the LServe phase's shape: the padded batch of 8 rows, a
    320-page table holding a 32K-token context, 4 retrieval heads of 8 kv
    heads, budget 32. It gathers each sequence's stats rows and scores only
    those. Time of one layer's refresh, and the stats bytes it reads."""
    import torch

    from omniserve_tpu_torch.ops import attention_ref

    b, w, hkv, hr, n_rep, d, n_sub, budget, page = 8, 320, 8, 4, 4, 128, 4, 32, 128
    n_pages = 264
    stats = torch.randn((1, n_pages, hr, 2 * n_sub, d), generator=gen,
                        device=dev)
    tables = torch.zeros((b, w), dtype=torch.int32, device=dev)
    tables[0, :257] = torch.randperm(n_pages - 1, generator=gen,
                                     device=dev)[:257].to(torch.int32)
    lens = torch.zeros(b, dtype=torch.int32, device=dev)
    lens[0] = 32768 + 17
    flags = torch.arange(hkv, device=dev) < hr
    rank = torch.cat([torch.arange(hr), torch.arange(hkv - hr)]).to(
        torch.int32).to(dev)
    q = torch.randn((b, hkv * n_rep, d), generator=gen, device=dev).bfloat16()

    def refresh():
        scores = attention_ref.page_selector_scores(q, stats, 0, tables,
                                                    flags, rank)
        return attention_ref.select_topk_pages(scores, lens, budget, page)

    sel = refresh()
    if sel.shape != (b, hkv, budget) or int(sel[0, 0, 0]) != 256 or len(
            set(sel[0, 0].tolist())) != budget:
        raise AssertionError(f"selector picked {sel[0, 0].tolist()}")
    ms = time_graphed_ms(refresh, 10)
    call_ms = time_ms(refresh, 20)
    gathered = b * w * hr * 2 * n_sub * d * 4
    log(f"  page selector, one layer's refresh (B={b} rows, table {w} pages, "
        f"Hr={hr}, budget {budget}): {ms:.4f} ms on the device (graph "
        f"replay), {call_ms:.4f} ms per eager call; gathers "
        f"{gathered / 2**20:.1f} MiB of stats rows "
        f"(bytes bound {gathered / HBM_BYTES_PER_S * 1e3:.4f} ms)")


# ---------------------------------------------------------------------------
# phase 3: full-width, depth-cut forward, kernels vs plain versions
# ---------------------------------------------------------------------------

LOGITS_RTOL = 5e-2   # of max |logit|; reason printed with the result
# The logits' own sensitivity ("floor"): the plain forward again, with a
# random ATTN_ULP_RATE share of every attention output moved by one bf16
# ulp, about the share of flash prefill's bf16 outputs that differ from
# its plain version's on these forwards' layer-0 inputs (each precision
# forward measures and prints that share). A random W4A8 body moves its
# logits by well under 1% of their scale under it, a random W8A8 body
# (uniform int8 codes, the JAX package's draw) by a few %; the precision
# forwards hold kernels against plain within max(LOGITS_RTOL,
# FLOOR_FACTOR x floor) of max |logit|.
ATTN_ULP_RATE = 4e-4
FLOOR_FACTOR = 3.0


def _mode_ctx(mode, nudged=None):
    """kernels: the card's kernels; plain: the plain versions; floor: the
    plain versions with one-ulp nudges on every attention output (of the
    dispatch's entry points ``nudged``, or the dense path's)."""
    stack = contextlib.ExitStack()
    if mode in ("plain", "floor"):
        from omniserve_tpu_torch.ops import cuda

        stack.enter_context(cuda.plain_versions())
    if mode == "floor":
        stack.enter_context(nudged_attention() if nudged is None
                            else nudged_attention(names=nudged))
    return stack


@contextlib.contextmanager
def nudged_attention(rate=ATTN_ULP_RATE, seed=7, names=(
        "prefill_attention", "paged_prefill_attention",
        "paged_decode_attention_fused")):
    """Within the block, each attention entry point of the dispatch named in
    ``names`` moves a random ``rate`` share of its nonzero finite bf16
    outputs by one ulp (up or down in magnitude: a zero, the padding rows'
    output, stays zero, and no nudge reaches an inf or a NaN)."""
    import torch

    from omniserve_tpu_torch.ops import dispatch

    gens = {}

    def nudge(out):
        gen = gens.setdefault(out.device, torch.Generator(
            device=out.device).manual_seed(seed))
        bits = out.contiguous().view(torch.int16)
        hit = torch.rand(bits.shape, generator=gen, device=out.device) < rate
        up = torch.rand(bits.shape, generator=gen, device=out.device) < 0.5
        step = torch.where(up, 1, -1).to(torch.int16)
        mag = bits & 0x7FFF      # sign-magnitude: +-1 moves the magnitude
        hit &= (mag > 0) & (mag < 0x7F7F)
        return torch.where(hit, bits + step, bits).view(torch.bfloat16)

    saved = {n: getattr(dispatch, n) for n in names}

    def wrap(real):
        def f(*a, **k):
            out = real(*a, **k)
            if isinstance(out, tuple):
                return (nudge(out[0]),) + tuple(out[1:])
            return nudge(out)
        return f

    for n in names:
        setattr(dispatch, n, wrap(saved[n]))
    try:
        yield
    finally:
        for n, real in saved.items():
            setattr(dispatch, n, real)


def flash_flip_share(spec, params, batch) -> float:
    """Share of flash prefill's bf16 outputs that differ from its plain
    version's, on the layer-0 inputs of this forward."""
    import torch

    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.ops import dispatch
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool

    seen = []
    real = dispatch.prefill_attention

    def record(q, k, v, segment_ids, positions, sm_scale, **kw):
        if not seen:
            seen.append((q, k, v, segment_ids, positions, sm_scale))
        return real(q, k, v, segment_ids, positions, sm_scale, **kw)

    dispatch.prefill_attention = record
    try:
        one = dataclasses.replace(spec, num_layers=1)
        with torch.inference_mode():
            pool = make_kv_pool(1, batch.block_tables.numel() + 1,
                                spec.num_kv_heads, spec.page_size,
                                spec.head_dim, kv_bits=spec.kv_bits,
                                kv_zeros=spec.kv_zeros,
                                device=batch.token_ids.device)
            llama.llama_forward(params, pool, None, batch, one,
                                is_prefill=True)
    finally:
        dispatch.prefill_attention = real
    q, k, v, seg, pos, sm = seen[0]
    with torch.inference_mode():
        got = fa.flash_prefill(q.contiguous(), k.contiguous(),
                               v.contiguous(), seg, pos, sm)
        want = fa.prefill_attention_plain(q, k, v, seg, pos, sm)
    return float((got != want).float().mean())


def logits_bound(results, step, scale, with_floor):
    """(relative bound, floor or None) for one compared output."""
    if not with_floor:
        return LOGITS_RTOL, None
    floor = float((results["floor"][step] - results["plain"][step]).abs()
                  .max()) / scale
    return max(LOGITS_RTOL, FLOOR_FACTOR * floor), floor


# precision label -> (weight bits, act bits, group size, kv bits, kv_zeros)
PRECISIONS = {
    "w4a8kv4": (4, 8, -1, 4, True), "w4a8kv4-g128": (4, 8, 128, 4, True),
    "w4a8kv8": (4, 8, -1, 8, True), "w8a8kv8": (8, 8, -1, 8, True),
    "w16a16kv8": (16, 16, -1, 8, True), "w16a16kv16": (16, 16, -1, 16, True),
    "w8a8kv8-pt": (8, 8, -1, 8, False),
}


def spec_label(spec) -> str:
    g = f"-g{spec.group_size}" if spec.group_size > 0 else ""
    pt = "" if spec.kv_zeros or spec.kv_bits == 16 else "-pt"
    return f"w{spec.weight_bits}a{spec.act_bits}kv{spec.kv_bits}{g}{pt}"


def forward_pool(spec, n_pages, dev, kv_scales=None):
    """The retrieval pool a ``CacheEngine`` builds for ``spec``, per-tensor
    scales loaded through ``CacheEngine.load_kv_scales``, the route a
    checkpoint's take (``ModelRunner.load_params(kv_scales=)``)."""
    from types import SimpleNamespace

    from omniserve_tpu_torch.worker.cache_engine import CacheEngine

    engine = CacheEngine(
        SimpleNamespace(kv_cache_bits=spec.kv_bits, kv_zeros=spec.kv_zeros),
        SimpleNamespace(page_size=spec.page_size,
                        num_retrieval_device_blocks=n_pages,
                        num_streaming_device_blocks=0),
        num_layers=spec.num_layers, num_kv_heads=spec.num_kv_heads,
        head_dim=spec.head_dim, device=dev)
    if kv_scales is not None:
        engine.load_kv_scales(kv_scales)
    return engine.retrieval_pool


def calibrate_kv_scales(spec, params, batch, n_pages, dev):
    """Per-layer per-tensor K and V scales, max |x| / qmax of the K and V a
    prefill of ``batch`` writes (read from a kv16 twin of the pool): the
    calibration a checkpoint's scales come from."""
    import torch

    from omniserve_tpu_torch.models import llama

    twin = dataclasses.replace(spec, kv_bits=16, kv_zeros=True)
    pool = forward_pool(twin, n_pages, dev)
    with torch.inference_mode():
        llama.llama_forward(params, pool, None, batch, twin, is_prefill=True)
    qmax = 7 if spec.kv_bits == 4 else 127
    return tuple(x.flatten(1).float().abs().amax(dim=1) / qmax
                 for x in (pool.k_data, pool.v_data))


def precision_spec(precision, num_layers=2, geometry=None):
    """The widths of ``geometry`` (a config of this file; Llama-3-8B's by
    default) at ``num_layers`` layers and one precision of ``PRECISIONS``
    (a w8a8 lm_head; the QKV bias where the config is Qwen2's)."""
    from omniserve_tpu_torch.models import llama

    g = LLAMA3_8B if geometry is None else geometry
    wb, ab, gs, kv, zeros = PRECISIONS[precision]
    return llama.LlamaSpec(
        num_layers=num_layers, hidden=g["hidden_size"],
        intermediate=g["intermediate_size"],
        num_q_heads=g["num_attention_heads"],
        num_kv_heads=g["num_key_value_heads"], head_dim=head_dim_of(g),
        vocab=g["vocab_size"], rope_base=g["rope_theta"],
        rms_eps=g["rms_norm_eps"], page_size=128, lm_head_bits=8,
        weight_bits=wb, act_bits=ab, group_size=gs, kv_bits=kv,
        kv_zeros=zeros, attn_bias=g["model_type"] == "qwen2",
    )


def forward_batch(spec, dev):
    """Phase 3's prompts (700, 333 and 1024 tokens from a seed) as one
    whole-prompt prefill batch: (prompts, tables, batch, pages needed)."""
    import torch

    from omniserve_tpu_torch.models import llama

    lens = [700, 333, 1024]
    rng = torch.Generator(device="cpu").manual_seed(2)
    prompts = [torch.randint(0, spec.vocab, (n,), generator=rng) for n in lens]
    w = max((n + 1 + 127) // 128 for n in lens)
    tables = torch.arange(len(lens) * w, dtype=torch.int32).view(len(lens), w)
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32)
                     for i, n in enumerate(lens)])
    pos = torch.cat([torch.arange(n, dtype=torch.int32) for n in lens])
    last = torch.tensor(lens).cumsum(0) - 1
    pre = llama.PrefillBatch(
        token_ids=torch.cat(prompts).to(dev), positions=pos.to(dev),
        segment_ids=seg.to(dev), block_tables=tables.to(dev),
        last_token_idx=last.to(dev),
    )
    return prompts, tables, pre, len(lens) * w + 1


def next_decode_batch(logits, prompts, tables, dev):
    """One decode step of every prompt from the next tokens ``logits``
    pick."""
    import torch

    from omniserve_tpu_torch.models import llama

    return llama.DecodeBatch(
        token_ids=logits.argmax(-1),
        positions=torch.tensor([len(p) for p in prompts],
                               dtype=torch.int32).to(dev),
        block_tables=tables.to(dev),
        active=torch.ones(len(prompts), dtype=torch.bool, device=dev),
    )


def check_forward(dev, precision="w4a8kv4", with_floor=False, family=None):
    """Whole-prompt prefill and one decode step of a 2-layer full-width
    forward (Llama-3-8B's widths, or those of phase 12's ``family``),
    kernels against plain (``with_floor``: the gate of a body whose logits
    move under one-ulp attention nudges). A biased spec's plain forward
    without its bias must move the prefill logits by more than the kernels
    do. Returns (spec, params, prompts, tables, kv_scales)."""
    import torch

    from omniserve_tpu_torch.models import llama

    spec = precision_spec(precision, geometry=None if family is None else {
        **FAMILIES, **D64_FAMILIES}[family][0])
    label = precision if family is None else f"{family} {precision}"
    params = llama.make_random_packed_params(spec, seed=1, device=dev)
    prompts, tables, pre, n_pages = forward_batch(spec, dev)
    lens = [len(p) for p in prompts]
    kv, zeros = spec.kv_bits, spec.kv_zeros
    kv_scales = None
    if kv < 16 and not zeros:
        kv_scales = calibrate_kv_scales(spec, params, pre, n_pages, dev)
        log(f"  forward {label}: calibrated K scales "
            f"{[round(float(x), 6) for x in kv_scales[0]]}, V scales "
            f"{[round(float(x), 6) for x in kv_scales[1]]}")
    results = {}
    modes = ("kernels", "plain") + (("floor",) if with_floor else ())
    for mode in modes:
        pool = forward_pool(spec, n_pages, dev, kv_scales)
        with _mode_ctx(mode), torch.inference_mode():
            t0 = time.time()
            lp, pool, _, _ = llama.llama_forward(params, pool, None, pre,
                                                 spec, is_prefill=True)
            sync(dev)
            t_pre = time.time() - t0
            results[mode] = dict(prefill=lp, pool=pool, t_pre=t_pre)
    if with_floor:
        share = flash_flip_share(spec, params, pre)
        log(f"  forward {label}: flash prefill's bf16 outputs differ "
            f"from the plain version's in {share:.3g} of layer 0's "
            f"elements (floor nudge rate {ATTN_ULP_RATE:g})")
    # one decode step from the same next tokens
    dec = next_decode_batch(results["plain"]["prefill"], prompts, tables,
                            dev)
    for mode in modes:
        with _mode_ctx(mode), torch.inference_mode():
            ld, _, _, _ = llama.llama_forward(params, results[mode]["pool"],
                                              None, dec, spec,
                                              is_prefill=False)
            results[mode]["decode"] = ld
    for step in ("prefill", "decode"):
        a, b_ = results["kernels"][step], results["plain"][step]
        if not bool(torch.isfinite(a).all()) or a.shape != (len(lens),
                                                            spec.vocab):
            raise AssertionError(f"forward {label} {step}: bad logits "
                                 f"{a.shape}")
        scale = float(b_.abs().max())
        err = float((a - b_).abs().max())
        agree = float((a.argmax(-1) == b_.argmax(-1)).float().mean())
        by_results = {m: {step: results[m][step]} for m in modes}
        rtol, floor = logits_bound(by_results, step, scale, with_floor)
        log(f"  forward {label} 2 layers {step}: max |logit| "
            f"{scale:.4g}, max abs "
            f"diff kernels vs plain {err:.4g} ({err / scale:.3g} of max), "
            f"argmax agreement {agree:.2f}"
            + ("" if floor is None else
               f"; floor {floor:.3g} of max, bound {rtol:.3g}"))
        if err > rtol * scale:
            raise AssertionError(f"forward {label} {step}: logits differ "
                                 f"by {err} > "
                                 f"{rtol} x {scale}")
    if spec.attn_bias:     # the bias is in both runs: leaving it out shows
        unbiased = dataclasses.replace(spec, attn_bias=False)
        with _mode_ctx("plain"), torch.inference_mode():
            lu, _, _, _ = llama.llama_forward(
                params, forward_pool(spec, n_pages, dev, kv_scales), None,
                pre, unbiased, is_prefill=True)
        b_, a = results["plain"]["prefill"], results["kernels"]["prefill"]
        scale = float(b_.abs().max())
        moved = float((lu - b_).abs().max()) / scale
        err = float((a - b_).abs().max()) / scale
        log(f"  forward {label}: the QKV bias left out moves the prefill "
            f"logits by {moved:.3g} of max (kernels vs plain {err:.3g})")
        if moved <= err:
            raise AssertionError(f"forward {label}: the bias moves the "
                                 f"logits by {moved} <= the kernels' {err}")
        del lu
    kp, pp = results["kernels"]["pool"], results["plain"]["pool"]
    diff = float((kp.k_data != pp.k_data).float().mean())
    log(f"  forward {label} pools: fraction of K code bytes that differ "
        f"{diff:.3g} (layer 0 identical: "
        f"{bool(torch.equal(kp.k_data[0], pp.k_data[0]))})")
    log(f"  logits tolerance: {LOGITS_RTOL} x max|logit| -- the two runs "
        "share every integer GEMM bit for bit but attention sums in another "
        "order (bf16 outputs can differ by one ulp), and the next int8 "
        "activation quantization turns such a ulp into a code step of "
        "1/127 of the row max on a few elements")
    log(f"  {label} prefill wall (2 layers, T={sum(lens)}): kernels "
        f"{results['kernels']['t_pre'] * 1e3:.1f} ms, plain "
        f"{results['plain']['t_pre'] * 1e3:.1f} ms (first call, host clock)")
    return spec, params, [p.tolist() for p in prompts], tables, kv_scales


def check_chunked_forward(dev, spec, params, prompts, tables,
                          with_floor=False, kv_scales=None):
    """The same prompts prefilled in [4, 512] chunks (the runner's geometry
    for a 2048-token budget): the 700- and 1024-token prompts take two
    chunks, the second attending the first through the paged pool. Kernels
    against plain versions; returns the kernels' pool and next tokens."""
    import torch

    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.worker.model_runner import chunked_prefill_batches

    seqs = [(p, tables[i].tolist()) for i, p in enumerate(prompts)]
    results = {}
    modes = ("kernels", "plain") + (("floor",) if with_floor else ())
    for mode in modes:
        pool = forward_pool(spec, tables.numel() + 1, dev, kv_scales)
        final, n_chunks = None, 0
        with _mode_ctx(mode), torch.inference_mode():
            for batch, ends in chunked_prefill_batches(seqs, 2048,
                                                       spec.page_size, dev):
                logits, _, _, _ = llama.llama_forward(
                    params, pool, None, batch, spec, is_prefill=True)
                final = logits if final is None else torch.where(
                    ends[:, None], logits, final)
                n_chunks += 1
        results[mode] = (final[: len(seqs)], pool)
    if n_chunks != 2:
        raise AssertionError(f"chunked prefill ran {n_chunks} chunks, not 2")
    a, b_ = results["kernels"][0], results["plain"][0]
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("chunked prefill: non-finite logits")
    scale = float(b_.abs().max())
    err = float((a - b_).abs().max())
    rtol, floor = logits_bound({m: {0: results[m][0]} for m in modes}, 0,
                               scale, with_floor)
    log(f"  chunked prefill {spec_label(spec)} 2 layers, 2 chunks of "
        f"[4, 512]: max |logit| "
        f"{scale:.4g}, max abs diff kernels vs plain {err:.4g} "
        f"({err / scale:.3g} of max), argmax agreement "
        f"{float((a.argmax(-1) == b_.argmax(-1)).float().mean()):.2f}"
        + ("" if floor is None else
           f"; floor {floor:.3g} of max, bound {rtol:.3g}"))
    if err > rtol * scale:
        raise AssertionError(f"chunked prefill {spec_label(spec)}: logits "
                             f"differ by {err} > "
                             f"{rtol} x {scale}")
    return results["kernels"][1], a.argmax(-1)


def check_window(dev, spec, params, pool, tables, lens, first, n_steps=8,
                 spool=None, stables=None):
    """An ``n_steps`` greedy window over the prefilled pool(s): replays of
    the captured decode step(s) against the eager loop of the same step on
    copies of the pools. Tokens, pool bytes and, under sparse decode, K
    stats and the page selection must be equal."""
    import numpy as np
    import torch

    from omniserve_tpu_torch.worker.decode_window import DecodeWindow
    from omniserve_tpu_torch.worker.model_runner import table_width

    n, b_pad = len(lens), 8
    w = table_width([[0] * tables.shape[1]])
    bt = np.zeros((b_pad, w), np.int32)
    bt[:n, : tables.shape[1]] = tables.numpy()
    tokens = np.zeros(b_pad, np.int32)
    tokens[:n] = first.cpu().numpy()
    positions = np.zeros(b_pad, np.int32)
    positions[:n] = lens
    active = np.arange(b_pad) < n
    sparse = spec.sparse_decode
    st = None
    if sparse:
        st = np.zeros((b_pad, stables.shape[1]), np.int32)
        st[:n] = stables.numpy()
    twins = {"graph": (pool, spool),
             "eager": (pool.clone(), None if spool is None else spool.clone())}
    out, sels = {}, {}
    with torch.inference_mode():
        for mode, (rp, sp) in twins.items():
            sel = torch.full(
                (spec.num_layers, b_pad, spec.num_kv_heads,
                 spec.budget_pages), -1, dtype=torch.int32,
                device=dev) if sparse else None
            win = DecodeWindow(params, rp, spec, b_pad, w, dev,
                               use_graph=mode == "graph", streaming_pool=sp,
                               page_idxes=sel)
            win.load(tokens, positions, active, bt, st)
            out[mode] = win.run(n_steps, refresh_first=sparse)[:, :n].cpu()
            sels[mode] = sel
            if mode == "graph":
                capture_s, n_graphs = win.capture_s, len(win.graphs)
                refreshes = win.refreshes_in(n_steps, sparse)
    if not torch.equal(out["graph"], out["eager"]):
        raise AssertionError(f"window: graph tokens {out['graph'].tolist()} "
                             f"!= eager {out['eager'].tolist()}")
    if sparse and not torch.equal(sels["graph"][:, :n], sels["eager"][:, :n]):
        raise AssertionError("window: page selection differs between graph "
                             "and eager")
    for a_pool, b_pool in zip(twins["graph"], twins["eager"]):
        if a_pool is not None:
            # all but the trash page, which takes the inactive rows' writes
            pools_equal(a_pool, b_pool, "window (graph against eager)",
                        skip_trash=True)
    log(f"  window {n_steps} steps x {n} rows (b_pad {b_pad}, table width "
        f"{w}): graph replay tokens == eager loop tokens, pools equal"
        f"{f', selections equal, {refreshes} refresh steps' if sparse else ''}"
        f"; {n_graphs} graph(s) captured in {capture_s:.2f} s")


def sparse_precision(spec, precision):
    """``spec`` at one precision of ``PRECISIONS`` (body and KV pool)."""
    wb, ab, gs, kv, zeros = PRECISIONS[precision]
    return dataclasses.replace(spec, weight_bits=wb, act_bits=ab,
                               group_size=gs, kv_bits=kv, kv_zeros=zeros)


def sparse_pools(spec, n_pages, n_stream_pages, dev, kv_scales=None):
    """The retrieval pool (K stats) and the streaming pool of a 2-layer
    LServe forward at ``spec``'s KV mode, 4 pool heads each; per-tensor
    pools take ``kv_scales`` as ``CacheEngine.load_kv_scales`` gives both
    pools the same."""
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool

    kv = dict(kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros, device=dev)
    heads = spec.num_kv_heads // 2
    pools = (make_kv_pool(2, n_pages, heads, 128, spec.head_dim,
                          with_stats=True, **kv),
             make_kv_pool(2, n_stream_pages, heads, 128, spec.head_dim,
                          **kv))
    for pool in pools:
        if kv_scales is not None and pool.k_scale_per_tensor is not None:
            pool.k_scale_per_tensor.copy_(kv_scales[0])
            pool.v_scale_per_tensor.copy_(kv_scales[1])
    return pools


# attention entry points a sparse forward's floor nudges
SPARSE_NUDGED = ("prefill_attention", "paged_prefill_attention",
                 "paged_decode_attention")


@contextlib.contextmanager
def held_decode_calls(tol, label):
    """Within the block, every decode attention call of the dispatch (rows
    6 / 4 / 5 through ``paged_decode_attention``) is held against its
    plain version on the same inputs (``tol`` and 1e-2 of each row's
    norm), and every two-pool append against the plain appends on copies
    of its pools (bytes, planes and stats equal but the trash page). The
    dict yielded counts the calls held and the share of attention outputs
    that differ from the plain version's."""
    import torch

    from omniserve_tpu_torch.ops import cuda, dispatch

    attn, append = dispatch.paged_decode_attention, \
        dispatch.append_kv_decode_pools
    seen = {"attention": 0, "appends": 0, "moved": 0, "outputs": 0}

    def held_attn(q, pool, layer, *a, **k):
        out = attn(q, pool, layer, *a, **k)
        with cuda.plain_versions():
            want = attn(q, pool, layer, *a, **k)
        hold(out, want, tol, tol, ATTN_ROW_RTOL,
             f"{label} decode attention, layer {layer}")
        seen["attention"] += 1
        seen["moved"] += int((out != want).sum())
        seen["outputs"] += out.numel()
        return out

    def held_append(rp, sp, layer, *a, **k):
        twins = (rp.clone(), None if sp is None else sp.clone())
        with cuda.plain_versions():
            append(*twins, layer, *a, **k)
        out = append(rp, sp, layer, *a, **k)
        for got, want in zip((rp, sp), twins):
            if got is not None:
                pools_equal(got, want, f"{label} append, layer {layer}",
                            skip_trash=True)
        seen["appends"] += 1
        return out

    dispatch.paged_decode_attention = held_attn
    dispatch.append_kv_decode_pools = held_append
    try:
        yield seen
    finally:
        dispatch.paged_decode_attention = attn
        dispatch.append_kv_decode_pools = append


def check_sparse_forward(dev, precision="w4a8kv4", geometry=None,
                         per_call=False):
    """LServe's decode side at full width, 2 layers: 4 of the 8 kv heads
    keep their history in the retrieval pool (K stats, a budget of 4 pages
    so the selector drops pages of the 9-page prompt), 4 live in the
    streaming ring (1 sink + 2 ring pages, wrapped by every prompt). A
    whole-prompt prefill into both pools and two decode steps (a refresh
    step, a reuse step), kernels against plain versions (a W16A16 body's
    decode steps from the plain prefill's pools); then, at w4a8kv4 and
    w16a16kv16, a 10-step window against the eager loop. Other
    ``PRECISIONS`` (kv8, per-tensor KV with scales calibrated on a dense
    kv16 twin) run the forwards, a W8A8 body at its floor's gate.
    ``geometry``: another config's widths (Llama-3-8B's by default).
    ``per_call``: the decode steps' gate is each decode call's, held in
    place against its plain version on the same inputs
    (``held_decode_calls``), and their logits' gap to the plain run is
    logged (a 2-layer random model at Llama-3.2-1B's widths moves its
    decode logits by 0.67 of max |logit| when 30% of the decode attention
    outputs move by one bf16 ulp: PERF.md §7)."""
    import numpy as np
    import torch

    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.ops import cuda

    g = LLAMA3_8B if geometry is None else geometry
    hkv = g["num_key_value_heads"]
    spec = sparse_precision(llama.LlamaSpec(
        num_layers=2, hidden=g["hidden_size"],
        intermediate=g["intermediate_size"],
        num_q_heads=g["num_attention_heads"], num_kv_heads=hkv,
        head_dim=head_dim_of(g),
        vocab=g["vocab_size"], rope_base=g["rope_theta"], page_size=128,
        lm_head_bits=8, sparse_decode=True, sink_blocks=1, local_blocks=2,
        dec_sink_tokens=128, dec_local_tokens=256, sub_chunks=4,
        budget_pages=4, selector_interval=4,
    ), precision)
    suffix = kv_suffix(spec.kv_bits, not spec.kv_zeros)
    flags = np.zeros((2, hkv), bool)
    flags[:, : hkv // 2] = True
    params = llama.make_random_packed_params(spec, seed=1, device=dev,
                                             retrieval_flags=flags)
    lens = [700, 1150, 1024]
    n = len(lens)
    rng = torch.Generator(device="cpu").manual_seed(2)
    prompts = [torch.randint(0, spec.vocab, (m,), generator=rng) for m in lens]
    w = max((m + 16 + 127) // 128 for m in lens)
    tables = torch.arange(n * w, dtype=torch.int32).view(n, w)
    stables = torch.arange(n * 3, dtype=torch.int32).view(n, 3)
    pre = llama.PrefillBatch(
        token_ids=torch.cat(prompts).to(dev),
        positions=torch.cat([torch.arange(m, dtype=torch.int32)
                             for m in lens]).to(dev),
        segment_ids=torch.cat([torch.full((m,), i, dtype=torch.int32)
                               for i, m in enumerate(lens)]).to(dev),
        block_tables=tables.to(dev),
        last_token_idx=(torch.tensor(lens).cumsum(0) - 1).to(dev),
        seq_lens=torch.tensor(lens, dtype=torch.int32).to(dev),
        streaming_block_tables=stables.to(dev),
        new_page_ids=tables.reshape(-1).to(dev),
    )
    kv_scales = None
    if not spec.kv_zeros:     # calibrated on a dense kv16 twin
        kv_scales = calibrate_kv_scales(
            dataclasses.replace(spec, sparse_decode=False), params, pre,
            n * w + 1, dev)
    modes = ("kernels", "plain") + (("floor",) if spec.weight_bits == 8
                                    else ())
    runs = {}
    for mode in modes:
        rp, sp = sparse_pools(spec, n * w + 1, n * 3 + 1, dev, kv_scales)
        with _mode_ctx(mode, SPARSE_NUDGED), torch.inference_mode():
            lp, _, _, _ = llama.llama_forward(params, rp, sp, pre, spec,
                                              is_prefill=True)
        runs[mode] = dict(prefill=lp, pools=(rp, sp))
    if spec.weight_bits == 16 or spec.head_dim != 128:
        # a random W16A16 body carries the prefill's one-ulp attention
        # differences into the K / V it writes (~0.2 of the K values of
        # phase 3's dense w16a16kv16 forward differ) and so into the K
        # stats the selector ranks: the decode steps start from copies of
        # the plain run's pools, and compare the decode path itself. So
        # does any body at head_dim 64 (Llama-3.2-1B's W8A8 body: its
        # prefill within the gate, its first decode step 0.14 of max
        # |logit| off the plain run's from the kernels' own pools, whose
        # K stats rank other pages)
        for mode in modes:
            if mode != "plain":
                runs[mode]["pools"] = tuple(
                    p.clone() for p in runs["plain"]["pools"])
    nxt = runs["plain"]["prefill"].argmax(-1)
    positions = torch.tensor(lens, dtype=torch.int32).to(dev)
    per_layer = dict.fromkeys(lserve_decode_names(suffix, spec.head_dim), 1)
    for step, refresh in enumerate((True, False)):
        for mode in modes:
            rp, sp = runs[mode]["pools"]
            sel = runs[mode].get("sel")
            if sel is None:
                sel = torch.full((2, n, hkv, spec.budget_pages), -1,
                                 dtype=torch.int32, device=dev)
            dec = llama.DecodeBatch(
                token_ids=nxt, positions=positions + step,
                block_tables=tables.to(dev),
                active=torch.ones(n, dtype=torch.bool, device=dev),
                streaming_block_tables=stables.to(dev),
                new_page_ids=torch.full((1,), -1, dtype=torch.int32,
                                        device=dev),
                refresh_selection=refresh, cached_page_idxes=sel,
            )
            before = dict(cuda.LAUNCHES)
            held = (held_decode_calls(
                KV16_TOL if spec.kv_bits == 16 else 5e-2,
                f"sparse forward {precision} D={spec.head_dim} decode{step}")
                if per_call and mode == "kernels"
                else contextlib.nullcontext())
            with _mode_ctx(mode, SPARSE_NUDGED), torch.inference_mode(), \
                    held as calls:
                ld, _, _, new_sel = llama.llama_forward(
                    params, rp, sp, dec, spec, is_prefill=False)
            if calls is not None:
                if calls["attention"] != spec.num_layers or \
                        calls["appends"] != spec.num_layers:
                    raise AssertionError(f"decode step held {calls}")
                log(f"  sparse forward {precision} D={spec.head_dim} "
                    f"decode{step}: {calls['attention']} decode attention "
                    f"calls held against their plain versions (gate "
                    f"{KV16_TOL if spec.kv_bits == 16 else 5e-2}, rows "
                    f"{ATTN_ROW_RTOL}), {calls['appends']} two-pool appends "
                    f"equal; {calls['moved'] / calls['outputs']:.3f} of the "
                    f"attention outputs differ from the plain version's")
            runs[mode]["sel"] = new_sel
            runs[mode][f"decode{step}"] = ld
            if mode == "kernels":
                ticks = {k: cuda.LAUNCHES[k] - before[k] for k in per_layer}
                if ticks != {k: n * spec.num_layers
                             for k, n in per_layer.items()}:
                    raise AssertionError(f"sparse decode step launched "
                                         f"{ticks}")
        nxt = runs["plain"][f"decode{step}"].argmax(-1)
    results = {mode: {st: runs[mode][st] for st in
                      ("prefill", "decode0", "decode1")} for mode in modes}
    for step in ("prefill", "decode0", "decode1"):
        a, b_ = runs["kernels"][step], runs["plain"][step]
        if not bool(torch.isfinite(a).all()) or a.shape != (n, spec.vocab):
            raise AssertionError(f"sparse forward {step}: bad logits")
        scale = float(b_.abs().max())
        err = float((a - b_).abs().max())
        bound, floor = logits_bound(results, step, scale,
                                    spec.weight_bits == 8)
        note = "" if floor is None else f"; floor {floor:.3g}, bound {bound:.3g}"
        held = per_call and step != "prefill"
        log(f"  sparse forward 2 layers {precision} D={spec.head_dim} "
            f"{step}: max |logit| "
            f"{scale:.4g}, max abs diff kernels vs plain {err:.4g} "
            f"({err / scale:.3g} of max{note}), argmax agreement "
            f"{float((a.argmax(-1) == b_.argmax(-1)).float().mean()):.2f}"
            + ("; gated per call above" if held else ""))
        if err > bound * scale and not held:
            raise AssertionError(f"sparse forward {precision} {step}: logits "
                                 f"differ by {err} > {bound} x {scale}")
    ks, ps = runs["kernels"]["sel"], runs["plain"]["sel"]
    same = float((ks.sort(-1).values == ps.sort(-1).values).float().mean())
    used = int((ks[:, 1, 0] >= 0).sum(-1).min())
    log(f"  selections [L, B, Hkv, budget] {tuple(ks.shape)}: kernels' and "
        f"plain runs' picks agree on {same:.3f} of entries (their K stats "
        f"come from pools that differ in a few codes); the 9-page prompt "
        f"keeps {used} pages per retrieval head")
    if used != spec.budget_pages or same < 0.9:
        raise AssertionError("sparse forward: selection did not fill its "
                             "budget or strays from the plain run's")
    if precision not in ("w4a8kv4", "w16a16kv16"):
        return
    rp, sp = runs["kernels"]["pools"]
    first = runs["kernels"]["decode1"].argmax(-1)
    check_window(dev, spec, params, rp, tables, [m + 2 for m in lens], first,
                 n_steps=10, spool=sp, stables=stables)


def check_sparse_prefill_forward(dev, precision="w4a8kv4"):
    """LServe's prefill side at full width, 2 layers, both sparse modes: 4
    of the 8 kv heads stream with a ctx band of 128 sink + 256 local tokens
    over a 1 + 4 page ring (a 256-token chunk beside the local window).
    The same three prompts (700, 1150, 1024 tokens) prefill whole (flash
    band) and in [4, 256] chunks (retrieval heads dense over the paged
    history, streaming heads through the ring, which the longer prompts
    wrap), each with kernels against plain versions; the chunked run must
    launch the ring mode once per layer and chunk. Other ``PRECISIONS``
    (kv8, per-tensor KV with scales calibrated on a dense kv16 twin) the
    same, a W8A8 body at its floor's gate."""
    import numpy as np
    import torch

    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.worker.model_runner import chunked_prefill_batches

    g = LLAMA3_8B
    hkv = g["num_key_value_heads"]
    spec = sparse_precision(llama.LlamaSpec(
        num_layers=2, hidden=g["hidden_size"],
        intermediate=g["intermediate_size"],
        num_q_heads=g["num_attention_heads"], num_kv_heads=hkv, head_dim=128,
        vocab=g["vocab_size"], rope_base=g["rope_theta"], page_size=128,
        lm_head_bits=8, sparse_decode=True, sink_blocks=1, local_blocks=4,
        dec_sink_tokens=128, dec_local_tokens=256, sub_chunks=4,
        budget_pages=4, sparse_prefill=True, ctx_sink=128, ctx_local=256,
    ), precision)
    suffix = kv_suffix(spec.kv_bits, not spec.kv_zeros)
    dense_name = dense_prefill_name(suffix)
    flags = np.zeros((2, hkv), bool)
    flags[:, ::2] = True
    params = llama.make_random_packed_params(spec, seed=3, device=dev,
                                             retrieval_flags=flags)
    lens = [700, 1150, 1024]
    n = len(lens)
    rng = torch.Generator(device="cpu").manual_seed(4)
    prompts = [torch.randint(0, spec.vocab, (m,), generator=rng) for m in lens]
    w = max((m + 127) // 128 for m in lens)
    tables = torch.arange(n * w, dtype=torch.int32).view(n, w)
    stables = torch.arange(n * 5, dtype=torch.int32).view(n, 5)
    whole = llama.PrefillBatch(
        token_ids=torch.cat(prompts).to(dev),
        positions=torch.cat([torch.arange(m, dtype=torch.int32)
                             for m in lens]).to(dev),
        segment_ids=torch.cat([torch.full((m,), i, dtype=torch.int32)
                               for i, m in enumerate(lens)]).to(dev),
        block_tables=tables.to(dev),
        last_token_idx=(torch.tensor(lens).cumsum(0) - 1).to(dev),
        seq_lens=torch.tensor(lens, dtype=torch.int32).to(dev),
        streaming_block_tables=stables.to(dev),
        new_page_ids=tables.reshape(-1).to(dev),
    )
    seqs = [(p.tolist(), tables[i].tolist()) for i, p in enumerate(prompts)]
    kv_scales = None
    if not spec.kv_zeros:     # calibrated on a dense kv16 twin
        kv_scales = calibrate_kv_scales(
            dataclasses.replace(spec, sparse_decode=False,
                                sparse_prefill=False),
            params, whole, n * w + 1, dev)
    modes = ("kernels", "plain") + (("floor",) if spec.weight_bits == 8
                                    else ())
    out = {}
    for path in ("whole", "chunked"):
        for mode in modes:
            rp, sp = sparse_pools(spec, n * w + 1, n * 5 + 1, dev, kv_scales)
            cuda.reset_launch_counts()
            with _mode_ctx(mode, SPARSE_NUDGED), torch.inference_mode():
                if path == "whole":
                    logits = llama.llama_forward(params, rp, sp, whole, spec,
                                                 is_prefill=True)[0]
                    n_chunks = 1
                else:
                    logits, n_chunks = None, 0
                    for batch, ends in chunked_prefill_batches(
                            seqs, 2048, 128, dev, with_stats=True,
                            streaming_tables=stables.tolist(),
                            ring=(1, 4, 256)):
                        lg = llama.llama_forward(params, rp, sp, batch, spec,
                                                 is_prefill=True)[0]
                        logits = lg if logits is None else torch.where(
                            ends[:, None], lg, logits)
                        n_chunks += 1
                    logits = logits[:n]
            out[(path, mode)] = logits
            if mode == "kernels":
                want = ({"flash_prefill_band": 2} if path == "whole" else
                        {"paged_prefill_ring" + suffix: 2 * n_chunks,
                         dense_name: 2 * n_chunks})
                got = {k: cuda.LAUNCHES[k] for k in want}
                if got != want:
                    raise AssertionError(f"sparse prefill {path}: launches "
                                         f"{got}, expected {want}")
        a, b_ = out[(path, "kernels")], out[(path, "plain")]
        if not bool(torch.isfinite(a).all()) or a.shape != (n, spec.vocab):
            raise AssertionError(f"sparse prefill {path}: bad logits")
        scale = float(b_.abs().max())
        err = float((a - b_).abs().max())
        bound, floor = logits_bound(
            {m: {path: out[(path, m)]} for m in modes}, path, scale,
            spec.weight_bits == 8)
        note = "" if floor is None else f"; floor {floor:.3g}, bound {bound:.3g}"
        log(f"  sparse prefill 2 layers {precision}, {path} ({n_chunks} "
            f"chunk(s)): max |logit| {scale:.4g}, max abs diff kernels vs "
            f"plain {err:.4g} ({err / scale:.3g} of max{note}), argmax "
            f"agreement "
            f"{float((a.argmax(-1) == b_.argmax(-1)).float().mean()):.2f}")
        if err > bound * scale:
            raise AssertionError(f"sparse prefill {precision} {path}: logits "
                                 f"differ by {err} > {bound} x {scale}")
    if n_chunks != 5:
        raise AssertionError(f"chunked sparse prefill ran {n_chunks} chunks")
    a, b_ = out[("chunked", "plain")], out[("whole", "plain")]
    log(f"  sparse prefill plain versions, chunked vs whole prompt: max abs "
        f"diff {float((a - b_).abs().max()):.4g} of max |logit| "
        f"{float(b_.abs().max()):.4g} (the chunks read earlier chunks' K/V "
        f"back through the kv{spec.kv_bits} pool)")


def check_precision_forwards(dev):
    """The precision matrix at full width, depth 2: whole-prompt prefill,
    a decode step and a chunked prefill, kernels against plain, for each of
    w4a8kv4-g128, w4a8kv8, w8a8kv8, w16a16kv8, w16a16kv16 and w8a8kv8
    per-tensor (calibrated scales through ``CacheEngine.load_kv_scales``);
    an 8-step graph window against the eager loop for the g128, kv8, kv16
    and per-tensor pools. Each run must launch its body's GEMM and its
    pool's attention kernels."""
    import torch

    from omniserve_tpu_torch.ops import cuda

    want = {
        "w4a8kv4-g128": ("w4a8_matmul_per_group", "paged_prefill_attention",
                         "decode_attention_append"),
        "w4a8kv8": ("w4a8_matmul_per_channel", "paged_prefill_kv8",
                    "decode_attention_append_kv8"),
        "w8a8kv8": ("w8a8_matmul", "paged_prefill_kv8",
                    "decode_attention_append_kv8"),
        "w16a16kv8": ("paged_prefill_kv8", "decode_attention_append_kv8"),
        "w16a16kv16": ("paged_prefill_kv16", "kv_append_decode_kv16",
                       "paged_mqa_attention_kv16"),
        "w8a8kv8-pt": ("w8a8_matmul", "paged_prefill_pt",
                       "decode_attention_append_pt"),
    }
    windowed = ("w4a8kv4-g128", "w4a8kv8", "w16a16kv16", "w8a8kv8-pt")
    for precision, kernels in want.items():
        cuda.reset_launch_counts()
        spec, params, prompts, tables, kv_scales = check_forward(
            dev, precision, with_floor=True)
        pool, first = check_chunked_forward(dev, spec, params, prompts,
                                            tables, with_floor=True,
                                            kv_scales=kv_scales)
        if precision in windowed:
            check_window(dev, spec, params, pool, tables,
                         [len(p) for p in prompts], first)
        idle = [k for k in kernels if cuda.LAUNCHES[k] <= 0]
        if idle:
            raise AssertionError(f"{precision} forwards launched no {idle}")
        del spec, params, pool
        gc.collect()
        torch.cuda.empty_cache()


# the kernels phase 12's models launch in a 2-layer whole-prompt and
# chunked forward (Yi-34B's decode step at n_rep 7, Qwen1.5-72B's at 1)
FAMILY_FORWARD_KERNELS = ("w4a8_matmul_per_channel", "w8a8_matmul",
                          "flash_prefill", "paged_prefill_attention",
                          "decode_attention_append")


def check_family_forwards(dev, families=FAMILIES,
                          kernels=FAMILY_FORWARD_KERNELS):
    """Phase 12's models (or ``families``) at full width, depth 2, w4a8kv4:
    whole-prompt prefill, a decode step and a chunked prefill, kernels
    against plain (Qwen1.5-72B with its QKV bias, whose effect must show);
    each run must launch ``kernels``."""
    import torch

    from omniserve_tpu_torch.ops import cuda

    for family in families:
        cuda.reset_launch_counts()
        spec, params, prompts, tables, _ = check_forward(dev, family=family)
        check_chunked_forward(dev, spec, params, prompts, tables)
        idle = [k for k in kernels if cuda.LAUNCHES[k] <= 0]
        if idle:
            raise AssertionError(f"{family} forwards launched no {idle}")
        del spec, params
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the engine at full width
# ---------------------------------------------------------------------------


def write_model_dir(name: str = "llama3-8b", config=None) -> str:
    """A checkpoint-free model directory: ``config.json`` of LLAMA3_8B (or
    of ``config``)."""
    model_dir = os.path.join(ROOT, "build", "chip_smoke", name)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(LLAMA3_8B if config is None else config, f)
    return model_dir


def device_gib(dev, stat) -> float:
    return stat() / 2**30 if dev.type == "cuda" else float("nan")


ENGINE_KERNELS = ("w4a8_matmul_per_channel", "w8a8_matmul", "flash_prefill",
                  "decode_attention_append")


def run_engine(dev, model=("llama3-8b", LLAMA3_8B), kernels=ENGINE_KERNELS,
               profile=True):
    """The IFB engine, 8 requests x 1,024 prompt tokens, 32 greedy tokens
    each, whole-prompt prefill (row 9) and eager decode steps, at
    ``model`` = (directory name, config.json); each of ``kernels`` must
    launch. ``profile``: then one traced prefill and decode step."""
    import numpy as np
    import torch

    from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
    from omniserve_tpu_torch.ops import cuda

    n_req, prompt_len, gen_len, page = 8, 1024, 32, 128
    vocab = model[1]["vocab_size"]
    pages_per_seq = (prompt_len + gen_len + page - 1) // page
    t0 = time.time()
    engine = LLMEngine.from_engine_args(EngineArgs(
        model=write_model_dir(*model), precision="w4a8kv4",
        load_format="dummy",
        lm_head_precision="w8a8", tokenizer_mode="skip", device=str(dev),
        block_size=page, max_num_seqs=n_req,
        max_num_batched_tokens=2 * n_req * prompt_len,
        num_retrieval_blocks=n_req * pages_per_seq + 8,
        disable_log_stats=True, seed=0,
    ))
    sync(dev)
    log(f"  engine built in {time.time() - t0:.1f} s (random weights, "
        f"seed 0); device memory "
        f"{device_gib(dev, torch.cuda.memory_allocated):.2f} GiB")
    rng = np.random.default_rng(0)
    for i in range(n_req):
        engine.add_request(
            f"req{i}",
            prompt_token_ids=rng.integers(0, vocab, prompt_len).tolist(),
            sampling_params=SamplingParams(temperature=0.0,
                                           max_tokens=gen_len,
                                           ignore_eos=True),
        )
    cuda.reset_launch_counts()
    finished = {}
    step_times = []
    while engine.has_unfinished_requests():
        t0 = time.time()
        outs = engine.step()
        step_times.append(time.time() - t0)
        for o in outs:
            if o.finished:
                finished[o.request_id] = o
        if len(step_times) > 4 * gen_len:
            raise AssertionError("engine did not finish")
    launches = dict(cuda.LAUNCHES)
    if len(finished) != n_req:
        raise AssertionError(f"finished only {sorted(finished)}")
    for rid, o in finished.items():
        toks = o.outputs[0].token_ids
        lp = o.outputs[0].cumulative_logprob
        if len(toks) != gen_len or not math.isfinite(lp):
            raise AssertionError(f"{rid}: {len(toks)} tokens, logprob {lp}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{rid}: token out of vocab")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the engine: {missing}")
    prefill_s = step_times[0]
    decode_s = sum(step_times[1:])
    n_dec = len(step_times) - 1
    log(f"  engine: {n_req} requests x {prompt_len} prompt tokens, "
        f"{gen_len} greedy tokens each; steps {len(step_times)}")
    log(f"  engine prefill step {prefill_s * 1e3:.1f} ms "
        f"({n_req * prompt_len / prefill_s:.0f} prompt tok/s); decode "
        f"{n_dec} steps {decode_s * 1e3:.1f} ms = "
        f"{decode_s / max(n_dec, 1) * 1e3:.2f} ms/step, "
        f"{n_req * n_dec / decode_s:.1f} tok/s (host clock)")
    log(f"  engine launches: {json.dumps(launches)}")
    if dev.type == "cuda" and profile:
        profile_engine(engine, rng, n_req, prompt_len)
    return launches


def profile_engine(engine, rng, n_req, prompt_len, n_decode=3):
    """Where an engine step's time goes: one traced prefill step and
    ``n_decode`` traced decode steps of a fresh batch (after the measured
    run, so tracing costs it nothing). Prints each window's wall time, the
    device's busy time (sum of kernel and copy durations on the card) and
    idle share, and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from omniserve_tpu_torch import SamplingParams

    for i in range(n_req):
        engine.add_request(
            f"prof{i}",
            prompt_token_ids=rng.integers(0, LLAMA3_8B["vocab_size"],
                                          prompt_len).tolist(),
            sampling_params=SamplingParams(temperature=0.0,
                                           max_tokens=n_decode + 1,
                                           ignore_eos=True),
        )
    for window, n_steps in (("prefill", 1), ("decode", n_decode)):
        trace_steps(engine, window, n_steps)
    while engine.has_unfinished_requests():
        engine.step()


# the __global__ functions of omniserve_tpu_torch/csrc/*.cu
PORT_KERNEL_FUNCTIONS = ("int8_wgmma_kernel", "quant_gemm_kernel",
                         "flash_prefill_kernel", "flash_tile_ranges_kernel",
                         "paged_prefill_kernel", "decode_attn_list_kernel",
                         "decode_attn_kv16_kernel",
                         "decode_split_combine_kernel", "kv_append_kernel",
                         "prefill_single_pass_kernel", "embed_gather_kernel")

# the __global__ function each wrapper launches (by name prefix; the first
# match counts), named in the kernels line
WRAPPER_FUNCTIONS = (
    ("w4a8_matmul_per_channel", "int8_wgmma_kernel"),
    ("w4a8_matmul_per_group", "int8_wgmma_kernel"),
    ("w8a8_matmul", "int8_wgmma_kernel"),
    ("decode_attention_ph_kv16", "decode_attn_kv16_kernel"),
    ("decode_attention_band_kv16", "decode_attn_kv16_kernel"),
    ("decode_attention_", "decode_attn_list_kernel"),
    ("paged_mqa_attention_kv16", "decode_attn_kv16_kernel"),
    ("paged_mqa_attention", "decode_attn_list_kernel"),   # kv4 / kv8 pools
    ("flash_prefill", "flash_prefill_kernel"),
    ("paged_prefill_single_pass", "prefill_single_pass_kernel"),
    ("paged_prefill", "paged_prefill_kernel"),
    ("kv_append_decode", "kv_append_kernel"),
    ("embed_gather", "embed_gather_kernel"),
)


def kernel_function(name: str) -> str:
    return next(fn for prefix, fn in WRAPPER_FUNCTIONS
                if name.startswith(prefix))


def trace_steps(engine, label, n_steps):
    """``n_steps`` engine steps under ``torch.profiler``: prints the wall
    time, the device's busy time (sum of kernel and copy durations on the
    card) and idle share, and the kernels that take the most device time.
    Returns (the device events in start order, wall ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name = {}
    device_events = sorted((e for e in prof.events()
                            if e.device_type == DeviceType.CUDA),
                           key=lambda e: e.time_range.start)
    for e in device_events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(t for t, _ in by_name.values())
    n_kernels = sum(n for _, n in by_name.values())
    log(f"  profile {label}: {n_steps} step(s), wall {wall_ms:.1f} ms "
        f"(traced), device busy {busy:.1f} ms in {n_kernels} kernels "
        f"and copies, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the eight heaviest, and every kernel of the port below them
    shown = ranked[:8] + [kv for kv in ranked[8:]
                          if any(k in kv[0] for k in PORT_KERNEL_FUNCTIONS)]
    for name, (t, n) in shown:
        log(f"    {t:9.3f} ms {n:6d}x  {name[:110]}")
    return device_events, wall_ms


# ---------------------------------------------------------------------------
# phase 5: the bench protocol through the port's engine
# ---------------------------------------------------------------------------

BENCH_KERNELS = ("w4a8_matmul_per_channel", "w8a8_matmul",
                 "paged_prefill_attention", "decode_attention_append")
# the body's GEMM weights (Llama's projections, Mixtral's expert stacks)
BODY_WEIGHTS = ("qkv", "o", "gate_up", "down", "w13", "w2")


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def run_bench(dev, rounds=2, batch=128, prompt_len=1024, gen_len=512,
              multi=32, precision="w4a8kv4", group_size=-1,
              kernels=BENCH_KERNELS, trace=True, granularity="fine_grained",
              stats=None, model=("llama3-8b", LLAMA3_8B), warmup_gen=None,
              lm_head="w8a8", trace_prefill_batch=None):
    """``bench.py``'s engine protocol on the port: static batch 128, 1024
    prompt tokens, 512 greedy tokens, ``chunk_prefill_size`` 8192,
    ``decode_multi_step`` 32, w8a8 lm_head, benchmarking mode, each round
    through ``omniserve_tpu_torch.qserve_benchmark.run_round``, at
    ``precision`` (and ``group_size``, ``granularity`` of the KV). With two
    rounds or more round 1 is warmup (``bench.py`` discards it); the launch
    counts are read from the last round alone, and each of ``kernels`` must
    have launched in it. Then, with ``trace``, a
    fresh batch's chunked prefill step and one 32-step window under the
    profiler. ``stats`` (a dict) receives the last round's prefill step
    ms, decode tok/s, graphs captured and the peak device memory.
    ``model`` = (directory name, config.json) of the model (Llama-3-8B
    unless given); ``warmup_gen`` cuts the warmup round's output to that
    many tokens; ``lm_head`` is the lm_head precision. With ``trace`` and
    ``stats``, stats["traces"] receives the two traced windows' (device
    events, wall ms) by "prefill" / "decode". ``trace_prefill_batch``: the
    traced prefill is that many requests' after the window instead (at
    1,024-token prompts and batch 16: two [16, 512] chunks of 8,192
    tokens)."""
    import torch

    from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
    from omniserve_tpu_torch.config import ProfilingConfig
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.qserve_benchmark import run_round

    blocks_per_seq = (prompt_len + gen_len + 127) // 128 + 1   # bench.py:72
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine = LLMEngine.from_engine_args(EngineArgs(
        model=write_model_dir(*model), precision=precision,
        group_size=group_size,
        kv_quant_granularity=granularity, load_format="dummy",
        lm_head_precision=lm_head, tokenizer_mode="skip", device=str(dev),
        block_size=128, ifb_mode=False, benchmarking_mode=True,
        disable_log_stats=True, chunk_prefill_size=8192,
        decode_multi_step=multi, max_num_seqs=batch,
        max_num_batched_tokens=max(262144, batch * prompt_len),
        num_retrieval_blocks=blocks_per_seq * batch + 2, seed=0,
    ))
    sync(dev)
    pool = engine.worker.model_runner.cache_engine.retrieval_pool
    pool_gib = sum(t.numel() * t.element_size() for t in pool
                   if t is not None) / 2**30
    log(f"  engine built in {time.time() - t0:.1f} s ({model[0]}, {precision}"
        f"{f' g{group_size}' if group_size > 0 else ''}"
        f"{' per-tensor' if granularity == 'per_tensor' else ''}); device "
        "memory "
        f"{device_gib(dev, torch.cuda.memory_allocated):.2f} GiB, KV pool "
        f"{pool_gib:.2f} GiB")
    runner = engine.worker.model_runner
    n_layers = runner.spec.num_layers
    if stats is not None:
        stats.update(weight_gib=tree_bytes(runner.params) / 2**30,
                     body_bytes=tree_bytes(
                         {k: v for k, v in runner.params["layers"].items()
                          if k in BODY_WEIGHTS}))

    # time each step and keep the round's groups to check their outputs
    step_s, groups = [], []
    real_step = engine.step

    def timed_step():
        if not step_s:
            groups.extend(engine.scheduler.waiting)
        t = time.time()
        out = real_step()
        step_s.append(time.time() - t)
        return out

    engine.step = timed_step
    for r in range(rounds):
        step_s.clear()
        groups.clear()
        cuda.reset_launch_counts()
        graphs_before = runner.graphs_captured
        sampler = (card_samples(f"round {r + 1}") if r == rounds - 1
                   else contextlib.nullcontext())
        warm = rounds > 1 and r == 0
        n_gen = warmup_gen if warm and warmup_gen else gen_len
        with sampler:
            toks_per_s = run_round(engine, batch, prompt_len, n_gen)
            sync(dev)
        launches = dict(cuda.LAUNCHES)
        lens = [len(g.get_seqs()[0].data.output_token_ids) for g in groups]
        if len(groups) != batch or set(lens) != {n_gen} or not all(
                g.is_finished() for g in groups):
            raise AssertionError(f"round {r + 1}: {len(groups)} requests, "
                                 f"output lengths {sorted(set(lens))}")
        vocab = model[1]["vocab_size"]
        if not all(0 <= t < vocab for g in groups
                   for t in g.get_seqs()[0].data.output_token_ids):
            raise AssertionError(f"round {r + 1}: token out of vocab")
        n_chunks = sum(launches.get(k, 0) + launches.get(k + "_d64", 0)
                       for k in (
            "paged_prefill_attention", "paged_prefill_kv8",
            "paged_prefill_kv16", "paged_prefill_pt",
            "paged_prefill_single_pass", "paged_prefill_single_pass_kv8",
            "paged_prefill_single_pass_pt")) // n_layers
        log(f"  round {r + 1}{' (warmup)' if warm else ''}: {batch} x "
            f"{prompt_len} in / {n_gen} out; prefill step "
            f"{step_s[0] * 1e3:.1f} ms ({batch * prompt_len / step_s[0]:.0f} "
            f"prompt tok/s, {n_chunks} chunks); decode "
            f"{toks_per_s:.1f} tok/s ({sum(step_s[1:]) * 1e3:.1f} ms for "
            f"{len(step_s) - 1} steps, host clock); graphs captured "
            f"{runner.graphs_captured - graphs_before}; launches "
            + ", ".join(f"{k} {launches[k]}" for k in kernels))
        if stats is not None:
            stats.update(prefill_ms=step_s[0] * 1e3, decode_tps=toks_per_s,
                         graphs=runner.graphs_captured - graphs_before)
    if stats is not None:
        stats["peak_gib"] = device_gib(dev, torch.cuda.max_memory_allocated)
    log(f"  {batch} requests, each with its token count, in every round; "
        f"graphs held {len(runner._ms_fn_cache)}, captured "
        f"{runner.graphs_captured} in {runner.graph_capture_s:.2f} s; peak "
        "device memory "
        f"{device_gib(dev, torch.cuda.max_memory_allocated):.2f} GiB")
    log(f"  launches in the measured round: {json.dumps(launches)}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the bench: {missing}")
    engine.step = real_step
    if not trace:
        return launches

    # a fresh batch under the profiler: its chunked prefill step, then one
    # window: 33 tokens = the prefill's + one 32-step window (too short to
    # pipeline a second window behind it)
    for i in range(batch):
        engine.add_request(
            f"prof{i}", profiling_config=ProfilingConfig(prompt_len,
                                                         multi + 1),
            sampling_params=SamplingParams(temperature=0.0))
    traces = {}
    if trace_prefill_batch:
        engine.step()
    else:
        traces["prefill"] = trace_steps(
            engine, f"chunked prefill ({batch} x {prompt_len})", 1)
    traces["decode"] = trace_steps(
        engine, f"decode window ({multi} steps, batch {batch})", multi)
    if engine.has_unfinished_requests():
        raise AssertionError("profiled window left requests unfinished")
    if trace_prefill_batch:
        for i in range(trace_prefill_batch):
            engine.add_request(
                f"prof-prefill{i}",
                profiling_config=ProfilingConfig(prompt_len, multi + 1),
                sampling_params=SamplingParams(temperature=0.0))
        traces["prefill"] = trace_steps(
            engine, f"chunked prefill ({trace_prefill_batch} x "
            f"{prompt_len})", 1)
        while engine.has_unfinished_requests():
            engine.step()
    if stats is not None:
        stats["traces"] = traces
    return launches


# ---------------------------------------------------------------------------
# phase 6: the LServe benchmark protocol through the port's engine
# ---------------------------------------------------------------------------

# launches of one sparse decode step, per layer: one append into both
# pools, the retrieval heads' page lists, the streaming heads' band
LSERVE_LAUNCHES_PER_LAYER = {"kv_append_decode": 1, "decode_attention_ph": 1,
                             "decode_attention_band": 1}
LSERVE_KERNELS = tuple(LSERVE_LAUNCHES_PER_LAYER)


def lserve_decode_names(suffix, head_dim=128):
    """The launch names of LSERVE_LAUNCHES_PER_LAYER's three calls over a
    pool mode (``kv_suffix``) at ``head_dim``: rows 5 / 4 where the JAX
    package's supports rule holds (kv4 / kv8 at head_dim 128), row 6's
    per-head and band modes elsewhere (kv16, head_dim 64), ``_d64`` at
    head_dim 64."""
    stems = LSERVE_KERNELS
    if head_dim != 128 and suffix != "_kv16":
        stems = ("kv_append_decode", "paged_mqa_attention_ph",
                 "paged_mqa_attention_band")
    d64 = "_d64" if head_dim == 64 else ""
    return tuple(s + suffix + d64 for s in stems)
# every round of the protocol must go through these
LSERVE_ROUND_KERNELS = LSERVE_KERNELS + ("flash_prefill",)


def run_lserve(dev, prompt_len=32768, gen_len=128, multi=16):
    """``lserve_benchmark.py``'s protocol on the port: batch 1, a
    ``prompt_len``-token prompt, ``gen_len`` greedy tokens, sparse decode
    with half of the kv heads streaming (defaults: 128 sink + 256 local
    tokens, a 4096-token page budget, selector refresh every 4 steps), each
    round through ``lserve_benchmark.process_requests_split_stage``. A
    warmup and a measured round in ``multi``-step decode windows, then a
    measured round in single decode steps (the script's defaults; the
    windows' rounds warm it, which keeps chip_smoke inside its time
    limit). The launch counts are read from the measured single-step
    round alone."""
    import argparse

    import torch

    from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
    from omniserve_tpu_torch import lserve_benchmark as lb
    from omniserve_tpu_torch.config import ProfilingConfig
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.worker.cache_engine import pool_bytes

    batch = 1
    sizing = argparse.Namespace(max_num_seqs=batch, max_num_batched_tokens=0,
                                num_retrieval_blocks=None, block_size=128)
    lb.size_pool(sizing, batch, prompt_len, gen_len)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine = LLMEngine.from_engine_args(EngineArgs(
        model=write_model_dir("llama3.1-8b", LLAMA31_8B),
        precision="w4a8kv4", load_format="dummy", tokenizer_mode="skip",
        device=str(dev), block_size=sizing.block_size,
        sparse_decode_mode=True, static_sparsity=0.5,
        max_num_seqs=sizing.max_num_seqs,
        max_num_batched_tokens=sizing.max_num_batched_tokens,
        num_retrieval_blocks=sizing.num_retrieval_blocks,
        disable_log_stats=True, seed=0,
    ))
    sync(dev)
    runner = engine.worker.model_runner
    spec, ce = runner.spec, runner.cache_engine
    mib = 1 << 20
    rb, sb = pool_bytes(ce.retrieval_pool), pool_bytes(ce.streaming_pool)
    log(f"  engine built in {time.time() - t0:.1f} s; device memory "
        f"{device_gib(dev, torch.cuda.memory_allocated):.2f} GiB")
    log(f"  retrieval pool {ce.retrieval_pool.num_pages} pages x "
        f"{ce.retrieval_pool.num_heads} heads: "
        f"{sum(rb.values()) / mib:.1f} MiB, of which K stats "
        f"{rb['k_stats'] / mib:.1f} MiB "
        f"({rb['k_stats'] / ce.retrieval_pool.num_pages / mib:.3f} MiB per "
        f"page); streaming pool {ce.streaming_pool.num_pages} pages x "
        f"{ce.streaming_pool.num_heads} heads: {sum(sb.values()) / mib:.1f} "
        f"MiB; budget {spec.budget_pages} pages, ring {spec.sink_blocks}+"
        f"{spec.local_blocks} pages, refresh every {spec.selector_interval}")
    if (spec.rope_llama3 is None or not spec.sparse_decode
            or 2 * ce.retrieval_pool.num_heads != spec.num_kv_heads):
        raise AssertionError("LServe phase: engine is not the sparse-decode "
                             "Llama-3.1-8B configuration")

    groups = []
    add_request = engine.add_request

    def recording_add(*args, **kw):
        add_request(*args, **kw)
        groups.append(engine.scheduler.waiting[-1])

    engine.add_request = recording_add
    result = {}
    for mode, steps_per_call, rounds in (
            ("windows", multi, ("warmup", "measured")),
            ("single steps", 1, ("measured",))):
        engine.ifb_config.decode_multi_step = steps_per_call
        for r in rounds:
            groups.clear()
            cuda.reset_launch_counts()
            refreshes_before = runner.selector_refreshes
            graphs_before = runner.graphs_captured
            t_prefill, t_decode, steps = lb.process_requests_split_stage(
                engine, batch, prompt_len, gen_len)
            launches = dict(cuda.LAUNCHES)
            # a request that ends inside a window leaves the window's tail
            # buffered; drain it (host bookkeeping only) before the next round
            while engine._multi_step_buffer:
                engine.step()
            prefill_tps, decode_tps = lb.check_round(
                engine, batch, prompt_len, gen_len, t_prefill, t_decode,
                steps)
            outs = [g.get_seqs()[0].data.output_token_ids for g in groups]
            if (len(groups) != batch
                    or any(len(o) != gen_len for o in outs)
                    or not all(g.is_finished() for g in groups)):
                raise AssertionError(
                    f"LServe {mode} {r}: {len(groups)} requests, output "
                    f"lengths {[len(o) for o in outs]}")
            if not all(0 <= t < LLAMA3_8B["vocab_size"]
                       for o in outs for t in o):
                raise AssertionError(f"LServe {mode} {r}: token out of vocab")
            missing = [k for k in LSERVE_ROUND_KERNELS if launches[k] <= 0]
            if missing:
                raise AssertionError(f"LServe {mode} {r}: kernels not "
                                     f"launched: {missing}")
            # each layer of a single decode step: one append launch into
            # both pools (no head gather), one of each attention kernel
            per_layer = {k: launches[k] / (steps * spec.num_layers)
                         for k in LSERVE_KERNELS}
            if mode == "single steps" and per_layer != \
                    LSERVE_LAUNCHES_PER_LAYER:
                raise AssertionError(f"LServe {mode} {r}: launches per "
                                     f"layer and decode step {per_layer}, "
                                     f"not {LSERVE_LAUNCHES_PER_LAYER}")
            refreshes = runner.selector_refreshes - refreshes_before
            log(f"  {mode}, {r}: prefill {prompt_len} tokens "
                f"{t_prefill:.3f} s ({prefill_tps:.0f} tok/s); decode "
                f"{steps} steps {t_decode:.3f} s = {decode_tps:.2f} tok/s "
                f"({t_decode / steps * 1e3:.2f} ms per token, host clock); "
                f"selector refreshes {refreshes}; graphs captured "
                f"{runner.graphs_captured - graphs_before}; launches "
                f"{json.dumps({k: launches[k] for k in LSERVE_KERNELS})}")
            if mode == "single steps" and r == "measured":
                result = launches
    engine.add_request = add_request
    log(f"  peak device memory "
        f"{device_gib(dev, torch.cuda.max_memory_allocated):.2f} GiB; "
        f"launches in the measured single-step round: {json.dumps(result)}")

    # where the time goes: the traced prefill step of a fresh request, then
    # 4 traced single decode steps (one of them refreshes the selection)
    engine.ifb_config.decode_multi_step = 1
    engine.add_request(
        "prof", profiling_config=ProfilingConfig(prompt_len, 6),
        sampling_params=SamplingParams(temperature=0.0, max_tokens=6,
                                       ignore_eos=True))
    trace_steps(engine, f"whole-prompt prefill, {prompt_len} tokens", 1)
    trace_steps(engine, f"sparse decode after {prompt_len} tokens, single "
                "steps", 4)
    while engine.has_unfinished_requests():
        engine.step()
    return result


# ---------------------------------------------------------------------------
# phase 7: LServe's prefill side through the port's lserve_benchmark
# ---------------------------------------------------------------------------

def run_lserve_prefill(dev, long_len=32768, long_gen=128, short_len=16384,
                       short_gen=32, chunk=32000, multi=16,
                       single_pass=False, stats=None, precision="w4a8kv4",
                       granularity="fine_grained", trace_window=False,
                       trace=True, model=("llama3.1-8b", LLAMA31_8B)):
    """``lserve_benchmark.py``'s protocol with the reference's LServe flags
    (``--sparse-context-mode --sparse-decode-mode --static-sparsity 0.5``,
    ctx band 128 + 8,192 tokens, ``chunk_prefill_size`` 32000) at
    Llama-3.1-8B's config, ``precision`` and KV ``granularity``, decode in
    ``multi``-step windows, each round through
    ``lserve_benchmark.process_requests_split_stage``: (a) batch 1, 32,768
    prompt tokens, 128 greedy tokens, which prefill in two chunks over the
    1 + 314 page ring; (b) a 16,384-token prompt, 32 tokens, which takes
    the whole-prompt band path (not run with ``short_len`` None). A
    warmup and a measured round each, then one traced prefill step of each
    and, with ``trace_window``, one traced decode window of (a). With ``single_pass`` (phase 10 (c), the switch on): (a) alone,
    untraced, its prefill on row 8 over both pools; ``trace`` False: no
    traced steps. ``stats`` (a dict)
    receives (a)'s measured prefill seconds, decode tok/s and peak memory.
    Returns the measured rounds' launches of the prefill kernels and of
    the decode kernels of the pool's mode. ``model``: (directory name,
    config.json) of another model (Llama-3.1-8B's by default)."""
    import argparse

    import torch

    from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
    from omniserve_tpu_torch import lserve_benchmark as lb
    from omniserve_tpu_torch.config import ProfilingConfig
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.worker.cache_engine import pool_bytes

    batch = 1
    sizing = argparse.Namespace(max_num_seqs=batch, max_num_batched_tokens=0,
                                num_retrieval_blocks=None, block_size=128)
    lb.size_pool(sizing, batch, long_len, long_gen)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine = LLMEngine.from_engine_args(EngineArgs(
        model=write_model_dir(*model),
        precision=precision, kv_quant_granularity=granularity,
        load_format="dummy", tokenizer_mode="skip",
        device=str(dev), block_size=sizing.block_size,
        sparse_context_mode=True, sparse_decode_mode=True,
        static_sparsity=0.5, chunk_prefill_size=chunk,
        max_num_seqs=sizing.max_num_seqs,
        max_num_batched_tokens=sizing.max_num_batched_tokens,
        num_retrieval_blocks=sizing.num_retrieval_blocks,
        disable_log_stats=True, seed=0,
    ))
    sync(dev)
    runner = engine.worker.model_runner
    spec, ce = runner.spec, runner.cache_engine
    n_layers = spec.num_layers
    mib = 1 << 20
    sb = pool_bytes(ce.streaming_pool)
    log(f"  engine built in {time.time() - t0:.1f} s; device memory "
        f"{device_gib(dev, torch.cuda.memory_allocated):.2f} GiB; "
        f"streaming pool {ce.streaming_pool.num_pages} pages x "
        f"{ce.streaming_pool.num_heads} heads: {sum(sb.values()) / mib:.1f} "
        f"MiB; ring {spec.sink_blocks}+{spec.local_blocks} pages; ctx band "
        f"{spec.ctx_sink}+{spec.ctx_local} tokens; retrieval pool "
        f"{ce.retrieval_pool.num_pages} pages")
    ring_tok = spec.local_blocks * spec.page_size
    # the runner clamps a chunk to what the ring holds beside the ctx-local
    # window (a model with a shorter context sizes a shorter ring)
    page = spec.page_size
    tc = min(chunk // page * page, (ring_tok - spec.ctx_local) // page * page)
    n_chunks = -(-long_len // tc)
    wb, ab, _, kv_bits, kv_zeros = PRECISIONS[precision + (
        "-pt" if granularity == "per_tensor" else "")]
    llama3_rope = (model[1].get("rope_scaling") or {}).get(
        "rope_type") == "llama3"
    if not (spec.sparse_prefill and spec.sparse_decode
            and (spec.rope_llama3 is not None) == llama3_rope
            and tc >= page
            and (spec.weight_bits, spec.act_bits, spec.kv_bits,
                 spec.kv_zeros) == (wb, ab, kv_bits, kv_zeros)):
        raise AssertionError("LServe prefill phase: engine is not the "
                             f"sparse-context + sparse-decode {model[0]} "
                             f"configuration at {precision} {granularity} "
                             "with a ring that holds the ctx-local window "
                             "and a chunk")
    suffix = kv_suffix(kv_bits, not kv_zeros)
    d64 = "_d64" if spec.head_dim == 64 else ""
    dense_name = dense_prefill_name(suffix) + d64
    ring_name = "paged_prefill_ring" + suffix + d64
    band_name = "flash_prefill_band" + d64
    decode_kernels = lserve_decode_names(suffix, spec.head_dim)
    engine.ifb_config.decode_multi_step = multi
    groups = []
    add_request = engine.add_request

    def recording_add(*args, **kw):
        add_request(*args, **kw)
        groups.append(engine.scheduler.waiting[-1])

    engine.add_request = recording_add
    result = {}
    # launches of one prefill: the chunked path runs the retrieval heads'
    # dense call and the streaming heads' ring call per chunk and layer; the
    # whole-prompt path one band-mode flash call per layer
    per_pool = n_chunks * n_layers
    cases = (("a", long_len, long_gen,
              {dense_name: per_pool, ring_name: per_pool, band_name: 0}),
             ("b", short_len, short_gen,
              {dense_name: 0, ring_name: 0, band_name: n_layers}))
    if short_len is None:
        cases = cases[:1]
    if single_pass:
        cases = (("a", long_len, long_gen,
                  {"paged_prefill_attention": 0, "paged_prefill_ring": 0,
                   "flash_prefill_band": 0,
                   "paged_prefill_single_pass": per_pool,
                   "paged_prefill_single_pass_list": per_pool}),)
    for case, prompt_len, gen_len, want in cases:
        for r in ("warmup", "measured"):
            groups.clear()
            graphs_before = runner.graphs_captured
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            # the prefill step's launches alone, then the whole round's
            cuda.reset_launch_counts()
            real_step, seen = engine.step, {}

            def first_step():
                out = real_step()
                if not seen:
                    seen.update(cuda.LAUNCHES)
                return out

            engine.step = first_step
            t_prefill, t_decode, steps = lb.process_requests_split_stage(
                engine, batch, prompt_len, gen_len)
            engine.step = real_step
            launches = dict(cuda.LAUNCHES)
            while engine._multi_step_buffer:
                engine.step()
            prefill_tps, decode_tps = lb.check_round(
                engine, batch, prompt_len, gen_len, t_prefill, t_decode,
                steps)
            outs = [g.get_seqs()[0].data.output_token_ids for g in groups]
            if (len(groups) != batch
                    or any(len(o) != gen_len for o in outs)
                    or not all(g.is_finished() for g in groups)
                    or not all(0 <= t < model[1]["vocab_size"]
                               for o in outs for t in o)):
                raise AssertionError(
                    f"LServe prefill ({case}) {r}: {len(groups)} requests, "
                    f"output lengths {[len(o) for o in outs]}")
            pre = {k: seen[k] for k in want}
            if pre != want:
                raise AssertionError(f"LServe prefill ({case}) {r}: prefill "
                                     f"launched {pre}, expected {want}")
            chunks = max(pre.get(ring_name, 0),
                         pre.get("paged_prefill_single_pass_list", 0)
                         ) // n_layers
            log(f"  ({case}) {r}: prefill {prompt_len} tokens "
                f"{t_prefill:.3f} s ({prefill_tps:.0f} tok/s, "
                f"{max(chunks, 1)} chunk(s) per prefill"
                f"{'' if chunks else ', whole prompt'}); decode {steps} "
                f"steps {t_decode:.3f} s = {decode_tps:.2f} tok/s "
                f"({t_decode / max(gen_len - 1, 1) * 1e3:.2f} ms per token, "
                f"host clock); "
                f"graphs captured {runner.graphs_captured - graphs_before}; "
                f"prefill launches {json.dumps(pre)}; round launches of the "
                f"decode kernels "
                f"{json.dumps({k: launches[k] for k in decode_kernels})}; "
                f"peak device memory "
                f"{device_gib(dev, torch.cuda.max_memory_allocated):.2f} GiB")
            idle = [k for k in decode_kernels if launches[k] <= 0]
            if idle:
                raise AssertionError(f"LServe prefill ({case}) {r}: decode "
                                     f"kernels not launched: {idle}")
            if r == "measured":
                for k in (*want, *decode_kernels):
                    result[k] = result.get(k, 0) + launches[k]
                if case == "a" and stats is not None:
                    stats.update(
                        prefill_s=t_prefill, decode_tps=decode_tps,
                        peak_gib=device_gib(dev,
                                            torch.cuda.max_memory_allocated))
    engine.add_request = add_request
    log(f"  launches in the measured rounds: {json.dumps(result)}")
    if single_pass or not trace:
        return result

    # where a prefill's time goes: one traced prefill step of each path
    # (and of (a)'s decode: one traced window after its prefill)
    for case, prompt_len, _, _ in cases:
        window = trace_window and case == "a"
        engine.ifb_config.decode_multi_step = multi if window else 1
        gen = multi + 2 if window else 2
        engine.add_request(
            f"prof-{case}", profiling_config=ProfilingConfig(prompt_len, gen),
            sampling_params=SamplingParams(temperature=0.0, max_tokens=gen,
                                           ignore_eos=True))
        trace_steps(engine, f"({case}) sparse prefill, {prompt_len} tokens",
                    1)
        if window:
            trace_steps(engine, f"({case}) sparse decode, one {multi}-step "
                        f"window after {prompt_len} tokens", 1)
        while engine.has_unfinished_requests():
            engine.step()
        while engine._multi_step_buffer:
            engine.step()
    return result


# ---------------------------------------------------------------------------
# phase 8: the bench protocol across the precision matrix
# ---------------------------------------------------------------------------

G128_KERNELS = ("w4a8_matmul_per_group", "w8a8_matmul",
                "paged_prefill_attention", "decode_attention_append")
KV8_KERNELS = ("w4a8_matmul_per_channel", "w8a8_matmul", "paged_prefill_kv8",
               "decode_attention_append_kv8")


def run_bench_precisions(dev):
    """Phase 5's protocol (``run_bench``) at ``--precision w4a8kv4
    --group-size 128`` (a warmup and a measured round), then at
    ``w4a8kv8`` per-channel (one measured round); untraced, to keep the
    script well inside its time limit (run J's trace of the g128 steps is
    in PERF.md). Returns each run's launches."""
    import torch

    log("  (a) w4a8kv4 g128")
    g128 = run_bench(dev, group_size=128, kernels=G128_KERNELS, trace=False)
    gc.collect()
    torch.cuda.empty_cache()
    log("  (b) w4a8kv8")
    kv8 = run_bench(dev, rounds=1, precision="w4a8kv8", kernels=KV8_KERNELS,
                    trace=False)
    return g128, kv8


# ---------------------------------------------------------------------------
# phase 9: the bench protocol at the kv16 and per-tensor KV modes
# ---------------------------------------------------------------------------

KV16_KERNELS = ("w8a8_matmul", "paged_prefill_kv16", "kv_append_decode_kv16",
                "paged_mqa_attention_kv16")
PT_KERNELS = ("w8a8_matmul", "paged_prefill_pt", "decode_attention_append_pt")


def run_bench_kv_modes(dev):
    """Phase 9: phase 5's protocol (``run_bench``) at ``--precision
    w16a16kv16`` (a warmup and a measured round, then a traced prefill step
    and window), then at ``w8a8kv8 --kv-quant-granularity per_tensor``
    (one measured round, untraced: run M's trace of its steps is in
    PERF.md). Returns each run's launches."""
    import torch

    log("  (a) w16a16kv16")
    kv16 = run_bench(dev, precision="w16a16kv16", kernels=KV16_KERNELS)
    gc.collect()
    torch.cuda.empty_cache()
    log("  (b) w8a8kv8 per-tensor")
    pt = run_bench(dev, rounds=1, precision="w8a8kv8", kernels=PT_KERNELS,
                   granularity="per_tensor", trace=False)
    return kv16, pt


# ---------------------------------------------------------------------------
# phase 10: rows 8 and 11 behind the JAX dispatch's switches
# ---------------------------------------------------------------------------

SWITCHES = ("OMNISERVE_PREFILL_SINGLE_PASS", "OMNISERVE_EMBED_DMA")
ROW7_NAMES = ("paged_prefill_attention", "paged_prefill_kv8",
              "paged_prefill_kv16", "paged_prefill_pt", "paged_prefill_ring")
ROW8_NAMES = ("paged_prefill_single_pass", "paged_prefill_single_pass_kv8",
              "paged_prefill_single_pass_pt",
              "paged_prefill_single_pass_list")
SWITCHED_BENCH_KERNELS = ("w4a8_matmul_per_channel", "w8a8_matmul",
                          "paged_prefill_single_pass",
                          "decode_attention_append", "embed_gather")


@contextlib.contextmanager
def switches_on():
    """Both of the JAX dispatch's switches on within the block; the
    environment as it was after it."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    os.environ.update(dict.fromkeys(SWITCHES, "1"))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_single_pass(label, args, kw, n_bytes, ops, library, reps=3,
                      short_by_one=True):
    """Row 8 on ``args`` / ``kw`` against its plain version at the JAX
    test's 2e-2 and at ATTN_ROW_RTOL of each row's norm, refusing a causal
    frontier one page short and (``short_by_one``) a context length one
    short planted in the plain version; timed beside the plain version, row
    7 on the same inputs and ``library()`` (ms or None). Returns (the
    kernel table's entry, row 7's ms).

    A context one short hides one key from the last token's rows alone; at
    8K-32K visible keys that moves a row by ~1e-4 of its norm, below any
    gate a bf16 output allows, so the long chunks plant the page fault
    only."""
    import torch

    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.cuda import prefill_single_pass as psp

    q, pool, layer, tables, q_pos, ctx = args
    page = kw["page_size"]
    what = f"single-pass prefill {label}"
    got = psp.paged_prefill_single_pass(*args, **kw)
    want = psp.paged_prefill_single_pass_plain(*args, **kw)
    faults = [("the causal frontier one page short", ctx - page)]
    if short_by_one:
        faults.append(("a context length one short", ctx - 1))
    planted = [(name, psp.paged_prefill_single_pass_plain(
        q, pool, layer, tables, q_pos, bad_ctx, **kw))
        for name, bad_ctx in faults]
    err, row = hold(got, want, 2e-2, 2e-2, ATTN_ROW_RTOL, what,
                    planted=planted)
    del got, want, planted
    torch.cuda.empty_cache()
    ms = time_ms(lambda: psp.paged_prefill_single_pass(*args, **kw), reps,
                 warmup=1)
    row7 = time_ms(lambda: pp.paged_prefill_attention(*args, **kw), reps,
                   warmup=1)
    plain = time_ms(lambda: psp.paged_prefill_single_pass_plain(*args, **kw),
                    1, warmup=0)
    lib = library()
    bnd, by = bound_ms(n_bytes, ops, BF16_FLOPS_PER_S)
    log(f"  {what}: kernel_ms {ms:.4f} (row 7 on the same inputs {row7:.4f}, "
        f"row 8 / row 7 {ms / row7:.3f}) plain_ms {plain:.4f} bound_ms "
        f"{bnd:.4f} ({by}) library_ms {lib if lib is None else f'{lib:.4f}'} "
        f"(SDPA over K/V dequantized beforehand, not counted) max_abs_err "
        f"{err:.3g}, largest row error {row:.3g} of its norm (limit "
        f"{ATTN_ROW_RTOL})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err), row7


def check_single_pass_dense(dev, gen, kv_bits=4, per_tensor=False, b=128,
                            history=896, tc=128, band=False, page=128,
                            n_rep=4):
    """Row 8 over ``dense_chunk_inputs`` (with ``band``: kv heads 4-7
    streaming, phase 7's ctx band of 128 sink + 8,192 local tokens)."""
    import torch

    args, kw, label, n_bytes, pairs = dense_chunk_inputs(
        dev, gen, kv_bits, per_tensor, b, history, tc, page, n_rep)
    q = args[0]
    hq, d = q.shape[2], q.shape[3]
    hkv = args[1].num_heads
    ops = 4.0 * d * hq * pairs
    head_mask = None
    if band:
        sink, local = 128, 8192
        flags = (torch.arange(hkv, device=dev) < hkv // 2).repeat_interleave(
            hq // hkv)
        kw.update(head_is_retrieval=flags, sink_size=sink, local_size=local)
        n_stream = int((~flags).sum())
        ctx_len = history + tc
        kv_pos = torch.arange(ctx_len, device=dev)
        stream_pairs = b * band_pairs(args[4][0], kv_pos, sink, local)
        ops = 4.0 * d * ((hq - n_stream) * pairs + n_stream * stream_pairs)

        def head_mask(shape):
            qp = args[4][0][:, None].long()
            kp = kv_pos[None, :]
            in_band = (kp < sink) | (qp - kp < local)
            return flags[:, None, None] | in_band[None]

        label += f", kv heads {hkv // 2}-{hkv - 1} streaming (sink {sink}, "
        label += f"local {local})"
    label = (f"{label} B={b} Tc={tc} history={history} Hq={hq} Hkv={hkv} "
             f"page={kw['page_size']}")
    return check_single_pass(label, args, kw, n_bytes, ops,
                             lambda: dense_sdpa_ms(args, kw, head_mask),
                             short_by_one=history + tc <= 1024)


def check_single_pass_ring(dev, gen, context, tc, n_ring, label):
    """Row 8 over ``ring_chunk_inputs`` (the streaming heads' ring call)."""
    args, kw, n_bytes, pairs, note = ring_chunk_inputs(dev, gen, context, tc,
                                                       n_ring)
    q = args[0]
    return check_single_pass(f"ring ({label}) {note}", args, kw, n_bytes,
                             4.0 * q.shape[3] * q.shape[2] * pairs,
                             lambda: ring_sdpa_ms(args, kw),
                             short_by_one=False)


def check_embed_gather(dev, gen, table, b, reps=20):
    """Row 11 at ``b`` decode rows over the Llama-3-8B embedding table:
    equal bytes to the plain version with a negative id and an id of V
    among the ids; times over ``reps`` calls with fresh ids each, replayed
    from one CUDA graph (a few-us kernel), beside the plain version and
    ``table[ids]`` as the library call."""
    import torch

    from omniserve_tpu_torch.ops.cuda import embed_gather as eg

    v, d = table.shape
    ids = torch.randint(0, v, (b,), generator=gen, device=dev)
    ids[0], ids[-1] = -1, v
    got = eg.embed_gather(table, ids)
    want = eg.embed_gather_plain(table, ids)
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"embed gather B={b}: bytes differ from the "
                             "plain version's")
    if not (torch.equal(got[0], table[0]) and torch.equal(got[-1],
                                                          table[-1])):
        raise AssertionError(f"embed gather B={b}: out-of-range ids not "
                             "clamped")
    batches = [torch.randint(0, v, (b,), generator=gen, device=dev)
               for _ in range(reps)]

    def cycling(fn):
        it = itertools.cycle(batches)
        return lambda: fn(next(it))

    ms = time_graphed_ms(cycling(lambda i: eg.embed_gather(table, i)), reps)
    plain = time_graphed_ms(cycling(lambda i: eg.embed_gather_plain(table,
                                                                    i)), reps)
    lib = time_graphed_ms(cycling(lambda i: table[i]), reps)
    n_bytes = 2 * b * d * table.element_size() + 8 * b
    bnd, by = bound_ms(n_bytes, 0.0, BF16_FLOPS_PER_S)
    log(f"  embed gather B={b} over [{v}, {d}] {table.dtype}: kernel_ms "
        f"{ms:.5f} plain_ms {plain:.5f} bound_ms {bnd:.6f} ({by}) library_ms "
        f"{lib:.5f} (table[ids]); equal bytes, ids -1 and {v} clamped "
        f"(graph replay of {reps} calls with fresh ids)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=0.0)


def check_switched_kernels(dev, gen):
    """Phase 10 (a): rows 8 and 11 against their plain versions at the
    main paths' shapes, row 8 beside row 7 on the same inputs. Returns the
    kernel table's entries of rows 8 and 11."""
    import torch

    rows, ab = {}, {}
    for line in ptxas_report("prefill_single_pass.cu"):
        log(f"    ptxas {line}")

    def case(label, name, result):
        entry, row7 = result
        ab[label] = (entry["ms"], row7)
        if name:
            rows[name] = entry

    for name, kv_bits, pt in (("paged_prefill_single_pass", 4, False),
                              ("paged_prefill_single_pass_kv8", 8, False),
                              ("paged_prefill_single_pass_pt", 8, True)):
        case(f"bench chunk {name}", name,
             check_single_pass_dense(dev, gen, kv_bits, pt))
    # 384-token pages: under kv4 a 128-token unit's two 64-key sub-tiles
    # sit in different nibble halves of the page's 192 rows
    for kv_bits, pt in ((4, False), (4, True), (8, False)):
        case(f"page 384 kv{kv_bits}{' pt' if pt else ''}", None,
             check_single_pass_dense(dev, gen, kv_bits, pt, b=16, page=384))
    # a long dense chunk: the last 8,192 tokens of a 32K context, without
    # and with the band
    case("32K, last 8192, kv4", None, check_single_pass_dense(
        dev, gen, b=1, history=24576, tc=8192))
    case("32K, last 8192, kv4, band", None, check_single_pass_dense(
        dev, gen, b=1, history=24576, tc=8192, band=True))
    case("ring, phase 7 (a)'s first chunk", "paged_prefill_single_pass_list",
         check_single_pass_ring(dev, gen, 32000, 32000, 314,
                                "phase 7's first chunk"))
    case("wrapped ring", None, check_single_pass_ring(dev, gen, 20000, 2048,
                                                      80, "wrapped"))
    torch.cuda.empty_cache()
    table = (torch.randn((LLAMA3_8B["vocab_size"], LLAMA3_8B["hidden_size"]),
                         generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    check_embed_gather(dev, gen, table, 8)
    rows["embed_gather"] = check_embed_gather(dev, gen, table, 128)
    del table
    log("  A/B on the same inputs, kernel_ms row 8 / row 7 (ratio): "
        + "; ".join(f"{k} {a:.4f} / {b_:.4f} ({a / b_:.3f})"
                    for k, (a, b_) in ab.items()))
    return rows


def run_switched_protocols(dev, phase5, phase7):
    """Phase 10 (b): phase 5's protocol with both switches on (row 8 must
    launch as often as row 7 did in phase 5's measured round, row 7 never,
    the row gather once a decode step); the 2-layer full-width chunked
    forwards at w4a8kv8 and w8a8kv8 per-tensor, kernels against plain at
    their gates. (c): phase 7 (a)'s LServe command with both switches on
    (row 8 over the retrieval pool and the ring, row 7 never). ``phase5`` /
    ``phase7``: those phases' launches and round figures. Returns the
    launches of rows 8 and 11 on these paths."""
    import torch

    from omniserve_tpu_torch.ops import cuda

    launches = {}
    with switches_on():
        log("  (b) phase 5's protocol with both switches on")
        stats = {}
        bench = run_bench(dev, kernels=SWITCHED_BENCH_KERNELS, trace=False,
                          stats=stats)
        n_layers = LLAMA3_8B["num_hidden_layers"]
        steps = bench["decode_attention_append"] // n_layers
        want = {"paged_prefill_single_pass":
                phase5["launches"]["paged_prefill_attention"],
                "embed_gather": steps, **dict.fromkeys(ROW7_NAMES, 0)}
        got = {k: bench[k] for k in want}
        if got != want:
            raise AssertionError(f"switched bench launched {got}, expected "
                                 f"{want}")
        p5 = phase5["stats"]
        log(f"  (b) beside phase 5 (switches off, same run): prefill step "
            f"{stats['prefill_ms']:.1f} ms vs {p5['prefill_ms']:.1f} ms; "
            f"decode {stats['decode_tps']:.1f} vs {p5['decode_tps']:.1f} "
            f"tok/s; graphs {stats['graphs']} vs {p5['graphs']}; peak "
            f"device memory {stats['peak_gib']:.2f} vs "
            f"{p5['peak_gib']:.2f} GiB; launches {json.dumps(got)} (row 7 "
            f"in phase 5: {p5['row7']})")
        launches.update({k: bench[k] for k in ("paged_prefill_single_pass",
                                                "embed_gather")})
        gc.collect()
        torch.cuda.empty_cache()
        for precision, name in (("w4a8kv8", "paged_prefill_single_pass_kv8"),
                                ("w8a8kv8-pt",
                                 "paged_prefill_single_pass_pt")):
            cuda.reset_launch_counts()
            spec, params, prompts, tables, kv_scales = check_forward(
                dev, precision, with_floor=True)
            check_chunked_forward(dev, spec, params, prompts, tables,
                                  with_floor=True, kv_scales=kv_scales)
            n = {k: cuda.LAUNCHES[k] for k in (name, *ROW7_NAMES,
                                               "embed_gather")}
            log(f"  (b) {precision} forwards with both switches on: "
                f"launches {json.dumps(n)}")
            if n[name] <= 0 or n["embed_gather"] <= 0 or any(
                    n[k] for k in ROW7_NAMES):
                raise AssertionError(f"{precision} switched forwards "
                                     f"launched {n}")
            launches[name] = n[name]
            del spec, params
            gc.collect()
            torch.cuda.empty_cache()
        log("  (c) phase 7 (a)'s LServe command with both switches on")
        stats = {}
        prefill = run_lserve_prefill(dev, single_pass=True, stats=stats)
        p7 = phase7["stats"]
        log(f"  (c) beside phase 7 (a) (switches off, same run): prefill "
            f"{stats['prefill_s']:.3f} s vs {p7['prefill_s']:.3f} s; decode "
            f"{stats['decode_tps']:.2f} vs {p7['decode_tps']:.2f} tok/s; "
            f"measured round's launches {json.dumps(prefill)}")
        launches["paged_prefill_single_pass_list"] = prefill[
            "paged_prefill_single_pass_list"]
    return launches


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 11: the reference's LServe command at its own precision
# ---------------------------------------------------------------------------

LSERVE_KV_KERNELS = tuple(
    k + sfx for sfx in ("_kv8", "_pt")
    for k in ("decode_attention_ph", "decode_attention_band",
              "kv_append_decode", "paged_prefill_ring"))


def run_lserve_kv_modes(dev):
    """Phase 11: phase 7 (a)'s protocol (``run_lserve_prefill``) at the
    reference's LServe precision, ``w8a8kv8 --kv-quant-granularity
    per_tensor`` (the sweep command of its ``lserve_benchmark/launch.sh``;
    unit scales under dummy weights): 32,768 in / 128 out, a warmup and a
    measured round, then a traced prefill step and a traced 16-step decode
    window; then at ``w4a8kv8`` (fine-grained): 32,768 in / 32 out, a
    warmup and a measured round. Returns both runs' measured launches."""
    import torch

    log("  (a) w8a8kv8 per-tensor")
    stats = {}
    a = run_lserve_prefill(dev, short_len=None, precision="w8a8kv8",
                           granularity="per_tensor", trace_window=True,
                           stats=stats)
    gc.collect()
    torch.cuda.empty_cache()
    log("  (b) w4a8kv8")
    b = run_lserve_prefill(dev, long_gen=32, short_len=None,
                           precision="w4a8kv8")
    log(f"  (a)'s measured round: prefill {stats['prefill_s']:.3f} s, decode "
        f"{stats['decode_tps']:.2f} tok/s, peak {stats['peak_gib']:.2f} GiB")
    return {**a, **b}


# ---------------------------------------------------------------------------
# phase 13: LServe over kv16 pools, the default precision
# ---------------------------------------------------------------------------

LSERVE_KV16_KERNELS = ("decode_attention_ph_kv16", "decode_attention_band_kv16",
                       "paged_prefill_ring_kv16", "kv_append_decode_kv16")


def run_lserve_kv16(dev):
    """Phase 13: phase 7 (a)'s protocol (``run_lserve_prefill``) at
    ``--precision w16a16kv16``, the default of both packages, under both
    LServe flags: 32,768 in / 128 out, 16-step windows, a warmup and a
    measured round, untraced; every kv16 LServe entry (row 6's per-head and
    band modes, row 7's kv16 ring, row 10's two-pool kv16 append) must
    launch. Returns the measured round's launches."""
    stats = {}
    launches = run_lserve_prefill(dev, short_len=None,
                                  precision="w16a16kv16", stats=stats,
                                  trace=False)
    idle = [k for k in LSERVE_KV16_KERNELS if launches[k] <= 0]
    if idle:
        raise AssertionError(f"LServe kv16: entries not launched: {idle}")
    log(f"  w16a16kv16 measured round on {card_line()}: prefill "
        f"{stats['prefill_s']:.3f} s, decode {stats['decode_tps']:.2f} "
        f"tok/s, peak {stats['peak_gib']:.2f} GiB; launches "
        f"{json.dumps({k: launches[k] for k in LSERVE_KV16_KERNELS})}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the reference's two other headline models at full width
# ---------------------------------------------------------------------------

# the kernels each model's protocol launches: Yi-34B prefills in chunks of
# 64 x 128 tokens (row 7 at n_rep 7, decode row 4 at n_rep 7); Qwen1.5-72B's
# 4 x 1,024 prompt tokens fit one 8,192-token budget, so they prefill whole
# through row 9 (n_rep 1), and row 4 decodes at n_rep 1
FAMILY_KERNELS = {
    "Yi-34B": ("w4a8_matmul_per_channel", "w8a8_matmul",
               "paged_prefill_attention", "decode_attention_append"),
    "Qwen1.5-72B": ("w4a8_matmul_per_channel", "w8a8_matmul",
                    "flash_prefill", "decode_attention_append"),
}


def run_families(dev):
    """``bench.py``'s protocol (w4a8kv4, 1,024 in / 512 out, chunks of
    8,192, 32-step windows, w8a8 lm_head) on Yi-34B at batch 64 and
    Qwen1.5-72B at batch 4 (the reference's L40S batches), full width and
    depth, random weights from a seed: a warmup round cut to 32 output
    tokens, then the measured round, each request with its token count and
    each of FAMILY_KERNELS launched. Returns {model: (launches, stats)}."""
    import torch

    out = {}
    for family, (config, batch, *_) in FAMILIES.items():
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {family}: {config['num_hidden_layers']} layers, hidden "
            f"{config['hidden_size']}, {config['num_attention_heads']} / "
            f"{config['num_key_value_heads']} heads, vocab "
            f"{config['vocab_size']}, batch {batch}; device memory before "
            f"the engine {device_gib(dev, torch.cuda.memory_allocated):.2f} "
            "GiB")
        stats = {}
        launches = run_bench(dev, batch=batch, kernels=FAMILY_KERNELS[family],
                             trace=False, stats=stats,
                             model=(family.lower(), config), warmup_gen=32)
        out[family] = (launches, stats)
        log(f"  {family} measured round: prefill step "
            f"{stats['prefill_ms']:.1f} ms, decode {stats['decode_tps']:.1f} "
            f"tok/s, graphs {stats['graphs']}, peak device memory "
            f"{stats['peak_gib']:.2f} GiB")
    return out


# ---------------------------------------------------------------------------
# phase 2 / 3 at head_dim 64 and phase 14: Llama-3.2-1B at full width
# ---------------------------------------------------------------------------

# the kernels each of phase 14's protocols launches, at head_dim 64: the
# bench's chunked prefill (row 7) and split decode step (row 10's append,
# then row 6); the IFB engine's whole prompts (row 9); the LServe command's
# chunks (row 7 dense and ring), whole prompt (row 9's band) and decode
# (row 10's two-pool append, row 6's per-head and band modes)
D64_BENCH_KERNELS = ("w4a8_matmul_per_channel", "w8a8_matmul",
                     "paged_prefill_attention_d64", "kv_append_decode_d64",
                     "paged_mqa_attention_d64")
D64_ENGINE_KERNELS = ("w4a8_matmul_per_channel", "w8a8_matmul",
                      "flash_prefill_d64", "kv_append_decode_d64",
                      "paged_mqa_attention_d64")
D64_FORWARD_KERNELS = ("w4a8_matmul_per_channel", "w8a8_matmul",
                       "flash_prefill_d64", "paged_prefill_attention_d64",
                       "kv_append_decode_d64", "paged_mqa_attention_d64")
_ROW6 = ("omniserve_tpu_torch/csrc/decode_attention.cu",
         "omniserve_tpu/ops/pallas/paged_attention.py:255")
_ROW7 = ("omniserve_tpu_torch/csrc/paged_prefill.cu",
         "omniserve_tpu/ops/pallas/paged_prefill.py:268")
_ROW9 = ("omniserve_tpu_torch/csrc/flash_prefill.cu",
         "omniserve_tpu/ops/pallas/flash_attention.py:150")
_ROW10 = ("omniserve_tpu_torch/csrc/kv_append.cu",
          "omniserve_tpu/ops/pallas/kv_append.py:156")
# the kernels line's head_dim-64 entries (phase 2's rows, phase 14's
# launches): name -> (source, the TPU kernel it replaces)
D64_ENTRIES = {
    "paged_mqa_attention_d64": _ROW6,
    "paged_mqa_attention_ph_pt_d64": _ROW6,
    "paged_mqa_attention_band_pt_d64": _ROW6,
    "paged_prefill_attention_d64": _ROW7,
    "paged_prefill_pt_d64": _ROW7,
    "paged_prefill_ring_pt_d64": _ROW7,
    "flash_prefill_d64": _ROW9,
    "flash_prefill_band_d64": _ROW9,
    "kv_append_decode_d64": _ROW10,
    "kv_append_decode_pt_d64": _ROW10,
}


def check_d64_kernels(dev, gen):
    """Phase 2 at head_dim 64: each kernel and mode phase 14 runs against
    its plain version at the shapes phase 14 gives it (the bench's decode
    at B=128 and its last chunk, Llama-3.2-1B's 32 / 8 heads; the LServe
    command's shapes), with its time, bound and SDPA yardstick; row 6's
    other head_dim-64 modes (kv4, kv8 and kv16 lists) and row 6 kv4 at
    head_dim 128 over 64-token pages (pages the JAX package's supports rule
    sends to row 6) logged beside them; rows 1 and 3 at Llama-3.2-1B's GEMM
    shapes with their plans. Returns the kernels-line entries of the
    head_dim-64 launches phase 14 counts."""
    rows = {}
    rows["paged_mqa_attention_d64"] = check_decode_kv16(
        dev, gen, b=128, lens_from=1024, lens_to=1536, mode="kv4", d=64)
    check_decode_kv16(dev, gen, b=8, mode="kv4", d=64)
    check_decode_kv16(dev, gen, b=128, lens_from=1024, lens_to=1536,
                      mode="kv4", d=128, page=64)
    for mode in ("kv8", "pt8", "kv16"):
        check_decode_kv16(dev, gen, b=8, mode=mode, d=64)
    for mode in ("kv4", "kv8", "pt8", "kv16"):
        ph = check_decode_ph(dev, gen, b=1, mode=mode, d=64)
        band = check_decode_band(dev, gen, b=1, mode=mode, d=64)
        if mode == "pt8":
            rows["paged_mqa_attention_ph_pt_d64"] = ph
            rows["paged_mqa_attention_band_pt_d64"] = band
    rows["kv_append_decode_d64"] = check_kv_append(dev, gen, "kv4", d=64,
                                                   kept_shape=(128, 8))
    rows["kv_append_decode_pt_d64"] = check_kv_append(dev, gen, "pt8", d=64)
    check_kv_append_pools(dev, gen, "kv16", 8, d=64)
    rows["flash_prefill_d64"] = check_flash(dev, gen, d=64)
    rows["flash_prefill_band_d64"] = check_flash_band(dev, gen, d=64)
    rows["paged_prefill_attention_d64"] = check_paged_prefill(dev, gen, d=64)
    rows["paged_prefill_pt_d64"] = check_paged_prefill(
        dev, gen, kv_bits=8, per_tensor=True, d=64)
    check_paged_prefill(dev, gen, kv_bits=16, d=64)
    rows["paged_prefill_ring_pt_d64"] = check_paged_ring(
        dev, gen, 32000, 32000, 314, "phase 14 (b)'s first chunk", "pt8",
        d=64)
    check_paged_ring(dev, gen, 20000, 2048, 80, "wrapped", "pt8", d=64)
    check_paged_ring(dev, gen, 20000, 2048, 80, "wrapped", "kv4", d=64)
    check_family_gemms(dev, gen, D64_FAMILIES)
    return rows


def check_d64_forwards(dev):
    """Phase 3 at head_dim 64: Llama-3.2-1B's widths, 2 layers: the
    whole-prompt prefill, a decode step (the split path: row 10, then row
    6) and a chunked prefill at w4a8kv4, kernels against plain, each of
    D64_FORWARD_KERNELS launched; then LServe's decode side at the
    reference's LServe precision (w8a8kv8 per-tensor, scales calibrated on
    a dense kv16 twin) and at w16a16kv16 (a 10-step window of graphs
    against the eager loop), each decode call held in place against its
    plain version (``check_sparse_forward``'s ``per_call``)."""
    check_family_forwards(dev, D64_FAMILIES, D64_FORWARD_KERNELS)
    for precision in ("w8a8kv8-pt", "w16a16kv16"):
        gc.collect()
        check_sparse_forward(dev, precision, geometry=LLAMA32_1B,
                             per_call=True)


# the wrappers of rows 4 and 5 (the single-pass kernels)
SINGLE_PASS_WRAPPERS = ("paged_decode_attention_fused",
                        "paged_mqa_attention_single_pass_ph",
                        "paged_mqa_attention_single_pass")


@contextlib.contextmanager
def plain_routes():
    """While the block runs, count the dispatch decisions that send a CUDA
    tensor to a plain version (``cuda.use_kernel`` False on a CUDA tensor)
    and the calls of rows 4 and 5's wrappers: the dict yielded gets
    "plain", "kernel" and "rows 4 / 5" counts."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    real = cuda.use_kernel
    wrapped = {n: getattr(da, n) for n in SINGLE_PASS_WRAPPERS}
    seen = {"plain": 0, "kernel": 0, "rows 4 / 5": 0}

    def counting(t):
        use = real(t)
        if t.is_cuda:
            seen["kernel" if use else "plain"] += 1
        return use

    def counted(fn):
        def call(*args, **kw):
            seen["rows 4 / 5"] += 1
            return fn(*args, **kw)
        return call

    cuda.use_kernel = counting
    for n, fn in wrapped.items():
        setattr(da, n, counted(fn))
    try:
        yield seen
    finally:
        cuda.use_kernel = real
        for n, fn in wrapped.items():
            setattr(da, n, fn)


def run_llama32(dev):
    """Phase 14: Llama-3.2-1B (LLAMA32_1B) at full width and depth, random
    weights from a seed: (a) ``bench.py``'s protocol at w4a8kv4 (batch 128,
    1,024 in / 512 out, chunks of 8,192, 32-step windows, w8a8 lm_head;
    warmup and measured round), then the IFB engine's 8 x 1,024 whole
    prompts (row 9); (b) the LServe command at the reference's LServe
    precision (w8a8kv8 per-tensor, both flags, static sparsity 0.5; batch
    1, 32,768 in / 128 out in two chunks, then 16,384 in / 32 out whole
    prompt; warmup and measured rounds, untraced). Every request finishes
    with its token count; no head_dim-64 call reaches rows 4 / 5 (their
    launch counts stay 0) or a plain version (no dispatch decision sends a
    CUDA tensor to one). Returns (launches, stats)."""
    import torch

    from omniserve_tpu_torch.ops import cuda

    model = ("llama3.2-1b", LLAMA32_1B)
    launches, stats = {}, {}
    with plain_routes() as routes:
        log("  (a) bench.py's protocol at w4a8kv4, batch 128")
        bench_stats = {}
        bench = run_bench(dev, kernels=D64_BENCH_KERNELS, trace=False,
                          stats=bench_stats, model=model)
        stats["bench"] = bench_stats
        launches.update(bench)
        log("  (a) the IFB engine, 8 x 1,024 whole prompts, 32 tokens each")
        engine = run_engine(dev, model=model, kernels=D64_ENGINE_KERNELS,
                            profile=False)
        launches["flash_prefill_d64"] = engine["flash_prefill_d64"]
        gc.collect()
        torch.cuda.empty_cache()
        log("  (b) the LServe command at w8a8kv8 per-tensor, both flags")
        lserve_stats = {}
        lserve = run_lserve_prefill(
            dev, precision="w8a8kv8", granularity="per_tensor",
            stats=lserve_stats, trace=False, model=model)
        stats["lserve"] = lserve_stats
        for name, n in lserve.items():
            launches[name] = launches.get(name, 0) + n
    reached = {n: bench[n] + engine[n] for n in cuda.LAUNCHES
               if n.startswith("decode_attention_")
               and bench[n] + engine[n]}
    log(f"  phase 14 dispatch decisions on CUDA tensors: "
        f"{routes['kernel']} to kernels, {routes['plain']} to plain "
        f"versions; calls of rows 4 / 5's wrappers: {routes['rows 4 / 5']}"
        f"; their launches in (a): {reached or 'none'}")
    if routes["plain"] or routes["rows 4 / 5"] or reached:
        raise AssertionError(f"phase 14: {routes['plain']} calls took a "
                             f"plain version, {routes['rows 4 / 5']} reached "
                             f"rows 4 / 5 ({reached})")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 15: checkpoints through the weight loader and the converter
# ---------------------------------------------------------------------------

_ST_DTYPE_NAMES = {"torch.float32": "F32", "torch.float16": "F16",
                   "torch.bfloat16": "BF16"}


def write_safetensors(path: str, tensors) -> int:
    """Write ``tensors`` (name -> CPU torch tensor, F32 / F16 / BF16) as one
    safetensors file, in the format the ``safetensors`` package writes: an
    8-byte little-endian header length, the JSON header (each tensor's
    ``dtype``, ``shape`` and ``data_offsets`` from the first byte after the
    header, plus ``__metadata__``) padded with spaces to 8 bytes, then the
    bytes in header order. Returns the bytes of tensor data."""
    import struct

    import torch

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPE_NAMES[str(t.dtype)],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy())
    return offset


def write_hf_checkpoint(path: str, config: dict, tensors,
                        n_shards: int = 1) -> None:
    """An HF checkpoint directory: ``config.json`` and ``tensors`` in
    ``n_shards`` safetensors files (``model-0000k-of-0000n.safetensors``
    with ``model.safetensors.index.json`` when more than one)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    names = list(tensors)
    if n_shards == 1:
        write_safetensors(os.path.join(path, "model.safetensors"), tensors)
        return
    per = -(-len(names) // n_shards)
    weight_map, total = {}, 0
    for k in range(n_shards):
        fname = f"model-{k + 1:05d}-of-{n_shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[k * per:(k + 1) * per]}
        total += write_safetensors(os.path.join(path, fname), part)
        weight_map.update(dict.fromkeys(part, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)


def draw_hf_llama(config: dict, dev, seed: int = 0, std: float = 0.02,
                  n_layers=None):
    """Seeded fp weights of an HF Llama of ``config`` (its first
    ``n_layers``), drawn on ``dev`` from an explicit generator and kept as
    bf16 CPU tensors under HF's names: projections and the embedding
    ``std * N(0, 1)``, norm weights ``1 + std * N(0, 1)``; no
    ``lm_head.weight`` (tied embeddings)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    d, inter = config["hidden_size"], config["intermediate_size"]
    hd = head_dim_of(config)
    q, kv = (config["num_attention_heads"] * hd,
             config["num_key_value_heads"] * hd)

    def normal(*shape, mean=0.0):
        t = torch.randn(shape, generator=gen, device=dev) * std + mean
        return t.to(torch.bfloat16).cpu()

    out = {"model.embed_tokens.weight": normal(config["vocab_size"], d)}
    shapes = (("self_attn.q_proj", (q, d)), ("self_attn.k_proj", (kv, d)),
              ("self_attn.v_proj", (kv, d)), ("self_attn.o_proj", (d, q)),
              ("mlp.gate_proj", (inter, d)), ("mlp.up_proj", (inter, d)),
              ("mlp.down_proj", (d, inter)))
    for i in range(n_layers or config["num_hidden_layers"]):
        base = f"model.layers.{i}"
        for ln in ("input_layernorm", "post_attention_layernorm"):
            out[f"{base}.{ln}.weight"] = normal(d, mean=1.0)
        for name, shape in shapes:
            out[f"{base}.{name}.weight"] = normal(*shape)
    out["model.norm.weight"] = normal(d, mean=1.0)
    return out


def in_memory_params(draw, spec, dev):
    """The port's parameter tree of ``draw`` quantized in memory (the
    loader's fusion and quantizers, without its files): what an engine
    served through ``load_params`` reads."""
    import numpy as np
    import torch

    from omniserve_tpu_torch.models import llama

    L = spec.num_layers

    def stack(part):
        return np.stack([draw[f"model.layers.{i}.{part}.weight"].float()
                         .numpy() for i in range(L)])

    fp_layers = {
        "attn_ln": stack("input_layernorm"),
        "mlp_ln": stack("post_attention_layernorm"),
        "qkv": llama.fuse_qkv_rank_major(stack("self_attn.q_proj"),
                                         stack("self_attn.k_proj"),
                                         stack("self_attn.v_proj")),
        "o": stack("self_attn.o_proj"),
        "gate_up": llama.fuse_gate_up_rank_major(stack("mlp.gate_proj"),
                                                 stack("mlp.up_proj")),
        "down": stack("mlp.down_proj"),
    }
    embed = draw["model.embed_tokens.weight"].to(dev)
    params = {
        "embed": embed,
        "final_ln": draw["model.norm.weight"].float().to(dev),
        "lm_head": embed.t().contiguous(),
        "layers": llama.quantize_layer_weights(fp_layers, spec, device=dev),
        "attn_meta": llama.make_attn_meta(spec, device=dev),
    }
    if spec.lm_head_bits == 8:
        params["lm_head"], params["lm_head_scale"] = llama._quantize_lm_head(
            params["lm_head"])
    return params


def cpu_layer_equal(draw, spec, params, layer: int) -> int:
    """Every packed tensor of ``layer`` in ``params`` (on the card) against
    the port's CPU quantization of the same draw, byte for byte; returns
    the bytes compared."""
    import torch

    from omniserve_tpu_torch.models import llama

    def w(part):
        return draw[f"model.layers.{layer}.{part}.weight"].float()

    fused = {
        "qkv": torch.cat([w("self_attn.q_proj"), w("self_attn.k_proj"),
                          w("self_attn.v_proj")]),
        "o": w("self_attn.o_proj"),
        "gate_up": torch.cat([w("mlp.gate_proj"), w("mlp.up_proj")]),
        "down": w("mlp.down_proj"),
    }
    n = 0
    for name, fp in fused.items():
        want = llama._quantize_linear(fp, spec)
        got = params["layers"][name]
        for field, a in zip(want._fields, want):
            b = getattr(got, field)[layer].cpu()
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"phase 15: layer {layer} {name}."
                                     f"{field} differs from the CPU "
                                     "quantization")
            n += a.numel() * a.element_size()
    return n


@contextlib.contextmanager
def host_rss_peak(period_s: float = 0.02):
    """While the block runs, sample this process's resident set size
    (``VmRSS`` of ``/proc/self/status``, read only) every ``period_s``;
    the dict yielded gets the largest sample in GiB under "gib"."""
    import threading

    out = {"gib": 0.0}
    stop = threading.Event()

    def rss_gib():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
        return float("nan")

    def sample():
        while not stop.is_set():
            out["gib"] = max(out["gib"], rss_gib())
            stop.wait(period_s)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield out
    finally:
        stop.set()
        th.join()
        out["gib"] = max(out["gib"], rss_gib())


@contextlib.contextmanager
def load_meter(dev, label: str, stats: dict):
    """Wall seconds, peak host RSS and peak device memory of the block,
    logged and kept in ``stats[label]``."""
    import torch

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    held = device_gib(dev, lambda: torch.cuda.memory_allocated(dev))
    t0 = time.time()
    with host_rss_peak() as rss:
        yield
        sync(dev)
    stats[label] = dict(s=time.time() - t0, host_gib=rss["gib"],
                        device_gib=device_gib(
                            dev, lambda: torch.cuda.max_memory_allocated(dev)))
    log(f"  {label}: {stats[label]['s']:.2f} s, peak host RSS "
        f"{stats[label]['host_gib']:.2f} GiB, peak device memory "
        f"{stats[label]['device_gib']:.2f} GiB ({held:.2f} GiB held "
        "before)")


def checkpoint_engine(dev, model_dir, prompts, gen_len,
                      load_format="auto", **extra):
    """An IFB engine on ``model_dir`` sized for ``prompts`` (whole-prompt
    prefill, w8a8 lm_head)."""
    from omniserve_tpu_torch import EngineArgs, LLMEngine

    page = 128
    pages_per_seq = (max(map(len, prompts)) + gen_len + page - 1) // page
    return LLMEngine.from_engine_args(EngineArgs(
        model=model_dir, load_format=load_format, lm_head_precision="w8a8",
        tokenizer_mode="skip", device=str(dev), block_size=page,
        max_num_seqs=len(prompts),
        max_num_batched_tokens=2 * sum(map(len, prompts)),
        num_retrieval_blocks=len(prompts) * pages_per_seq + 8,
        disable_log_stats=True, seed=0, **extra))


def serve_greedy(engine, prompts, gen_len):
    """{request: tokens} of ``prompts`` served greedily, once every request
    finished with ``gen_len`` tokens."""
    from omniserve_tpu_torch import SamplingParams

    for i, p in enumerate(prompts):
        engine.add_request(f"req{i}", prompt_token_ids=list(p),
                           sampling_params=SamplingParams(
                               temperature=0.0, max_tokens=gen_len,
                               ignore_eos=True))
    finished, steps = {}, 0
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                finished[o.request_id] = list(o.outputs[0].token_ids)
        steps += 1
        if steps > 4 * gen_len:
            raise AssertionError("phase 15: the engine did not finish")
    bad = {r: len(t) for r, t in finished.items() if len(t) != gen_len}
    if len(finished) != len(prompts) or bad:
        raise AssertionError(f"phase 15: finished {sorted(finished)}, "
                             f"short {bad}")
    return finished


PACKED_LAYERS = 4   # phase 15 (b)'s depth cut (its time)


def run_checkpoints(dev, hf_dir: str):
    """Phase 15: Llama-3.2-1B (LLAMA32_1B) served from files.

    (a) A seeded draw (std 0.02) written as an HF checkpoint in bf16
    safetensors (two shards with their index, config.json, no
    ``lm_head.weight``), served through ``LLMEngine`` (``load_format=
    "auto"``, w4a8kv4, w8a8 lm_head) at full width and depth: every packed
    tensor of layers 0 and 15 and the lm_head equal to the port's CPU
    quantization of the draw byte for byte, and 8 requests of 1,024 in /
    32 out (greedy) the tokens of an engine served the in-memory
    quantization through ``load_params``.
    (b) The same draw's first ``PACKED_LAYERS`` layers as a QoQ fake-quant
    dump at g128 with per-tensor KV calibration (``make_fake_quant_dump``),
    converted (``ckpt_converter.convert``) and served at w4a8kv8
    ``--group-size 128 --kv-quant-granularity per_tensor``: the pools carry
    the file's per-tensor scales, and the requests finish.
    Logs the load seconds, peak host RSS and peak device memory of each,
    and the dump's and converter's seconds. (a)'s files stay in ``hf_dir``
    for phase 17; the rest go at the end."""
    import shutil

    import numpy as np
    import torch

    from omniserve_tpu_torch.ckpt_converter import convert as conv
    from omniserve_tpu_torch.ckpt_converter import make_fake_quant_dump
    from omniserve_tpu_torch.models import llama

    stats = {}
    root = os.path.join(ROOT, "build", "chip_smoke", "phase15")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(0)
    vocab = LLAMA32_1B["vocab_size"]
    prompts = [rng.integers(0, vocab, 1024).tolist() for _ in range(8)]
    try:
        t0 = time.time()
        draw = draw_hf_llama(LLAMA32_1B, dev)
        shutil.rmtree(hf_dir, ignore_errors=True)
        write_hf_checkpoint(hf_dir, LLAMA32_1B, draw, n_shards=2)
        log(f"  (a) drew {sum(t.numel() for t in draw.values()) / 1e9:.3f} "
            f"B bf16 weights (seed 0) and wrote them as 2 safetensors "
            f"shards in {time.time() - t0:.1f} s")
        with load_meter(dev, "(a) HF load", stats):
            engine = checkpoint_engine(dev, hf_dir, prompts, 32,
                                       precision="w4a8kv4")
        got = serve_greedy(engine, prompts, 32)
        runner = engine.worker.model_runner
        last = LLAMA32_1B["num_hidden_layers"] - 1
        n = sum(cpu_layer_equal(draw, runner.spec, runner.params, layer)
                for layer in (0, last))
        want_q, want_s = llama._quantize_lm_head(
            draw["model.embed_tokens.weight"].t().contiguous())
        if not (torch.equal(runner.params["lm_head"].cpu(), want_q)
                and torch.equal(runner.params["lm_head_scale"].cpu(),
                                want_s)):
            raise AssertionError("phase 15: the lm_head differs from the "
                                 "CPU quantization of the tied embedding")
        log(f"  (a) layers 0 and {last} ({n / 2**20:.1f} MiB of packed "
            f"tensors) and the w8 lm_head equal the CPU quantization of "
            f"the draw byte for byte")
        spec = runner.spec
        del engine, runner
        gc.collect()
        torch.cuda.empty_cache()
        engine = checkpoint_engine(dev, hf_dir, prompts, 32,
                                   load_format="dummy", precision="w4a8kv4")
        engine.worker.model_runner.load_params(
            in_memory_params(draw, spec, dev))
        want = serve_greedy(engine, prompts, 32)
        del engine
        same = sum(got[r] == want[r] for r in want)
        log(f"  (a) 8 x 1,024 in / 32 out, greedy: {same} of 8 requests "
            f"give the in-memory engine's tokens")
        if same != len(want):
            raise AssertionError("phase 15: the HF checkpoint's engine and "
                                 "the in-memory engine part")
        gc.collect()
        torch.cuda.empty_cache()

        cut = dict(LLAMA32_1B, num_hidden_layers=PACKED_LAYERS)
        small = {k: t for k, t in draw.items()
                 if not k.startswith("model.layers.")
                 or int(k.split(".")[2]) < PACKED_LAYERS}
        del draw
        b_dir = os.path.join(root, "llama3.2-1b")
        write_hf_checkpoint(b_dir, cut, small)
        del small
        dump_dir = os.path.join(root, "dump")
        t0 = time.time()
        make_fake_quant_dump.make_dump(b_dir, dump_dir, group_size=128,
                                       kv_per_tensor=True)
        stats["(b) dump s"] = time.time() - t0
        t0 = time.time()
        packed = conv.convert(b_dir, dump_dir, 4, 128, True,
                              os.path.join(root, "packed"), device=str(dev))
        sync(dev)
        stats["(b) convert s"] = time.time() - t0
        log(f"  (b) fake-quant dump (g128, per-tensor KV) of the draw's "
            f"first {PACKED_LAYERS} layers {stats['(b) dump s']:.2f} s, "
            f"conversion {stats['(b) convert s']:.2f} s")
        with load_meter(dev, "(b) packed load", stats):
            engine = checkpoint_engine(
                dev, packed, prompts, 32, precision="w4a8kv8",
                group_size=128, kv_quant_granularity="per_tensor")
        serve_greedy(engine, prompts, 32)
        with np.load(os.path.join(packed, "packed.npz")) as z:
            pt = z["kv_pt_scales"]
        pool = engine.worker.model_runner.cache_engine.retrieval_pool
        k_got = pool.k_scale_per_tensor.cpu().numpy()
        v_got = pool.v_scale_per_tensor.cpu().numpy()
        if not (np.array_equal(k_got, pt[:, 0])
                and np.array_equal(v_got, pt[:, 1])) or (k_got == 1).all():
            raise AssertionError(f"phase 15: the pool's per-tensor scales "
                                 f"{k_got}, {v_got} are not the file's {pt}")
        log(f"  (b) served {PACKED_LAYERS} layers at w4a8kv8 g128 "
            f"per-tensor: 8 x 1,024 in / 32 out finished; pool K / V "
            f"scales {k_got[0]:.6g} / {v_got[0]:.6g} (the file's, not 1)")
        del engine
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return stats


# ---------------------------------------------------------------------------
# phase 2 / 3 at Mixtral's expert GEMMs and phase 16: Mixtral-8x7B
# ---------------------------------------------------------------------------

# Mixtral-8x7B (public config.json, mistralai/Mixtral-8x7B-v0.1): 32
# layers, hidden 4,096, 8 experts of intermediate 14,336 with top-2
# routing, 32 q heads over 8 kv heads of 128, vocab 32,000, rope theta
# 1e6, a 32,768-token context, no sliding window
MIXTRAL_8X7B = dict(
    architectures=["MixtralForCausalLM"], model_type="mixtral",
    hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
    num_key_value_heads=8, num_hidden_layers=32, vocab_size=32000,
    num_local_experts=8, num_experts_per_tok=2, rope_theta=1000000.0,
    rms_norm_eps=1e-5, max_position_embeddings=32768, sliding_window=None,
    tie_word_embeddings=False,
)
# its expert GEMMs (name, K, N); the [L*E, ...] stack of each kind the
# served path indexes; an expert's M (its capacity): at decode batch 128,
# at an 8,192-token chunk and at the bench's [128, 128] chunks
MOE_GEMMS = [("w13", 4096, 28672), ("w2", 14336, 4096)]
MOE_STACK = 32 * 8
MOE_M = (64, 4096, 8192)
# the kernels-line entries of the expert GEMMs, by body
MOE_ENTRIES = {
    "channel": "w4a8_matmul_per_channel_moe",
    "group": "w4a8_matmul_per_group_moe",
    "w8": "w8a8_matmul_moe",
}


def moe_stack(dev, gen, mode, k, n, idx):
    """A [MOE_STACK, ...] expert stack of ``mode``'s container (per channel,
    g128, W8) with the matrices ``idx`` drawn; the others stay unwritten
    (a kernel sees only the pointer of the matrix it is given)."""
    import torch

    from omniserve_tpu_torch.ops.quantization import (
        QuantizedWeightPerChannel,
        QuantizedWeightPerGroup,
        QuantizedWeightW8,
    )

    w8 = mode == "w8"
    rows = k if w8 else k // 2
    qw = torch.empty((MOE_STACK, rows, n), device=dev,
                     dtype=torch.int8 if w8 else torch.uint8)
    s1 = torch.zeros((MOE_STACK, n), device=dev)
    s2 = s2z = None
    if mode == "group":
        s2 = torch.zeros((MOE_STACK, k // 128, n), dtype=torch.int8,
                         device=dev)
        s2z = torch.zeros_like(s2)
    for i in idx:
        qw[i] = torch.randint(-127 if w8 else 0, 128 if w8 else 256,
                              (rows, n), generator=gen, dtype=qw.dtype,
                              device=dev)
        s1[i].uniform_(*((0.0003, 0.0006) if w8 else (0.003, 0.006)),
                       generator=gen)
        if s2 is not None:
            s2[i] = torch.randint(1, 18, (k // 128, n), generator=gen,
                                  dtype=torch.int8, device=dev)
            s2z[i] = torch.randint(-128, 128, (k // 128, n), generator=gen,
                                   dtype=torch.int8, device=dev)
    if mode == "channel":
        return QuantizedWeightPerChannel(qw, s1, 8.0 * s1)
    if w8:
        return QuantizedWeightW8(qw, s1)
    return QuantizedWeightPerGroup(qw, s1, s2, s2z)


def check_moe_gemms(dev, gen):
    """Rows 1-3 at Mixtral-8x7B's expert GEMMs as the served path calls
    them (``llama._apply_linear`` on index ``layer * E + e`` of a [L*E,
    ...] stack, inside ``cuda.expert_launches``): per channel, g128 and
    W8 bodies, both expert shapes (MOE_GEMMS) at each M of MOE_M, the
    experts at stack index 0 and L*E - 1 = 255 each equal to the plain
    version within 1e-5 and counted under its ``_moe`` entry; timed (M =
    64 by graph replay over matrices of the stack rotated past L2, as a
    decode step finds them cold), beside the plain version, the bound and
    ``torch._int_mm`` + epilogue. Returns the kernels-line entries: one
    expert's two GEMMs at M = 64, the error the largest of all."""
    import torch

    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.matmul import dequant_per_group
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    entries = {}
    for mode, entry in MOE_ENTRIES.items():
        rows, worst = [], 0.0
        for name, k, n in MOE_GEMMS:
            w_bytes = (k if mode == "w8" else k // 2) * n + (
                2 * (k // 128) * n if mode == "group" else 0)
            n_rot = max(1, math.ceil(120e6 / w_bytes))
            idx = sorted(set(range(n_rot)) | {MOE_STACK - 1})
            w = moe_stack(dev, gen, mode, k, n, idx)
            spec = llama.LlamaSpec(
                num_layers=1, hidden=k, intermediate=n, num_q_heads=1,
                num_kv_heads=1, head_dim=128, vocab=8,
                weight_bits=8 if mode == "w8" else 4,
                group_size=128 if mode == "group" else -1)
            if mode == "channel":
                w_i8 = torch.cat([w.qweight[0] & 0xF,
                                  w.qweight[0] >> 4]).to(torch.int8)
            elif mode == "group":
                w_i8 = dequant_per_group(w.qweight[0], w.s2_scales[0],
                                         w.s2_zeros[0], 128)
            else:
                w_i8 = w.qweight[0]
            for m in MOE_M:
                a_i8, a_scale, a_sum = quantize_activations(
                    torch.randn((m, k), generator=gen, device=dev),
                    fuse_sum=mode == "channel")

                def call(i):
                    with cuda.expert_launches():
                        return llama._apply_linear(w, spec, a_i8, a_scale,
                                                   a_sum, i)

                for i in (0, MOE_STACK - 1):
                    before = cuda.LAUNCHES[entry]
                    got = call(i)
                    if cuda.LAUNCHES[entry] != before + 1:
                        raise AssertionError(f"{entry}: the launch was not "
                                             "counted as an expert GEMM")
                    with cuda.plain_versions():
                        want = call(i)
                    worst = max(worst, allclose_err(
                        got, want, 1e-5, 1e-5,
                        f"{entry} {name} M={m} stack index {i}"))
                    del got, want
                ms = time_gemm_ms(call, idx[:n_rot], m)
                with cuda.plain_versions():
                    plain = time_ms(lambda: call(0), 3, warmup=1)
                s1 = (w.scales if mode == "w8" else w.s1_scales)[0]
                a_s = a_scale
                if mode == "channel":
                    sz = w.s1_szeros[0]

                    def epi(p, mm):
                        return (p.float() * s1[None] * a_s[:mm, None]
                                - sz[None] * a_sum[:mm, None]).to(
                                    torch.bfloat16)
                else:
                    def epi(p, mm):
                        return (p.float() * s1[None] * a_s[:mm, None]).to(
                            torch.bfloat16)
                lib = int_mm_ms(a_i8, w_i8, epi, 50 if m <= 128 else 10)
                n_bytes = m * k + w_bytes + 8 * n + 8 * m + 2 * m * n
                ops = 2.0 * m * n * k
                bnd, by = bound_ms(n_bytes, ops, INT8_OPS_PER_S)
                plan = qm.gemm_plan(mode, m, n, k, cuda.sm_count(dev))
                rows.append(dict(m=m, ms=ms, plain_ms=plain, bound_ms=bnd,
                                 bound_by=by, library_ms=lib,
                                 max_abs_err=worst))
                log(f"  {entry} {name} M={m:5d} K={k:5d} N={n:5d} (stack "
                    f"of {MOE_STACK}, indices 0 and {MOE_STACK - 1} held): "
                    f"kernel_ms {ms:.4f}{' (graph replay)' if m <= 128 else ''}"
                    f" plain_ms {plain:.4f} bound_ms {bnd:.4f} ({by}) "
                    f"library_ms {lib:.4f} max_abs_err {worst:.3g}; "
                    f"{plan_note(plan)}; {100 * bnd / ms:.1f}% of the bound")
            del w, w_i8
            gc.collect()
            torch.cuda.empty_cache()
        for m in MOE_M:
            r = layer_row(rows, m)
            log(f"  {entry} one expert's w13 + w2 at M={m}: kernel_ms "
                f"{r['ms']:.4f} bound_ms {r['bound_ms']:.4f} "
                f"({r['bound_by']}) = {100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of the bound; 16 such GEMMs a layer")
        entries[entry] = layer_row(rows, MOE_M[0])
    return entries


def mixtral_spec(precision, num_layers=2):
    """Mixtral-8x7B's widths at ``num_layers`` layers and one precision of
    ``PRECISIONS``, the bf16 lm_head (the only one the JAX package's
    Mixtral has)."""
    from omniserve_tpu_torch.models import mixtral

    g = MIXTRAL_8X7B
    wb, ab, gs, kv, zeros = PRECISIONS[precision]
    return mixtral.MixtralSpec(
        num_layers=num_layers, hidden=g["hidden_size"],
        intermediate=g["intermediate_size"],
        num_q_heads=g["num_attention_heads"],
        num_kv_heads=g["num_key_value_heads"], head_dim=head_dim_of(g),
        vocab=g["vocab_size"], rope_base=g["rope_theta"],
        rms_eps=g["rms_norm_eps"], page_size=128, lm_head_bits=16,
        weight_bits=wb, act_bits=ab, group_size=gs, kv_bits=kv,
        kv_zeros=zeros, num_experts=g["num_local_experts"],
        top_k=g["num_experts_per_tok"])


@contextlib.contextmanager
def recorded_routing():
    """Within the block, each MoE block's routing records (its tokens' top-k
    expert sets [T, k] in index order, the valid rows [T], the router
    logits [T, E]) in call order."""
    import torch

    from omniserve_tpu_torch.ops import moe as moe_ops

    seen = []
    real = moe_ops.route_topk

    def rec(logits, top_k, capacity, valid=None):
        sets = torch.sort(torch.topk(logits, top_k, dim=-1).indices,
                          dim=-1).values
        seen.append((sets, torch.ones(logits.shape[0], dtype=torch.bool,
                                      device=logits.device)
                     if valid is None else valid, logits.clone()))
        return real(logits, top_k, capacity, valid=valid)

    moe_ops.route_topk = rec
    try:
        yield seen
    finally:
        moe_ops.route_topk = real


def routing_agreement(a, b, k):
    """Two runs' routing records (``recorded_routing``, layer by layer):
    (tokens whose top-k sets agree in every layer [T], the differing
    (token, layer) choices by layer, the valid ones by layer, a note on
    the flipped choices: the largest margin between b's k-th and (k+1)-th
    router logit among them, beside the median margin of all valid
    tokens, and by layer the largest router-logit move of the tokens that
    routed alike in every layer so far)."""
    import torch

    differ = torch.stack([(x != y).any(-1) & v
                          for (x, v, _), (y, _, _) in zip(a, b)])
    alike = torch.cumprod((~differ).int(), dim=0).bool()
    flipped_margin, margins, drift = 0.0, [], []
    for layer, ((_, v, la), (_, _, lb)) in enumerate(zip(a, b)):
        top = torch.topk(lb.float(), k + 1, dim=-1).values
        margin = top[:, k - 1] - top[:, k]
        margins.append(margin[v])
        if bool(differ[layer].any()):
            flipped_margin = max(flipped_margin,
                                 float(margin[differ[layer]].max()))
        still = v & alike[layer]
        drift.append(float((la.float() - lb.float())[still].abs().max())
                     if bool(still.any()) else 0.0)
    note = (f"largest margin of a flipped choice {flipped_margin:.3g}, "
            f"median margin {float(torch.cat(margins).median()):.3g}; "
            f"router logits of the tokens that routed alike moved by up to "
            + " / ".join(f"{x:.3g}" for x in drift) + " by layer")
    return (~differ.any(0), [int(d.sum()) for d in differ],
            [int(v.sum()) for _, v, _ in a], note)


MIXTRAL_FORWARD_PRECISIONS = ("w4a8kv4", "w4a8kv4-g128", "w8a8kv8-pt")


def check_mixtral_forwards(dev):
    """Phase 16 (b): 2-layer Mixtral-8x7B forwards at full width, w4a8kv4,
    g128 and w8a8kv8 per-tensor (unit scales; its gate max(5e-2, 3 x the
    one-ulp floor) as the dense W8A8 forwards'): a prefill chunk ([4, 512],
    prompts of 512, 300, 512 and 450 tokens: padding rows in the chunk) and
    a decode step, kernels against plain versions, and the plain versions
    with one-ulp attention nudges (the routing's own sensitivity). Each
    run records every token's top-2 expert set in every layer: fewer than
    1% of layer 0's (token, layer) choices may differ kernels vs plain
    (layer 1 inherits layer 0's flips through the K / V its neighbours
    read; every layer's share is printed), and the logits of the rows
    whose token routed alike in every layer hold the gate. Then, at
    w4a8kv4, an 8-step window replayed from a captured graph against the
    eager loop. Returns the launches of the g128 and W8 expert entries."""
    import torch

    from omniserve_tpu_torch.models import llama, mixtral
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.worker.model_runner import chunked_prefill_batches

    lens = [512, 300, 512, 450]
    pages = 5                          # 513 tokens after the decode step
    tables = torch.arange(len(lens) * pages,
                          dtype=torch.int32).view(len(lens), pages)
    rng = torch.Generator(device="cpu").manual_seed(3)
    launches, failures = {}, []
    for precision in MIXTRAL_FORWARD_PRECISIONS:
        spec = mixtral_spec(precision)
        with_floor = spec.weight_bits == 8
        cuda.reset_launch_counts()
        params = mixtral.make_random_packed_params(spec, seed=1, device=dev)
        prompts = [torch.randint(0, spec.vocab, (n,), generator=rng).tolist()
                   for n in lens]
        seqs = [(p, tables[i].tolist()) for i, p in enumerate(prompts)]
        (batch, ends), = list(chunked_prefill_batches(seqs, 2048, 128, dev))
        # the floor run (the plain versions with one-ulp attention nudges)
        # shows how far this random model's routing moves under rounding
        modes = ("kernels", "plain", "floor")
        res = {}
        for mode in modes:
            pool = forward_pool(spec, tables.numel() + 1, dev)
            with _mode_ctx(mode), torch.inference_mode(), \
                    recorded_routing() as routes:
                lp, _, _, _ = mixtral.mixtral_forward(params, pool, None,
                                                      batch, spec,
                                                      is_prefill=True)
                res[mode] = dict(prefill=lp[: len(lens)], pool=pool,
                                 routes_pre=list(routes))
        dec = llama.DecodeBatch(
            token_ids=res["plain"]["prefill"].argmax(-1),
            positions=torch.tensor(lens, dtype=torch.int32, device=dev),
            block_tables=tables.to(dev),
            active=torch.ones(len(lens), dtype=torch.bool, device=dev))
        for mode in modes:
            with _mode_ctx(mode), torch.inference_mode(), \
                    recorded_routing() as routes:
                ld, _, _, _ = mixtral.mixtral_forward(
                    params, res[mode]["pool"], None, dec, spec,
                    is_prefill=False)
                res[mode].update(decode=ld, routes_dec=list(routes))
        k = spec.top_k
        ok_tok, p_diff, p_valid, p_note = routing_agreement(
            res["kernels"]["routes_pre"], res["plain"]["routes_pre"], k)
        ok_dec, d_diff, d_valid, d_note = routing_agreement(
            res["kernels"]["routes_dec"], res["plain"]["routes_dec"], k)
        n_diff = sum(p_diff) + sum(d_diff)
        n_valid = sum(p_valid) + sum(d_valid)
        share = n_diff / n_valid
        _, f_pre, _, _ = routing_agreement(
            res["floor"]["routes_pre"], res["plain"]["routes_pre"], k)
        _, f_dec, _, _ = routing_agreement(
            res["floor"]["routes_dec"], res["plain"]["routes_dec"], k)
        floor_share = (sum(f_pre) + sum(f_dec)) / n_valid
        # a row's logits are its last token's: gated where that token
        # routed alike in every layer
        last_ok = ok_tok[batch.last_token_idx.long()]
        log(f"  mixtral {precision} 2 layers: {n_diff} of {n_valid} (token, "
            f"layer) top-2 choices differ kernels vs plain ({share:.3g}); "
            f"by layer: prefill {p_diff} of {p_valid} ({p_note}), decode "
            f"{d_diff} of {d_valid} ({d_note}); one-ulp attention nudges "
            f"of the plain run move {floor_share:.3g} (prefill {f_pre}, "
            f"decode {f_dec}); rows whose token routed alike in every "
            f"layer: prefill {int(last_ok.sum())} / {len(lens)}, decode "
            f"{int(ok_dec.sum())} / {len(lens)}")
        # layer 0 reads the same residual stream in both runs but for the
        # attention kernels' rounding; later layers inherit its flips (a
        # token routed elsewhere has other K / V, which its neighbours'
        # attention reads), so the 1% gate holds layer 0's choices
        share0 = (p_diff[0] + d_diff[0]) / (p_valid[0] + d_valid[0])
        log(f"  mixtral {precision}: layer 0's choices differ in {share0:.3g}"
            f" (gate 1%), every layer's in {share:.3g}")
        if share0 >= 0.01:
            failures.append(f"mixtral {precision}: {share0:.4g} of layer "
                            "0's routing choices differ (gate 1%)")
        for step, rows in (("prefill", last_ok), ("decode", ok_dec)):
            a, b_ = res["kernels"][step], res["plain"][step]
            if not bool(torch.isfinite(a).all()) or a.shape != (
                    len(lens), spec.vocab):
                raise AssertionError(f"mixtral {precision} {step}: bad "
                                     f"logits {tuple(a.shape)}")
            if not bool(rows.any()):
                failures.append(f"mixtral {precision} {step}: no row "
                                "routed alike in both runs")
                continue
            scale = float(b_.abs().max())
            err = float((a - b_)[rows].abs().max())
            by = {m: {step: res[m][step]} for m in ("plain", "floor")}
            rtol, floor = logits_bound(by, step, scale, with_floor)
            log(f"  mixtral {precision} 2 layers {step}: max |logit| "
                f"{scale:.4g}, max abs diff kernels vs plain over "
                f"{int(rows.sum())} rows {err:.4g} ({err / scale:.3g} of "
                f"max), argmax agreement "
                f"{float((a.argmax(-1) == b_.argmax(-1)).float().mean()):.2f}"
                + ("" if floor is None else
                   f"; floor {floor:.3g} of max, bound {rtol:.3g}"))
            if err > rtol * scale:
                failures.append(f"mixtral {precision} {step}: logits "
                                f"differ by {err} > {rtol} x {scale}")
        entry = MOE_ENTRIES[{4: "group" if spec.group_size > 0 else "channel",
                             8: "w8"}[spec.weight_bits]]
        if cuda.LAUNCHES[entry] <= 0:
            raise AssertionError(f"mixtral {precision}: no {entry} launch")
        if entry != MOE_ENTRIES["channel"]:     # (a) reports that one's
            launches[entry] = cuda.LAUNCHES[entry]
        log(f"  mixtral {precision}: {entry} launches in the kernels runs "
            f"{cuda.LAUNCHES[entry]} (16 a layer a forward)")
        if precision == "w4a8kv4":
            first = res["kernels"]["prefill"].argmax(-1)
            check_window(dev, spec, params, res["kernels"]["pool"], tables,
                         lens, first, n_steps=8)
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


MOE_CATEGORIES = (
    "expert GEMMs (row 1, _moe)", "attention GEMMs (qkv, o)",
    "attention kernels (rows 4-10)",
    "MoE route / dispatch (norm, router, top-2, quantize, scatter)",
    "MoE stack + SwiGLU quant", "MoE stack + combine (+ next layer's norm)",
    "other (embedding, rope, KV writes, lm_head, sampling)",
)


def moe_breakdown(events, label, n_units, unit):
    """Split a traced Mixtral window's device time. A layer launches its
    int8 GEMMs as qkv, o, then a run of E ``w13`` expert GEMMs and a run of
    E ``w2`` ones with nothing between them: a run of two or more GEMMs is
    expert GEMMs, a lone one an attention GEMM (``o`` when an expert run
    follows it, else ``qkv``), and each other kernel is named by the GEMM
    before it (after ``o``: the router's side; after ``w13``: the
    SwiGLU's; after ``w2``: the combine's). Robust to an event the
    profiler drops. Prints the split per ``unit`` (the window holds
    ``n_units``)."""
    cats = dict.fromkeys(MOE_CATEGORIES, 0.0)
    attn_fns = [f for f in PORT_KERNEL_FUNCTIONS
                if f not in ("int8_wgmma_kernel", "quant_gemm_kernel")]
    is_gemm = ["int8_wgmma_kernel" in e.name for e in events]
    runs = []            # [first, last] event index of each GEMM run
    for i, g in enumerate(is_gemm):
        if g and runs and runs[-1][1] == i - 1:
            runs[-1][1] = i
        elif g:
            runs.append([i, i])
    kind = {}            # run index -> "qkv" / "o" / "w13" / "w2"
    for r, (a, b) in enumerate(runs):
        nxt_expert = r + 1 < len(runs) and runs[r + 1][1] > runs[r + 1][0]
        if b > a:
            kind[r] = "w13" if nxt_expert else "w2"
        else:
            kind[r] = "o" if nxt_expert else "qkv"
    after = {"o": 3, "w13": 4, "w2": 5}
    r = -1
    for i, e in enumerate(events):
        t = e.time_range.elapsed_us() / 1e3
        if is_gemm[i]:
            if r + 1 < len(runs) and runs[r + 1][0] == i:
                r += 1
            cats[MOE_CATEGORIES[0 if kind[r] in ("w13", "w2") else 1]] += t
        elif any(f in e.name for f in attn_fns):
            cats[MOE_CATEGORIES[2]] += t
        elif r >= 0 and kind[r] in after and r + 1 < len(runs):
            cats[MOE_CATEGORIES[after[kind[r]]]] += t
        else:
            cats[MOE_CATEGORIES[6]] += t
    busy = sum(cats.values())
    n_expert = sum(b - a + 1 for q, (a, b) in enumerate(runs)
                   if kind[q] in ("w13", "w2"))
    log(f"  {label}: {n_expert} expert and {sum(is_gemm) - n_expert} "
        f"attention GEMM launches; device busy {busy / n_units:.2f} ms a "
        f"{unit}, split (ms a {unit}): " + "; ".join(
            f"{k} {v / n_units:.3f} ({100 * v / max(busy, 1e-9):.1f}%)"
            for k, v in cats.items()))
    return {k: v / n_units for k, v in cats.items()}


MIXTRAL_BENCH_KERNELS = ("w4a8_matmul_per_channel",
                         "w4a8_matmul_per_channel_moe",
                         "paged_prefill_attention", "decode_attention_append")


def run_mixtral(dev):
    """Phase 16: Mixtral-8x7B (MIXTRAL_8X7B), random weights from a seed,
    the bf16 lm_head. (a) ``bench.py``'s protocol at full width and depth,
    w4a8kv4 per channel (batch 128, 1,024 in / 512 out, chunks of 8,192,
    32-step windows; a warmup round of 32 output tokens, then the measured
    round; a traced decode window and a traced prefill of 16 requests,
    two 8,192-token chunks, split by ``moe_breakdown``), with the
    weights' GiB, peak memory, the expert
    GEMMs' launches and the decode step's bytes bound; (b) 2-layer
    forwards kernels against plain (``check_mixtral_forwards``); (c) the
    reference's LServe command (both flags, static sparsity 0.5) at
    w4a8kv4, 32,736 in / 32 out (the model's whole context), full width
    and depth. Every request
    finishes with its token count. Returns the launches of the kernels-
    line entries it reaches."""
    import torch

    from omniserve_tpu_torch.ops import cuda

    model = ("mixtral-8x7b", MIXTRAL_8X7B)
    launches = {}
    log("  (a) bench.py's protocol at w4a8kv4, batch 128, bf16 lm_head")
    stats = {}
    bench = run_bench(dev, kernels=MIXTRAL_BENCH_KERNELS, stats=stats,
                      model=model, warmup_gen=32, lm_head="fp16",
                      trace_prefill_batch=16)
    launches["w4a8_matmul_per_channel_moe"] = bench[
        "w4a8_matmul_per_channel_moe"]
    batch, multi = 128, 32
    step_ms = batch / stats["decode_tps"] * 1e3
    bound = stats["body_bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"  (a) measured round: prefill step {stats['prefill_ms']:.1f} ms, "
        f"decode {stats['decode_tps']:.1f} tok/s ({step_ms:.2f} ms a step "
        f"at batch {batch}, host clock), weights "
        f"{stats['weight_gib']:.2f} GiB (the body's GEMM weights "
        f"{stats['body_bytes'] / 1e9:.2f} GB), peak device memory "
        f"{stats['peak_gib']:.2f} GiB, graphs {stats['graphs']}; expert "
        f"GEMM launches {bench['w4a8_matmul_per_channel_moe']} "
        f"(attention GEMMs {bench['w4a8_matmul_per_channel']}); a decode "
        f"step's bytes bound (every expert read once) {bound:.3f} ms = "
        f"{100 * bound / step_ms:.1f}% of the step")
    # the traced prefill: 16 x 1,024 tokens in two [16, 512] chunks of
    # 8,192 tokens (an expert's M 4,096)
    for window, n_units, unit in (("prefill", 2, "chunk"),
                                  ("decode", multi, "decode step")):
        events, wall = stats["traces"][window]
        if not events:
            log(f"  (a) traced {window}: the profiler recorded no device "
                "events")
            continue
        moe_breakdown(events, f"(a) traced {window} ({n_units} {unit}s, "
                      f"wall {wall / n_units:.2f} ms a {unit})", n_units,
                      unit)
    del stats, bench
    gc.collect()
    torch.cuda.empty_cache()
    log("  (b) 2-layer forwards at full width, kernels vs plain")
    launches.update(check_mixtral_forwards(dev))
    gc.collect()
    torch.cuda.empty_cache()
    # Mixtral-8x7B's context is 32,768 tokens: the prompt and its 32 output
    # tokens fill it (a longer request is refused by the scheduler)
    long_len = MIXTRAL_8X7B["max_position_embeddings"] - 32
    log(f"  (c) the LServe command at w4a8kv4, both flags, {long_len:,} in "
        "/ 32 out (the model's whole context)")
    lserve_stats = {}
    run_lserve_prefill(dev, long_len=long_len, long_gen=32, short_len=None,
                       trace=False, stats=lserve_stats, model=model)
    moe = cuda.LAUNCHES["w4a8_matmul_per_channel_moe"]
    log(f"  (c) measured round: prefill {lserve_stats['prefill_s']:.3f} s, "
        f"decode {lserve_stats['decode_tps']:.2f} tok/s, peak device memory "
        f"{lserve_stats['peak_gib']:.2f} GiB; expert GEMM launches {moe}")
    if moe <= 0:
        raise AssertionError("(c): no expert GEMM launched")
    return launches



# ---------------------------------------------------------------------------
# phase 17: the port's evals and host prep on the card
# ---------------------------------------------------------------------------

PPL_WINDOWS, PPL_SEQLEN = 4, 2048
# the chunked NLL against a full-logits log_softmax over the same hidden
# states, per token: both are f32 over the same bf16 operands, so they
# part only where cuBLAS sums a column's products in another order
NLL_RTOL = 1e-5
# the kernels each eval's path must launch: the whole-window prefill at
# head_dim 64 (row 9, and row 1 in a W4A8 body); the agreement run's
# whole 8,192-token prompts (row 9 dense and band), dense decode (row 4's
# fused append) and sparse decode (row 10's two-pool append, row 5's
# per-head lists)
PPL_KERNELS = {"w4a8kv4": ("w4a8_matmul_per_channel", "flash_prefill_d64"),
               "w16a16kv16": ("flash_prefill_d64",)}
AGREEMENT_KERNELS = ("w4a8_matmul_per_channel", "flash_prefill",
                     "flash_prefill_band", "decode_attention_append",
                     "kv_append_decode", "decode_attention_ph")
AGREEMENT_PATTERN = os.path.join(ROOT, "attn_patterns",
                                 "Llama-3-8B-Instruct-Gradient-1048k")


def nll_gate_error(h, lm_head, targets, vocab, planted=None) -> float:
    """The largest per-token relative gap between ``eval.ppl``'s chunked
    NLL and the NLL of a full-logits ``log_softmax`` over the same hidden
    states (the padded columns cut off). ``planted`` feeds the chunked
    NLL a fault: "late" the targets a position late, "unmasked" its padded
    columns left in."""
    import torch

    from omniserve_tpu_torch.eval import ppl

    got = ppl.chunked_nll(
        h, lm_head, torch.roll(targets, -1) if planted == "late" else targets,
        lm_head.shape[1] if planted == "unmasked" else vocab)
    logits = h.to(torch.bfloat16).float() @ lm_head[:, :vocab].float()
    want = -torch.log_softmax(logits, dim=-1).gather(
        1, targets.long()[:, None])[:, 0]
    return float(((got - want).abs() / want.abs()).max())


def run_ppl(dev, hf_dir: str, work: str):
    """(a) ``eval.ppl`` on Llama-3.2-1B at full width and depth, read from
    phase 15's HF checkpoint through the weight loader (what
    ``load_format="auto"`` runs): four seqlen-2,048 windows of seeded ids
    from a ``.npy``, at w4a8kv4 and w16a16kv16. Gate: on each precision's
    first window the chunked NLL equals a full-logits log_softmax's within
    NLL_RTOL per token, and both planted faults (targets a position late,
    the padded columns left unmasked) exceed it. Returns the launches."""
    import numpy as np
    import torch

    from omniserve_tpu_torch.eval import ppl
    from omniserve_tpu_torch.ops import cuda

    vocab = LLAMA32_1B["vocab_size"]
    ids_path = os.path.join(work, "ppl_ids.npy")
    np.save(ids_path, np.random.default_rng(17).integers(
        0, vocab, PPL_WINDOWS * PPL_SEQLEN + 1))
    launches = {}
    for precision in PPL_KERNELS:
        args = ppl.parse_args([
            "--model", hf_dir, "--precision", precision, "--text", ids_path,
            "--seqlen", str(PPL_SEQLEN), "--max-windows", str(PPL_WINDOWS)])
        windows = ppl.token_windows(args.text, None, args.seqlen,
                                    args.max_windows)
        t0 = time.time()
        params, spec, pool = ppl.load_model(args, str(dev))
        sync(dev)
        load_s = time.time() - t0
        cuda.reset_launch_counts()
        with torch.no_grad():
            res = ppl.evaluate(params, spec, pool, windows, args.page_size,
                               dev, verbose=False)
        sync(dev)
        got = {k: n for k, n in cuda.LAUNCHES.items() if n}
        idle = [k for k in PPL_KERNELS[precision] if got.get(k, 0) <= 0]
        if idle:
            raise AssertionError(f"phase 17 (a) {precision}: {idle} never "
                                 f"launched ({got})")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        secs = res["window_seconds"]
        log(f"  (a) {precision}: ppl {res['ppl']:.4f} over {res['tokens']} "
            f"tokens; seconds a window {', '.join(f'{s:.3f}' for s in secs)}"
            f" (the first includes warmup); load {load_s:.2f} s; launches "
            f"{got}")
        if not math.isfinite(res["ppl"]):
            raise AssertionError(f"phase 17 (a) {precision}: ppl "
                                 f"{res['ppl']}")
        w = windows[0]
        tokens = torch.tensor(w[:-1], device=dev)
        targets = torch.tensor(w[1:], device=dev)
        with torch.no_grad():
            h, _ = ppl.window_hidden(params, pool, spec, tokens,
                                     args.page_size)
            lm = params["lm_head"]
            err, late, unmasked = (
                nll_gate_error(h, lm, targets, vocab, planted)
                for planted in (None, "late", "unmasked"))
        log(f"  (a) {precision} gate: chunked NLL vs full log_softmax, "
            f"largest per-token relative gap {err:.3g} (tolerance "
            f"{NLL_RTOL:g}); planted: targets a position late {late:.3g}, "
            f"padded columns unmasked {unmasked:.3g}")
        if not err <= NLL_RTOL:
            raise AssertionError(f"phase 17 (a) {precision}: chunked NLL "
                                 f"off the full log_softmax by {err:.3g}")
        if not (late > NLL_RTOL and unmasked > NLL_RTOL):
            raise AssertionError("phase 17 (a): a planted fault passes the "
                                 f"gate ({late:.3g}, {unmasked:.3g})")
        del params, pool, h, lm
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def run_agreement(dev, ctx: int = 8192, gen: int = 32):
    """(b) ``eval.sparse_agreement`` at Llama-3-8B's geometry (LLAMA31_8B's
    config: Llama-3-8B's widths and a context past 8,192), full width and
    depth, seeded dummy weights, w4a8kv4: one context of 8,192 seeded
    prompt ids, 32 greedy tokens through the dense engine twice, the
    sparse-decode engine (budget 4,096, interval 4) and the engine of both
    LServe flags (static sparsity 0.5, the in-repo Llama-3-8B pattern).
    Gates: the two dense runs agree 1.0; every run finishes its 32 tokens.
    The harness's dense noise-floor control (``--control-precision``) is
    not run here: under dummy weights its W8 body is another random draw
    than the W4 one, so its agreement measures nothing until the run reads
    a checkpoint. Returns the launches."""
    import numpy as np
    import torch

    from omniserve_tpu_torch.eval import sparse_agreement as sa
    from omniserve_tpu_torch.ops import cuda

    model_dir = write_model_dir("llama3.1-8b", LLAMA31_8B)
    prompts = {(ctx, 50.0): np.random.default_rng(18).integers(
        0, LLAMA31_8B["vocab_size"], ctx).tolist()}
    flags = ["--model", model_dir, "--precision", "w4a8kv4", "--contexts",
             str(ctx), "--depths", "50", "--gen-len", str(gen)]
    kw = dict(load_format="dummy", tokenizer_mode="skip", device=str(dev),
              seed=0)
    runs = [("dense", False, []), ("dense again", False, []),
            ("sparse decode", True, []),
            ("both flags + pattern", True,
             ["--attn-pattern-path", AGREEMENT_PATTERN])]
    cuda.reset_launch_counts()
    out = {}
    for name, sparse, extra in runs:
        args = sa.parse_args(flags + extra)
        t0 = time.time()
        out[name] = sa.run_mode(args, sparse, prompts, mode=name, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        toks = out[name][(ctx, 50.0)]["tokens"]
        log(f"  (b) {name}: {len(toks)} tokens, {time.time() - t0:.1f} s "
            "with the engine's build")
        if len(toks) != gen:
            raise AssertionError(f"phase 17 (b) {name}: {len(toks)} of "
                                 f"{gen} tokens")
    got = {k: n for k, n in cuda.LAUNCHES.items() if n}
    idle = [k for k in AGREEMENT_KERNELS if got.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"phase 17 (b): {idle} never launched ({got})")
    args = sa.parse_args(flags)
    for name in ("dense again", "sparse decode", "both flags + pattern"):
        res = sa.agreement_result(args, out["dense"], out[name])
        log(f"  (b) dense vs {name}: agreement {res['mean_agreement']} "
            f"(keys {sorted(res)})")
        if name == "dense again" and res["mean_agreement"] != 1.0:
            raise AssertionError("phase 17 (b): the dense engine gave other "
                                 "tokens on its second run")
    log(f"  (b) launches {got}")
    return got


def time_host_prep():
    """(c) The host-prep library: built with g++ and loaded; one batch-128
    decode batch assembly (12-page tables, 6-page streaming tables)
    through it and through the numpy version, equal byte for byte, with
    the median host seconds of 200 calls each."""
    import statistics

    import numpy as np

    from omniserve_tpu_torch import csrc
    from omniserve_tpu_torch.csrc import build

    t0 = time.time()
    lib = csrc.get_lib()
    path = build._target(csrc.HOST_PREP)
    if lib._name != path:
        raise AssertionError(f"phase 17 (c): loaded {lib._name}, built "
                             f"{path}")
    log(f"  (c) host-prep library {os.path.relpath(path, ROOT)} built and "
        f"loaded in {time.time() - t0:.3f} s")
    rng = np.random.default_rng(19)
    entries = [(s, int(rng.integers(0, 128256)), int(rng.integers(1024, 1536)),
                rng.integers(0, 4096, 12).tolist(),
                rng.integers(0, 4096, 6).tolist()) for s in range(128)]
    args = dict(page_size=128, b_pad=128, w=12, sw=6, max_new_pages=128)
    a = csrc.build_decode_batch(entries, **args)
    b = csrc.build_decode_batch_plain(entries, **args)
    if not all((x.tobytes() == y.tobytes()) if isinstance(x, np.ndarray)
               else x == y for x, y in zip(a, b)):
        raise AssertionError("phase 17 (c): the library and the numpy "
                             "version assemble other batches")
    secs = {}
    for name, fn in (("library", csrc.build_decode_batch),
                     ("numpy", csrc.build_decode_batch_plain)):
        ts = []
        for _ in range(200):
            t0 = time.perf_counter()
            fn(entries, **args)
            ts.append(time.perf_counter() - t0)
        secs[name] = statistics.median(ts)
    log(f"  (c) batch-128 decode batch assembly, median of 200: library "
        f"{secs['library'] * 1e3:.4f} ms, numpy {secs['numpy'] * 1e3:.4f} ms "
        f"(host clock; equal bytes)")
    return secs


def run_evals(dev, hf_dir: str):
    """Phase 17: (a) perplexity, (b) sparse-vs-dense agreement, (c) host
    prep. Returns the launches of (a) and (b) by kernel name."""
    import shutil

    work = os.path.join(ROOT, "build", "chip_smoke", "phase17")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        launches = run_ppl(dev, hf_dir, work)
        for k, n in run_agreement(dev).items():
            launches[k] = launches.get(k, 0) + n
        time_host_prep()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from omniserve_tpu_torch.csrc import build
    except ImportError as e:
        print(f"chip_smoke: the omniserve_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    build_s = build.build_all()
    log(f"kernels built in {build_s:.1f} s")
    for src, text in build.build_log.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    phase_s = {}
    t_phase = time.time()

    def phase_done(name):
        nonlocal t_phase
        phase_s[name] = time.time() - t_phase
        log(f"  [{name} wall {phase_s[name]:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
        t_phase = time.time()

    log("phase 2: kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    gemm_rows, _ = check_quant_gemms(dev, gen)
    group_rows = check_per_group_gemms(dev, gen)
    kernels = {
        # the GEMM entries: one prefill layer (M = 8192); the error is the
        # largest over all sixteen shape / M pairs
        "w4a8_matmul_per_channel": layer_row(gemm_rows, 8192),
        "w4a8_matmul_per_group": layer_row(group_rows, 8192),
        "w8a8_matmul": check_w8a8(dev, gen),
        "flash_prefill": check_flash(dev, gen, ptxas=True),
        "decode_attention_append": check_decode(dev, gen),
        "decode_attention_append_kv8": check_decode(dev, gen, kv_bits=8),
        "decode_attention_append_pt": check_decode(dev, gen, kv_bits=8,
                                                   per_tensor=True),
        "paged_mqa_attention_kv16": check_decode_kv16(dev, gen),
        "paged_prefill_attention": check_paged_prefill(dev, gen),
        "paged_prefill_kv8": check_paged_prefill(dev, gen, kv_bits=8),
        "paged_prefill_kv16": check_paged_prefill(dev, gen, kv_bits=16),
        "paged_prefill_pt": check_paged_prefill(dev, gen, kv_bits=8,
                                                per_tensor=True),
        "kv_append_decode": check_kv_append(dev, gen),
        "kv_append_decode_kv16": check_kv_append_kv16(dev, gen),
        "decode_attention_ph": check_decode_ph(dev, gen, b=1),
        "decode_attention_band": check_decode_band(dev, gen, b=1),
        "flash_prefill_band": check_flash_band(dev, gen),
        "paged_prefill_ring": check_paged_ring(dev, gen, 32000, 32000, 314,
                                               "phase 7's first chunk"),
    }
    # a wrapped ring whose newest page holds stale rows (the 315-slot ring
    # of phase 7 never wraps at 32K)
    check_paged_ring(dev, gen, 20000, 2048, 80, "wrapped")
    # the bench's decode shapes (batch 128), logged beside the rows above
    check_w8a8(dev, gen, m=128)
    check_w8a8_body_gemms(dev, gen)
    check_narrow_gemms(dev, gen)
    for line in ptxas_report("quant_gemm.cu"):
        log(f"    ptxas {line}")
    for kv_bits in (4, 8):
        check_decode(dev, gen, b=128, lens_from=1024, lens_to=1536,
                     kv_bits=kv_bits)
    check_decode(dev, gen, kv_bits=4, per_tensor=True)
    for kv_bits in (4, 8):
        check_decode(dev, gen, b=128, lens_from=1024, lens_to=1536,
                     kv_bits=kv_bits, per_tensor=True)
    check_decode_kv16(dev, gen, b=128, lens_from=1045, lens_to=1536)
    for line in ptxas_report("decode_attention.cu"):
        log(f"    ptxas {line}")
    # the page-list kernels at a batch of 8 long contexts
    check_decode_ph(dev, gen, b=8)
    check_decode_band(dev, gen, b=8)
    time_selector(dev, gen)
    # LServe over kv8 and per-tensor kv8 pools: rows 5, 4 (band/ring), 10
    # and 7 (ring) at the shapes above
    for mode in ("kv8", "pt8"):
        sfx = kv_suffix(*LIST_MODES[mode])
        kernels["decode_attention_ph" + sfx] = check_decode_ph(
            dev, gen, b=1, mode=mode)
        check_decode_ph(dev, gen, b=8, mode=mode)
        kernels["decode_attention_band" + sfx] = check_decode_band(
            dev, gen, b=1, mode=mode)
        check_decode_band(dev, gen, b=8, mode=mode)
        kernels["kv_append_decode" + sfx] = check_kv_append(dev, gen, mode)
        kernels["paged_prefill_ring" + sfx] = check_paged_ring(
            dev, gen, 32000, 32000, 314, "phase 7's first chunk", mode)
        check_paged_ring(dev, gen, 20000, 2048, 80, "wrapped", mode)
    for line in ptxas_report("kv_append.cu"):
        log(f"    ptxas {line}")
    # LServe over kv16 pools: row 6's per-head lists and band, row 7's kv16
    # ring and row 10's two-pool entry with K stats, at the shapes above
    kernels["decode_attention_ph_kv16"] = check_decode_ph(dev, gen, b=1,
                                                          mode="kv16")
    check_decode_ph(dev, gen, b=8, mode="kv16")
    kernels["decode_attention_band_kv16"] = check_decode_band(
        dev, gen, b=1, mode="kv16")
    check_decode_band(dev, gen, b=8, mode="kv16")
    kernels["paged_prefill_ring_kv16"] = check_paged_ring(
        dev, gen, 32000, 32000, 314, "phase 7's first chunk", "kv16")
    check_paged_ring(dev, gen, 20000, 2048, 80, "wrapped", "kv16")
    for t in (8, 128):
        check_kv_append_pools(dev, gen, "kv16", t)
    # GQA groups of 7 beside n_rep 8, and phase 12's GEMM shapes
    kernels.update(check_gqa7(dev, gen))
    kernels.update(check_mha_rows(dev, gen))
    check_family_gemms(dev, gen)
    # head_dim 64 (Llama-3.2-1B, phase 14): row 6's kv4 / kv8 modes and
    # rows 6, 7, 9 and 10 at phase 14's shapes, rows 1 and 3 at its GEMMs
    kernels.update(check_d64_kernels(dev, gen))
    # Mixtral-8x7B's expert GEMMs (phase 16) on rows 1-3 by stack index
    kernels.update(check_moe_gemms(dev, gen))
    phase_done("phase 2")
    log("phase 3: 2-layer full-width forward, kernels vs plain")
    spec, params, prompts, tables, _ = check_forward(dev)
    pool, first = check_chunked_forward(dev, spec, params, prompts, tables)
    check_window(dev, spec, params, pool, tables, [len(p) for p in prompts],
                 first)
    del spec, params, pool
    torch.cuda.empty_cache()
    check_precision_forwards(dev)
    check_family_forwards(dev)
    check_sparse_forward(dev)
    torch.cuda.empty_cache()
    check_sparse_prefill_forward(dev)
    for precision in ("w8a8kv8-pt", "w4a8kv8", "w16a16kv16"):
        gc.collect()
        torch.cuda.empty_cache()
        check_sparse_forward(dev, precision)
        check_sparse_prefill_forward(dev, precision)
    gc.collect()
    torch.cuda.empty_cache()
    check_d64_forwards(dev)
    phase_done("phase 3")
    log("phase 4: engine, Llama-3-8B W4A8KV4, 32 layers, w8a8 lm_head")
    launches = run_engine(dev)
    phase_done("phase 4")
    log("phase 5: bench protocol (batch 128, 1024 in / 512 out, chunked "
        "prefill 8192, 32-step windows) through qserve_benchmark.run_round")
    # the bench's kernels report its launches; the flash kernel, which the
    # bench's chunked prefill does not run, reports phase 4's
    p5_stats = {}
    bench = run_bench(dev, stats=p5_stats)
    p5_stats["row7"] = bench["paged_prefill_attention"]
    launches.update({k: bench[k] for k in BENCH_KERNELS})
    phase_done("phase 5")
    log("phase 6: LServe benchmark protocol (batch 1, 32768 in / 128 out, "
        "sparse decode, static sparsity 0.5) through lserve_benchmark")
    lserve = run_lserve(dev)
    launches.update({k: lserve[k] for k in LSERVE_KERNELS})
    phase_done("phase 6")
    log("phase 7: LServe prefill side (--sparse-context-mode "
        "--sparse-decode-mode, static sparsity 0.5; 32768 in / 128 out "
        "chunked, 16384 in / 32 out whole prompt) through lserve_benchmark")
    p7_stats = {}
    prefill = run_lserve_prefill(dev, stats=p7_stats)
    launches.update({k: prefill[k] for k in ("flash_prefill_band",
                                             "paged_prefill_ring")})
    phase_done("phase 7")
    log("phase 8: bench protocol across the precision matrix (w4a8kv4 "
        "g128, then w4a8kv8) through qserve_benchmark.run_round")
    g128, kv8 = run_bench_precisions(dev)
    launches["w4a8_matmul_per_group"] = g128["w4a8_matmul_per_group"]
    launches.update({k: kv8[k] for k in ("decode_attention_append_kv8",
                                         "paged_prefill_kv8")})
    phase_done("phase 8")
    log("phase 9: bench protocol at the kv16 and per-tensor KV modes "
        "(w16a16kv16, then w8a8kv8 --kv-quant-granularity per_tensor) "
        "through qserve_benchmark.run_round")
    kv16, pt = run_bench_kv_modes(dev)
    launches.update({k: kv16[k] for k in ("paged_prefill_kv16",
                                          "kv_append_decode_kv16",
                                          "paged_mqa_attention_kv16")})
    launches.update({k: pt[k] for k in ("paged_prefill_pt",
                                        "decode_attention_append_pt")})
    phase_done("phase 9")
    log("phase 10: rows 8 and 11 behind the JAX dispatch's switches "
        "(OMNISERVE_PREFILL_SINGLE_PASS=1, OMNISERVE_EMBED_DMA=1): kernels "
        "vs plain and row 8 vs row 7, then phase 5's protocol, the kv8 and "
        "per-tensor chunked forwards and phase 7 (a) with both switches on")
    kernels.update(check_switched_kernels(dev, gen))
    launches.update(run_switched_protocols(
        dev, {"launches": bench, "stats": p5_stats}, {"stats": p7_stats}))
    phase_done("phase 10")
    log("phase 11: the reference's LServe command at its own precision "
        "(w8a8kv8 --kv-quant-granularity per_tensor, both flags, static "
        "sparsity 0.5; 32768 in / 128 out), then w4a8kv8 (32768 in / 32 "
        "out), through lserve_benchmark")
    lserve_kv = run_lserve_kv_modes(dev)
    launches.update({k: lserve_kv[k] for k in LSERVE_KV_KERNELS})
    phase_done("phase 11")
    log("phase 12: bench protocol on Yi-34B (batch 64, GQA groups of 7) and "
        "Qwen1.5-72B (batch 4, QKV bias), full width and depth, through "
        "qserve_benchmark.run_round")
    families = run_families(dev)
    yi = families["Yi-34B"][0]     # every launch of these is at n_rep 7
    launches["decode_attention_append_n7"] = yi["decode_attention_append"]
    launches["paged_prefill_attention_n7"] = yi["paged_prefill_attention"]
    qwen = families["Qwen1.5-72B"][0]   # every launch of these is at 64 / 64
    launches["decode_attention_append_mha"] = qwen["decode_attention_append"]
    launches["flash_prefill_mha"] = qwen["flash_prefill"]
    phase_done("phase 12")
    log("phase 13: the LServe command at the default precision (w16a16kv16, "
        "both flags, static sparsity 0.5; 32768 in / 128 out) through "
        "lserve_benchmark")
    lserve_kv16 = run_lserve_kv16(dev)
    launches.update({k: lserve_kv16[k] for k in LSERVE_KV16_KERNELS[:3]})
    phase_done("phase 13")
    log("phase 14: Llama-3.2-1B (head_dim 64) at full width and depth: "
        "bench.py's protocol at w4a8kv4 and the IFB engine's whole prompts, "
        "then the LServe command at w8a8kv8 per-tensor (both flags, static "
        "sparsity 0.5; 32768 in / 128 out, 16384 in / 32 out)")
    d64_launches, _ = run_llama32(dev)
    launches.update({k: d64_launches[k] for k in D64_ENTRIES})
    phase_done("phase 14")
    log("phase 15: Llama-3.2-1B from files: (a) an HF checkpoint (bf16 "
        "safetensors, two shards, tied embeddings) through load_format="
        "'auto' at w4a8kv4, full width and depth; (b) its QoQ fake-quant "
        f"dump (g128, per-tensor KV) converted to packed.npz and served at "
        f"w4a8kv8 per-tensor ({PACKED_LAYERS} layers)")
    import shutil

    # (a)'s checkpoint serves phase 17 too; it goes when the script ends
    llama32_dir = os.path.join(ROOT, "build", "chip_smoke", "llama3.2-1b-hf")
    try:
        run_checkpoints(dev, llama32_dir)
        phase_done("phase 15")
        log("phase 16: Mixtral-8x7B (8 experts, top-2) at full width and "
            "depth: (a) bench.py's protocol at w4a8kv4 (bf16 lm_head), (b) "
            "2-layer forwards at w4a8kv4, g128 and w8a8kv8 per-tensor, "
            "kernels vs plain, (c) the LServe command at w4a8kv4 (both "
            "flags, static sparsity 0.5; 32736 in / 32 out)")
        launches.update(run_mixtral(dev))
        phase_done("phase 16")
        log("phase 17: the port's evals and host prep: (a) eval.ppl on "
            "phase 15's Llama-3.2-1B checkpoint (full width and depth, 4 x "
            "2,048-token windows of seeded ids) at w4a8kv4 and w16a16kv16, "
            "the chunked NLL against a full log_softmax; (b) eval."
            "sparse_agreement at Llama-3-8B's geometry (full width and "
            "depth, w4a8kv4, 8,192 seeded prompt ids, 32 greedy tokens): "
            "dense twice, sparse decode, both LServe flags with the in-repo "
            "pattern; (c) the g++ host-prep library")
        evals = run_evals(dev, llama32_dir)
        phase_done("phase 17")
    finally:
        shutil.rmtree(llama32_dir, ignore_errors=True)
    log(f"phase wall times (s): {json.dumps(phase_s)}")

    meta = {
        "w4a8_matmul_per_channel": (
            "omniserve_tpu_torch/csrc/quant_gemm.cu",
            "omniserve_tpu/ops/pallas/quant_matmul.py:151"),
        "w4a8_matmul_per_group": (
            "omniserve_tpu_torch/csrc/quant_gemm.cu",
            "omniserve_tpu/ops/pallas/quant_matmul.py:281"),
        "w8a8_matmul": (
            "omniserve_tpu_torch/csrc/quant_gemm.cu",
            "omniserve_tpu/ops/pallas/quant_matmul.py:406"),
        "flash_prefill": (
            "omniserve_tpu_torch/csrc/flash_prefill.cu",
            "omniserve_tpu/ops/pallas/flash_attention.py:150"),
        "decode_attention_append": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:620"),
        "decode_attention_append_kv8": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:620"),
        "paged_prefill_attention": (
            "omniserve_tpu_torch/csrc/paged_prefill.cu",
            "omniserve_tpu/ops/pallas/paged_prefill.py:268"),
        "paged_prefill_kv8": (
            "omniserve_tpu_torch/csrc/paged_prefill.cu",
            "omniserve_tpu/ops/pallas/paged_prefill.py:268"),
        "kv_append_decode": (
            "omniserve_tpu_torch/csrc/kv_append.cu",
            "omniserve_tpu/ops/pallas/kv_append.py:156"),
        "decode_attention_ph": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:1119"),
        "decode_attention_band": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:620"),
        "flash_prefill_band": (
            "omniserve_tpu_torch/csrc/flash_prefill.cu",
            "omniserve_tpu/ops/pallas/flash_attention.py:150"),
        "paged_prefill_ring": (
            "omniserve_tpu_torch/csrc/paged_prefill.cu",
            "omniserve_tpu/ops/pallas/paged_prefill.py:268"),
        "paged_mqa_attention_kv16": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/paged_attention.py:255"),
        "kv_append_decode_kv16": (
            "omniserve_tpu_torch/csrc/kv_append.cu",
            "omniserve_tpu/ops/pallas/kv_append.py:156"),
        "decode_attention_append_pt": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:620"),
        "paged_prefill_kv16": (
            "omniserve_tpu_torch/csrc/paged_prefill.cu",
            "omniserve_tpu/ops/pallas/paged_prefill.py:268"),
        "paged_prefill_pt": (
            "omniserve_tpu_torch/csrc/paged_prefill.cu",
            "omniserve_tpu/ops/pallas/paged_prefill.py:268"),
        **{f"decode_attention_ph{sfx}": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:1119")
           for sfx in ("_kv8", "_pt")},
        **{f"decode_attention_band{sfx}": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:620")
           for sfx in ("_kv8", "_pt")},
        **{f"kv_append_decode{sfx}": (
            "omniserve_tpu_torch/csrc/kv_append.cu",
            "omniserve_tpu/ops/pallas/kv_append.py:156")
           for sfx in ("_kv8", "_pt")},
        **{f"paged_prefill_ring{sfx}": (
            "omniserve_tpu_torch/csrc/paged_prefill.cu",
            "omniserve_tpu/ops/pallas/paged_prefill.py:268")
           for sfx in ("_kv8", "_pt", "_kv16")},
        # row 6's per-head and band modes over kv16 pools: phase 2's
        # entries, phase 13's launches
        **dict.fromkeys(("decode_attention_ph_kv16",
                         "decode_attention_band_kv16"), (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/paged_attention.py:255")),
        **dict.fromkeys(ROW8_NAMES, (
            "omniserve_tpu_torch/csrc/prefill_single_pass.cu",
            "omniserve_tpu/ops/pallas/prefill_single_pass.py:291")),
        "embed_gather": (
            "omniserve_tpu_torch/csrc/embed_gather.cu",
            "omniserve_tpu/ops/pallas/embed_gather.py:46"),
        # n_rep 7 (Yi-34B): phase 2's entries, phase 12's launches
        "decode_attention_append_n7": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:620"),
        "paged_prefill_attention_n7": (
            "omniserve_tpu_torch/csrc/paged_prefill.cu",
            "omniserve_tpu/ops/pallas/paged_prefill.py:268"),
        # 64 q over 64 kv heads (Qwen1.5-72B): phase 2's entries, phase
        # 12's launches
        "decode_attention_append_mha": (
            "omniserve_tpu_torch/csrc/decode_attention.cu",
            "omniserve_tpu/ops/pallas/decode_attention.py:620"),
        "flash_prefill_mha": (
            "omniserve_tpu_torch/csrc/flash_prefill.cu",
            "omniserve_tpu/ops/pallas/flash_attention.py:150"),
        # head_dim 64 (Llama-3.2-1B): phase 2's entries, phase 14's
        # launches
        **D64_ENTRIES,
        # Mixtral-8x7B's expert GEMMs: phase 2's entries; the per-channel
        # launches of phase 16 (a)'s measured round, the g128 and W8 ones
        # of (b)'s forwards
        **{MOE_ENTRIES[mode]: (
            "omniserve_tpu_torch/csrc/quant_gemm.cu",
            f"omniserve_tpu/ops/pallas/quant_matmul.py:{line}")
           for mode, line in (("channel", 151), ("group", 281), ("w8", 406))},
    }
    idle = [name for name in meta if launches[name] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the path: {idle}")
    # phase 17's own counts stand beside each entry's (``launches`` stays
    # the count of the path that entry names); run_ppl / run_agreement
    # gate their kernels themselves
    unlisted = sorted(set(evals) - set(meta))
    if unlisted:
        raise AssertionError(f"phase 17 launched kernels the kernels line "
                             f"does not list: {unlisted}")
    line = [
        {"name": name, "function": kernel_function(name), "route": "cuda",
         "source": src, "replaces": rep, "launches": launches[name],
         "launches_phase17": evals.get(name, 0), **kernels[name]}
        for name, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)     # as nvidia-smi gives it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
