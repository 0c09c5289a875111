#!/usr/bin/env python3
"""Where chip_smoke's head_dim-64 W8A8 sparse decode gap comes from, on one
H100 (run from the checkout's root: ``PYTHONPATH=. python3
scripts/torch_d64_decode_gap.py [swap|per-call]``).

``swap``: row 3 (the W8A8 GEMM) against its plain version at Llama-3.2-1B's
shapes and M = 1 to 2,874, then ``chip_smoke.check_sparse_forward`` at
w8a8kv8 per-tensor and Llama-3.2-1B's widths twice: with the attention
calls sent to their plain versions (the GEMMs on kernels), then with the
GEMMs plain (the attention on kernels); each prints its logits' gap.

``per-call``: the same forward with every decode attention call of the
kernels run held against its plain version on the same inputs (largest
difference, per q head) and every two-pool append against the plain
appends on copies of its pools.
"""

import sys

import torch

import chip_smoke as cs
from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.ops import cuda, dispatch
from omniserve_tpu_torch.ops.cuda import decode_attention as da
from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
from omniserve_tpu_torch.ops.quantization import quantize_activations


def plain_calls(module, names):
    saved = {}
    for name in names:
        real = getattr(module, name)
        saved[name] = real

        def wrapped(*a, _r=real, **k):
            with cuda.plain_versions():
                return _r(*a, **k)
        setattr(module, name, wrapped)
    return saved


def swap(dev, gen):
    for k, n in ((2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
                 (4096, 6144)):
        for m in (1, 3, 8, 128, 2874):
            a, s, _ = quantize_activations(torch.randn((m, k), generator=gen,
                                                       device=dev))
            w = torch.randint(-127, 128, (k, n), generator=gen,
                              dtype=torch.int8, device=dev)
            ws = torch.empty(n, device=dev).uniform_(0.0003, 0.0006,
                                                     generator=gen)
            got = qm.w8a8_matmul(a, w, ws, s)
            want = qm.w8a8_matmul_plain(a, w, ws, s)
            err = float((got.float() - want.float()).abs().max())
            cs.log(f"  w8a8 M={m} K={k} N={n}: max abs err {err:g}")
    cs.lserve_decode_names = lambda suffix, head_dim=128: ()
    for label, module, names in (
            ("attention plain, GEMMs on kernels", dispatch,
             ("paged_decode_attention", "append_kv_decode_pools",
              "prefill_attention", "paged_prefill_attention")),
            ("GEMMs plain, attention on kernels", t_llama,
             ("w8a8_matmul", "w4a8_matmul_per_channel"))):
        saved = plain_calls(module, names)
        cs.log(f"-- {label}")
        try:
            cs.check_sparse_forward(dev, "w8a8kv8-pt",
                                    geometry=cs.LLAMA32_1B)
            cs.log("   passed")
        except AssertionError as e:
            cs.log(f"   {e}")
        for name, fn in saved.items():
            setattr(module, name, fn)


def per_call(dev):
    real_attn = dispatch.paged_decode_attention
    real_app = dispatch.append_kv_decode_pools

    def attn(q, pool, layer, *a, **k):
        out = real_attn(q, pool, layer, *a, **k)
        if cuda.use_kernel(q):
            with cuda.plain_versions():
                want = real_attn(q, pool, layer, *a, **k)
                comp = da.paged_decode_attention(q, pool, layer, *a[:4], **k)
            err = float((out.float() - want.float()).abs().max())
            err2 = float((comp.float() - want.float()).abs().max())
            per = (out.float() - want.float()).abs().amax(dim=(0, 2))
            cs.log(f"  decode attention layer {layer}: kernel vs plain "
                   f"{err:.4g} (plain composition vs ref {err2:.4g}); per q "
                   f"head {[round(float(x), 3) for x in per]}")
        return out

    def app(rp, sp, layer, *a, **kw):
        tr, ts = rp.clone(), sp.clone()
        with cuda.plain_versions():
            real_app(tr, ts, layer, *a, **kw)
        out = real_app(rp, sp, layer, *a, **kw)
        for what, got, want in (("retrieval", rp, tr), ("streaming", sp, ts)):
            for name, x, y in zip(got._fields, got, want):
                if x is not None and x.dim() > 1 and not torch.equal(
                        x[:, :-1], y[:, :-1]):
                    cs.log(f"  append layer {layer}: {what} {name} differs")
        return out

    dispatch.paged_decode_attention = attn
    dispatch.append_kv_decode_pools = app
    try:
        cs.check_sparse_forward(dev, "w8a8kv8-pt", geometry=cs.LLAMA32_1B)
    except AssertionError as e:
        cs.log(f"  {e}")


def main():
    dev = torch.device("cuda:0")
    cs.log(f"card: {cs.card_line()}")
    cs.log(f"built in {build.build_all():.1f} s")
    part = sys.argv[1] if len(sys.argv) > 1 else "swap"
    if part == "swap":
        swap(dev, torch.Generator(device=dev).manual_seed(0))
    else:
        per_call(dev)


if __name__ == "__main__":
    main()
