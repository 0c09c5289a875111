"""Mixtral (sparse MoE) family, quantized, in PyTorch.

Counterpart of ``omniserve_tpu.models.mixtral``: the transformer trunk
(attention, paged KV pools, LServe's modes) is the Llama forward's, and
only the MLP block differs (``llama_forward``'s ``mlp_fn`` hook). The
router keeps the reference's semantics (bf16 router, f32 softmax, top-k,
renormalized probabilities) and the experts run on static-capacity
buffers (``ops/moe.py``); w1 (gate) and w3 (up) fuse into ``w13`` like
the dense gate_up, w2 is the down projection.

Expert weights are STACKED [L, E, ...]. The served path flattens them to
[L*E, ...] views (no copy) and runs the body's GEMM once per expert on
stack index ``layer * E + e``, the Hopper kernels of ``ops/matmul.py``
reading that matrix through the view's pointer, as the JAX package's
scanned forward runs its Pallas GEMMs. Those launches count under the
kernels' ``_moe`` entries (``ops.cuda.expert_launches``).

Expert parallelism (``ep_size`` > 1) is ROADMAP.md queue 1 item 10, as
the rest of the parallel axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from omniserve_tpu_torch.models import llama
from omniserve_tpu_torch.models.llama import LlamaSpec, make_attn_meta
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops import moe as moe_ops
from omniserve_tpu_torch.ops.activation import silu_and_mul, silu_and_mul_quant
from omniserve_tpu_torch.ops.norms import rms_norm
from omniserve_tpu_torch.ops.quantization import quantize_activations


@dataclasses.dataclass(frozen=True)
class MixtralSpec(LlamaSpec):
    num_experts: int = 8          # GLOBAL expert count
    top_k: int = 2
    # capacity per expert = ceil(T * top_k / E * factor), multiple of 8
    capacity_factor: float = 2.0
    ep_size: int = 1

    @classmethod
    def from_model_config(cls, model_config, sp_attn_config=None,
                          tp_size: int = 1,
                          page_size: int = 64) -> "MixtralSpec":
        base = LlamaSpec.from_model_config(model_config, sp_attn_config,
                                           tp_size, page_size)
        hf = model_config.hf_config
        return cls(
            **dataclasses.asdict(base),
            num_experts=getattr(hf, "num_local_experts", 8),
            top_k=getattr(hf, "num_experts_per_tok", 2),
        )

    @property
    def local_experts(self) -> int:
        return self.num_experts // self.ep_size

    def check_supported(self, device=None) -> None:
        """``LlamaSpec``'s checks, and two refusals of the MoE path: expert
        parallelism, and the W8A8 lm_head, which the JAX package's Mixtral
        never quantizes (neither its random draw nor its loader writes an
        ``lm_head_scale``, so its forward fails on that head)."""
        super().check_supported(device)
        if self.ep_size != 1:
            raise NotImplementedError(
                "expert parallelism is ROADMAP.md queue 1 item 10")
        if self.lm_head_bits == 8:
            raise NotImplementedError(
                "Mixtral serves the bf16 lm_head (lm_head_precision='fp16'): "
                "the JAX package's Mixtral parameters carry no W8A8 lm_head "
                "(mixtral.make_random_params / load_mixtral_params write no "
                "lm_head_scale), so the reference cannot serve that pairing")
        if not 1 <= self.top_k <= self.num_experts:
            raise NotImplementedError(
                f"top_k {self.top_k} over {self.num_experts} experts")


def moe_capacity(spec: MixtralSpec, t: int) -> int:
    c = int(np.ceil(t * spec.top_k / spec.num_experts
                    * spec.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _flatten_experts(weight):
    """[L, E, ...] stacks -> [L*E, ...] views (a tensor or a weight
    container)."""
    if isinstance(weight, torch.Tensor):
        return weight.view((-1,) + tuple(weight.shape[2:]))
    return type(weight)(*(a.view((-1,) + tuple(a.shape[2:]))
                          for a in weight))


def _expert_bmm(weight, spec: MixtralSpec, x_q, x_scale=None, x_sum=None,
                layer=None):
    """Batched per-expert linear on [E, C, K] inputs -> [E, C, N].

    With ``layer``, ``weight`` holds STACKED [L, E, ...] leaves: the body's
    GEMM runs once per expert on index ``layer * E + e`` of the flattened
    [L*E, ...] views (``llama._apply_linear``: the Hopper kernels on a
    card), counted as expert launches. Without, ``weight`` is one layer's
    [E, ...] and the plain batched contracts of ``ops/moe.py`` run."""
    if layer is not None:
        e = x_q.shape[0]
        wm = _flatten_experts(weight)
        with cuda.expert_launches():
            outs = [
                llama._apply_linear(
                    wm, spec, x_q[ex],
                    None if x_scale is None else x_scale[ex],
                    None if x_sum is None else x_sum[ex],
                    layer * e + ex,
                )
                for ex in range(e)
            ]
        return torch.stack(outs)
    if spec.weight_bits == 4 and spec.group_size == -1:
        return moe_ops.w4a8_bmm_per_channel(
            x_q, weight.qweight, weight.s1_scales, weight.s1_szeros,
            x_scale, x_sum,
        )
    if spec.weight_bits == 4:
        return moe_ops.w4a8_bmm_per_group(
            x_q, weight.qweight, weight.s1_scales, weight.s2_scales,
            weight.s2_zeros, x_scale, group_size=spec.group_size,
        )
    if spec.weight_bits == 8:
        return moe_ops.w8a8_bmm(x_q, weight.qweight, weight.scales, x_scale)
    return moe_ops.bf16_bmm(x_q, weight)


def moe_mlp(h: torch.Tensor, lp: Dict[str, Any], spec: MixtralSpec,
            layer: Optional[int] = None,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm MoE block: route -> dispatch -> expert SwiGLU -> combine,
    plus the residual. ``lp`` is STACKED over layers when ``layer`` is
    given (the forward's case: the norm and router are indexed, the expert
    stacks stay whole), else one layer's leaves. ``valid`` [T] bool keeps
    padding and inactive rows out of the experts' capacity."""
    expert_layer = layer
    if layer is not None:
        lp = dict(lp, mlp_ln=lp["mlp_ln"][layer], gate=lp["gate"][layer])
    t = h.shape[0]
    e, k = spec.num_experts, spec.top_k
    capacity = moe_capacity(spec, t)

    x_n = rms_norm(h, lp["mlp_ln"], spec.rms_eps).to(torch.bfloat16)
    # the bf16 router with f32 accumulation (an f32 product of the bf16
    # values: exact products, f32 sums)
    logits = x_n.float() @ lp["gate"].float()
    routing = moe_ops.route_topk(logits, k, capacity, valid=valid)

    if spec.quantized_acts:
        a_i8, a_scale, a_sum = quantize_activations(
            x_n, fuse_sum=spec.needs_act_sums)
        x_d = moe_ops.dispatch(a_i8, routing, e, capacity)
        s_d = moe_ops.dispatch_rows(a_scale, routing, e, capacity)
        sum_d = (moe_ops.dispatch_rows(a_sum, routing, e, capacity)
                 if a_sum is not None else None)
    else:
        x_d = moe_ops.dispatch(x_n, routing, e, capacity)
        s_d = sum_d = None

    gate_up = _expert_bmm(lp["w13"], spec, x_d, s_d, sum_d,
                          layer=expert_layer)             # [E, C, 2I]
    gu_flat = gate_up.reshape(e * capacity, -1)
    if spec.quantized_acts:
        g_q, g_scale, g_sum = silu_and_mul_quant(
            gu_flat, fuse_sum=spec.needs_act_sums)
        g_q = g_q.view(e, capacity, -1)
        g_scale = g_scale.view(e, capacity)
        g_sum = g_sum.view(e, capacity) if g_sum is not None else None
    else:
        g_q = silu_and_mul(gu_flat).to(torch.bfloat16).view(e, capacity, -1)
        g_scale = g_sum = None
    down = _expert_bmm(lp["w2"], spec, g_q, g_scale, g_sum,
                       layer=expert_layer)                # [E, C, D]
    y = moe_ops.combine(down, routing, t)
    return h + y.to(h.dtype)


def mixtral_forward(params, retrieval_pool, streaming_pool, batch,
                    spec: MixtralSpec, is_prefill: bool):
    return llama.llama_forward(
        params, retrieval_pool, streaming_pool, batch, spec=spec,
        is_prefill=is_prefill, mlp_fn=moe_mlp,
    )


def model_forward(params, retrieval_pool, streaming_pool, batch, spec,
                  is_prefill: bool):
    """The forward of ``spec``'s model: Mixtral's for a ``MixtralSpec``,
    the Llama family's otherwise (looked up at each call), as the JAX
    runner picks its ``_model_forward`` by architecture."""
    fn = (mixtral_forward if isinstance(spec, MixtralSpec)
          else llama.llama_forward)
    return fn(params, retrieval_pool, streaming_pool, batch, spec,
              is_prefill=is_prefill)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ExpertStack:
    """Quantized [L, E, ...] expert stacks filled one (layer, expert)
    matrix at a time: each [N, K] fp matrix is quantized on ``device`` as
    it arrives, into stacks allocated at the first one, so no fp [L, E,
    N, K] stack is ever held (at Mixtral-8x7B one is ~60 GB in f32)."""

    def __init__(self, spec: MixtralSpec, device, shape=None) -> None:
        self.spec, self.device = spec, device
        self.shape = (tuple(shape) if shape is not None
                      else (spec.num_layers, spec.num_experts))
        self.fields = None
        self.kind = None
        self.filled = np.zeros(self.shape, bool)

    def put(self, layer: int, ex: int, w_fp) -> None:
        q = llama._quantize_linear(
            torch.as_tensor(w_fp).to(self.device), self.spec)
        fields = (q,) if isinstance(q, torch.Tensor) else tuple(q)
        if self.fields is None:
            self.kind = None if isinstance(q, torch.Tensor) else type(q)
            self.fields = [torch.empty(self.shape + f.shape, dtype=f.dtype,
                                       device=self.device) for f in fields]
        for dst, src in zip(self.fields, fields):
            dst[layer, ex] = src
        self.filled[layer, ex] = True

    def result(self):
        if self.kind is None:
            return self.fields[0]
        return self.kind(*self.fields)


def quantize_expert_stack(w_fp, spec: MixtralSpec, device="cuda:0"):
    """[L, E, N, K] fp (host numpy or a tensor) -> the quantized container
    with leading [L, E] dims on ``device`` (the JAX package's
    ``_quantize_expert_stack``), one (layer, expert) at a time."""
    stack = ExpertStack(spec, device, shape=w_fp.shape[:2])
    for layer in range(w_fp.shape[0]):
        for ex in range(w_fp.shape[1]):
            stack.put(layer, ex, w_fp[layer, ex])
    return stack.result()


def make_random_packed_params(
    spec: MixtralSpec, seed: int = 0, device="cuda:0",
    retrieval_flags: Optional[np.ndarray] = None,
    head_rank: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Random packed Mixtral params drawn on ``device`` from a seeded
    ``torch.Generator``: the JAX ``mixtral.make_random_params`` tree (its
    shapes and dtypes; a bf16 lm_head) at its magnitudes, drawn packed as
    ``llama.make_random_packed_params`` draws a Llama body (the JAX draw
    quantizes f32 host arrays, 120 GB of ``w13`` alone at 8x7B).
    Benchmarks only."""
    spec.check_supported(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, D, I, E = (spec.num_layers, spec.hidden, spec.intermediate,
                  spec.num_experts)

    def experts(n_out, k_in):
        w = llama._random_packed_stack(gen, spec, L * E, n_out, k_in, device)
        if isinstance(w, torch.Tensor):
            return w.view(L, E, *w.shape[1:])
        return type(w)(*(a.view(L, E, *a.shape[1:]) for a in w))

    def normal(*shape):
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        return out.normal_(generator=gen) * 0.02

    layers = {
        "attn_ln": torch.ones((L, D), dtype=torch.float32, device=device),
        "mlp_ln": torch.ones((L, D), dtype=torch.float32, device=device),
        "qkv": llama._random_packed_stack(gen, spec, L, spec.qkv_out, D,
                                          device),
        "o": llama._random_packed_stack(gen, spec, L, D, spec.q_size,
                                        device),
        "gate": normal(L, D, E),
        "w13": experts(2 * I, D),
        "w2": experts(D, I),
    }
    return {
        "embed": normal(spec.vocab, D),
        "final_ln": torch.ones((D,), dtype=torch.float32, device=device),
        "lm_head": normal(D, spec.vocab),
        "layers": layers,
        "attn_meta": make_attn_meta(spec, retrieval_flags, head_rank, device),
    }


def load_mixtral_params(model_config, spec: MixtralSpec,
                        retrieval_flags=None, head_rank=None,
                        tp_size: int = 1, device="cuda:0"):
    """HF Mixtral checkpoint -> quantized stacked params on ``device`` and
    the per-tensor KV scales (``(k [L], v [L])``, or None), as the JAX
    ``load_mixtral_params``.

    Experts live at ``model.layers.{i}.block_sparse_moe.experts.{e}.w{1,2,
    3}.weight`` and the router at ``...block_sparse_moe.gate.weight``; w1
    (gate) and w3 (up) fuse into ``w13 = [w1; w3]``. Each expert matrix is
    quantized as soon as it is whole (``ExpertStack``): w13 once both w1
    and w3 of its (layer, expert) were read, w2 at once. The attention
    projections gather into fp32 host stacks and quantize a layer at a
    time (``llama.quantize_layer_weights``). A tensor the model needs and
    the checkpoint lacks raises, naming it."""
    from omniserve_tpu_torch.models.weight_loader import (
        _iter_hf_weights,
        _resolve_path,
    )

    if tp_size != 1:
        raise NotImplementedError(
            "tensor / expert parallelism is ROADMAP.md queue 1 item 10")
    path = _resolve_path(model_config.quant_path or model_config.model)
    L, D, E = spec.num_layers, spec.hidden, spec.num_experts
    stacks = {
        "q_proj.weight": np.zeros((L, spec.q_size, D), np.float32),
        "k_proj.weight": np.zeros((L, spec.kv_size, D), np.float32),
        "v_proj.weight": np.zeros((L, spec.kv_size, D), np.float32),
        "o_proj.weight": np.zeros((L, D, spec.q_size), np.float32),
        "input_layernorm": np.ones((L, D), np.float32),
        "post_attention_layernorm": np.ones((L, D), np.float32),
        "block_sparse_moe.gate.weight": np.zeros((L, D, E), np.float32),
    }
    seen = set()
    w13 = ExpertStack(spec, device)
    w2 = ExpertStack(spec, device)
    half = {}       # (layer, expert) -> {"w1": ..., "w3": ...} until whole
    embed = lm_head = final_ln = None
    k_pt = np.ones((L,), np.float32)
    v_pt = np.ones((L,), np.float32)
    has_pt_scales = False

    def layer_of(name: str) -> int:
        return int(name.split("layers.")[1].split(".")[0])

    def expert_of(name: str) -> int:
        return int(name.split("experts.")[1].split(".")[0])

    for name, t in _iter_hf_weights(path):
        w = t.float().numpy()
        if "embed_tokens" in name:
            embed = w
        elif "lm_head" in name:
            lm_head = w
        elif name.endswith("model.norm.weight"):
            final_ln = w
        elif "kv_scale_quant_orig" in name or "kv_scale" in name:
            li, flat = layer_of(name), np.atleast_1d(w)
            k_pt[li] = float(flat[0])
            v_pt[li] = float(flat[1] if flat.size > 1 else flat[0])
            has_pt_scales = True
        elif ".experts." in name and name.endswith(".weight"):
            li, ex, kind = layer_of(name), expert_of(name), name[-9:-7]
            if kind == "w2":
                w2.put(li, ex, w)
            elif kind in ("w1", "w3"):
                parts = half.setdefault((li, ex), {})
                parts[kind] = w
                if len(parts) == 2:
                    w13.put(li, ex, np.concatenate([parts["w1"],
                                                    parts["w3"]]))
                    del half[(li, ex)]
        else:
            key = next((k for k in stacks if k in name), None)
            if key is not None:
                li = layer_of(name)
                # the router is stored [E, D]; the forward reads [D, E]
                stacks[key][li] = w.T if key.endswith("gate.weight") else w
                seen.add((key, li))
    missing = [f"model.layers.{li}.{key}" for li in range(L)
               for key in stacks if (key, li) not in seen]
    for stack, kinds in ((w13, "w1 / w3"), (w2, "w2")):
        for li, ex in zip(*np.nonzero(~stack.filled)):
            missing.append(f"model.layers.{li}.block_sparse_moe.experts."
                           f"{ex}.{kinds}")
    if embed is None:
        missing.insert(0, "model.embed_tokens.weight")
    if final_ln is None:
        missing.append("model.norm.weight")
    if missing:
        raise ValueError(f"{path} lacks {missing[0]}"
                         + (f" and {len(missing) - 1} more tensors"
                            if len(missing) > 1 else ""))
    if lm_head is None:
        lm_head = embed                     # tied embeddings

    s = stacks
    layers = llama.quantize_layer_weights(
        {"qkv": llama.fuse_qkv_rank_major(s["q_proj.weight"],
                                          s["k_proj.weight"],
                                          s["v_proj.weight"]),
         "o": s["o_proj.weight"]},
        spec, device=device,
    )
    layers["attn_ln"] = torch.from_numpy(s["input_layernorm"]).to(device)
    layers["mlp_ln"] = torch.from_numpy(
        s["post_attention_layernorm"]).to(device)
    layers["gate"] = torch.from_numpy(
        s["block_sparse_moe.gate.weight"]).to(device).to(torch.bfloat16)
    layers["w13"] = w13.result()
    layers["w2"] = w2.result()
    params = {
        "embed": torch.from_numpy(embed).to(device).to(torch.bfloat16),
        "final_ln": torch.from_numpy(final_ln).to(device),
        "lm_head": torch.from_numpy(lm_head).to(device).t()
        .to(torch.bfloat16).contiguous(),
        "layers": layers,
        "attn_meta": make_attn_meta(spec, retrieval_flags, head_rank,
                                    device),
    }
    kv_scales = None
    if has_pt_scales and not model_config.kv_zeros:
        kv_scales = (torch.from_numpy(k_pt).to(device),
                     torch.from_numpy(v_pt).to(device))
    return params, kv_scales
