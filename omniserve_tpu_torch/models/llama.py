"""Llama family, quantized (W4A8 per-channel x KV4), in PyTorch.

Dense subset of ``omniserve_tpu.models.llama`` with the same parameter
tree and the same per-layer op order:

- fused RMSNorm -> int8 quant (+ act sums), W4A8 qkv GEMM, RoPE;
- prefill: quantize + scatter K/V into the paged pool (``append_kv``),
  then packed-varlen causal attention over the prompt's own K/V; or, for a
  chunk of a chunked prefill (``PrefillBatch.context_lens`` set), causal
  attention over the paged pool (history + chunk);
- decode: one call attends the pool and appends the step's K/V to it;
- W4A8 o_proj, residual, RMSNorm -> quant, W4A8 gate_up, SwiGLU -> quant,
  W4A8 down, residual;
- final RMSNorm and the lm_head (bf16, or W8A8) on each sequence's last
  token at prefill.

The JAX ``lax.scan`` over layers is a Python loop here. Stacked [L, ...]
weights are indexed per layer as views. Pools are updated in place.
Outside the slice (tensor/sequence parallelism, LServe streaming and
sparse modes, other precisions) the functions raise and name the
ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from omniserve_tpu_torch.ops import dispatch
from omniserve_tpu_torch.ops.activation import silu_and_mul_quant
from omniserve_tpu_torch.ops.matmul import (
    w4a8_matmul_per_channel,
    w8a8_matmul,
)
from omniserve_tpu_torch.ops.norms import rms_norm, rms_norm_quant
from omniserve_tpu_torch.ops.paged_kv import KVPool, append_kv
from omniserve_tpu_torch.ops.quantization import (
    QuantizedWeightPerChannel,
    ieee_div,
    quantize_activations,
)
from omniserve_tpu_torch.ops.rope import apply_rope, rope_freqs


@dataclasses.dataclass(frozen=True)
class LlamaSpec:
    """Static model + quantization + attention geometry.

    The dense subset of the JAX ``LlamaSpec``'s fields; ``check_supported``
    refuses the values the port does not serve yet."""

    num_layers: int
    hidden: int
    intermediate: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    vocab: int
    rms_eps: float = 1e-5
    rope_base: float = 10000.0
    rope_scaling: float = 1.0
    rope_llama3: tuple = None
    weight_bits: int = 4
    act_bits: int = 8
    kv_bits: int = 4
    kv_zeros: bool = True
    group_size: int = -1
    page_size: int = 64
    sparse_decode: bool = False
    sparse_prefill: bool = False
    lm_head_bits: int = 16
    attn_bias: bool = False

    @property
    def n_rep(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    @property
    def qkv_out(self) -> int:
        return (self.num_q_heads + 2 * self.num_kv_heads) * self.head_dim

    @property
    def q_size(self) -> int:
        return self.num_q_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def sm_scale(self) -> float:
        return self.head_dim ** -0.5

    def check_supported(self) -> None:
        """Raise for configurations the port does not serve yet."""
        if (self.weight_bits, self.act_bits, self.group_size) != (4, 8, -1):
            raise NotImplementedError(
                "the port serves W4A8 per-channel weights; "
                "per-group, W8A8 and W16A16 bodies are ROADMAP.md queue 1 "
                "item 8"
            )
        if self.kv_bits != 4 or not self.kv_zeros:
            raise NotImplementedError(
                "the port serves fine-grained kv4 pools; kv8, "
                "kv16 and per-tensor KV are ROADMAP.md queue 1 item 8"
            )
        if self.sparse_decode or self.sparse_prefill:
            raise NotImplementedError(
                "LServe sparse prefill/decode is ROADMAP.md queue 1 item 5"
            )
        if self.attn_bias:
            raise NotImplementedError(
                "the QKV bias (Qwen2) is ROADMAP.md queue 1 item 8"
            )

    @classmethod
    def from_model_config(cls, model_config, sp_attn_config=None,
                          tp_size: int = 1,
                          page_size: int = 64) -> "LlamaSpec":
        if sp_attn_config is not None:
            raise NotImplementedError(
                "LServe sparse attention is ROADMAP.md queue 1 item 5"
            )
        if tp_size != 1:
            raise NotImplementedError(
                "tensor parallelism is ROADMAP.md queue 1 item 10"
            )
        hf = model_config.hf_config
        rope_scaling = 1.0
        rope_llama3 = None
        scaling_cfg = getattr(hf, "rope_scaling", None)
        if scaling_cfg:
            stype = scaling_cfg.get("type", scaling_cfg.get("rope_type"))
            if stype == "linear":
                rope_scaling = float(scaling_cfg["factor"])
            elif stype == "llama3":
                rope_llama3 = (
                    float(scaling_cfg["factor"]),
                    float(scaling_cfg["low_freq_factor"]),
                    float(scaling_cfg["high_freq_factor"]),
                    float(scaling_cfg["original_max_position_embeddings"]),
                )
            elif stype not in (None, "default"):
                raise NotImplementedError(
                    f"rope_scaling type {stype!r} not supported"
                )
        return cls(
            num_layers=hf.num_hidden_layers,
            hidden=hf.hidden_size,
            intermediate=hf.intermediate_size,
            num_q_heads=hf.num_attention_heads,
            num_kv_heads=model_config.get_num_kv_heads(),
            head_dim=model_config.get_head_size(),
            vocab=hf.vocab_size,
            rms_eps=getattr(hf, "rms_norm_eps", 1e-5),
            rope_base=getattr(hf, "rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            rope_llama3=rope_llama3,
            weight_bits=model_config.weight_bits,
            act_bits=model_config.act_bits,
            kv_bits=model_config.kv_cache_bits,
            kv_zeros=model_config.kv_zeros,
            group_size=model_config.group_size,
            page_size=page_size,
            lm_head_bits=getattr(model_config, "lm_head_bits", 16),
            attn_bias=(
                bool(getattr(hf, "attention_bias", False))
                or getattr(hf, "model_type", "") == "qwen2"
            ),
        )


class PrefillBatch(NamedTuple):
    token_ids: torch.Tensor       # [T] int
    positions: torch.Tensor       # [T] int32
    segment_ids: torch.Tensor     # [T] int32, padding rows = -1
    block_tables: torch.Tensor    # [B, max_blocks] int32
    last_token_idx: torch.Tensor  # [B] int index into T
    seq_lens: Optional[torch.Tensor] = None  # [B] int32 prompt length
    # Chunked-prefill mode only (rectangular [B, Tc] token layout): tokens
    # in the pool incl. this chunk, per seq. None = whole-prompt prefill.
    context_lens: Optional[torch.Tensor] = None


class DecodeBatch(NamedTuple):
    token_ids: torch.Tensor       # [B] int
    positions: torch.Tensor       # [B] int32 (index of this token)
    block_tables: torch.Tensor    # [B, max_blocks] int32
    active: torch.Tensor          # [B] bool


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _random_packed_stack(gen, n_layers, n_out, k_in, device):
    """Random PACKED W4 per-channel weights for ``n_layers`` layers.

    The 'dummy' load format needs plausible magnitudes only: codes are
    uniform bytes, scales in [0.003, 0.006], zero point 8 (dequantized std
    about 0.02), as the JAX package draws them."""
    qweight = torch.randint(
        0, 256, (n_layers, k_in // 2, n_out), generator=gen,
        dtype=torch.uint8, device=device,
    )
    s1 = torch.empty((n_layers, n_out), dtype=torch.float32, device=device)
    s1.uniform_(0.003, 0.006, generator=gen)
    return QuantizedWeightPerChannel(
        qweight=qweight, s1_scales=s1, s1_szeros=8.0 * s1
    )


def _quantize_lm_head(w_bf16: torch.Tensor):
    """[D, V] bf16 -> (int8 [D, V], f32 scale [V]) per-channel symmetric."""
    wf = w_bf16.float()
    scale = ieee_div(torch.clamp(wf.abs().amax(dim=0), min=1e-12), 127.0)
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def make_random_packed_params(
    spec: LlamaSpec, seed: int = 0, device="cuda:0",
) -> Dict[str, Any]:
    """Random packed params drawn on ``device`` from a seeded
    ``torch.Generator`` (the numbers differ from the JAX package's draw;
    the shapes, dtypes and magnitudes are the same). Benchmarks only."""
    spec.check_supported()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, D, I = spec.num_layers, spec.hidden, spec.intermediate
    layers = {
        "attn_ln": torch.ones((L, D), dtype=torch.float32, device=device),
        "mlp_ln": torch.ones((L, D), dtype=torch.float32, device=device),
        "qkv": _random_packed_stack(gen, L, spec.qkv_out, D, device),
        "o": _random_packed_stack(gen, L, D, spec.q_size, device),
        "gate_up": _random_packed_stack(gen, L, 2 * I, D, device),
        "down": _random_packed_stack(gen, L, D, I, device),
    }

    def normal(*shape):
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        return out.normal_(generator=gen) * 0.02

    params = {
        "embed": normal(spec.vocab, D),
        "final_ln": torch.ones((D,), dtype=torch.float32, device=device),
        "lm_head": normal(D, spec.vocab),
        "layers": layers,
    }
    if spec.lm_head_bits == 8:
        params["lm_head"], params["lm_head_scale"] = _quantize_lm_head(
            params["lm_head"]
        )
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_linear(weight: QuantizedWeightPerChannel, x_q, x_scale, x_sum,
                  layer: int):
    return w4a8_matmul_per_channel(
        x_q, weight.qweight, weight.s1_scales, weight.s1_szeros, x_scale,
        x_sum, layer=layer,
    )


def _split_qkv(qkv, spec: LlamaSpec, t: int):
    q = qkv[:, : spec.q_size].reshape(t, spec.num_q_heads, spec.head_dim)
    k = qkv[:, spec.q_size: spec.q_size + spec.kv_size].reshape(
        t, spec.num_kv_heads, spec.head_dim
    )
    v = qkv[:, spec.q_size + spec.kv_size:].reshape(
        t, spec.num_kv_heads, spec.head_dim
    )
    return q, k, v


def _prefill_page_ids(batch: PrefillBatch, spec: LlamaSpec):
    """Token -> (physical page or -1 for padding, slot)."""
    seg = torch.clamp(batch.segment_ids, min=0).long()
    blk = (batch.positions // spec.page_size).long()
    slot = batch.positions % spec.page_size
    n_blocks = batch.block_tables.shape[1]
    pages = batch.block_tables[seg, torch.clamp(blk, max=n_blocks - 1)]
    pages = torch.where(batch.segment_ids < 0, -1, pages)
    return pages, slot


def _dense_mlp(h, lp, spec: LlamaSpec, layer: int):
    """The Llama SwiGLU MLP (pre-norm, quantized, residual)."""
    x_q, x_scale, x_sum = rms_norm_quant(
        h, lp["mlp_ln"][layer], spec.rms_eps, fuse_sum=True
    )
    gate_up = _apply_linear(lp["gate_up"], x_q, x_scale, x_sum, layer)
    g_q, g_scale, g_sum = silu_and_mul_quant(gate_up, fuse_sum=True)
    d_out = _apply_linear(lp["down"], g_q, g_scale, g_sum, layer)
    return h + d_out.to(h.dtype)


def _layer_step(h, pool: KVPool, layer: int, lp, inv_freq, spec: LlamaSpec,
                is_prefill: bool, batch, page_io):
    """One transformer layer. h: [T, D] bf16 residual stream."""
    t = h.shape[0]
    x_q, x_scale, x_sum = rms_norm_quant(
        h, lp["attn_ln"][layer], spec.rms_eps, fuse_sum=True
    )
    qkv = _apply_linear(lp["qkv"], x_q, x_scale, x_sum, layer)
    q, k, v = _split_qkv(qkv, spec, t)
    q = apply_rope(q, batch.positions, inv_freq)
    k = apply_rope(k, batch.positions, inv_freq)

    chunked = is_prefill and batch.context_lens is not None
    if is_prefill:
        pages, slots = page_io
        # chunked prefill is page-aligned by construction: the chunk size is
        # a page multiple and each [B, Tc] row starts at a page boundary
        append_kv(pool, layer, k, v, pages, slots, spec.page_size,
                  spec.kv_bits, spec.kv_zeros, page_aligned=chunked)
    if chunked:
        # attend causally over the paged pool (history + this chunk,
        # appended above); rectangular [B, Tc] layout
        nb = batch.block_tables.shape[0]
        tc = t // nb
        q4 = q.reshape(nb, tc, spec.num_q_heads, spec.head_dim)
        seg2 = batch.segment_ids.reshape(nb, tc)
        qpos = torch.where(seg2 >= 0, batch.positions.reshape(nb, tc), -1)
        attn = dispatch.paged_prefill_attention(
            q4, pool, layer, batch.block_tables, qpos.to(torch.int32),
            batch.context_lens,
            sm_scale=spec.sm_scale, page_size=spec.page_size,
            kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros,
        )
    elif is_prefill:
        attn = dispatch.prefill_attention(
            q, k, v,
            segment_ids=batch.segment_ids,
            positions=batch.positions,
            sm_scale=spec.sm_scale,
            valid=batch.segment_ids >= 0,
        )
    else:
        context_lens = torch.where(
            batch.active, batch.positions + 1, 0
        ).to(torch.int32)
        attn, pool, _ = dispatch.paged_decode_attention_fused(
            q, pool, None, layer, batch.block_tables, context_lens, k, v,
            sm_scale=spec.sm_scale, page_size=spec.page_size,
            kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros,
        )
    attn = attn.reshape(t, spec.q_size)
    a_q, a_scale, a_sum = quantize_activations(attn, fuse_sum=True)
    o_out = _apply_linear(lp["o"], a_q, a_scale, a_sum, layer)
    h = h + o_out.to(h.dtype)
    return _dense_mlp(h, lp, spec, layer)


def llama_forward(
    params: Dict[str, Any],
    retrieval_pool: KVPool,
    streaming_pool: Optional[KVPool],
    batch,
    spec: LlamaSpec,
    is_prefill: bool,
) -> Tuple[torch.Tensor, KVPool, Optional[KVPool], None]:
    """Returns (last-token logits [B, V] f32, pool, None, None).

    Same signature and results as the JAX ``llama_forward`` for the dense
    subset; the pool is updated in place."""
    if streaming_pool is not None:
        raise NotImplementedError(
            "streaming (ring) pools are the LServe path; see ROADMAP.md "
            "queue 1 item 5"
        )
    h = params["embed"][batch.token_ids.long()].to(torch.bfloat16)
    page_io = _prefill_page_ids(batch, spec) if is_prefill else None
    inv_freq = rope_freqs(
        spec.head_dim, spec.rope_base, spec.rope_scaling,
        llama3_cfg=spec.rope_llama3, device=h.device,
    )
    layers_p = params["layers"]
    for layer in range(spec.num_layers):
        h = _layer_step(h, retrieval_pool, layer, layers_p, inv_freq, spec,
                        is_prefill, batch, page_io)

    h = rms_norm(h, params["final_ln"], spec.rms_eps)
    h_last = h[batch.last_token_idx.long()] if is_prefill else h
    if spec.lm_head_bits == 8:
        h_i8, h_scale, _ = quantize_activations(h_last.float())
        logits = w8a8_matmul(
            h_i8, params["lm_head"], params["lm_head_scale"], h_scale,
            out_dtype=torch.float32,
        )
    elif h_last.is_cuda:
        # a plain bf16 product (the JAX package leaves it to XLA); on the
        # card the product rounds to bf16 before the f32 logits
        logits = (h_last.to(torch.bfloat16) @ params["lm_head"]).float()
    else:
        logits = h_last.to(torch.bfloat16).float() @ params["lm_head"].float()
    return logits, retrieval_pool, None, None
