"""Llama family, quantized (QServe's precision matrix), in PyTorch.

Subset of ``omniserve_tpu.models.llama`` (the dense path and LServe's
sparse prefill and dynamic-sparse decode) with the same parameter tree and
the same per-layer op order. Bodies: W4A8 with per-channel or per-group
(g128) weights, W8A8, W16A16 (bf16 activations, no quantization), with
the Qwen2 QKV bias where the model has one; GQA groups of 1 to 8 q heads
a kv head (Llama-3's 4, Yi-34B's 7, Qwen1.5's MHA); pools:
fine-grained kv4 or kv8, per-tensor kv4 or kv8, or kv16, on the dense
path and under LServe's modes alike (the per-tensor scales ride in the
pool, where the attention calls read them). Per layer:

- fused RMSNorm -> int8 quant (+ act sums for per-channel W4), the qkv
  GEMM (+ the QKV bias in f32), RoPE;
- prefill: quantize + scatter K/V into the paged pool(s), then
  packed-varlen causal attention over the prompt's own K/V (under
  ``sparse_prefill`` streaming heads keep the ctx sink + local band); or,
  for a chunk of a chunked prefill (``PrefillBatch.context_lens`` set),
  causal attention over the paged pool (history + chunk), with LServe's
  head routing when a streaming pool exists (``_dual_pool_chunk_attn``:
  retrieval heads dense over the retrieval pool, streaming heads their band
  over the ring);
- decode: one call attends the pool and appends the step's K/V to it; or,
  under sparse decode, per layer: the page selector (on a refresh step),
  the split append into the retrieval pool (with K min/max stats) and the
  streaming ring pool, then attention over the selected pages (retrieval
  heads) and the sink + local band (streaming heads);
- o_proj, residual, RMSNorm -> quant, gate_up, SwiGLU -> quant, down,
  residual (W16A16: no quantization, bf16 products);
- final RMSNorm and the lm_head (bf16, or W8A8) on each sequence's last
  token at prefill.

The JAX ``lax.scan`` over layers is a Python loop here. Stacked [L, ...]
weights are indexed per layer as views. Pools are updated in place.
Outside the slice (tensor/sequence parallelism, other precisions) the
functions raise and name the ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from omniserve_tpu_torch.ops import attention_ref, dispatch
from omniserve_tpu_torch.ops.cuda import HEAD_DIMS, MAX_N_REP, MAX_PAGE
from omniserve_tpu_torch.ops.activation import silu_and_mul, silu_and_mul_quant
from omniserve_tpu_torch.ops.matmul import (
    bf16_matmul,
    w4a8_matmul_per_channel,
    w4a8_matmul_per_group,
    w8a8_matmul,
)
from omniserve_tpu_torch.ops.norms import rms_norm, rms_norm_quant
from omniserve_tpu_torch.ops.cuda.decode_attention import pool_head_sources
from omniserve_tpu_torch.ops.paged_kv import (
    KVPool,
    append_kv,
    reset_page_stats_all_layers,
    ring_logical_blocks,
    update_k_stats,
)
from omniserve_tpu_torch.ops.quantization import (
    QuantizedWeightPerChannel,
    QuantizedWeightPerGroup,
    QuantizedWeightW8,
    ieee_div,
    quantize_activations,
    quantize_weight_per_channel,
    quantize_weight_per_group,
    quantize_weight_w8,
)
from omniserve_tpu_torch.ops.rope import apply_rope, rope_freqs


@dataclasses.dataclass(frozen=True)
class LlamaSpec:
    """Static model + quantization + attention geometry.

    The JAX ``LlamaSpec``'s fields minus the parallelism axes;
    ``check_supported`` refuses the values the port does not serve yet."""

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
    # LServe decode sparsity. sink_blocks/local_blocks are the RING geometry
    # (physical streaming capacity); dec_*_tokens are the decode attention
    # band (-1 = the whole ring).
    sparse_decode: bool = False
    sink_blocks: int = 2
    local_blocks: int = 4
    dec_sink_tokens: int = -1
    dec_local_tokens: int = -1
    sub_chunks: int = 4
    budget_pages: int = 64
    selector_interval: int = 4
    # LServe prefill sparsity
    sparse_prefill: bool = False
    ctx_sink: int = 128
    ctx_local: int = 8192
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

    @property
    def with_stats(self) -> bool:
        return self.sparse_decode

    @property
    def quantized_acts(self) -> bool:
        return self.act_bits == 8

    @property
    def needs_act_sums(self) -> bool:
        """Only the per-channel W4 epilogue cancels its zero point with
        the activation sums."""
        return self.weight_bits == 4 and self.group_size == -1

    def check_supported(self, device=None) -> None:
        """Raise for configurations the port does not serve yet. On a CUDA
        ``device`` also for what no card kernel takes: head_dim other than
        64 or 128, pages over 256 tokens (the CPU's plain paths take any)."""
        if (self.weight_bits, self.act_bits) not in ((4, 8), (8, 8),
                                                     (16, 16)):
            raise NotImplementedError(
                f"W{self.weight_bits}A{self.act_bits} bodies are outside "
                "the precision matrix (W4A8 per-channel or per-group, W8A8, "
                "W16A16)"
            )
        if self.kv_bits not in (4, 8, 16):
            raise NotImplementedError(
                f"kv{self.kv_bits} pools are outside the precision matrix "
                "(kv4, kv8, kv16)"
            )
        if (self.num_q_heads % self.num_kv_heads
                or not 1 <= self.n_rep <= MAX_N_REP):
            raise NotImplementedError(
                f"{self.num_q_heads} q heads over {self.num_kv_heads} kv "
                "heads: the attention kernels serve whole GQA groups of 1 "
                f"to {MAX_N_REP} q heads a kv head"
            )
        if device is None or torch.device(device).type != "cuda":
            return
        if self.head_dim not in HEAD_DIMS:
            raise NotImplementedError(
                f"head_dim {self.head_dim}: the card's attention, decode and "
                f"append kernels are built for head_dim "
                f"{' or '.join(map(str, HEAD_DIMS))}; other head dims are "
                "ROADMAP.md queue 2 item G"
            )
        if self.page_size > MAX_PAGE:
            raise NotImplementedError(
                f"{self.page_size}-token pages: the card's decode and append "
                f"kernels stage pages of at most {MAX_PAGE} tokens; larger "
                "pages are ROADMAP.md queue 2 item G"
            )

    @classmethod
    def from_model_config(cls, model_config, sp_attn_config=None,
                          tp_size: int = 1,
                          page_size: int = 64) -> "LlamaSpec":
        kwargs: Dict[str, Any] = {}
        if sp_attn_config is not None:
            dec = sp_attn_config.dec
            ctx = sp_attn_config.ctx
            kwargs.update(
                sparse_decode=dec.sparse_decode_mode,
                sink_blocks=dec.sink_blocks,
                local_blocks=dec.ring_local_blocks,
                dec_sink_tokens=dec.dec_sink_size,
                dec_local_tokens=dec.dec_local_size,
                sub_chunks=dec.sub_chunk_per_block,
                budget_pages=dec.budget_pages,
                selector_interval=dec.selector_update_interval,
                sparse_prefill=ctx.sparse_context_mode,
                ctx_sink=ctx.ctx_sink_size,
                ctx_local=ctx.ctx_local_size,
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
            **kwargs,
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
    # LServe: [B, sink+ring blocks] int32 pages of the streaming pool, and
    # the pages whose K stats this step resets ([Npg] int32, -1 padded)
    streaming_block_tables: Optional[torch.Tensor] = None
    new_page_ids: Optional[torch.Tensor] = None


class DecodeBatch(NamedTuple):
    token_ids: torch.Tensor       # [B] int
    positions: torch.Tensor       # [B] int32 (index of this token)
    block_tables: torch.Tensor    # [B, max_blocks] int32
    active: torch.Tensor          # [B] bool
    streaming_block_tables: Optional[torch.Tensor] = None
    new_page_ids: Optional[torch.Tensor] = None   # [Npg] int32, -1 padded
    # Sparse decode: recompute the page selection this step (a host bool:
    # eager code branches on it, and a captured step is captured per value),
    # else reuse the cached one, [L, B, Hkv, budget] int32 (-1 pad)
    refresh_selection: bool = False
    cached_page_idxes: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _quantize_linear(w_fp: torch.Tensor, spec: LlamaSpec,
                     k_shards: int = 1):
    """[N_out, K_in] fp -> the weight container of ``spec``'s body (W16A16:
    the bf16 [K, N] matrix)."""
    if spec.weight_bits == 4 and spec.group_size == -1:
        return quantize_weight_per_channel(w_fp, k_shards=k_shards)
    if spec.weight_bits == 4:
        return quantize_weight_per_group(
            w_fp, group_size=spec.group_size, k_shards=k_shards
        )
    if spec.weight_bits == 8:
        return quantize_weight_w8(w_fp)
    return w_fp.t().to(torch.bfloat16).contiguous()


# Row-parallel layers shard their input channels over tp ranks, so their
# int4 packing is per shard (the JAX package's ``_ROW_PARALLEL``).
_ROW_PARALLEL = ("o", "down")
_COL_PARALLEL = ("qkv", "gate_up")


def quantize_layer_weights(fp_layers: Dict[str, Any], spec: LlamaSpec,
                           tp_size: int = 1, device="cuda:0"
                           ) -> Dict[str, Any]:
    """Per-layer fp dict (each [L, N, K] stacked, host numpy or tensors) ->
    quantized stacked tensors on ``device``.

    One layer at a time goes to ``device`` and is quantized there, into
    stacks allocated after the first layer, so the fp32 stacks never sit
    on the device whole. Other entries (norm weights, the QKV bias) go to
    ``device`` as they are."""
    out: Dict[str, Any] = {}
    for name, w in fp_layers.items():
        if name in _ROW_PARALLEL:
            shards = tp_size
        elif name in _COL_PARALLEL:
            shards = 1
        else:
            out[name] = torch.as_tensor(w).to(device)
            continue
        stacked = None
        for layer in range(len(w)):
            q = _quantize_linear(torch.as_tensor(w[layer]).to(device), spec,
                                 k_shards=shards)
            fields = (q,) if isinstance(q, torch.Tensor) else tuple(q)
            if stacked is None:
                stacked = [torch.empty((len(w),) + f.shape, dtype=f.dtype,
                                       device=device) for f in fields]
            for dst, src in zip(stacked, fields):
                dst[layer] = src
        out[name] = (stacked[0] if isinstance(q, torch.Tensor)
                     else type(q)(*stacked))
    return out


def fuse_qkv_rank_major(q, k, v, tp_size: int = 1) -> np.ndarray:
    """Fuse per-layer q / k / v [L, N_*, K] into [L, N_qkv, K] with output
    channels ordered [q_0|k_0|v_0|q_1|k_1|v_1|...], so a tp shard of the
    fused output axis is one rank's (q, k, v) slice. Host numpy."""
    if tp_size == 1:
        return np.concatenate([q, k, v], axis=1)
    parts = []
    for qs, ks, vs in zip(np.split(q, tp_size, axis=1),
                          np.split(k, tp_size, axis=1),
                          np.split(v, tp_size, axis=1)):
        parts.extend([qs, ks, vs])
    return np.concatenate(parts, axis=1)


def fuse_gate_up_rank_major(gate, up, tp_size: int = 1) -> np.ndarray:
    """Fuse gate / up [L, I, K] into [L, 2I, K], rank-major like
    ``fuse_qkv_rank_major``."""
    if tp_size == 1:
        return np.concatenate([gate, up], axis=1)
    parts = []
    for gs, us in zip(np.split(gate, tp_size, axis=1),
                      np.split(up, tp_size, axis=1)):
        parts.extend([gs, us])
    return np.concatenate(parts, axis=1)


def _random_packed_stack(gen, spec: LlamaSpec, n_layers, n_out, k_in,
                         device):
    """Random PACKED weights of ``spec``'s body for ``n_layers`` layers.

    The 'dummy' load format needs plausible magnitudes only, drawn as the
    JAX package draws them: W4 codes are uniform bytes with s1 in [0.003,
    0.006] and zero point 8 (per group: integer s2 in [1, 3], ``s2_zero =
    -8 * s2``), dequantized std about 0.02; W8 codes uniform int8 with
    scales in [0.0003, 0.0006], std about 0.033; bf16 weights ``0.02 *
    N(0, 1)``."""
    L = n_layers

    def uniform(lo, hi):
        t = torch.empty((L, n_out), dtype=torch.float32, device=device)
        return t.uniform_(lo, hi, generator=gen)

    if spec.weight_bits == 4:
        qweight = torch.randint(
            0, 256, (L, k_in // 2, n_out), generator=gen,
            dtype=torch.uint8, device=device,
        )
        s1 = uniform(0.003, 0.006)
        if spec.group_size == -1:
            return QuantizedWeightPerChannel(
                qweight=qweight, s1_scales=s1, s1_szeros=8.0 * s1
            )
        s2 = torch.randint(1, 4, (L, k_in // spec.group_size, n_out),
                           generator=gen, dtype=torch.int8, device=device)
        return QuantizedWeightPerGroup(
            qweight=qweight, s1_scales=s1, s2_scales=s2, s2_zeros=-8 * s2,
        )
    if spec.weight_bits == 8:
        qweight = torch.randint(
            -128, 128, (L, k_in, n_out), generator=gen, dtype=torch.int8,
            device=device,
        )
        return QuantizedWeightW8(qweight=qweight,
                                 scales=uniform(0.0003, 0.0006))
    w = torch.empty((L, k_in, n_out), dtype=torch.bfloat16, device=device)
    return w.normal_(generator=gen) * 0.02


def _quantize_lm_head(w_bf16: torch.Tensor):
    """[D, V] bf16 -> (int8 [D, V], f32 scale [V]) per-channel symmetric."""
    wf = w_bf16.float()
    scale = ieee_div(torch.clamp(wf.abs().amax(dim=0), min=1e-12), 127.0)
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def make_attn_meta(
    spec: LlamaSpec,
    retrieval_flags: Optional[np.ndarray] = None,
    head_rank: Optional[np.ndarray] = None,
    device="cuda:0",
) -> Dict[str, torch.Tensor]:
    """Per-(layer, kv head) pool routing: ``retrieval_flags`` [L, Hkv] bool
    and ``head_rank`` [L, Hkv] int32, a head's row in its own pool
    (retrieval heads numbered in head order, streaming heads likewise)."""
    L, H = spec.num_layers, spec.num_kv_heads
    if retrieval_flags is None:
        retrieval_flags = np.ones((L, H), bool)
    retrieval_flags = np.asarray(retrieval_flags, bool)
    if retrieval_flags.shape != (L, H):
        raise ValueError(f"retrieval_flags must be [{L}, {H}]")
    if head_rank is None:
        head_rank = np.where(
            retrieval_flags, np.cumsum(retrieval_flags, axis=1) - 1,
            np.cumsum(~retrieval_flags, axis=1) - 1,
        )
    return {
        "retrieval_flags": torch.from_numpy(retrieval_flags).to(device),
        "head_rank": torch.from_numpy(
            np.asarray(head_rank, np.int32)).to(device),
    }


def make_random_packed_params(
    spec: LlamaSpec, seed: int = 0, device="cuda:0",
    retrieval_flags: Optional[np.ndarray] = None,
    head_rank: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Random packed params drawn on ``device`` from a seeded
    ``torch.Generator`` (the numbers differ from the JAX package's draw;
    the shapes, dtypes and magnitudes are the same). Benchmarks only."""
    spec.check_supported(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, D, I = spec.num_layers, spec.hidden, spec.intermediate
    layers = {
        "attn_ln": torch.ones((L, D), dtype=torch.float32, device=device),
        "mlp_ln": torch.ones((L, D), dtype=torch.float32, device=device),
        "qkv": _random_packed_stack(gen, spec, L, spec.qkv_out, D, device),
        "o": _random_packed_stack(gen, spec, L, D, spec.q_size, device),
        "gate_up": _random_packed_stack(gen, spec, L, 2 * I, D, device),
        "down": _random_packed_stack(gen, spec, L, D, I, device),
    }

    def normal(*shape):
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        return out.normal_(generator=gen) * 0.02

    if spec.attn_bias:   # f32 [L, qkv_out], as the JAX dummy draw
        layers["qkv_bias"] = torch.empty(
            (L, spec.qkv_out), dtype=torch.float32, device=device,
        ).normal_(generator=gen) * 0.02
    params = {
        "embed": normal(spec.vocab, D),
        "final_ln": torch.ones((D,), dtype=torch.float32, device=device),
        "lm_head": normal(D, spec.vocab),
        "layers": layers,
        "attn_meta": make_attn_meta(spec, retrieval_flags, head_rank, device),
    }
    if spec.lm_head_bits == 8:
        params["lm_head"], params["lm_head_scale"] = _quantize_lm_head(
            params["lm_head"]
        )
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_linear(weight, spec: LlamaSpec, x_q, x_scale, x_sum,
                  layer: int):
    """The body's linear on int8 activations (or bf16 under W16A16) for
    one layer of STACKED weights."""
    if spec.weight_bits == 4 and spec.group_size == -1:
        return w4a8_matmul_per_channel(
            x_q, weight.qweight, weight.s1_scales, weight.s1_szeros, x_scale,
            x_sum, layer=layer,
        )
    if spec.weight_bits == 4:
        return w4a8_matmul_per_group(
            x_q, weight.qweight, weight.s1_scales, weight.s2_scales,
            weight.s2_zeros, x_scale, group_size=spec.group_size,
            layer=layer,
        )
    if spec.weight_bits == 8:
        return w8a8_matmul(x_q, weight.qweight, weight.scales, x_scale,
                           layer=layer)
    return bf16_matmul(x_q, weight, layer=layer)


def _norm_quant(x, ln_w, spec: LlamaSpec):
    """RMSNorm (+ per-token quant when activations are int8)."""
    if spec.quantized_acts:
        return rms_norm_quant(x, ln_w, spec.rms_eps,
                              fuse_sum=spec.needs_act_sums)
    return rms_norm(x, ln_w, spec.rms_eps), None, None


def _act_quant(x, spec: LlamaSpec):
    if spec.quantized_acts:
        return quantize_activations(x, fuse_sum=spec.needs_act_sums)
    return x.to(torch.bfloat16), None, None


def _split_qkv(qkv, spec: LlamaSpec, t: int):
    q = qkv[:, : spec.q_size].reshape(t, spec.num_q_heads, spec.head_dim)
    k = qkv[:, spec.q_size: spec.q_size + spec.kv_size].reshape(
        t, spec.num_kv_heads, spec.head_dim
    )
    v = qkv[:, spec.q_size + spec.kv_size:].reshape(
        t, spec.num_kv_heads, spec.head_dim
    )
    return q, k, v


def _ring_slot(blk: torch.Tensor, sink_b: int, local_b: int) -> torch.Tensor:
    return torch.where(blk < sink_b, blk, sink_b + (blk - sink_b) % local_b)


def _prefill_page_ids(batch: PrefillBatch, spec: LlamaSpec):
    """Token -> (retrieval page or -1 for padding, slot, streaming page or
    -1, slot); the streaming pair is None without streaming tables."""
    seg = torch.clamp(batch.segment_ids, min=0).long()
    blk = (batch.positions // spec.page_size).long()
    slot = batch.positions % spec.page_size
    n_blocks = batch.block_tables.shape[1]
    pages_r = batch.block_tables[seg, torch.clamp(blk, max=n_blocks - 1)]
    invalid = batch.segment_ids < 0
    pages_r = torch.where(invalid, -1, pages_r)
    st = batch.streaming_block_tables
    if st is None:
        return pages_r, slot, None, None
    # streaming: ring mapping; tokens that are not in the sink and older
    # than the local window are never read again (and would be overwritten
    # within this same prefill), so their write is dropped. The horizon is
    # the running context of a chunk, the prompt length of a whole prompt.
    ring = _ring_slot(blk, spec.sink_blocks, spec.local_blocks)
    pages_s = st[seg, torch.clamp(ring, max=st.shape[1] - 1)]
    horizon = (batch.context_lens if batch.context_lens is not None
               else batch.seq_lens)[seg]
    sink_tok = spec.sink_blocks * spec.page_size
    local_tok = spec.local_blocks * spec.page_size
    dead = (batch.positions >= sink_tok) & (
        batch.positions < horizon - local_tok)
    pages_s = torch.where(invalid | dead, -1, pages_s)
    return pages_r, slot, pages_s, slot


def _decode_page_ids(batch: DecodeBatch, spec: LlamaSpec):
    """Row -> (retrieval page or -1 if inactive, slot, streaming page, slot)
    of the step's new token."""
    bi = torch.arange(batch.token_ids.shape[0], device=batch.positions.device)
    blk = (batch.positions // spec.page_size).long()
    slot = batch.positions % spec.page_size
    n_blocks = batch.block_tables.shape[1]
    pages_r = batch.block_tables[bi, torch.clamp(blk, max=n_blocks - 1)]
    pages_r = torch.where(batch.active, pages_r, -1)
    st = batch.streaming_block_tables
    if st is None:
        return pages_r, slot, None, None
    ring = _ring_slot(blk, spec.sink_blocks, spec.local_blocks)
    pages_s = st[bi, torch.clamp(ring, max=st.shape[1] - 1)]
    pages_s = torch.where(batch.active, pages_s, -1)
    return pages_r, slot, pages_s, slot


def _write_kv(pools, layer: int, k, v, page_io, meta_l, spec: LlamaSpec,
              update_stats: bool, unique_pages: bool = False,
              page_aligned: bool = False):
    """Quantize + write K/V into both pools for one layer, each kv head
    routed to its pool row; in place."""
    retrieval_pool, streaming_pool = pools
    pages_r, slots_r, pages_s, slots_s = page_io
    flags, rank = meta_l["retrieval_flags"], meta_l["head_rank"]
    args = (spec.page_size, spec.kv_bits, spec.kv_zeros)
    # pool row r <- the kv head h with flags[h] and rank[h] == r
    src_r = pool_head_sources(rank, flags, retrieval_pool.num_heads, True)
    src_s = None
    if streaming_pool is not None:
        src_s = pool_head_sources(rank, flags, streaming_pool.num_heads,
                                  False)
    if unique_pages:
        # decode: both pools in one append, each row reading its head
        dispatch.append_kv_decode_pools(
            retrieval_pool, streaming_pool, layer, k, v,
            (pages_r, slots_r, src_r), (pages_s, slots_s, src_s), *args,
            update_stats=update_stats, sub_chunks=spec.sub_chunks,
        )
        return
    k_r, v_r = k[:, src_r], v[:, src_r]
    append_kv(retrieval_pool, layer, k_r, v_r, pages_r, slots_r, *args,
              page_aligned=page_aligned)
    if update_stats:
        update_k_stats(retrieval_pool, layer, k_r, pages_r, slots_r,
                       spec.page_size, spec.sub_chunks)
    if streaming_pool is not None:
        append_kv(streaming_pool, layer, k[:, src_s], v[:, src_s],
                  pages_s, slots_s, *args, page_aligned=page_aligned)


def _run_selector(q, retrieval_pool: KVPool, layer: int, batch: DecodeBatch,
                  meta_l, spec: LlamaSpec) -> torch.Tensor:
    """This layer's dynamic page selection [B, Hkv, budget] from its
    current queries. Runs BEFORE the step's append: the stats do not hold
    the new token yet, and the newest page is force-included."""
    context_lens = torch.where(batch.active, batch.positions + 1, 0)
    scores = attention_ref.page_selector_scores(
        q, retrieval_pool.k_stats, layer, batch.block_tables,
        meta_l["retrieval_flags"], meta_l["head_rank"],
    )
    return attention_ref.select_topk_pages(
        scores, context_lens, spec.budget_pages, spec.page_size
    )


def _dense_mlp(h, lp, spec: LlamaSpec, layer: int, valid=None):
    """The Llama SwiGLU MLP (pre-norm, quantized, residual). ``valid`` (the
    row mask) is unused here: a MoE MLP (``mlp_fn``) keeps padding and
    inactive rows out of its experts' capacity with it."""
    x_q, x_scale, x_sum = _norm_quant(h, lp["mlp_ln"][layer], spec)
    gate_up = _apply_linear(lp["gate_up"], spec, x_q, x_scale, x_sum, layer)
    if spec.quantized_acts:
        g_q, g_scale, g_sum = silu_and_mul_quant(
            gate_up, fuse_sum=spec.needs_act_sums)
    else:
        g_q, g_scale, g_sum = (
            silu_and_mul(gate_up).to(torch.bfloat16), None, None)
    d_out = _apply_linear(lp["down"], spec, g_q, g_scale, g_sum, layer)
    return h + d_out.to(h.dtype)


def _layer_step(h, pools, layer: int, lp, meta_l, inv_freq,
                spec: LlamaSpec, is_prefill: bool, batch, page_io, ring=None,
                mlp_fn=_dense_mlp):
    """One transformer layer. h: [T, D] bf16 residual stream; ``pools`` =
    (retrieval pool, streaming pool or None), updated in place; ``ring`` is
    the chunk's ``_ring_lists``; ``mlp_fn`` the MLP block (dense SwiGLU, or
    Mixtral's MoE block). Returns (h, this layer's page selection or
    None)."""
    t = h.shape[0]
    pool, streaming_pool = pools
    x_q, x_scale, x_sum = _norm_quant(h, lp["attn_ln"][layer], spec)
    qkv = _apply_linear(lp["qkv"], spec, x_q, x_scale, x_sum, layer)
    if spec.attn_bias:   # in f32, back to the GEMM's dtype (the JAX order)
        qkv = (qkv.float() + lp["qkv_bias"][layer]).to(qkv.dtype)
    q, k, v = _split_qkv(qkv, spec, t)
    q = apply_rope(q, batch.positions, inv_freq)
    k = apply_rope(k, batch.positions, inv_freq)

    use_sparse = (not is_prefill) and spec.sparse_decode
    page_idxes_l = None
    if use_sparse:
        # refresh the selection from this layer's current q every
        # selector_interval steps, else reuse the cached one
        page_idxes_l = (
            _run_selector(q, pool, layer, batch, meta_l, spec)
            if batch.refresh_selection else batch.cached_page_idxes[layer]
        )

    chunked = is_prefill and batch.context_lens is not None
    if spec.sparse_decode:
        # pool rows are routed per head; decode appends stay split from the
        # attention (they also merge the K min/max stats)
        _write_kv(pools, layer, k, v, page_io, meta_l, spec,
                  update_stats=True, unique_pages=not is_prefill,
                  page_aligned=chunked)
    elif is_prefill:
        # chunked prefill is page-aligned by construction: the chunk size is
        # a page multiple and each [B, Tc] row starts at a page boundary
        append_kv(pool, layer, k, v, page_io[0], page_io[1], spec.page_size,
                  spec.kv_bits, spec.kv_zeros, page_aligned=chunked)
    if chunked:
        # attend causally over the paged pool (history + this chunk,
        # appended above); rectangular [B, Tc] layout
        nb = batch.block_tables.shape[0]
        tc = t // nb
        q4 = q.reshape(nb, tc, spec.num_q_heads, spec.head_dim)
        seg2 = batch.segment_ids.reshape(nb, tc)
        qpos = torch.where(seg2 >= 0, batch.positions.reshape(nb, tc),
                           -1).to(torch.int32)
        if streaming_pool is None:
            attn = dispatch.paged_prefill_attention(
                q4, pool, layer, batch.block_tables, qpos,
                batch.context_lens,
                sm_scale=spec.sm_scale, page_size=spec.page_size,
                kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros,
            )
        else:
            attn = _dual_pool_chunk_attn(q4, pool, streaming_pool, layer,
                                         batch, qpos, meta_l, spec, ring)
    elif is_prefill:
        attn = dispatch.prefill_attention(
            q, k, v,
            segment_ids=batch.segment_ids,
            positions=batch.positions,
            sm_scale=spec.sm_scale,
            head_is_retrieval=(
                meta_l["retrieval_flags"].repeat_interleave(spec.n_rep)
                if spec.sparse_prefill else None),
            sink_size=spec.ctx_sink,
            local_size=spec.ctx_local,
            valid=batch.segment_ids >= 0,
        )
    else:
        context_lens = torch.where(
            batch.active, batch.positions + 1, 0
        ).to(torch.int32)
        if use_sparse:
            streaming = streaming_pool is not None
            attn = dispatch.paged_decode_attention(
                q, pool, layer, batch.block_tables, context_lens,
                spec.sm_scale, spec.page_size, spec.kv_bits, spec.kv_zeros,
                streaming_pool=streaming_pool,
                streaming_block_tables=batch.streaming_block_tables,
                head_is_retrieval=(
                    meta_l["retrieval_flags"] if streaming else None),
                head_rank=meta_l["head_rank"] if streaming else None,
                sink_blocks=spec.sink_blocks,
                local_blocks=spec.local_blocks,
                page_idxes=page_idxes_l,
                dec_sink_tokens=(None if spec.dec_sink_tokens < 0
                                 else spec.dec_sink_tokens),
                dec_local_tokens=(None if spec.dec_local_tokens < 0
                                  else spec.dec_local_tokens),
            )
        else:
            attn, _, _ = dispatch.paged_decode_attention_fused(
                q, pool, None, layer, batch.block_tables, context_lens, k, v,
                sm_scale=spec.sm_scale, page_size=spec.page_size,
                kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros,
            )
    attn = attn.reshape(t, spec.q_size)
    a_q, a_scale, a_sum = _act_quant(attn, spec)
    o_out = _apply_linear(lp["o"], spec, a_q, a_scale, a_sum, layer)
    h = h + o_out.to(h.dtype)
    # the MLP block; padding (prefill) and inactive (decode) rows are not
    # valid, so they take no expert capacity in a MoE block
    valid_rows = batch.segment_ids >= 0 if is_prefill else batch.active
    return mlp_fn(h, lp, spec, layer, valid=valid_rows), page_idxes_l


def _ring_lists(batch: PrefillBatch, spec: LlamaSpec, n_heads: int):
    """What the streaming heads' paged-prefill call takes besides q, the
    same in every layer of a chunk: the logical block each ring slot holds,
    the ring's span and sink, and per-q-head flags that all stream."""
    n_slots = batch.streaming_block_tables.shape[1]
    ring_local = max(1, n_slots - spec.sink_blocks)
    return dict(
        sel_logic=ring_logical_blocks(batch.context_lens, n_slots,
                                      spec.sink_blocks, ring_local,
                                      spec.page_size),
        ring_span_pages=ring_local,
        ring_sink_tokens=spec.sink_blocks * spec.page_size,
        head_is_retrieval=torch.zeros(
            n_heads * spec.n_rep, dtype=torch.bool,
            device=batch.context_lens.device),
    )


def _dual_pool_chunk_attn(q4, rpool: KVPool, spool: KVPool, layer: int,
                          batch: PrefillBatch, qpos, meta_l, spec: LlamaSpec,
                          ring=None):
    """Chunked-prefill attention with LServe's head routing: retrieval
    heads attend their whole paged history (dense causal), streaming heads
    their ctx sink + local band out of the ring pool, whose slots resolve to
    logical blocks (the ring holds the ctx-local window plus one chunk:
    ``DecAttnConfig.ring_local_blocks``). ``ring`` is the chunk's
    ``_ring_lists``, built here when not given. q4 [B, Tc, Hq, D] -> the
    same."""
    nb, tc = q4.shape[:2]
    hkv, n_rep, d = spec.num_kv_heads, spec.n_rep, spec.head_dim
    flags, rank = meta_l["retrieval_flags"], meta_l["head_rank"]
    ctx = batch.context_lens
    q_g = q4.reshape(nb, tc, hkv, n_rep, d)

    hr = rpool.num_heads
    src_r = pool_head_sources(rank, flags, hr, True)
    out_r = dispatch.paged_prefill_attention(
        q_g[:, :, src_r].reshape(nb, tc, hr * n_rep, d), rpool, layer,
        batch.block_tables, qpos, ctx,
        sm_scale=spec.sm_scale, page_size=spec.page_size,
        kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros,
    ).reshape(nb, tc, hr, n_rep, d)

    hs = spool.num_heads
    src_s = pool_head_sources(rank, flags, hs, False)
    if ring is None:
        ring = _ring_lists(batch, spec, hs)
    out_s = dispatch.paged_prefill_attention(
        q_g[:, :, src_s].reshape(nb, tc, hs * n_rep, d), spool, layer,
        batch.streaming_block_tables, qpos, ctx,
        sm_scale=spec.sm_scale, page_size=spec.page_size,
        kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros,
        sink_size=spec.ctx_sink, local_size=spec.ctx_local, **ring,
    ).reshape(nb, tc, hs, n_rep, d)

    full_r = out_r[:, :, torch.clamp(rank.long(), 0, hr - 1)]
    full_s = out_s[:, :, torch.clamp(rank.long(), 0, hs - 1)]
    out = torch.where(flags[None, None, :, None, None], full_r, full_s)
    return out.reshape(nb, tc, hkv * n_rep, d)


def llama_forward(
    params: Dict[str, Any],
    retrieval_pool: KVPool,
    streaming_pool: Optional[KVPool],
    batch,
    spec: LlamaSpec,
    is_prefill: bool,
    mlp_fn=_dense_mlp,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, KVPool, Optional[KVPool], Optional[torch.Tensor]]:
    """Returns (last-token logits [B, V] f32, pools..., new_page_idxes).

    ``return_hidden=True`` returns the final-norm hidden states of every
    token ([T, D] bf16) in place of the logits, and None for the selection,
    as the JAX forward does: teacher-forced evaluation
    (``eval/ppl.py``) applies the lm_head in vocab chunks itself.

    Same signature and results as the JAX ``llama_forward`` for the subset
    the port serves; the pools are updated in place. ``new_page_idxes``
    ([L, B, Hkv, budget] int32) is the page selection of a sparse decode
    step: freshly computed when ``batch.refresh_selection``, else the
    cached tensor itself; None otherwise. ``mlp_fn`` is each layer's MLP
    block (``models/mixtral.moe_mlp`` for Mixtral), as in JAX."""
    if streaming_pool is not None and not spec.sparse_decode:
        raise NotImplementedError(
            "a streaming (ring) pool under dense decode needs the fused "
            "append over a ring, ROADMAP.md queue 2 item 2; the engine "
            "builds a streaming pool only under --sparse-decode-mode"
        )
    ids = batch.token_ids.long()
    # prefill keeps the direct index, as the JAX forward does
    h = (params["embed"][ids] if is_prefill
         else dispatch.embed_lookup(params["embed"], ids)).to(torch.bfloat16)
    if spec.with_stats:
        reset_page_stats_all_layers(retrieval_pool, batch.new_page_ids)
    page_io = (_prefill_page_ids(batch, spec) if is_prefill
               else _decode_page_ids(batch, spec))
    inv_freq = rope_freqs(
        spec.head_dim, spec.rope_base, spec.rope_scaling,
        llama3_cfg=spec.rope_llama3, device=h.device,
    )
    layers_p = params["layers"]
    meta = (params["attn_meta"]
            if spec.sparse_decode or spec.sparse_prefill else None)
    pools = (retrieval_pool, streaming_pool)
    ring = (_ring_lists(batch, spec, streaming_pool.num_heads)
            if is_prefill and streaming_pool is not None
            and batch.context_lens is not None else None)
    selections = []
    for layer in range(spec.num_layers):
        meta_l = None if meta is None else {
            "retrieval_flags": meta["retrieval_flags"][layer],
            "head_rank": meta["head_rank"][layer],
        }
        h, page_idxes_l = _layer_step(h, pools, layer, layers_p, meta_l,
                                      inv_freq, spec, is_prefill, batch,
                                      page_io, ring, mlp_fn=mlp_fn)
        selections.append(page_idxes_l)
    new_page_idxes = None
    if (not is_prefill) and spec.sparse_decode:
        new_page_idxes = (torch.stack(selections) if batch.refresh_selection
                          else batch.cached_page_idxes)

    h = rms_norm(h, params["final_ln"], spec.rms_eps)
    if return_hidden:
        return h, retrieval_pool, streaming_pool, None
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
    return logits, retrieval_pool, streaming_pool, new_page_idxes
