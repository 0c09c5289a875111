"""The port's ``llama_forward`` against the JAX package's (CPU, tiny model).

Same packed W4A8 per-channel x KV4 weights (JAX ``make_random_packed_params``
carried over with ``params_from_numpy``), same padded prefill batch, then
one decode step from the same tokens; and a chunked prefill (two chunks,
the second attending the first through the paged pool) from the same
chunk batches.

Tolerances. Run op by op (``jax.disable_jit()``), the JAX functions and
the port execute the same integer GEMMs and the same f32 op order: logits
agree to 1e-4 of their scale (in practice bit for bit) and the KV pools byte
for byte (at most a few codes one step apart at an exact rounding tie).
Compiled, XLA fuses the layer scan and rounds its f32 elementwise chains
its own way; int8 activation codes then move by a step here and there and
the logits differ by about 1% of their scale, so the compiled comparison is
held at 3e-2 of the scale.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.models import llama as j_llama
from omniserve_tpu.ops.paged_kv import make_kv_pool as j_make_kv_pool
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models.convert import params_from_numpy
from omniserve_tpu_torch.ops.paged_kv import make_kv_pool as t_make_kv_pool
from omniserve_tpu_torch.worker.model_runner import chunked_prefill_batches

PAGE = 16
LOGIT_RTOL = 1e-4          # vs the op-by-op JAX forward
LOGIT_RTOL_JIT = 3e-2      # vs the compiled JAX forward
PLANE_RTOL = 1e-3          # the pools' f32 planes


def spec_kwargs(lm_head_bits):
    return dict(
        num_layers=2, hidden=64, intermediate=128, num_q_heads=4,
        num_kv_heads=2, head_dim=16, vocab=128, page_size=PAGE,
        rope_base=500000.0, weight_bits=4, act_bits=8, kv_bits=4,
        kv_zeros=True, lm_head_bits=lm_head_bits,
    )


def assert_logits_close(got, want, rtol=LOGIT_RTOL):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def assert_pools_close(tpool, jpool, plane_rtol=PLANE_RTOL, moved=1e-3):
    """Codes at most one step apart, fewer than ``moved`` of the code bytes
    different, the f32 planes within ``plane_rtol``."""
    for name in ("k_data", "v_data"):
        a = tpool_np(tpool, name).astype(int)
        b = np.asarray(getattr(jpool, name)).astype(int)
        for shift in (0, 4):
            assert np.abs(((a >> shift) & 15) - ((b >> shift) & 15)).max() <= 1
        assert (a != b).mean() < moved, name
    np.testing.assert_allclose(tpool_np(tpool, "kv_scales"),
                               np.asarray(jpool.kv_scales), rtol=plane_rtol,
                               atol=1e-6)


def tpool_np(pool, name):
    return getattr(pool, name).numpy()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


@contextlib.contextmanager
def recorded_gemms():
    """Within the block, each package's ``llama_forward`` records, in call
    order, every body GEMM's input (int8 activation codes, or bf16) and
    output, the W8A8 lm_head's input codes, and the qkv that
    ``_split_qkv`` receives (after the bias): {"jax": [...], "torch":
    [...]} of (kind, arrays)."""
    seen = {"jax": [], "torch": []}
    with pytest.MonkeyPatch.context() as mp:
        for mod, key in ((j_llama, "jax"), (t_llama, "torch")):
            def wrap(name, kind, arg, out=seen[key]):
                real = getattr(mod, name)

                def rec(*a, **k):
                    y = real(*a, **k)
                    out.append((kind, _np(a[arg]), _np(y) if kind == "gemm"
                                else None))
                    return y
                mp.setattr(mod, name, rec)
            wrap("_apply_linear", "gemm", 2)    # (weight, spec, x_q, ...)
            wrap("w8a8_matmul", "head", 0)
            wrap("_split_qkv", "split", 0)
        yield seen


def codes_moved(seen) -> int:
    """Activation codes that differ between the two packages' GEMM inputs
    (0: every GEMM read the same codes)."""
    j, t = seen["jax"], seen["torch"]
    assert [e[0] for e in j] == [e[0] for e in t]
    return sum(int((a[1] != b[1]).sum()) for a, b in zip(j, t)
               if a[0] != "split")


def biased_qkv_checked(seen) -> float:
    """Each layer's qkv after the bias, element by element: wherever both
    packages' qkv GEMMs returned the same value, the biased value is
    equal bit for bit (the bias added in f32 and cast back, the JAX
    order). Returns the share of qkv elements so checked (the rest
    follow an f32 last-ulp difference or a flipped code upstream)."""
    checked = total = 0
    pairs = list(zip(seen["jax"], seen["torch"]))
    for i, (j, t) in enumerate(pairs):
        if j[0] == "split":
            same = pairs[i - 1][0][2] == pairs[i - 1][1][2]
            np.testing.assert_array_equal(t[1][same], j[1][same])
            checked += int(same.sum())
            total += same.size
    return checked / total


def both_models(kw, seed=3):
    """(JAX spec, port spec, JAX params, the port's copy) of ``kw``."""
    j_spec, t_spec = j_llama.LlamaSpec(**kw), t_llama.LlamaSpec(**kw)
    t_spec.check_supported()
    jparams = j_llama.make_random_packed_params(j_spec, seed=seed)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert ("qkv_bias" in tparams["layers"]) == kw.get("attn_bias", False)
    return j_spec, t_spec, jparams, tparams


def check_forward(kw, flip_gates=None, jit=False, models=None,
                  forwards=None):
    """A padded prefill of two prompts (13 and 20 tokens), then one decode
    step (and an inactive slot) from the same next tokens, through both
    packages' ``llama_forward`` with the same packed weights of spec
    ``kw`` (``models``: ``both_models(kw)``, made here if None). While
    every GEMM reads the same activation codes in both, the logits agree
    within LOGIT_RTOL of the op-by-op JAX forward's scale and the pools
    per ``assert_pools_close``; from a step where an f32 last-ulp
    difference flips a code on, the logits are held at
    ``flip_gates["logits"]`` and the pools at its "planes" and "codes"
    (None: no flip allowed). ``jit``: also within LOGIT_RTOL_JIT of the
    compiled JAX forward. A biased spec's qkv after the bias is equal bit
    for bit wherever both qkv GEMMs agree (over half of it), and that
    check refuses its forward without the bias. ``forwards`` is the
    (JAX, port) forward pair, the packages' ``llama_forward`` if None (a
    Mixtral test passes ``mixtral_forward``'s with its ``models``).
    Returns the port's parameters."""
    gates = flip_gates or dict(logits=LOGIT_RTOL, planes=PLANE_RTOL,
                               codes=1e-3)
    page = kw["page_size"]
    j_spec, t_spec, jparams, tparams = models or both_models(kw)
    j_forward, t_forward = forwards or (j_llama.llama_forward,
                                        t_llama.llama_forward)
    rng = np.random.default_rng(4)
    lens = [13, 20]
    t_pad, w = 48, 3
    tables = np.array([[4, 1, 7], [2, 6, 0]], np.int32)
    tokens = np.zeros(t_pad, np.int32)
    pos = np.zeros(t_pad, np.int32)
    seg = np.full(t_pad, -1, np.int32)
    o = 0
    for i, n in enumerate(lens):
        tokens[o:o + n] = rng.integers(0, kw["vocab"], n)
        pos[o:o + n] = np.arange(n)
        seg[o:o + n] = i
        o += n
    last = np.cumsum(lens) - 1
    hkv, d = kw["num_kv_heads"], kw["head_dim"]
    jpool = j_make_kv_pool(2, 9, hkv, page, d, kv_bits=4, kv_zeros=True)
    tpool = t_make_kv_pool(2, 9, hkv, page, d, device="cpu")

    j_batch = j_llama.PrefillBatch(
        token_ids=jnp.asarray(tokens), positions=jnp.asarray(pos),
        segment_ids=jnp.asarray(seg), block_tables=jnp.asarray(tables),
        streaming_block_tables=jnp.zeros((2, 1), jnp.int32),
        last_token_idx=jnp.asarray(last, jnp.int32),
        seq_lens=jnp.asarray(lens, jnp.int32),
        new_page_ids=jnp.full((8,), -1, jnp.int32),
    )
    t_batch = t_llama.PrefillBatch(
        token_ids=torch.from_numpy(tokens), positions=torch.from_numpy(pos),
        segment_ids=torch.from_numpy(seg),
        block_tables=torch.from_numpy(tables),
        last_token_idx=torch.from_numpy(last),
    )
    # one decode step (plus an inactive slot) from the next tokens
    active = np.array([True, True, False])
    dtables = np.concatenate([tables, np.zeros((1, w), np.int32)])

    def decode_batches(nxt):
        dpos = np.array(lens + [0], np.int32)
        return (j_llama.DecodeBatch(
            token_ids=jnp.asarray(nxt), positions=jnp.asarray(dpos),
            block_tables=jnp.asarray(dtables),
            streaming_block_tables=jnp.zeros((3, 1), jnp.int32),
            active=jnp.asarray(active),
            new_page_ids=jnp.full((8,), -1, jnp.int32),
            refresh_selection=jnp.asarray(False),
            cached_page_idxes=jnp.full((2, 3, 1, 1), -1, jnp.int32),
        ), t_llama.DecodeBatch(
            token_ids=torch.from_numpy(nxt), positions=torch.from_numpy(dpos),
            block_tables=torch.from_numpy(dtables),
            active=torch.from_numpy(active),
        ))

    flipped = False
    for step in ("prefill", "decode"):
        is_prefill = step == "prefill"
        if not is_prefill:
            nxt = np.append(j_logits.argmax(-1), 0).astype(np.int32)
            j_batch, t_batch = decode_batches(nxt)
        if jit:
            jit_logits, _, _, _ = j_forward(
                jparams, jpool, None, j_batch, j_spec, is_prefill=is_prefill)
        with recorded_gemms() as seen:
            with jax.disable_jit():
                j_logits, jpool, _, _ = j_forward(
                    jparams, jpool, None, j_batch, j_spec,
                    is_prefill=is_prefill)
            t_logits, tpool, _, _ = t_forward(
                tparams, tpool, None, t_batch, t_spec, is_prefill=is_prefill)
        if t_spec.attn_bias:
            assert biased_qkv_checked(seen) > 0.5
        flipped |= codes_moved(seen) > 0
        j_logits = np.asarray(j_logits)
        rows = slice(None) if is_prefill else slice(0, 2)
        got = t_logits.numpy()[rows]
        assert_logits_close(got, j_logits[rows],
                            gates["logits"] if flipped else LOGIT_RTOL)
        if jit:
            assert_logits_close(got, np.asarray(jit_logits)[rows],
                                LOGIT_RTOL_JIT)
        if flipped:
            assert_pools_close(tpool, jpool, gates["planes"], gates["codes"])
        else:
            assert_pools_close(tpool, jpool)
        if t_spec.attn_bias and is_prefill:
            # the bias left out: refused by the same element check
            with recorded_gemms() as bad:
                t_llama.llama_forward(
                    tparams, t_make_kv_pool(2, 9, hkv, page, d, device="cpu"),
                    None, t_batch,
                    dataclasses.replace(t_spec, attn_bias=False),
                    is_prefill=True)
            with pytest.raises(AssertionError):
                biased_qkv_checked(dict(jax=seen["jax"], torch=bad["torch"]))
    return tparams


@pytest.mark.parametrize("lm_head_bits", [8, 16])
def test_prefill_then_decode_matches_jax(lm_head_bits):
    """Logits at 1e-4 of the op-by-op JAX forward's scale (no code may
    flip) and 3e-2 of the compiled one's, pools equal
    (``check_forward``)."""
    tparams = check_forward(spec_kwargs(lm_head_bits), jit=True)
    assert isinstance(tparams["layers"]["qkv"],
                      t_llama.QuantizedWeightPerChannel)


def test_chunked_prefill_matches_jax():
    """Two prompts prefilled in [2, 32] chunks (the runner's geometry for a
    64-token budget): the 40-token prompt takes two chunks, the second
    reading the first's quantized K/V back from the pool. Held against the
    JAX chunked forward run op by op on the same chunk batches."""
    j_spec = j_llama.LlamaSpec(**spec_kwargs(8))
    t_spec = t_llama.LlamaSpec(**spec_kwargs(8))
    jparams = j_llama.make_random_packed_params(j_spec, seed=6)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(7)
    seqs = [(rng.integers(0, 128, 40).tolist(), [4, 1, 7]),
            (rng.integers(0, 128, 23).tolist(), [2, 6])]
    jpool = j_make_kv_pool(2, 9, 2, PAGE, 16, kv_bits=4, kv_zeros=True)
    tpool = t_make_kv_pool(2, 9, 2, PAGE, 16, device="cpu")
    j_final = t_final = None
    n_chunks = 0
    for t_batch, ends in chunked_prefill_batches(seqs, 64, PAGE, "cpu"):
        n_chunks += 1
        assert t_batch.token_ids.shape == (2 * 32,)
        j_batch = j_llama.PrefillBatch(
            token_ids=jnp.asarray(t_batch.token_ids.numpy(), jnp.int32),
            positions=jnp.asarray(t_batch.positions.numpy()),
            segment_ids=jnp.asarray(t_batch.segment_ids.numpy()),
            block_tables=jnp.asarray(t_batch.block_tables.numpy()),
            streaming_block_tables=jnp.zeros((2, 1), jnp.int32),
            last_token_idx=jnp.asarray(t_batch.last_token_idx.numpy(),
                                       jnp.int32),
            seq_lens=jnp.asarray(t_batch.seq_lens.numpy()),
            new_page_ids=jnp.full((8,), -1, jnp.int32),
            context_lens=jnp.asarray(t_batch.context_lens.numpy()),
        )
        with jax.disable_jit():
            j_logits, jpool, _, _ = j_llama.llama_forward(
                jparams, jpool, None, j_batch, j_spec, is_prefill=True)
        t_logits, tpool, _, _ = t_llama.llama_forward(
            tparams, tpool, None, t_batch, t_spec, is_prefill=True)
        m = ends.numpy()[:, None]
        j_logits, t_logits = np.asarray(j_logits), t_logits.numpy()
        j_final = j_logits if j_final is None else np.where(m, j_logits,
                                                            j_final)
        t_final = t_logits if t_final is None else np.where(m, t_logits,
                                                            t_final)
    assert n_chunks == 2
    assert_logits_close(t_final, j_final)
    assert_pools_close(tpool, jpool)


def test_random_packed_params_shapes():
    spec = t_llama.LlamaSpec(**spec_kwargs(8))
    params = t_llama.make_random_packed_params(spec, seed=0, device="cpu")
    jspec = j_llama.LlamaSpec(**spec_kwargs(8))
    jparams = jax.tree.map(np.asarray,
                           j_llama.make_random_packed_params(jspec, seed=0))
    for name in ("qkv", "o", "gate_up", "down"):
        for a, b in zip(params["layers"][name], jparams["layers"][name]):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
    assert params["lm_head"].dtype == torch.int8
    assert tuple(params["lm_head_scale"].shape) == (spec.vocab,)


@pytest.mark.parametrize("extra", [
    # w8a8kv8 per-tensor, w16a16kv16 under LServe's modes
    dict(weight_bits=8, kv_bits=8, kv_zeros=False, sparse_decode=True),
    dict(weight_bits=16, act_bits=16, kv_bits=16, sparse_prefill=True),
    dict(kv_bits=16, sparse_decode=True),
    dict(kv_zeros=False, sparse_prefill=True),
    dict(kv_bits=8, sparse_decode=True),
    dict(kv_bits=8, sparse_prefill=True),
    dict(attn_bias=True),
    # GQA groups the attention kernels do not take: 9 q heads a kv head,
    # and q heads that do not divide over the kv heads
    dict(num_q_heads=18),
    dict(num_q_heads=5),
])
def test_forward_raises_outside_slice(extra):
    """The precision matrix serves, kv16 and per-tensor KV included
    (``tests/test_torch_precision.py``, ``tests/test_torch_kv16_pertensor.
    py``), and so do kv8 and per-tensor KV under LServe's modes: those
    cases run a prefill and two decode steps equal to the JAX forward's
    (``tests/test_torch_lserve_llama.check_sparse_forward``: logits 1e-4
    of their scale, pools equal). The QKV bias serves too: a prefill and a
    decode step against the JAX forward's at 1e-4, the bias left out
    refused (``check_forward``). kv16 under LServe's modes serves:
    ``check_supported`` passes (the forwards against the JAX package's are
    in ``tests/test_torch_lserve_kv16.py``); a GQA group the attention
    kernels do not take (n_rep past 8, or q heads that do not divide over
    the kv heads) raises at ``check_supported`` naming the limit."""
    if extra.get("kv_bits") == 16 or "num_q_heads" in extra:
        spec = t_llama.LlamaSpec(**dict(spec_kwargs(8), **extra))
        if extra.get("kv_bits") == 16:
            spec.check_supported()
            assert spec.sparse_decode or spec.sparse_prefill
            assert spec.with_stats == spec.sparse_decode
            return
        with pytest.raises(NotImplementedError, match="1 to 8 q heads"):
            spec.check_supported()
        return
    if extra.get("attn_bias"):
        check_forward(dict(spec_kwargs(8), **extra))
        return
    from tests.test_torch_lserve_llama import PAGE as LPAGE
    from tests.test_torch_lserve_llama import check_sparse_forward

    overrides = dict(extra)
    if overrides.get("sparse_prefill"):      # a band the prompts exceed
        overrides.update(ctx_sink=LPAGE, ctx_local=2 * LPAGE)
    overrides.setdefault("sparse_decode", False)
    check_sparse_forward(overrides, n_steps=2)
