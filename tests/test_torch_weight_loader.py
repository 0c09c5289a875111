"""The port's weight loader against the JAX package's (CPU).

``omniserve_tpu_torch.models.weight_loader`` reads HF checkpoints without
the ``safetensors`` package; these tests hold it against that package and
against ``omniserve_tpu.models.weight_loader`` on checkpoints built here
with ``transformers`` (nothing is downloaded):

- the safetensors reader against ``safetensors.safe_open`` on F32 and F16
  files written by ``save_pretrained`` and a BF16 file written by
  ``safetensors.torch``, and on the files of ``chip_smoke.py``'s writer
  (so a writer and a reader that agree only with each other cannot pass);
- ``_iter_hf_weights`` on sharded safetensors and on ``.bin`` files;
- ``quantize_layer_weights`` and the rank-major fusions, against the JAX
  functions run op by op: integer and float fields equal. Compiled, the
  JAX quantizer divides by a constant as a multiply by its reciprocal:
  scales one ulp away, codes equal wherever the scales are;
- ``load_llama_params`` against the JAX loader (op by op) on a tiny Llama
  (tied and untied) and a tiny Qwen2 (QKV bias) in each body: W4A8 per
  channel, W4A8 g128, W8A8, W16A16, with w8 and bf16 lm_heads, per-tensor
  KV scales; a bf16 checkpoint, also against its F32 twin; a missing
  tensor refused by name;
- both engines through ``load_format="auto"``: greedy tokens equal while
  every top-2 margin exceeds 2e-3.

The port's fp16 logits and tokens against HF's torch model are in
``tests/test_torch_golden_hf.py``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

import chip_smoke
from omniserve_tpu import EngineArgs as JEngineArgs
from omniserve_tpu import LLMEngine as JLLMEngine
from omniserve_tpu import SamplingParams as JSamplingParams
from omniserve_tpu.config import ModelConfig as JModelConfig
from omniserve_tpu.models import llama as j_llama
from omniserve_tpu.models import weight_loader as j_wl
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.config import ModelConfig as TModelConfig
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models import weight_loader as t_wl
from tests.test_torch_precision_engine import TrustedPrefix, serve

SMALL = dict(hidden_size=128, intermediate_size=256, num_attention_heads=8,
             num_key_value_heads=4, num_hidden_layers=2, vocab_size=512,
             max_position_embeddings=2048, rope_theta=10000.0,
             rms_norm_eps=1e-5)


def hf_model(kind="llama", seed=0, **extra):
    from transformers import (
        LlamaConfig,
        LlamaForCausalLM,
        Qwen2Config,
        Qwen2ForCausalLM,
    )

    torch.manual_seed(seed)
    if kind == "qwen2":
        cfg = Qwen2Config(**dict(SMALL, tie_word_embeddings=False,
                                 use_sliding_window=False, **extra))
        return Qwen2ForCausalLM(cfg).eval()
    return LlamaForCausalLM(LlamaConfig(**dict(SMALL, **extra))).eval()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Model directories: "llama" (tied), "llama_untied", "qwen2"."""
    out = {}
    for name, kind, extra in (("llama", "llama",
                               dict(tie_word_embeddings=True)),
                              ("llama_untied", "llama",
                               dict(tie_word_embeddings=False)),
                              ("qwen2", "qwen2", {})):
        d = tmp_path_factory.mktemp(name)
        hf_model(kind, **extra).save_pretrained(d)
        out[name] = str(d)
    return out


def leaves(tree, path=""):
    """(path, numpy array) of every leaf of a parameter tree of either
    package (bf16 as f32: exact)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif hasattr(tree, "_asdict"):
        for k, v in tree._asdict().items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(tree, torch.Tensor):
        yield path, (tree.float() if tree.dtype == torch.bfloat16
                     else tree).numpy()
    else:
        a = np.asarray(tree)
        yield path, a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_trees_equal(got, want):
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def st_tensors(path, framework="pt"):
    with safe_open(path, framework=framework) as f:
        return {k: f.get_tensor(k) for k in f.keys()}


def assert_tensors_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape), k
        assert torch.equal(g, w), k


# -- the safetensors reader ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_reader_matches_safe_open(tmp_path, dtype):
    """Names, dtypes, shapes and values of every tensor, against the
    ``safetensors`` package; F32 / F16 from ``save_pretrained`` (also
    against its numpy reader), BF16 from ``safetensors.torch`` (with a 0-d
    and an odd-sized tensor, so the header pads)."""
    model = hf_model(tie_word_embeddings=False)
    if dtype == "BF16":
        sd = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
        sd["scalar"] = torch.tensor(0.5, dtype=torch.bfloat16)
        sd["odd"] = torch.arange(7, dtype=torch.bfloat16)
        path = str(tmp_path / "model.safetensors")
        save_file(sd, path, metadata={"format": "pt"})
    else:
        (model.half() if dtype == "F16" else model).save_pretrained(tmp_path)
        path = str(tmp_path / "model.safetensors")
        want_np = st_tensors(path, "np")
        got_np = {k: v.numpy() for k, v in t_wl._read_safetensors(path)}
        assert sorted(got_np) == sorted(want_np)
        for k in want_np:
            np.testing.assert_array_equal(got_np[k], want_np[k])
            assert got_np[k].dtype == want_np[k].dtype
    assert_tensors_equal(dict(t_wl._read_safetensors(path)),
                         st_tensors(path))


def test_chip_smoke_writer_files_read_by_safe_open(tmp_path):
    """``chip_smoke.write_hf_checkpoint``'s two shards and index, read by
    ``safetensors.safe_open``: the same tensors (bf16, f16, f32, 0-d and
    odd sizes); and the port's reader agrees."""
    gen = torch.Generator().manual_seed(0)
    want = {
        "a.bf16": torch.randn((5, 3), generator=gen).to(torch.bfloat16),
        "b.f16": torch.randn((4,), generator=gen).half(),
        "c.f32": torch.randn((2, 3, 3), generator=gen),
        "d.scalar": torch.tensor(2.5),
        "e.bf16": torch.randn((7,), generator=gen).to(torch.bfloat16),
    }
    cfg = {"num_hidden_layers": 1}
    chip_smoke.write_hf_checkpoint(str(tmp_path), cfg, want, n_shards=2)
    index = json.load(open(tmp_path / "model.safetensors.index.json"))
    files = sorted(set(index["weight_map"].values()))
    assert files == ["model-00001-of-00002.safetensors",
                     "model-00002-of-00002.safetensors"]
    got = {}
    for f in files:
        part = st_tensors(str(tmp_path / f))
        assert all(index["weight_map"][k] == f for k in part)
        got.update(part)
    assert_tensors_equal(got, want)
    assert index["metadata"]["total_size"] == sum(
        t.numel() * t.element_size() for t in want.values())
    assert json.load(open(tmp_path / "config.json")) == cfg
    assert_tensors_equal(dict(t_wl._iter_hf_weights(str(tmp_path))), want)


def test_iter_hf_weights_sharded_and_bin(tmp_path):
    """Every shard of a sharded safetensors checkpoint, and torch ``.bin``
    files, give the model's state dict, the same names as the JAX
    package's ``_iter_hf_weights``."""
    model = hf_model(tie_word_embeddings=False)
    want = model.state_dict()
    for sub, kw in (("st", dict(max_shard_size="200KB")),
                    ("bin", dict(safe_serialization=False))):
        d = tmp_path / sub
        model.save_pretrained(d, **kw)
        if sub == "st":
            assert len(list(d.glob("*.safetensors"))) > 2
        got = dict(t_wl._iter_hf_weights(str(d)))
        assert_tensors_equal(got, want)
        j_names = [n for n, _ in j_wl._iter_hf_weights(str(d))]
        assert sorted(j_names) == sorted(got)
    with pytest.raises(FileNotFoundError):
        list(t_wl._iter_hf_weights(str(tmp_path / "st" / "..")))


# -- quantize_layer_weights and the fusions -----------------------------------


BODIES = {   # name: (weight bits, act bits, group size)
    "w4a8": (4, 8, -1), "w4a8-g128": (4, 8, 128), "w8a8": (8, 8, -1),
    "w16a16": (16, 16, -1),
}


def spec_pair(body, **extra):
    w, a, g = BODIES[body]
    kw = dict(num_layers=2, hidden=128, intermediate=256, num_q_heads=8,
              num_kv_heads=4, head_dim=16, vocab=512, weight_bits=w,
              act_bits=a, group_size=g, **extra)
    return j_llama.LlamaSpec(**kw), t_llama.LlamaSpec(**kw)


def fp_layers(rng, tp_size=1):
    """fp32 [L, N, K] stacks of a 2-layer model (hidden 128, 8 / 4 heads of
    16, intermediate 256 x ``tp_size``), fused rank-major by both
    packages (equal), plus norm weights."""
    L, D, I = 2, 128, 256 * tp_size

    def w(*shape):
        return (rng.standard_normal((L,) + shape) * 0.05).astype(np.float32)

    q, k, v = w(128 * tp_size, D), w(64 * tp_size, D), w(64 * tp_size, D)
    gate, up = w(I, D), w(I, D)
    qkv = t_llama.fuse_qkv_rank_major(q, k, v, tp_size)
    gate_up = t_llama.fuse_gate_up_rank_major(gate, up, tp_size)
    np.testing.assert_array_equal(
        qkv, j_llama.fuse_qkv_rank_major(q, k, v, tp_size))
    np.testing.assert_array_equal(
        gate_up, j_llama.fuse_gate_up_rank_major(gate, up, tp_size))
    return {"attn_ln": w(D)[:, 0] + 1, "mlp_ln": np.ones((L, D), np.float32),
            "qkv": qkv, "o": w(D, 128 * tp_size), "gate_up": gate_up,
            "down": w(D, I)}


@pytest.mark.parametrize("tp_size", [1, 2])
@pytest.mark.parametrize("body", list(BODIES))
def test_quantize_layer_weights_matches_jax(body, tp_size):
    """Every field equal to the JAX function run op by op (tp 2: the row-
    parallel layers packed per shard, the fusions rank-major)."""
    j_spec, t_spec = spec_pair(body)
    fp = fp_layers(np.random.default_rng(tp_size), tp_size)
    got = t_llama.quantize_layer_weights(fp, t_spec, tp_size, device="cpu")
    with jax.disable_jit():
        want = j_llama.quantize_layer_weights(fp, j_spec, tp_size)
    assert_trees_equal(got, jax.tree.map(np.asarray, want))


def ulps_apart(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("body", ["w4a8", "w4a8-g128", "w8a8"])
def test_compiled_jax_quantizer_rounds_scales_one_ulp(body):
    """The JAX loader runs the quantizer under ``jax.jit``, where XLA turns
    ``x / 15.0`` (``/ 119.0``, ``/ 127.0``) into ``x * (1 / c)``: some
    scales land one ulp from IEEE division, which the port keeps (the JAX
    quantizer's op-by-op contract, the card's kernels). Per-channel scales
    within one ulp; g128's integer s2 = ceil(range / 15) then moves by one
    where the range is a multiple of 15. Every code whose scales agree is
    equal."""
    j_spec, t_spec = spec_pair(body)
    fp = fp_layers(np.random.default_rng(3))
    got = t_llama.quantize_layer_weights(fp, t_spec, device="cpu")
    want = jax.tree.map(np.asarray, j_llama.quantize_layer_weights(
        fp, j_spec))
    moved = 0
    for name in ("qkv", "o", "gate_up", "down"):
        g = {k: v.numpy() for k, v in got[name]._asdict().items()}
        w = want[name]._asdict()
        s = "scales" if body == "w8a8" else "s1_scales"
        apart = ulps_apart(g[s], w[s])
        assert apart.max() <= 1, name
        moved += int((apart > 0).sum())
        same = np.broadcast_to((apart == 0)[:, None, :],
                               g["qweight"].shape).copy()   # [L, rows, N]
        if body == "w4a8-g128":
            s2_same = ((g["s2_scales"] == w["s2_scales"])
                       & (apart == 0)[:, None, :])          # [L, groups, N]
            assert np.abs(g["s2_scales"].astype(int)
                          - w["s2_scales"].astype(int)).max() <= 1
            np.testing.assert_array_equal(g["s2_zeros"][s2_same],
                                          w["s2_zeros"][s2_same])
            k2 = g["qweight"].shape[1]          # row r packs k = r, r + k2
            rows = np.arange(k2)
            same &= (s2_same[:, rows // 128] & s2_same[:, (rows + k2) // 128])
        np.testing.assert_array_equal(g["qweight"][same], w["qweight"][same],
                                      err_msg=name)
        assert same.mean() > 0.1
        if "s1_szeros" in g:      # zero x scale: follows the scale
            np.testing.assert_allclose(g["s1_szeros"], w["s1_szeros"],
                                       rtol=2 ** -22, atol=0)
    assert moved > 0    # the case this test exists for


# -- load_llama_params --------------------------------------------------------


PRECISIONS = {   # name: (precision, group size, lm_head precision)
    "w4a8kv4": ("w4a8kv4", -1, "w8a8"),
    "w4a8kv4-g128": ("w4a8kv4", 128, "fp16"),
    "w8a8kv8": ("w8a8kv8", -1, "w8a8"),
    "w16a16kv16": ("w16a16kv16", -1, "fp16"),
}


def load_both(path, precision, **extra):
    """(port params, port kv_scales, JAX params, JAX kv_scales) of the
    model at ``path``; the JAX loader op by op."""
    prec, group, head = PRECISIONS[precision]
    kw = dict(model=path, precision=prec, group_size=group,
              lm_head_precision=head, **extra)
    jmc, tmc = JModelConfig(**kw), TModelConfig(**kw)
    j_spec = j_llama.LlamaSpec.from_model_config(jmc, page_size=16)
    t_spec = t_llama.LlamaSpec.from_model_config(tmc, page_size=16)
    with jax.disable_jit():
        jp, jkv = j_wl.load_llama_params(jmc, j_spec)
    tp, tkv = t_wl.load_llama_params(tmc, t_spec, device="cpu")
    return tp, tkv, jax.tree.map(np.asarray, jp), jkv


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("model", ["llama", "llama_untied", "qwen2"])
def test_load_llama_params_matches_jax(checkpoints, model, precision):
    """Every tensor of the tree equal to the JAX loader's (op by op): the
    fused and quantized layers, norms, the QKV bias (Qwen2), the embedding,
    the lm_head (tied: the embedding's transpose) and its w8 form."""
    tp, tkv, jp, jkv = load_both(checkpoints[model], precision)
    assert tkv is None and jkv is None
    assert ("qkv_bias" in tp["layers"]) == (model == "qwen2")
    assert_trees_equal(tp, jp)


@pytest.fixture(scope="module")
def kv_scaled_checkpoint(tmp_path_factory):
    """A tiny Llama whose layers carry per-tensor KV scales (``kv_scale``
    [2] per layer: K, V) beside the weights."""
    d = tmp_path_factory.mktemp("kv_scaled")
    model = hf_model(tie_word_embeddings=True)
    model.save_pretrained(d)
    save_file({f"model.layers.{i}.self_attn.kv_scale":
               torch.tensor([0.03 + i / 100, 0.05 + i / 100])
               for i in range(SMALL["num_hidden_layers"])},
              str(d / "zz_kv_scales.safetensors"))
    return str(d)


def test_load_llama_params_kv_scales_match_jax(kv_scaled_checkpoint):
    """Per-tensor pools get the checkpoint's K / V scales, as from the JAX
    loader; fine-grained pools none."""
    tp, tkv, jp, jkv = load_both(kv_scaled_checkpoint, "w8a8kv8",
                                 kv_quant_granularity="per_tensor")
    assert_trees_equal(tp, jp)
    for g, w in zip(tkv, jkv):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(tkv[0].numpy(), [0.03, 0.04], rtol=1e-6)
    _, tkv, _, jkv = load_both(kv_scaled_checkpoint, "w4a8kv4")
    assert tkv is None and jkv is None


def test_bf16_checkpoint_matches_jax_and_its_f32_twin(tmp_path):
    """A bf16 safetensors checkpoint (most public ones) loads to the tree
    the JAX loader builds from it and from the same weights saved as F32
    (bf16 -> f32 is exact). The JAX loader reads bf16 through
    ``safetensors``' numpy reader, which knows the dtype only once
    ``ml_dtypes`` is imported (``jax`` imports it)."""
    model = hf_model(tie_word_embeddings=True).to(torch.bfloat16)
    model.save_pretrained(tmp_path / "bf16")
    model.float().save_pretrained(tmp_path / "f32")
    with safe_open(str(tmp_path / "bf16" / "model.safetensors"),
                   "pt") as f:
        assert f.get_tensor(f.keys()[0]).dtype == torch.bfloat16
    for precision in ("w4a8kv4", "w16a16kv16"):
        tp, _, jp, _ = load_both(str(tmp_path / "bf16"), precision)
        assert_trees_equal(tp, jp)
        _, _, jp32, _ = load_both(str(tmp_path / "f32"), precision)
        assert_trees_equal(tp, jp32)


def test_missing_tensor_raises_naming_it(tmp_path):
    """A checkpoint that lacks a tensor the model needs is refused, naming
    it (the JAX loader: ``assert embed is not None``)."""
    model = hf_model(tie_word_embeddings=True)
    sd = {k: v.contiguous() for k, v in model.state_dict().items()
          if k not in ("lm_head.weight",
                       "model.layers.1.self_attn.k_proj.weight")}
    save_file(sd, str(tmp_path / "model.safetensors"))
    model.config.to_json_file(str(tmp_path / "config.json"))
    mc = TModelConfig(model=str(tmp_path), precision="w4a8kv4")
    spec = t_llama.LlamaSpec.from_model_config(mc, page_size=16)
    with pytest.raises(ValueError,
                       match="model.layers.1.k_proj.weight"):
        t_wl.load_llama_params(mc, spec, device="cpu")
    del sd["model.embed_tokens.weight"]
    save_file(sd, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="model.embed_tokens.weight"):
        t_wl.load_llama_params(mc, spec, device="cpu")


# -- the engines --------------------------------------------------------------


REQUESTS = [("r0", list(range(3, 40)), 6), ("r1", [7, 1, 9, 4, 300], 6),
            ("r2", list(range(40, 140, 3)), 6)]


@pytest.mark.parametrize("model,precision", [("llama", "w4a8kv4"),
                                             ("qwen2", "w8a8kv8")])
def test_engines_serve_checkpoint_alike(checkpoints, monkeypatch, model,
                                        precision):
    """Both engines on the same HF checkpoint through ``load_format=
    "auto"`` (JAX op by op): greedy tokens equal while every top-2 margin
    of the port exceeds 2e-3 of max |logit|; the port's weights equal the
    JAX engine's."""
    prec, group, head = PRECISIONS[precision]
    kw = dict(model=checkpoints[model], precision=prec, group_size=group,
              lm_head_precision=head, load_format="auto",
              tokenizer_mode="skip", block_size=16, max_num_seqs=4,
              max_num_batched_tokens=4096, num_retrieval_blocks=64, seed=0)
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
        want = serve(jeng, JSamplingParams, REQUESTS)
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    assert_trees_equal(teng.worker.model_runner.params,
                       jax.tree.map(np.asarray,
                                    jeng.worker.model_runner.params))
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = serve(teng, SamplingParams, REQUESTS, groups)
    assert [len(t) for t in got.values()] == [6, 6, 6]
    assert trusted.compare(got, want) >= len(REQUESTS)


def test_engine_build_checks_support_before_loading(checkpoints, tmp_path,
                                                    monkeypatch):
    """``check_supported`` runs before a weight is read: a model the device
    cannot serve (here 6 q heads over 4 kv heads) fails at once."""
    cfg = json.load(open(os.path.join(checkpoints["llama"], "config.json")))
    cfg.update(num_attention_heads=6, num_key_value_heads=4, head_dim=16)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg, f)

    def never(*a, **k):
        raise AssertionError("weights read before the support check")

    monkeypatch.setattr(t_wl, "_iter_hf_weights", never)
    with pytest.raises(NotImplementedError, match="GQA groups"):
        LLMEngine.from_engine_args(EngineArgs(
            device="cpu", model=str(tmp_path), precision="w4a8kv4",
            load_format="auto", tokenizer_mode="skip", block_size=16))
