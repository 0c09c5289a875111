"""The port's evals (``omniserve_tpu_torch/eval/``) against the JAX
package's harnesses (``scripts/ppl_eval.py``, ``eval/needle/``,
``eval/LongBench/``) on the CPU.

- Perplexity: on a tiny HF checkpoint built here (the shapes of
  ``tests/test_ppl_eval.py``; 513 seeded ids, seqlen 256, page 16), the
  port's perplexity equals the jitted JAX ``window_nll``'s within 1e-3
  relative at w16a16kv16 and 1e-2 at w4a8kv4 (XLA fuses the compiled
  forward's f32 chains its own way, ROADMAP "not port faults"), and lies
  within 2% of HF fp32 at w16a16kv16, as the JAX test requires. The
  forward's ``return_hidden`` states agree with the JAX forward's op by op
  up to bf16 neighbours (under 10% of values, within 1e-2 of the scale).
- The text pieces (haystack, scoring, truncation, prompts, every LongBench
  metric) equal the JAX functions' outputs on the in-repo data, with a
  byte-level BPE tokenizer trained here on the essays.
- A NIAH ``run_test``, a LongBench ``pred`` pass and a ``sparse_agreement``
  run go through the port's CPU engine.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from omniserve_tpu_torch.eval import ppl as t_ppl

ROOT = os.path.join(os.path.dirname(__file__), "..")
PPL_CKPT = dict(hidden_size=128, intermediate_size=256,
                num_attention_heads=8, num_key_value_heads=4,
                num_hidden_layers=2, vocab_size=512,
                max_position_embeddings=2048)
SEQLEN, PAGE = 256, 16
PPL_TOL = {"w16a16kv16": 1e-3, "w4a8kv4": 1e-2}


def load_script(name, rel, extra_path=None):
    """Import one of the JAX package's scripts by path."""
    if extra_path is not None and extra_path not in sys.path:
        sys.path.insert(0, extra_path)
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ppl_ckpt(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(1)
    d = tmp_path_factory.mktemp("ppl_ckpt")
    LlamaForCausalLM(LlamaConfig(**PPL_CKPT)).save_pretrained(d)
    toks = np.random.default_rng(3).integers(1, 511, size=513)
    tok_path = d / "tokens.npy"
    np.save(tok_path, toks)
    return str(d), str(tok_path)


def jax_ppl(ckpt, tokens, precision):
    """``scripts/ppl_eval.py``'s main loop, jitted ``window_nll``."""
    import jax.numpy as jnp

    from omniserve_tpu.config import ModelConfig
    from omniserve_tpu.models.llama import LlamaSpec
    from omniserve_tpu.models.weight_loader import load_llama_params
    from omniserve_tpu.ops.paged_kv import make_kv_pool

    j = load_script("j_ppl_eval", "scripts/ppl_eval.py")
    mc = ModelConfig(model=ckpt, precision=precision)
    windows = j.token_windows(tokens, None, SEQLEN, 0)
    spec = LlamaSpec.from_model_config(mc, page_size=PAGE)
    params, _ = load_llama_params(mc, spec)
    v = params["lm_head"].shape[1]
    chunk = min(16384, v)
    if v % chunk:
        params["lm_head"] = jnp.pad(params["lm_head"],
                                    ((0, 0), (0, chunk - v % chunk)))
    pool = make_kv_pool(spec.num_layers, SEQLEN // PAGE + 1,
                        spec.num_kv_heads, PAGE, spec.head_dim,
                        kv_bits=spec.kv_bits, kv_zeros=spec.kv_zeros)
    fn = j.build_eval_fn(spec, PAGE)
    total, n = 0.0, 0
    for w in windows:
        nll, pool = fn(params, pool, jnp.asarray(np.asarray(w[:-1], np.int32)),
                       jnp.asarray(np.asarray(w[1:], np.int32)))
        total += float(nll)
        n += len(w) - 1
    return float(np.exp(total / n))


@pytest.fixture(scope="module")
def port_ppl(ppl_ckpt):
    ckpt, tokens = ppl_ckpt
    out = {}
    for precision in PPL_TOL:
        out[precision] = t_ppl.main([
            "--model", ckpt, "--precision", precision, "--text", tokens,
            "--seqlen", str(SEQLEN), "--page-size", str(PAGE),
            "--device", "cpu",
            *(["--compare-hf"] if precision == "w16a16kv16" else [])])
    return out


@pytest.mark.parametrize("precision", list(PPL_TOL))
def test_ppl_matches_jax_window_nll(ppl_ckpt, port_ppl, precision):
    want = jax_ppl(*ppl_ckpt, precision)
    got = port_ppl[precision]["ppl"]
    assert port_ppl[precision]["tokens"] == 2 * SEQLEN
    assert abs(got - want) / want < PPL_TOL[precision], (got, want)


def test_ppl_within_two_percent_of_hf(port_ppl):
    res = port_ppl["w16a16kv16"]
    assert abs(res["ppl"] - res["hf_ppl"]) / res["hf_ppl"] < 0.02, res
    # QoQ-level degradation, not garbage (random weights: ppl ~ vocab)
    q = port_ppl["w4a8kv4"]["ppl"]
    assert res["hf_ppl"] * 0.7 < q < res["hf_ppl"] * 1.5, (q, res)


def test_chunked_nll_equals_full_log_softmax():
    """The online log-sum-exp over vocab chunks against a full-logits
    log_softmax, with padded columns masked; both planted faults
    (unmasked padding, targets a position late) move it."""
    gen = torch.Generator().manual_seed(0)
    t, d, v, chunk = 40, 32, 1000, 256
    # logits of O(1), as a random model's: the padded (zero) columns
    # would then hold ~2% of the partition function
    h = (0.1 * torch.randn(t, d, generator=gen)).to(torch.bfloat16)
    lm = t_ppl.pad_lm_head(
        torch.randn(d, v, generator=gen).to(torch.bfloat16), chunk)
    assert lm.shape == (d, 1024) and not lm[:, v:].any()
    tg = torch.randint(0, v, (t,), generator=gen)
    got = t_ppl.chunked_nll(h, lm, tg, v, chunk)
    full = torch.log_softmax(h.float() @ lm[:, :v].float(), dim=-1)
    want = -full[torch.arange(t), tg]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    unmasked = t_ppl.chunked_nll(h, lm, tg, lm.shape[1], chunk)
    assert (unmasked - want).abs().min() > 1e-4
    late = t_ppl.chunked_nll(h, lm, torch.roll(tg, -1), v, chunk)
    assert (late - want).abs().max() > 1e-2


def test_return_hidden_matches_jax_forward(ppl_ckpt):
    """``llama_forward(return_hidden=True)``: the final-norm hidden states
    of every token against the JAX forward's, op by op, at w16a16kv16
    (None for the selection, as in JAX)."""
    import jax
    import jax.numpy as jnp

    from omniserve_tpu.config import ModelConfig as JModelConfig
    from omniserve_tpu.models import llama as j_llama
    from omniserve_tpu.models.weight_loader import load_llama_params as jload
    from omniserve_tpu.ops.paged_kv import make_kv_pool as j_pool

    ckpt, tokens = ppl_ckpt
    ids = np.load(tokens)[:64].astype(np.int32)
    args = t_ppl.parse_args(["--model", ckpt, "--precision", "w16a16kv16",
                             "--text", tokens, "--seqlen", "64",
                             "--page-size", str(PAGE), "--device", "cpu"])
    params, spec, pool = t_ppl.load_model(args, "cpu")
    h, _ = t_ppl.window_hidden(params, pool, spec,
                               torch.from_numpy(ids).long(), PAGE)
    mc = JModelConfig(model=ckpt, precision="w16a16kv16")
    jspec = j_llama.LlamaSpec.from_model_config(mc, page_size=PAGE)
    jparams, _ = jload(mc, jspec)
    jp = j_pool(jspec.num_layers, 64 // PAGE + 1, jspec.num_kv_heads, PAGE,
                jspec.head_dim, kv_bits=16, kv_zeros=jspec.kv_zeros)
    nb = 64 // PAGE
    batch = j_llama.PrefillBatch(
        token_ids=jnp.asarray(ids), positions=jnp.arange(64, dtype=jnp.int32),
        segment_ids=jnp.zeros((64,), jnp.int32),
        block_tables=jnp.arange(nb, dtype=jnp.int32)[None, :],
        streaming_block_tables=jnp.zeros((1, 1), jnp.int32),
        last_token_idx=jnp.asarray([63]), seq_lens=jnp.asarray([64]),
        new_page_ids=jnp.arange(nb, dtype=jnp.int32))
    with jax.disable_jit():
        jh, _, _, sel = j_llama.llama_forward(
            jparams, jp, None, batch, spec=jspec, is_prefill=True,
            return_hidden=True)
    assert sel is None and h.shape == (64, PPL_CKPT["hidden_size"])
    want = np.asarray(jh.astype(jnp.float32))
    scale = np.abs(want).max()
    diff = np.abs(h.float().numpy() - want)
    # bf16 states: XLA's and torch's f32 reductions (RMSNorm's mean, the
    # attention sums) round a few values to the neighbouring bf16, and the
    # next layer carries those (ROADMAP F5). Measured: 4.7% of the values
    # differ, by at most 5.8e-3 of the scale.
    assert (diff > 0).mean() < 0.1
    assert diff.max() <= 1e-2 * scale, (diff.max(), scale)


def test_ppl_device_rule():
    args = t_ppl.parse_args(["--model", "m", "--text", "t.npy"])
    assert args.device == "auto"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_ppl.main(["--model", "m", "--text", "t.npy"])


# -- text pieces, NIAH, LongBench and sparse agreement --------------------

ESSAYS = os.path.join(ROOT, "eval", "needle", "PaulGrahamEssays")
LB_DATA = os.path.join(ROOT, "eval", "LongBench", "data_tiny")


@pytest.fixture(scope="module")
def tokenizer(ppl_ckpt):
    """A byte-level BPE tokenizer trained on the essays (the recipe of
    ``scripts/make_tiny_model.py``), saved beside the tiny checkpoint so
    the engines load it as the model's own."""
    import glob

    from tokenizers import ByteLevelBPETokenizer
    from transformers import PreTrainedTokenizerFast

    tok = ByteLevelBPETokenizer()
    tok.train(sorted(glob.glob(os.path.join(ESSAYS, "*.txt"))),
              vocab_size=PPL_CKPT["vocab_size"], min_frequency=2,
              special_tokens=["<s>", "</s>", "<unk>"], show_progress=False)
    path = os.path.join(ppl_ckpt[0], "tokenizer.json")
    tok.save(path)
    fast = PreTrainedTokenizerFast(tokenizer_file=path, bos_token="<s>",
                                   eos_token="</s>", unk_token="<unk>")
    fast.save_pretrained(ppl_ckpt[0])
    return fast


@pytest.fixture(scope="module")
def j_needle():
    return load_script("j_needle_in_haystack",
                       "eval/needle/needle_in_haystack.py",
                       extra_path=os.path.join(ROOT, "eval", "needle"))


@pytest.fixture(scope="module")
def j_lb():
    path = os.path.join(ROOT, "eval", "LongBench")
    return (load_script("j_lb_pred", "eval/LongBench/pred.py", path),
            load_script("j_lb_metrics", "eval/LongBench/metrics.py", path),
            load_script("j_lb_eval", "eval/LongBench/eval.py", path))


def test_needle_text_equals_jax(tokenizer, j_needle):
    from omniserve_tpu_torch.eval import needle

    assert (needle.NEEDLE, needle.QUESTION, needle.FILLER_SENTENCES) == (
        j_needle.NEEDLE, j_needle.QUESTION, j_needle.FILLER_SENTENCES)
    assert needle._essay_corpus() == j_needle._essay_corpus()
    assert len(needle._essay_corpus()) > 100000
    for ctx in (300, 1024, 4000):
        for depth in (0.0, 10.0, 50.0, 100.0):
            got = needle.build_haystack(tokenizer, ctx, depth)
            assert got == j_needle.build_haystack(tokenizer, ctx, depth)
            assert needle.NEEDLE in got
    for answer in ("", needle.NEEDLE, "eat a sandwich in Dolores Park",
                   "I do not know.", "Sandwiches! Sitting; sunny days."):
        assert needle.score_answer(answer) == j_needle.score_answer(answer)
    assert needle.score_answer(needle.NEEDLE) == 10.0


def test_longbench_prompts_and_truncation_equal_jax(tokenizer, j_lb):
    from omniserve_tpu_torch.eval.longbench import pred

    j_pred = j_lb[0]
    assert pred.DATASET_PROMPTS == j_pred.DATASET_PROMPTS
    assert pred.MAX_GEN == j_pred.MAX_GEN
    text = open(os.path.join(ESSAYS, "apple.txt")).read()[:6000]
    for max_len in (50, 301, 100000):
        assert (pred.middle_truncate(tokenizer, text, max_len)
                == j_pred.middle_truncate(tokenizer, text, max_len))
    for name in ("samsum", "trec", "triviaqa"):
        with open(os.path.join(LB_DATA, f"{name}.jsonl")) as f:
            for line in f:
                s = json.loads(line)
                assert (pred.DATASET_PROMPTS[name].format(**s)
                        == j_pred.DATASET_PROMPTS[name].format(**s))


def test_longbench_metrics_equal_jax(j_lb):
    from omniserve_tpu_torch.eval.longbench import metrics

    j_metrics = j_lb[1]
    assert sorted(metrics.DATASET2METRIC) == sorted(j_metrics.DATASET2METRIC)
    cases = []
    for name in ("samsum", "trec", "triviaqa"):
        with open(os.path.join(LB_DATA, f"{name}.jsonl")) as f:
            for line in f:
                s = json.loads(line)
                for gt in s["answers"]:
                    for pred_text in (gt, gt.upper() + " extra words", "",
                                      "Paragraph 3 and 12", s["input"],
                                      "The answer: " + gt[: len(gt) // 2]):
                        cases.append((pred_text, gt, s.get("all_classes")))
    cases += [("段落1和段落2", "段落2", None), ("今天天气很好。", "天气很好", None),
              ("Paragraph 7", "Paragraph 7", None), ("4 4 5", "4", None),
              ("def f(x):\n    return x", "def f(x):", None)]
    for name, fn in metrics.DATASET2METRIC.items():
        j_fn = j_metrics.DATASET2METRIC[name]
        assert fn.__name__ == j_fn.__name__
        for pred_text, gt, classes in cases:
            assert (fn(pred_text, gt, all_classes=classes)
                    == j_fn(pred_text, gt, all_classes=classes)), (
                        name, pred_text, gt)


def test_niah_run_test_through_the_port_engine(ppl_ckpt, tokenizer):
    from omniserve_tpu_torch import EngineArgs, LLMEngine
    from omniserve_tpu_torch.eval import needle

    engine = LLMEngine.from_engine_args(EngineArgs(
        model=ppl_ckpt[0], device="cpu", max_model_len=1024,
        disable_log_stats=True))
    r = needle.run_test(engine, engine.tokenizer, 512, 50.0)
    assert sorted(r) == ["answer", "context_length", "depth_percent",
                         "score", "seconds"]
    assert (r["context_length"], r["depth_percent"]) == (512, 50.0)
    assert 0.0 <= r["score"] <= 10.0
    assert not engine.has_unfinished_requests()


def test_longbench_pred_and_eval_through_the_port_engine(ppl_ckpt,
                                                         tokenizer, j_lb,
                                                         tmp_path):
    from omniserve_tpu_torch.eval.longbench import eval as lb_eval
    from omniserve_tpu_torch.eval.longbench import pred

    pred.main(["--model", ppl_ckpt[0], "--device", "cpu", "--data-dir",
               LB_DATA, "--datasets", "trec", "triviaqa", "--limit", "1",
               "--max-model-len", "1024", "--disable-log-stats",
               "--out-dir", str(tmp_path)])
    for name in ("trec", "triviaqa"):
        rows = [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
        assert len(rows) == 1
        assert sorted(rows[0]) == ["all_classes", "answers", "length", "pred"]
    scores = lb_eval.main(["--pred-dir", str(tmp_path)])
    assert sorted(scores) == ["trec", "triviaqa"]
    for name, score in scores.items():
        want = j_lb[2].score_file(str(tmp_path / f"{name}.jsonl"))
        assert score == round(want, 2)


def jax_result_keys():
    """The keys of the JAX script's result and cell dicts, read from its
    source (``eval/needle/sparse_agreement.py`` main)."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "eval", "needle",
                                       "sparse_agreement.py")).read())
    dicts = [sorted(k.value for k in node.keys)
             for node in ast.walk(tree) if isinstance(node, ast.Dict)
             and node.keys and all(isinstance(k, ast.Constant)
                                   for k in node.keys)]
    result = next(d for d in dicts if "mean_agreement" in d)
    cell = next(d for d in dicts if "agreement" in d)
    return result, cell


def test_sparse_agreement_through_the_port_engine(ppl_ckpt, tokenizer):
    from omniserve_tpu_torch.eval import sparse_agreement as sa
    from omniserve_tpu_torch.eval.needle import QUESTION, build_haystack

    args = sa.parse_args(["--model", ppl_ckpt[0], "--contexts", "600",
                          "--depths", "50", "--gen-len", "6",
                          "--sparse-kv-cache-budget", "256",
                          "--selector-update-interval", "2"])
    ids = tokenizer.encode(build_haystack(tokenizer, 600, 50)
                           + "\n\n" + QUESTION + "\nAnswer:")[:600]
    prompts = {(600, 50.0): ids}
    dense = sa.run_mode(args, False, prompts, device="cpu")
    again = sa.run_mode(args, False, prompts, device="cpu")
    sparse = sa.run_mode(args, True, prompts, device="cpu")
    control = sa.agreement_result(args, dense, again)
    assert control["mean_agreement"] == 1.0
    result = sa.agreement_result(args, dense, sparse)
    want_result, want_cell = jax_result_keys()
    assert sorted(result) == want_result
    assert sorted(result["cells"][0]) == want_cell
    assert len(result["cells"][0]["sparse_tokens"]) == 6
    assert 0.0 <= result["mean_agreement"] <= 1.0
