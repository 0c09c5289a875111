"""The port's QoQ checkpoint tools against the JAX package's (CPU).

``omniserve_tpu_torch.ckpt_converter`` against
``scripts/ckpt_converter/{convert,make_fake_quant_dump}.py`` (mirroring
``tests/test_ckpt_converter.py``):

- the converter on ``tests/test_ckpt_converter``'s synthetic
  DeepCompressor dumps (per channel, g32, w8; per-tensor KV calibration):
  ``packed.npz`` equal array by array, ``omniserve_tpu.json`` and the
  copied json files equal, ``kv_pt_scales`` = max / 127;
- ``load_packed_params`` on that output: every tensor equal to the JAX
  loader's, the KV scales too, through ``load_llama_params`` as well; a
  checkpoint served at another weight format is refused;
- the fake-quant dump of an HF checkpoint: ``model.pt``, ``scale.pt`` and
  ``acts.pt`` equal;
- HF checkpoint -> the port's dump -> its converter (as a module, from the
  command line) -> both engines on the packed checkpoint
  (``load_format="auto"``): greedy tokens equal while every top-2 margin
  exceeds 2e-3, and the first tokens those of the HF checkpoint served
  directly (``tests/test_golden_hf.py::test_converter_end_to_end_serves``).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from omniserve_tpu import EngineArgs as JEngineArgs
from omniserve_tpu import LLMEngine as JLLMEngine
from omniserve_tpu import SamplingParams as JSamplingParams
from omniserve_tpu.models import llama as j_llama
from omniserve_tpu.models import weight_loader as j_wl
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.ckpt_converter import convert as t_convert
from omniserve_tpu_torch.ckpt_converter import make_fake_quant_dump as t_dump
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models import weight_loader as t_wl
from tests.test_ckpt_converter import HD, HEADS, KV_HEADS, D, I, L, _make_dump
from tests.test_torch_precision_engine import TrustedPrefix, serve
from tests.test_torch_weight_loader import assert_trees_equal, hf_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts", "ckpt_converter"))
import convert as j_convert  # noqa: E402
import make_fake_quant_dump as j_dump  # noqa: E402


def both_converted(tmp_path, w_bit, group_size, kv_per_tensor=True):
    """(JAX converter's directory, the port's) on one synthetic dump."""
    model_dir, quant_dir, _ = _make_dump(tmp_path, group_size)
    with jax.disable_jit():
        want = j_convert.convert(model_dir, quant_dir, w_bit, group_size,
                                 kv_per_tensor, str(tmp_path / "jax"))
    got = t_convert.convert(model_dir, quant_dir, w_bit, group_size,
                            kv_per_tensor, str(tmp_path / "torch"),
                            device="cpu")
    return want, got


@pytest.mark.parametrize("w_bit,group_size", [(4, -1), (4, 32), (8, -1)])
def test_convert_matches_jax(tmp_path, w_bit, group_size):
    """The same files: packed.npz array by array (dtype, shape, bytes),
    omniserve_tpu.json and the copied config.json; the per-tensor KV
    scales are the dump's calibrated max / 127."""
    want, got = both_converted(tmp_path, w_bit, group_size)
    assert os.path.basename(got) == os.path.basename(want)
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    zg = np.load(os.path.join(got, "packed.npz"))
    zw = np.load(os.path.join(want, "packed.npz"))
    assert sorted(zg.files) == sorted(zw.files)
    for k in zw.files:
        assert zg[k].dtype == zw[k].dtype and zg[k].shape == zw[k].shape, k
        np.testing.assert_array_equal(zg[k], zw[k], err_msg=k)
    for f in ("omniserve_tpu.json", "config.json"):
        assert (json.load(open(os.path.join(got, f)))
                == json.load(open(os.path.join(want, f))))
    meta = json.load(open(os.path.join(got, "omniserve_tpu.json")))
    assert meta == {"format": "omniserve_tpu_packed_v1", "weight_bits": w_bit,
                    "group_size": group_size, "kv_per_tensor": True}
    np.testing.assert_allclose(zg["kv_pt_scales"],
                               [[(5.0 + i) / 127.0, (3.0 + i) / 127.0]
                                for i in range(L)], rtol=1e-6)


def packed_spec(pkg, w_bit, group_size, lm_head_bits):
    cls = j_llama.LlamaSpec if pkg == "jax" else t_llama.LlamaSpec
    return cls(num_layers=L, hidden=D, intermediate=I, num_q_heads=HEADS,
               num_kv_heads=KV_HEADS, head_dim=HD, vocab=256,
               weight_bits=w_bit, act_bits=8, kv_bits=8, kv_zeros=False,
               group_size=group_size, lm_head_bits=lm_head_bits)


@pytest.mark.parametrize("w_bit,group_size,lm_head_bits",
                         [(4, -1, 8), (4, 32, 16), (8, -1, 8)])
def test_load_packed_params_matches_jax(tmp_path, w_bit, group_size,
                                        lm_head_bits):
    """The packed checkpoint's tree (layers, norms, embedding, lm_head and
    its w8 form) and per-tensor KV scales, equal to the JAX loader's;
    ``load_llama_params`` finds the packed.npz and gives the same."""
    _, dest = both_converted(tmp_path, w_bit, group_size)
    flags = np.array([[True, False]] * L)
    tp, tkv = t_wl.load_packed_params(
        dest, packed_spec("torch", w_bit, group_size, lm_head_bits),
        retrieval_flags=flags, device="cpu")
    with jax.disable_jit():
        jp, jkv = j_wl.load_packed_params(
            dest, packed_spec("jax", w_bit, group_size, lm_head_bits),
            retrieval_flags=flags)
    assert_trees_equal(tp, jax.tree.map(np.asarray, jp))
    for g, w in zip(tkv, jkv):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    class Config:
        model, quant_path, kv_zeros = "unused", dest, False

    tp2, tkv2 = t_wl.load_llama_params(
        Config, packed_spec("torch", w_bit, group_size, lm_head_bits),
        retrieval_flags=flags, device="cpu")
    assert_trees_equal(tp2, tp)
    assert all(torch.equal(a, b) for a, b in zip(tkv2, tkv))


def test_packed_at_another_format_is_refused(tmp_path):
    """A per-channel W4 checkpoint served as g32 (or W8) raises, naming
    both formats, instead of building mismatched containers."""
    _, dest = both_converted(tmp_path, 4, -1)
    for w_bit, group_size in ((4, 32), (8, -1)):
        with pytest.raises(ValueError, match="packed at w4 group size -1"):
            t_wl.load_packed_params(
                dest, packed_spec("torch", w_bit, group_size, 16),
                device="cpu")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_llama")
    hf_model(tie_word_embeddings=False, num_hidden_layers=2).save_pretrained(
        d)
    return str(d)


def load_pt(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def assert_nested_equal(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_nested_equal(got[k], want[k], f"{where}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got, want), where


@pytest.mark.parametrize("group_size", [-1, 32])
def test_fake_quant_dump_matches_jax(hf_dir, tmp_path, monkeypatch,
                                     group_size):
    """model.pt, scale.pt and acts.pt of the port's dump tool equal the
    JAX script's on the same HF checkpoint, and so do the two converters'
    packed.npz of them. (The dump's g32 s1 = amax / (127 x 7) leaves
    -zero x s2 past int8: both converters saturate it, as XLA's cast
    does.)"""
    t_dump.make_dump(hf_dir, str(tmp_path / "torch"), group_size, True)
    monkeypatch.setattr(sys, "argv", [
        "make_fake_quant_dump.py", "--model", hf_dir, "--output",
        str(tmp_path / "jax"), "--group-size", str(group_size),
        "--kv-per-tensor"])
    j_dump.main()
    for f in ("model.pt", "scale.pt", "acts.pt"):
        assert_nested_equal(load_pt(tmp_path / "torch" / f),
                            load_pt(tmp_path / "jax" / f), f)
    with jax.disable_jit():
        want = j_convert.convert(hf_dir, str(tmp_path / "jax"), 4,
                                 group_size, True, str(tmp_path / "jout"))
    got = t_convert.convert(hf_dir, str(tmp_path / "torch"), 4, group_size,
                            True, str(tmp_path / "tout"), device="cpu")
    zg = np.load(os.path.join(got, "packed.npz"))
    zw = np.load(os.path.join(want, "packed.npz"))
    assert sorted(zg.files) == sorted(zw.files)
    for k in zw.files:
        np.testing.assert_array_equal(zg[k], zw[k], err_msg=k)
    if group_size != -1:
        assert (zg["qkv.s2_zeros"] == -128).any()   # the saturated casts


REQUESTS = [("r0", list(range(3, 30)), 6), ("r1", [7, 1, 9, 4, 300], 6)]


def test_dump_convert_serve_end_to_end(hf_dir, tmp_path, monkeypatch):
    """HF checkpoint -> the port's dump -> its converter, run as
    ``python -m omniserve_tpu_torch.ckpt_converter.convert`` -> both
    engines on the packed checkpoint: greedy tokens equal while every
    top-2 margin exceeds 2e-3, and the port's first two tokens those of
    the HF checkpoint served directly at w4a8kv4 (the same QoQ grid)."""
    dump, out = tmp_path / "dump", tmp_path / "packed"
    t_dump.make_dump(hf_dir, str(dump))
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "omniserve_tpu_torch.ckpt_converter.convert",
         "--model-path", hf_dir, "--quant-path", str(dump), "--w-bit", "4",
         "--group-size", "-1", "--output-path", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-1500:]
    (packed,) = list(out.iterdir())
    kw = dict(precision="w4a8kv4", load_format="auto",
              tokenizer_mode="skip", block_size=16, max_num_seqs=4,
              max_num_batched_tokens=4096, num_retrieval_blocks=64)
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(JEngineArgs(model=str(packed),
                                                       **kw))
        want = serve(jeng, JSamplingParams, REQUESTS)
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu",
                                                 model=str(packed), **kw))
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = serve(teng, SamplingParams, REQUESTS, groups)
    assert trusted.compare(got, want) >= len(REQUESTS)
    monkeypatch.undo()
    direct = LLMEngine.from_engine_args(EngineArgs(device="cpu",
                                                   model=hf_dir, **kw))
    got_hf = serve(direct, SamplingParams, REQUESTS)
    for rid in got:
        assert got[rid][:2] == got_hf[rid][:2], rid
