"""HF checkpoint or packed.npz -> the port's quantized parameter tree.

PyTorch counterpart of ``omniserve_tpu.models.weight_loader``:

- HF checkpoints (safetensors, sharded or not, or torch ``.bin`` / ``.pt``
  files): q / k / v fuse into qkv and gate / up into gate_up, each
  projection quantizes per the model's precision one layer at a time on
  the runner's device, the embeddings tie when no ``lm_head`` is stored,
  and per-tensor KV scales (``kv_scale`` entries) come back beside the
  parameters;
- QoQ-calibrated ``packed.npz`` checkpoints (written by
  ``omniserve_tpu_torch.ckpt_converter.convert``): already packed, loaded
  as they are.

Safetensors files are read by ``_read_safetensors`` (no ``safetensors``
package): an 8-byte little-endian header length, a JSON header of
``dtype`` / ``shape`` / ``data_offsets`` (relative to the first byte after
the header) plus ``__metadata__``, then the raw bytes, memory mapped. F32,
F16 and BF16 tensors decode straight into torch.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from omniserve_tpu_torch.models.llama import (
    LlamaSpec,
    _quantize_lm_head,
    fuse_gate_up_rank_major,
    fuse_qkv_rank_major,
    make_attn_meta,
    quantize_layer_weights,
)
from omniserve_tpu_torch.ops.quantization import (
    QuantizedWeightPerChannel,
    QuantizedWeightPerGroup,
    QuantizedWeightW8,
)
from omniserve_tpu_torch.utils.logger import init_logger

logger = init_logger(__name__)

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) of one safetensors file in header order.

    The file is mapped copy-on-write, so the tensors view the page cache
    without a copy until written (and ``torch.frombuffer`` gets the
    writable buffer it wants)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(
                f"{path}: tensor {name} has dtype {info['dtype']}, which "
                "the loader does not read")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape))
        if end - start != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name} spans {end - start} "
                             f"bytes, not {count} x {info['dtype']}")
        if count == 0:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, count=count,
                             offset=base + start)
        yield name, t.reshape(shape)


def _iter_hf_weights(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) from the safetensors files of ``path`` in
    sorted order (every shard of a sharded checkpoint), else from its
    torch ``.bin`` / ``.pt`` files."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        for f in st_files:
            yield from _read_safetensors(f)
        return
    bin_files = sorted(glob.glob(os.path.join(path, "*.bin"))) + sorted(
        glob.glob(os.path.join(path, "*.pt"))
    )
    if not bin_files:
        raise FileNotFoundError(f"no weight files under {path}")
    for f in bin_files:
        sd = torch.load(f, map_location="cpu", weights_only=True)
        yield from sd.items()


def _resolve_path(model: str) -> str:
    """A local directory as it is; anything else is a hub name, fetched
    (lazily imported, as in the JAX package) by ``huggingface_hub``."""
    if os.path.isdir(model):
        return model
    from huggingface_hub import snapshot_download

    return snapshot_download(
        model, allow_patterns=["*.safetensors", "*.bin", "*.json", "*.model"]
    )


_QUANT_FIELDS = ("qweight", "s1_scales", "s1_szeros", "s2_scales",
                 "s2_zeros", "scales")


def _lm_head(params: Dict[str, Any], spec: LlamaSpec) -> None:
    if spec.lm_head_bits == 8:
        params["lm_head"], params["lm_head_scale"] = _quantize_lm_head(
            params["lm_head"])


def load_packed_params(
    path: str,
    spec: LlamaSpec,
    retrieval_flags: Optional[np.ndarray] = None,
    head_rank: Optional[np.ndarray] = None,
    device="cuda:0",
) -> Tuple[Dict[str, Any], Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Load a ``packed.npz`` checkpoint (with its ``omniserve_tpu.json``)
    onto ``device``: the arrays are already packed, nothing is quantized
    again but a w8 lm_head. Returns (params, (k [L], v [L]) per-tensor KV
    scales or None)."""
    with open(os.path.join(path, "omniserve_tpu.json")) as f:
        meta = json.load(f)
    if (meta["weight_bits"], meta["group_size"]) != (spec.weight_bits,
                                                     spec.group_size):
        raise ValueError(
            f"{path} is packed at w{meta['weight_bits']} group size "
            f"{meta['group_size']}, the engine serves w{spec.weight_bits} "
            f"group size {spec.group_size}: pass the checkpoint's "
            "--precision / --group-size")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with np.load(os.path.join(path, "packed.npz")) as z:
        layers: Dict[str, Any] = {"attn_ln": dev(z["attn_ln"]),
                                  "mlp_ln": dev(z["mlp_ln"])}
        for name in ("qkv", "o", "gate_up", "down"):
            fields = {f: dev(z[f"{name}.{f}"])
                      for f in _QUANT_FIELDS if f"{name}.{f}" in z}
            if meta["weight_bits"] == 8:
                layers[name] = QuantizedWeightW8(**fields)
            elif meta["group_size"] == -1:
                layers[name] = QuantizedWeightPerChannel(**fields)
            else:
                layers[name] = QuantizedWeightPerGroup(**fields)
        if "qkv_bias" in z:
            layers["qkv_bias"] = dev(z["qkv_bias"].astype(np.float32))
        embed = dev(z["embed"])
        lm_head = dev(z["lm_head"]) if "lm_head" in z else embed
        params = {
            "embed": embed.to(torch.bfloat16),
            "final_ln": dev(z["final_ln"]),
            "lm_head": lm_head.t().to(torch.bfloat16).contiguous(),
            "layers": layers,
            "attn_meta": make_attn_meta(spec, retrieval_flags, head_rank,
                                        device),
        }
        kv_scales = None
        if "kv_pt_scales" in z:
            pt = dev(z["kv_pt_scales"])                     # [L, 2]
            kv_scales = (pt[:, 0].contiguous(), pt[:, 1].contiguous())
    _lm_head(params, spec)
    logger.info("loaded packed checkpoint from %s", path)
    return params, kv_scales


def load_llama_params(
    model_config,
    spec: LlamaSpec,
    retrieval_flags: Optional[np.ndarray] = None,
    head_rank: Optional[np.ndarray] = None,
    tp_size: int = 1,
    device="cuda:0",
) -> Tuple[Dict[str, Any], Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (params on ``device``, (k [L], v [L]) per-tensor KV scales,
    or None when the checkpoint has none or the pools are fine-grained).

    ``model_config.quant_path`` (else ``.model``) names a ``packed.npz``
    directory or an HF checkpoint. The HF projections are gathered into
    fp32 host stacks (as the JAX loader does), fused rank-major
    (``tp_size``, as tensor parallelism will shard them) and quantized one
    layer at a time on ``device``. A tensor the model needs and the
    checkpoint lacks raises, naming it."""
    path = _resolve_path(model_config.quant_path or model_config.model)
    if os.path.exists(os.path.join(path, "packed.npz")):
        if tp_size > 1:
            raise NotImplementedError(
                "packed.npz checkpoints are packed for tp=1; re-run the "
                "converter with --tp-size to serve them tensor-parallel")
        return load_packed_params(path, spec, retrieval_flags, head_rank,
                                  device)
    L, D = spec.num_layers, spec.hidden
    inter = spec.intermediate * tp_size
    q_size, kv_size = spec.q_size * tp_size, spec.kv_size * tp_size
    stacks = {
        "q_proj.weight": np.zeros((L, q_size, D), np.float32),
        "k_proj.weight": np.zeros((L, kv_size, D), np.float32),
        "v_proj.weight": np.zeros((L, kv_size, D), np.float32),
        "o_proj.weight": np.zeros((L, D, q_size), np.float32),
        "gate_proj.weight": np.zeros((L, inter, D), np.float32),
        "up_proj.weight": np.zeros((L, inter, D), np.float32),
        "down_proj.weight": np.zeros((L, D, inter), np.float32),
        "input_layernorm": np.ones((L, D), np.float32),
        "post_attention_layernorm": np.ones((L, D), np.float32),
    }
    if spec.attn_bias:   # Qwen2 / attention_bias configs; o_proj has none
        stacks.update({
            "q_proj.bias": np.zeros((L, q_size), np.float32),
            "k_proj.bias": np.zeros((L, kv_size), np.float32),
            "v_proj.bias": np.zeros((L, kv_size), np.float32),
        })
    seen = set()
    embed = lm_head = final_ln = None
    k_pt = np.ones((L,), np.float32)
    v_pt = np.ones((L,), np.float32)
    has_pt_scales = False

    def layer_of(name: str) -> int:
        return int(name.split("layers.")[1].split(".")[0])

    n_loaded = 0
    for name, t in _iter_hf_weights(path):
        w = t.float().numpy()
        n_loaded += 1
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
        else:
            key = next((k for k in stacks if k in name), None)
            if key is not None:
                li = layer_of(name)
                stacks[key][li] = w
                seen.add((key, li))
    logger.info("loaded %d tensors from %s", n_loaded, path)
    missing = [f"model.layers.{li}.{key}" for li in range(L)
               for key in stacks if (key, li) not in seen]
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
    fp_layers = {
        "attn_ln": s.pop("input_layernorm"),
        "mlp_ln": s.pop("post_attention_layernorm"),
        "qkv": fuse_qkv_rank_major(s.pop("q_proj.weight"),
                                   s.pop("k_proj.weight"),
                                   s.pop("v_proj.weight"), tp_size),
        "o": s.pop("o_proj.weight"),
        "gate_up": fuse_gate_up_rank_major(s.pop("gate_proj.weight"),
                                           s.pop("up_proj.weight"), tp_size),
        "down": s.pop("down_proj.weight"),
    }
    if spec.attn_bias:
        # the fused qkv weight's rank-major channel order
        fp_layers["qkv_bias"] = fuse_qkv_rank_major(
            s.pop("q_proj.bias"), s.pop("k_proj.bias"), s.pop("v_proj.bias"),
            tp_size)
    params = {
        "embed": torch.from_numpy(embed).to(device).to(torch.bfloat16),
        "final_ln": torch.from_numpy(final_ln).to(device),
        "lm_head": torch.from_numpy(lm_head).to(device).t()
        .to(torch.bfloat16).contiguous(),
        "layers": quantize_layer_weights(fp_layers, spec, tp_size, device),
        "attn_meta": make_attn_meta(spec, retrieval_flags, head_rank,
                                    device),
    }
    _lm_head(params, spec)
    kv_scales = None
    if has_pt_scales and not model_config.kv_zeros:
        kv_scales = (torch.from_numpy(k_pt).to(device),
                     torch.from_numpy(v_pt).to(device))
    return params, kv_scales
