"""DeepCompressor QoQ fake-quant dump -> packed checkpoint, in PyTorch.

The port of ``scripts/ckpt_converter/convert.py`` on the port's quantizers
(``ops/quantization.py``). Input, as DeepCompressor / lmquant write it:

- ``model.pt``: the fake-quant (dequantized) state dict;
- ``scale.pt``: ``{prefix}.weight.scale.0`` (s1, per output channel),
  ``{prefix}.weight.scale.1`` (s2, per group; group size != -1 only) and
  ``{prefix}.weight.zero`` (the integer zero point; a signed dump's zeros
  get +8);
- ``acts.pt`` (``--kv-per-tensor``): the calibrated dynamic ranges of
  ``k_rotary_emb.output`` / ``v_proj.output``; per-tensor KV scale =
  max / 127.

Output: ``<output-path>/<model>-<tag>/packed.npz`` with the same arrays
(layers stacked on axis 0) and the same ``omniserve_tpu.json`` as the JAX
package's converter, plus copies of the model's json files:

  {qkv,o,gate_up,down}.qweight / .s1_scales / .s1_szeros      (per channel)
  {qkv,o,gate_up,down}.qweight / .s1_scales / .s2_scales / .s2_zeros
  {qkv,o,gate_up,down}.qweight / .scales                      (w8)
  attn_ln, mlp_ln, final_ln, embed, lm_head, qkv_bias, kv_pt_scales [L, 2]

Usage:
  python -m omniserve_tpu_torch.ckpt_converter.convert \\
      --model-path <hf-config-dir> --quant-path <deepcompressor-dump> \\
      --w-bit 4 --group-size -1 [--kv-per-tensor] --output-path out/ \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from omniserve_tpu_torch.ops.quantization import (
    quantize_weight_per_channel,
    quantize_weight_per_group,
    quantize_weight_w8,
)

_FUSED = {
    "qkv": ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
    "o": ("self_attn.o_proj",),
    "gate_up": ("mlp.gate_proj", "mlp.up_proj"),
    "down": ("mlp.down_proj",),
}


def _load_torch(path):
    # DeepCompressor's act stats are nested python containers
    return torch.load(path, map_location="cpu", weights_only=False)


def _np(t) -> np.ndarray:
    return np.asarray(t.float().cpu().numpy() if hasattr(t, "float") else t,
                      np.float32)


def _kv_dynamic_max(entry) -> float:
    """The lmquant-v0 and the DeepCompressor act stat formats."""
    try:
        return float(entry["dynamic_range.0.max"])
    except (KeyError, TypeError, IndexError):
        return float(entry["dynamic_range"][0]["max"])


def quantize_linear_calibrated(w_fp, s1, s2, zeros, w_bit, group_size,
                               device="cuda:0"):
    """Quantize one linear [OC, IC] with calibrated DeepCompressor params
    (numpy in) on ``device``; returns the weight container."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    w = dev(w_fp)
    if w_bit == 8:
        return quantize_weight_w8(w, scales=dev(s1))
    if group_size == -1:
        return quantize_weight_per_channel(w, s1_scales=dev(s1),
                                           zeros=dev(zeros))
    return quantize_weight_per_group(
        w, group_size=group_size, s1_scales=dev(s1), s2_scales=dev(s2),
        zeros=dev(zeros),
    )


def convert(model_path, quant_path, w_bit, group_size, kv_per_tensor,
            output_path, device="cuda:0"):
    """Write the packed checkpoint; returns its directory."""
    cfg = json.load(open(os.path.join(model_path, "config.json")))
    n_layers = cfg["num_hidden_layers"]
    fake = _load_torch(os.path.join(quant_path, "model.pt"))
    scales = _load_torch(os.path.join(quant_path, "scale.pt"))
    acts = (_load_torch(os.path.join(quant_path, "acts.pt"))
            if kv_per_tensor else None)

    def scale_params(prefix):
        s1 = _np(scales[f"{prefix}.weight.scale.0"]).reshape(-1)
        s2 = (_np(scales[f"{prefix}.weight.scale.1"])
              if group_size != -1 else None)
        z = _np(scales[f"{prefix}.weight.zero"])
        if z.min() < 0:  # signed dump -> unsigned grid (+8)
            z = z + 8
        return s1, s2, z

    stacked: dict = {}
    for i in range(n_layers):
        base = f"model.layers.{i}"
        for fname, parts in _FUSED.items():
            ws, s1s, s2s, zs = [], [], [], []
            for p in parts:
                prefix = f"{base}.{p}"
                ws.append(_np(fake[f"{prefix}.weight"]))
                s1, s2, z = scale_params(prefix)
                s1s.append(s1)
                if s2 is not None:
                    s2s.append(s2.reshape(ws[-1].shape[0], -1))
                zs.append(z.reshape(ws[-1].shape[0], -1))
            z = np.concatenate(zs, axis=0)
            q = quantize_linear_calibrated(
                np.concatenate(ws, axis=0), np.concatenate(s1s, axis=0),
                np.concatenate(s2s, axis=0) if s2s else None,
                z.reshape(-1) if group_size == -1 else z, w_bit, group_size,
                device)
            for field, arr in zip(q._fields, q):
                stacked.setdefault(f"{fname}.{field}", []).append(
                    arr.cpu().numpy())
        if f"{base}.self_attn.q_proj.bias" in fake:
            # the Qwen2 QKV bias: f32, in the fused qkv channel order
            stacked.setdefault("qkv_bias", []).append(np.concatenate([
                _np(fake[f"{base}.self_attn.{p}.bias"])
                for p in ("q_proj", "k_proj", "v_proj")
            ]))
        stacked.setdefault("attn_ln", []).append(
            _np(fake[f"{base}.input_layernorm.weight"]))
        stacked.setdefault("mlp_ln", []).append(
            _np(fake[f"{base}.post_attention_layernorm.weight"]))
        if kv_per_tensor:
            k_max = _kv_dynamic_max(
                acts[f"{base}.self_attn.k_rotary_emb.output"])
            v_max = _kv_dynamic_max(acts[f"{base}.self_attn.v_proj.output"])
            stacked.setdefault("kv_pt_scales", []).append(
                np.array([k_max / 127.0, v_max / 127.0], np.float32))
        print(f"layer {i + 1}/{n_layers} packed", flush=True)

    out = {name: np.stack(arrs) for name, arrs in stacked.items()}
    out["embed"] = _np(fake["model.embed_tokens.weight"])
    out["final_ln"] = _np(fake["model.norm.weight"])
    if "lm_head.weight" in fake:
        out["lm_head"] = _np(fake["lm_head.weight"])

    name = os.path.basename(model_path.rstrip("/"))
    tag = (f"w{w_bit}a8-per-channel" if group_size == -1
           else f"w{w_bit}a8-g{group_size}")
    if kv_per_tensor:
        tag += "-kv-per-tensor"
    dest = os.path.join(output_path, f"{name}-{tag}")
    os.makedirs(dest, exist_ok=True)
    np.savez(os.path.join(dest, "packed.npz"), **out)
    meta = {
        "format": "omniserve_tpu_packed_v1",
        "weight_bits": w_bit,
        "group_size": group_size,
        "kv_per_tensor": kv_per_tensor,
    }
    json.dump(meta, open(os.path.join(dest, "omniserve_tpu.json"), "w"),
              indent=2)
    for f in os.listdir(model_path):
        if f.endswith(".json") or f == "tokenizer.model":
            shutil.copy(os.path.join(model_path, f), dest)
    print(f"saved packed checkpoint to {dest}")
    return dest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True,
                    help="HF config/tokenizer dir")
    ap.add_argument("--quant-path", required=True,
                    help="DeepCompressor dump dir (model.pt, scale.pt)")
    ap.add_argument("--w-bit", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=-1)
    ap.add_argument("--kv-per-tensor", action="store_true")
    ap.add_argument("--output-path", default="checkpoints/")
    ap.add_argument("--device", default="cuda:0",
                    help="where the weights quantize (cpu: no card)")
    args = ap.parse_args(argv)
    convert(args.model_path, args.quant_path, args.w_bit, args.group_size,
            args.kv_per_tensor, args.output_path, args.device)


if __name__ == "__main__":
    main()
