"""HF checkpoint -> DeepCompressor-format QoQ fake-quant dump.

The port of ``scripts/ckpt_converter/make_fake_quant_dump.py``: writes the
(model.pt, scale.pt[, acts.pt]) triple that
``omniserve_tpu_torch.ckpt_converter.convert`` consumes, by fake-quantizing
an HF Llama checkpoint (read through the port's ``_iter_hf_weights``) with
the QoQ weight math, in numpy. It lacks DeepCompressor's activation-aware
scale search, so it serves to drive the convert -> packed -> serve path
end to end, not for accuracy.

    python -m omniserve_tpu_torch.ckpt_converter.make_fake_quant_dump \\
        --model <hf-dir> --output <dump-dir> [--group-size -1] \\
        [--kv-per-tensor]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from omniserve_tpu_torch.models.weight_loader import _iter_hf_weights

_LINEARS = (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
)


def make_dump(model: str, output: str, group_size: int = -1,
              kv_per_tensor: bool = False) -> int:
    """Write the dump of ``model`` into ``output``; returns the number of
    linears fake-quantized."""
    os.makedirs(output, exist_ok=True)
    fake, scales, acts = {}, {}, {}
    n_lin = 0
    for name, t in _iter_hf_weights(model):
        w = t.float().numpy()
        if not any(name.endswith(f"{p}.weight") for p in _LINEARS):
            fake[name] = torch.tensor(w)
            continue
        n_lin += 1
        prefix = name[: -len(".weight")]
        oc, ic = w.shape
        if group_size == -1:
            # per-channel asymmetric u4 (QoQ s1 + zero)
            w_max = w.max(axis=1)
            w_min = w.min(axis=1)
            s1 = np.maximum((w_max - w_min) / 15.0, 1e-8)
            zp = np.clip(np.round(-w_min / s1), 0, 15)
            q = np.clip(np.round(w / s1[:, None] + zp[:, None]), 0, 15)
            fake[name] = torch.tensor((q - zp[:, None]) * s1[:, None])
            scales[f"{prefix}.weight.scale.0"] = torch.tensor(
                s1.astype(np.float32))
        else:
            w3 = w.reshape(oc, ic // group_size, group_size)
            # progressive: an integer s2 per group on a per-channel s1
            amax = np.abs(w3).max(axis=2)
            s1 = np.maximum(amax.max(axis=1) / (127.0 * 7.0), 1e-8)
            s2 = np.clip(np.round(amax / s1[:, None] / 7.0), 1, 127)
            step = s2 * s1[:, None]
            zp = np.clip(np.round(-w3.min(axis=2) / step), 0, 15)
            q = np.clip(np.round(w3 / step[..., None] + zp[..., None]),
                        0, 15)
            fake[name] = torch.tensor(
                ((q - zp[..., None]) * step[..., None]).reshape(oc, ic))
            scales[f"{prefix}.weight.scale.0"] = torch.tensor(
                s1.astype(np.float32))
            scales[f"{prefix}.weight.scale.1"] = torch.tensor(
                s2.astype(np.float32))
        # signed dump convention: stored zero = zp - 8
        scales[f"{prefix}.weight.zero"] = torch.tensor(
            (zp - 8).astype(np.float32))
        if kv_per_tensor and prefix.endswith("self_attn.k_proj"):
            base = prefix[: -len(".self_attn.k_proj")]
            for src in ("k_rotary_emb", "v_proj"):
                acts[f"{base}.self_attn.{src}.output"] = {
                    "dynamic_range.0.max": torch.tensor(4.0)}
    torch.save(fake, os.path.join(output, "model.pt"))
    torch.save(scales, os.path.join(output, "scale.pt"))
    if acts:
        torch.save(acts, os.path.join(output, "acts.pt"))
    print(f"fake-quantized {n_lin} linears -> {output}")
    return n_lin


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--group-size", type=int, default=-1)
    parser.add_argument("--kv-per-tensor", action="store_true")
    args = parser.parse_args(argv)
    make_dump(args.model, args.output, args.group_size, args.kv_per_tensor)


if __name__ == "__main__":
    main()
