"""Carry the JAX package's parameters and pools into the port.

``params_from_numpy`` takes the JAX parameter tree after
``jax.tree.map(np.asarray, params)`` and returns the port's tree with the
same keys. Weight containers (``NamedTuple``s of the JAX package) are read
through ``_asdict()`` and rebuilt as the port's container of the same name,
so this module imports nothing of the JAX package. Plain arrays (the
stacked bf16 [L, K, N] weights of a W16A16 body, norms, embeddings) carry
across as they are.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from omniserve_tpu_torch.ops import quantization
from omniserve_tpu_torch.ops.paged_kv import KVPool

_CONTAINERS = {
    "QuantizedWeightPerChannel": quantization.QuantizedWeightPerChannel,
    "QuantizedWeightPerGroup": quantization.QuantizedWeightPerGroup,
    "QuantizedWeightW8": quantization.QuantizedWeightW8,
}


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch tensor on ``device``."""
    a = np.require(a, requirements=["C", "W"])   # copies read-only views
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """JAX parameter tree (numpy leaves) -> port parameter tree."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        name = type(tree).__name__
        if name not in _CONTAINERS:
            raise NotImplementedError(
                f"weight container {name} is not served by the port yet"
            )
        fields = {k: params_from_numpy(v, device)
                  for k, v in tree._asdict().items()}
        return _CONTAINERS[name](**fields)
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)


def pool_from_numpy(pool: Any, device) -> KVPool:
    """A JAX ``KVPool`` (numpy leaves, read by field name) -> port pool;
    kv4, kv8 (fine-grained or per-tensor) or kv16, a retrieval pool with
    its K stats, or a streaming pool."""

    def field(name):
        a = getattr(pool, name, None)
        return None if a is None else tensor_from_numpy(a, device)

    return KVPool(
        k_data=field("k_data"),
        v_data=field("v_data"),
        kv_scales=field("kv_scales"),
        k_stats=field("k_stats"),
        k_scale_per_tensor=field("k_scale_per_tensor"),
        v_scale_per_tensor=field("v_scale_per_tensor"),
    )
