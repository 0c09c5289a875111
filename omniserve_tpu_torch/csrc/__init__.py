"""Native code of the port: CUDA kernel sources (``*.cu``, built by
``build.py``) and the host-side batch preparation.

Host prep here is the numpy implementation of
``omniserve_tpu.csrc.build_decode_batch``; the ctypes host-prep library is
queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_decode_batch(
    entries, b: int, w: int, sw: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """entries: list of (slot, token, position, block table, streaming
    block table), one per running sequence; slots without an entry are
    inactive.

    Returns (token_ids [b], positions [b], active [b] bool, block tables
    [b, w], streaming block tables [b, sw]); the batch-assembly part of
    ``omniserve_tpu.csrc.build_decode_batch``'s numpy path.
    """
    token_ids = np.zeros(b, np.int32)
    positions = np.zeros(b, np.int32)
    active = np.zeros(b, bool)
    bt = np.zeros((b, w), np.int32)
    st = np.zeros((b, sw), np.int32)
    for slot, token, pos, tbl, stbl in entries:
        token_ids[slot] = token
        positions[slot] = pos
        active[slot] = True
        bt[slot, : min(len(tbl), w)] = tbl[:w]
        st[slot, : min(len(stbl), sw)] = stbl[:sw]
    return token_ids, positions, active, bt, st
