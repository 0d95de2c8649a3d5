"""Padded-COO graph layout for the large-scale sparse path.

Port of ``dream_gnn_tpu/graph/coo.py``: a static-shape edge list sorted by
destination, padded to a budget with zero-weight edges, so edge dropout is
an update of ``val`` and never a rebuild.  The scale path's FGCN runs on
identity ``CooGraph``s (scripts/train_scale.py:137-144 of the JAX
package); ``kernels/spmm.py:spmm_coo`` aggregates over it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CooGraph:
    """Static-shape COO graph: (E_pad,) src/dst/val tensors.

    ``val`` is the edge weight; padding edges have ``val == 0``, point at
    src 0 and at the last dst, so the list stays dst-sorted and a weighted
    segment sum ignores them.
    """

    src: torch.Tensor            # (E_pad,) int64 source node ids
    dst: torch.Tensor            # (E_pad,) int64 destination node ids
    val: torch.Tensor            # (E_pad,) f32 edge weights (0 = padding)
    n_src: int
    n_dst: int

    @property
    def e_pad(self) -> int:
        return self.src.shape[0]


def coo_from_arrays(src, dst, val, n_src: int, n_dst: int,
                    pad_to: int | None = None, pad_multiple: int = 512,
                    device="cuda") -> CooGraph:
    """A dst-sorted, padded CooGraph from host edge arrays, on ``device``
    (coo.py:50-72 of the JAX package)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    val = np.asarray(val, np.float32)
    order = np.argsort(dst, kind="stable")
    src, dst, val = src[order], dst[order], val[order]
    e = src.shape[0]
    budget = pad_to if pad_to is not None \
        else -(-max(e, 1) // pad_multiple) * pad_multiple
    if e > budget:
        raise ValueError(f"edge count {e} exceeds pad budget {budget}")

    def pad(x, fill=0):
        out = np.full((budget,), fill, x.dtype)
        out[:e] = x
        return torch.from_numpy(out).to(device)

    return CooGraph(src=pad(src), dst=pad(dst, fill=n_dst - 1), val=pad(val),
                    n_src=n_src, n_dst=n_dst)
