"""Gather apply of an ELL operator (counterpart of mpassit_tpu/ops/apply.py).

    out[t, c] = sum_k w[t, k] * src[idx[t, k], c]

as ``index_select`` row gathers and a K-unrolled multiply-add, in the
weights' dtype (f32 or f64). This is the engine for ``compute_dtype =
float64``, 1-D targets and operators whose tiles exceed ``W_CAP`` unique
source rows; the JAX package runs the same plain gather through XLA (it has
no Pallas kernel either).
"""

from __future__ import annotations

import numpy as np
import torch

from ..weights.ell import ELLWeights


def apply_ell(idx, w, src, out_dtype=None):
    """idx (T, K) int64 and w (T, K) tensors; src (n_src, C) or (n_src,)
    on the same device. Accumulates in w's dtype; output cast to
    out_dtype."""
    squeeze = src.dim() == 1
    if squeeze:
        src = src[:, None]
    srcw = src.to(w.dtype)
    out = None
    for k in range(idx.shape[1]):
        term = w[:, k, None] * torch.index_select(srcw, 0, idx[:, k])
        out = term if out is None else out + term
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out[:, 0] if squeeze else out


class Regridder:
    """Device-resident ELL operator with column chunking (the analog of a
    stored ESMF route handle: build once, apply to many field stacks)."""

    def __init__(self, ell: ELLWeights, device: torch.device,
                 dtype=torch.float32, max_cols: int = 256):
        self.method = ell.method
        self.src_loc = ell.src_loc
        self.dst_shape = tuple(ell.dst_shape)
        self.n_src = ell.n_src
        self.max_cols = max_cols
        self.device = torch.device(device)
        self.dtype = dtype
        self.idx = torch.as_tensor(np.asarray(ell.idx, np.int64),
                                   device=self.device)
        self.w = torch.as_tensor(np.asarray(ell.w), dtype=dtype,
                                 device=self.device)

    @property
    def n_dst(self) -> int:
        return self.idx.shape[0]

    def __call__(self, src, out_dtype=None):
        """src: (n_src,) or (n_src, C) array or tensor. Returns a tensor
        (dst_shape...) or (dst_shape..., C) on the operator's device."""
        src = torch.as_tensor(src, device=self.device)
        if src.shape[0] != self.n_src:
            # an index gather past n_src would fault on the device; catch
            # shape mistakes here instead
            raise ValueError(
                f"source has {src.shape[0]} rows, operator expects {self.n_src}"
            )
        if src.dim() == 1:
            out = apply_ell(self.idx, self.w, src, out_dtype=out_dtype)
            return out.reshape(self.dst_shape)
        C = src.shape[1]
        out = torch.cat([
            apply_ell(self.idx, self.w, src[:, lo:lo + self.max_cols],
                      out_dtype=out_dtype)
            for lo in range(0, C, self.max_cols)
        ], dim=1)
        return out.reshape(self.dst_shape + (C,))

    def apply_np(self, src, out_dtype=None, root_only: bool = False):
        """Host apply. ``root_only`` is accepted for the engines' common
        signature: unsharded, every process computes the whole result."""
        return self(src, out_dtype=out_dtype).cpu().numpy()
