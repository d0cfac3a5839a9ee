"""Static sparse interpolation operators in ELL (padded fixed-K) form.

This is the TPU-native replacement for an ESMF route handle
(``ESMF_FieldBundleRegridStore``'s output, interp.F90:123-128): a pair of
dense arrays ``idx (T, K) int32`` / ``w (T, K)`` such that

    out[t] = sum_k w[t, k] * src[idx[t, k]]

Fixed K keeps every shape static for XLA; padding entries have idx=0, w=0.
Unmapped target points (quirk Q5: unmappedaction=IGNORE) simply have all-zero
weight rows and a False ``mapped`` flag — the output stays whatever the
destination buffer was initialized to (zero), exactly like the reference
leaves unmapped points untouched.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass
class ELLWeights:
    #: (T, K) int32 source indices (element/cell or node/vertex ids)
    idx: np.ndarray
    #: (T, K) float64 weights (0 for padding)
    w: np.ndarray
    #: number of source locations (cells or vertices)
    n_src: int
    #: method tag: "bilinear" | "nearest" | "conserve" | "wachspress"
    method: str
    #: target grid shape this operator maps onto (e.g. (ny, nx))
    dst_shape: tuple = ()
    #: source location: "element" (cells) or "node" (vertices)
    src_loc: str = "element"

    @property
    def n_dst(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    @property
    def mapped(self) -> np.ndarray:
        """(T,) bool — rows with any nonzero weight."""
        return (self.w != 0).any(axis=1)

    def fingerprint(self) -> str:
        """Content hash of the operator (keys the packed-operator cache,
        the analog of the weight cache's (mesh, grid, method) key for
        derived layouts). Memoized: the arrays are immutable by contract."""
        fp = getattr(self, "_fp", None)
        if fp is None:
            h = hashlib.sha256()
            h.update(np.ascontiguousarray(self.idx).tobytes())
            h.update(np.ascontiguousarray(self.w).tobytes())
            h.update(
                f"|{self.n_src}|{self.dst_shape}|{self.src_loc}".encode())
            fp = h.hexdigest()[:16]
            self._fp = fp
        return fp

    def validate(self) -> None:
        assert self.idx.shape == self.w.shape
        assert self.idx.min() >= 0 and self.idx.max() < max(self.n_src, 1)
        # mapped bilinear/wachspress/nearest rows are convex combinations
        if self.method in ("bilinear", "nearest", "wachspress"):
            s = self.w.sum(axis=1)
            m = self.mapped
            if m.any():
                np.testing.assert_allclose(s[m], 1.0, atol=1e-10)

    def row_sums(self) -> np.ndarray:
        return self.w.sum(axis=1)

    def to_dense(self) -> np.ndarray:
        """(T, n_src) dense matrix — tiny test meshes only."""
        out = np.zeros((self.n_dst, self.n_src))
        rows = np.repeat(np.arange(self.n_dst), self.k)
        np.add.at(out, (rows, self.idx.reshape(-1)), self.w.reshape(-1))
        return out

    def save(self, path: str) -> None:
        # uncompressed: cache loads are on the warm-start critical path
        # (~0.8 s to inflate a compressed CONUS conserve entry vs ~0.1 s
        # raw); np.load reads either format, so old entries stay valid
        np.savez(
            path, idx=self.idx, w=self.w, n_src=self.n_src,
            method=self.method, dst_shape=np.array(self.dst_shape),
            src_loc=self.src_loc,
        )

    @classmethod
    def load(cls, path: str) -> "ELLWeights":
        z = np.load(path, allow_pickle=False)
        return cls(
            idx=z["idx"], w=z["w"], n_src=int(z["n_src"]),
            method=str(z["method"]), dst_shape=tuple(z["dst_shape"].tolist()),
            src_loc=str(z["src_loc"]),
        )
