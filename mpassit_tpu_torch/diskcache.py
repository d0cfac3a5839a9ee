"""Atomic directory-of-``.npy`` disk cache.

All three derived-artifact caches (ELL weights, packed operator layouts,
target grids) store multi-hundred-MB arrays that sit on the warm-start
critical path. ``np.savez`` wraps them in a zip container whose load pays a
CRC32 sweep plus a full copy (~1 s per 200 MB on a 2-core host); here each
array is its own ``.npy`` file loaded with ``mmap_mode="r"`` — a warm load
is a handful of page-table setups, and bytes are faulted in lazily as the
consumer touches them.

Atomicity: arrays are written into a ``<path>.tmp<pid>`` staging directory
that is published with one ``os.rename``. Concurrent writers race benignly
(first rename wins); a leftover corrupt entry at ``path`` is rotated away
and replaced.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np


def save_arrays(path: str, meta: dict, arrays: dict) -> None:
    """Atomically persist ``arrays`` (+ JSON-serializable ``meta``) at the
    directory ``path``."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(tmp, exist_ok=True)
        for name, a in arrays.items():
            np.save(os.path.join(tmp, name + ".npy"), np.asarray(a))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        try:
            os.rename(tmp, path)
        except OSError:
            # path already exists: either a concurrent writer won (keep
            # theirs) or a corrupt leftover blocks us (rotate it away)
            old = f"{path}.old{os.getpid()}"
            try:
                os.rename(path, old)
                os.rename(tmp, path)
                _rmtree(old)
            except OSError:
                _rmtree(tmp)
    except BaseException:
        _rmtree(tmp)
        raise


def load_arrays(path: str, mmap: bool = True):
    """Return ``(meta, {name: array})`` for a cache entry, or None when the
    entry is absent or unreadable (caller rebuilds)."""
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        arrays = {}
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".npy"):
                arrays[fn[:-4]] = np.load(
                    os.path.join(path, fn),
                    mmap_mode="r" if mmap else None, allow_pickle=False)
        return meta, arrays
    except Exception:
        return None


def _rmtree(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            os.remove(path)
        except OSError:
            pass
