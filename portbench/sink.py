"""An output sink in place of the NetCDF4 file the program writes.

``install(wrf_writer, recorder)`` puts ``SampleFile`` where
``io/wrf_writer`` looks up ``NetCDF4File``, so every call that
``write_output`` and ``StreamingWriter`` make reaches it: dimensions,
variables, whole writes and level slabs. Nothing goes to disk. Of each
variable the sink keeps its dimensions and dtype and, cast to that dtype
as the file would store it, its values at the sampled points of its
horizontal grid (mass, U or V points) on every level, or the whole
variable where it has no horizontal extent. A variable defined with one
value throughout reads back as that value (the writer reads Z_C back
before it fills its levels).
"""

from __future__ import annotations

import numpy as np

_HORIZONTAL = {("south_north", "west_east"): "M",
               ("south_north", "west_east_stag"): "U",
               ("south_north_stag", "west_east"): "V"}


class Recorder:
    """What the sink keeps for each file the program writes: one
    ``hour`` dict {var: {"dims", "dtype", "shape", "values", "levels"}},
    plus ``faults``: writes the sink could not place."""

    def __init__(self, points: dict):
        self.points = points            # {"M"/"U"/"V": (j, i)}
        self.hours = []

    def new_file(self):
        self.hours.append({"vars": {}, "faults": []})
        return self.hours[-1]


class _ReadBack:
    def __init__(self, owner):
        self.owner = owner

    def __getitem__(self, name):
        var = self.owner.rec["vars"][name]
        if "const" not in var:
            raise ValueError(f"the sink keeps no data of {name}")
        return np.full(var["shape"], var["const"], var["dtype"])


class SampleFile:
    def __init__(self, recorder: Recorder, path, mode="w"):
        if mode not in ("w", "w-", "x"):
            raise ValueError("the sink only writes")
        self.points = recorder.points
        self.rec = recorder.new_file()
        self.dims = {}
        self._f = _ReadBack(self)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def close(self):
        pass

    def create_dim(self, name, size):
        self.dims[name] = 0 if size is None else size

    def ensure_unlimited_size(self, name, size):
        self.dims[name] = max(self.dims[name], size)

    def set_attr(self, name, value, var=None):
        pass

    def has_var(self, name):
        return name in self.rec["vars"]

    def create_var(self, name, dims, dtype, data=None):
        shape = tuple(self.dims[d] for d in dims)
        where = _HORIZONTAL.get(tuple(dims[-2:]))
        dtype = np.dtype(dtype)
        if where is None:
            values = np.zeros(shape, dtype)
        else:
            nlev = shape[1] if len(shape) == 4 else 1
            values = np.zeros((nlev, len(self.points[where][0])), dtype)
        self.rec["vars"][name] = {
            "dims": list(dims), "dtype": dtype, "shape": shape,
            "where": where, "values": values,
            "levels": np.zeros(values.shape[0] if where else 1, bool)}
        if data is not None:
            self.write_var(name, data)

    def write_var(self, name, data):
        self.write_var_slab(name, data, (0,) * len(
            self.rec["vars"][name]["shape"]))

    def write_var_slab(self, name, data, starts):
        var = self.rec["vars"][name]
        a = np.asarray(data)
        shape, where = var["shape"], var["where"]
        var.pop("const", None)
        if where is None:
            if tuple(starts) != (0,) * len(shape) or a.shape != shape:
                self.rec["faults"].append(f"{name}: a partial write")
                return
            var["values"] = a.astype(var["dtype"])
            var["levels"][:] = True
            return
        j, i = self.points[where]
        if len(shape) == 4:
            lev0 = starts[1]
            if (a.ndim != 4 or tuple(starts[2:]) != (0, 0)
                    or a.shape[2:] != shape[2:]):
                self.rec["faults"].append(f"{name}: a write of part of a "
                                          f"level at {tuple(starts)}")
                return
            k = a.shape[1]
            var["values"][lev0:lev0 + k] = a[0][:, j, i].astype(var["dtype"])
            var["levels"][lev0:lev0 + k] = True
        else:
            if a.shape[-2:] != shape[-2:] or tuple(starts[1:]) != (0, 0):
                self.rec["faults"].append(f"{name}: a partial write")
                return
            var["values"][0] = a.reshape(shape[-2:])[j, i].astype(
                var["dtype"])
            var["levels"][0] = True
        whole = tuple(starts) == (0,) * len(shape) and a.shape == shape
        if whole and a.size and a.flat[0] == a.flat[-1] and (
                a.min() == a.max()):
            var["const"] = a.flat[0]


def install(wrf_writer, recorder: Recorder) -> None:
    """Make ``wrf_writer`` write into ``recorder`` instead of files."""
    wrf_writer.NetCDF4File = lambda path, mode="w": SampleFile(
        recorder, path, mode)
