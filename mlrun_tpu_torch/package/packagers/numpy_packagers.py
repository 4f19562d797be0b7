"""NumPy packagers — the port's copy of
``mlrun_tpu/package/packagers/numpy_packagers.py`` (ndarray / scalar /
dict-of-arrays / list-of-arrays families with npy / npz / csv formats)."""

from __future__ import annotations

from .default import DefaultPackager


class NumpyArrayPackager(DefaultPackager):
    artifact_types = ("artifact", "result", "file")
    priority = 3

    def can_pack(self, obj):
        import numpy as np

        return isinstance(obj, np.ndarray)

    def can_unpack(self, hint):
        import numpy as np

        return hint is np.ndarray

    def pack(self, context, obj, key, artifact_type="", **cfg):
        import numpy as np

        if obj.ndim == 0 or artifact_type == "result":
            value = obj.item() if obj.ndim == 0 else obj.tolist()
            context.log_result(key, value)
            return
        file_format = cfg.get("file_format", "npy")
        path = self.new_file(f".{file_format}")
        if file_format == "csv":
            np.savetxt(path, obj, delimiter=",")
        else:
            np.save(path, obj)
        context.log_artifact(key, local_path=path, format=file_format)

    def unpack(self, data_item, hint):
        import numpy as np

        local = data_item.local()
        if local.endswith(".csv"):
            return np.loadtxt(local, delimiter=",")
        return np.load(local)


class NumpyScalarPackager(DefaultPackager):
    default_artifact_type = "result"
    priority = 3

    def can_pack(self, obj):
        import numpy as np

        return isinstance(obj, np.generic)

    def can_unpack(self, hint):
        import numpy as np

        return isinstance(hint, type) and issubclass(hint, np.generic)

    def pack(self, context, obj, key, artifact_type="", **cfg):
        context.log_result(key, obj.item())

    def unpack(self, data_item, hint):
        raw = data_item.get()
        text = raw.decode() if isinstance(raw, bytes) else raw
        return hint(text)


class NumpyArrayDictPackager(DefaultPackager):
    """{name: ndarray} → one .npz artifact."""

    priority = 3

    def can_pack(self, obj):
        import numpy as np

        return (isinstance(obj, dict) and len(obj) > 0
                and all(isinstance(v, np.ndarray) for v in obj.values()))

    def can_unpack(self, hint):
        return False  # dict hints route to the collection packager

    def pack(self, context, obj, key, artifact_type="", **cfg):
        import numpy as np

        path = self.new_file(".npz")
        np.savez(path, **obj)
        context.log_artifact(key, local_path=path, format="npz")

    def unpack(self, data_item, hint):  # pragma: no cover - can_unpack False
        import numpy as np

        return dict(np.load(data_item.local()))


class NumpyArrayListPackager(DefaultPackager):
    """[ndarray, ...] → one .npz artifact (arr_0..arr_n)."""

    priority = 3

    def can_pack(self, obj):
        import numpy as np

        return (isinstance(obj, list) and len(obj) > 0
                and all(isinstance(v, np.ndarray) for v in obj))

    def can_unpack(self, hint):
        return False

    def pack(self, context, obj, key, artifact_type="", **cfg):
        import numpy as np

        path = self.new_file(".npz")
        np.savez(path, *obj)
        context.log_artifact(key, local_path=path, format="npz")

    def unpack(self, data_item, hint):  # pragma: no cover - can_unpack False
        import numpy as np

        loaded = np.load(data_item.local())
        return [loaded[name] for name in loaded.files]
