"""GGUF container reader and writer (numpy only, mmap-backed reads).

The port's own copy of `omni_tpu/core/gguf.py`: GGUF v2/v3 little-endian,
magic "GGUF", the KV metadata section, the tensor directory, then the
tensor blobs, each aligned (ggml/src/gguf.cpp, ggml/include/gguf.h). A file
written by either package's writer reads back the same through either
reader.

The reader memory-maps the file and exposes zero-copy uint8 views of the
tensor blocks. The writer streams: a tensor may be given as a function
that returns its data, which is called only when the tensor's turn to be
written comes, so a file of many GB is written one tensor at a time.
"""

from __future__ import annotations

import enum
import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Callable

import numpy as np

from .dtypes import GGMLType, row_nbytes, type_traits

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _guess_value_type(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        if v < 0:
            return GGUFValueType.INT64 if v < -(2**31) else GGUFValueType.INT32
        return GGUFValueType.UINT64 if v >= 2**32 else GGUFValueType.UINT32
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, (str, bytes)):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot map {type(v)} to a GGUF value type")


def _nbytes(ggml_type: GGMLType, shape: tuple[int, ...]) -> int:
    """Bytes of a tensor of `shape` (numpy order; rows along shape[-1])."""
    if not shape:
        return 0
    n_el = int(np.prod(shape))
    return n_el // shape[-1] * row_nbytes(ggml_type, shape[-1])


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy order (outermost first); the file stores ne[] reversed
    ggml_type: GGMLType
    offset: int  # relative to the start of the data section
    data: np.ndarray | None = None  # uint8 blocks [n_blocks, type_size], or typed

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return _nbytes(self.ggml_type, self.shape)


class GGUFReader:
    """mmap-backed GGUF reader.

    `reader.kv` maps metadata keys to Python values; `reader.tensors` maps
    tensor names to `TensorInfo` whose `.data` is a zero-copy numpy view:
    [n_blocks, type_size] uint8 for quantized types, typed and shaped for
    plain ones (BF16 as its uint16 bits)."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        self._pos = 0
        self.kv: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._parse()

    def _read_fmt(self, fmt: str):
        vals = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += struct.calcsize(fmt)
        return vals[0] if len(vals) == 1 else vals

    def _read_string(self) -> str:
        n = self._read_fmt("<Q")
        s = bytes(self._mm[self._pos:self._pos + n])
        self._pos += n
        return s.decode("utf-8", errors="replace")

    def _read_value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self._read_string()
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self._read_fmt("<I"))
            n = self._read_fmt("<Q")
            if etype in _SCALAR_FMT and etype != GGUFValueType.BOOL:
                arr = np.frombuffer(
                    self._mm, dtype=np.dtype(_SCALAR_FMT[etype][1]).newbyteorder("<"),
                    count=n, offset=self._pos)
                self._pos += arr.nbytes
                return arr
            return [self._read_value(etype) for _ in range(n)]
        return self._read_fmt(_SCALAR_FMT[vtype])

    def _parse(self) -> None:
        magic = self._read_fmt("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        self.version = self._read_fmt("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {self.version}")
        n_tensors = self._read_fmt("<q")
        n_kv = self._read_fmt("<q")
        for _ in range(n_kv):
            key = self._read_string()
            self.kv[key] = self._read_value(GGUFValueType(self._read_fmt("<I")))
        infos = []
        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read_fmt("<I")
            ne = [self._read_fmt("<Q") for _ in range(n_dims)]
            ggml_type = GGMLType(self._read_fmt("<I"))
            offset = self._read_fmt("<Q")
            infos.append(TensorInfo(name, tuple(reversed(ne)), ggml_type, offset))
        self.alignment = int(self.kv.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        self.data_start = -(-self._pos // self.alignment) * self.alignment
        for info in infos:
            start = self.data_start + info.offset
            raw = self._buf[start:start + info.nbytes]
            tr = type_traits(info.ggml_type)
            if tr.is_quantized:
                info.data = raw.reshape(info.n_elements // tr.block_size, tr.type_size)
            else:
                info.data = raw.view(tr.numpy_dtype).reshape(info.shape)
            self.tensors[info.name] = info

    def close(self) -> None:
        """Release the file. The mapping itself goes once no tensor view
        is alive."""
        self._file.close()
        try:
            self._buf = None
            self._mm.close()
        except BufferError:
            pass  # live tensor views keep the mapping until they go


TensorData = np.ndarray | Callable[[], np.ndarray]


class GGUFWriter:
    """Streaming GGUF v3 writer."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self.alignment = GGUF_DEFAULT_ALIGNMENT
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, TensorData]] = []

    def add_kv(self, key: str, value: Any) -> None:
        self._kv.append((key, _guess_value_type(value), value))

    def add_tensor(self, name: str, data: TensorData,
                   ggml_type: GGMLType | None = None,
                   logical_shape: tuple[int, ...] | None = None) -> None:
        """Add a tensor: block bytes (uint8) and the logical element shape
        for a quantized type, the typed array for a plain one. `data` may
        be a function returning the array, called when the tensor is
        written (then `ggml_type` and `logical_shape` are required)."""
        if callable(data):
            if ggml_type is None or logical_shape is None:
                raise ValueError(f"{name}: a lazy tensor needs its type and shape")
        elif ggml_type is None:
            ggml_type = {np.dtype(np.float32): GGMLType.F32,
                         np.dtype(np.float16): GGMLType.F16,
                         np.dtype(np.int32): GGMLType.I32}[data.dtype]
        shape = logical_shape if logical_shape is not None else data.shape
        self._tensors.append((name, tuple(int(s) for s in shape),
                              GGMLType(ggml_type), data))

    def _write_string(self, f: BinaryIO, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f: BinaryIO, vtype: GGUFValueType, v: Any) -> None:
        if vtype == GGUFValueType.STRING:
            self._write_string(f, v if isinstance(v, str) else v.decode())
        elif vtype == GGUFValueType.ARRAY:
            v = list(v) if not isinstance(v, np.ndarray) else v
            if len(v) == 0:
                etype = GGUFValueType.INT32
            else:
                etype = _guess_value_type(
                    v[0].item() if isinstance(v, np.ndarray) else v[0])
            f.write(struct.pack("<IQ", etype, len(v)))
            for e in v:
                self._write_value(f, etype, e.item() if isinstance(e, np.generic) else e)
        else:
            f.write(struct.pack(_SCALAR_FMT[vtype], v))

    def _pad(self, n: int) -> int:
        return -(-n // self.alignment) * self.alignment

    def write(self) -> None:
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIqq", GGUF_MAGIC, GGUF_VERSION,
                                len(self._tensors), len(self._kv)))
            for key, vtype, v in self._kv:
                self._write_string(f, key)
                f.write(struct.pack("<I", vtype))
                self._write_value(f, vtype, v)
            offset = 0
            for name, shape, ggml_type, _ in self._tensors:
                self._write_string(f, name)
                f.write(struct.pack("<I", len(shape)))
                for d in reversed(shape):
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", ggml_type, offset))
                offset += self._pad(_nbytes(ggml_type, shape))
            f.write(b"\x00" * (self._pad(f.tell()) - f.tell()))
            for name, shape, ggml_type, data in self._tensors:
                blob = np.ascontiguousarray(data() if callable(data) else data)
                want = _nbytes(ggml_type, shape)
                if blob.nbytes != want:
                    raise ValueError(
                        f"tensor {name}: blob is {blob.nbytes} bytes, "
                        f"{ggml_type.name} x {shape} needs {want}")
                f.write(memoryview(blob.reshape(-1).view(np.uint8)))
                f.write(b"\x00" * (self._pad(want) - want))
