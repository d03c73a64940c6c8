"""Task payload (de)serialization — v1 JSON and the v2 binary wire format.

Counterpart of ``vantage6_tpu/common/serialization.py``, byte for byte: the
same payload gives the same frame in both packages, and each decodes the
other's. Torch tensors take the place of ``jax.Array`` leaves: they encode
as their numpy equivalent (a CUDA tensor is pulled to the host), and
decode returns numpy, as in the reference. A bfloat16 tensor behaves as a
bfloat16 ``jax.Array`` does without ``ml_dtypes``: v2 refuses it
(``TypeError``), v1 writes the ``.npy`` the reference writes (descr
``'<V2'``), which decodes as 2-byte void.

Parity: the reference serializes task input/results as JSON written to the
container's INPUT_FILE/OUTPUT_FILE (SURVEY.md §2 item 18), with arrays
and pandas objects in a tagged encoding so federated payloads (model
weights, statistics tables) round-trip without pickle.

Two wire formats share one `serialize`/`deserialize` surface:

- **v1 (json)**: the historical format — UTF-8 JSON, arrays embedded as
  base64'd `.npy` blobs. ~1.78x byte inflation once the cryptor base64s the
  whole thing again, and several full in-memory copies per hop.
- **v2 (binary, default)**: a framed container (docs/wire_format.md)::

      b"V6T\\x02" | u32 header_len (LE) | header JSON | aligned raw buffers

  The header carries the payload STRUCTURE (dicts/lists/scalars plus tagged
  placeholders); every ndarray/bytes leaf's raw bytes land in the buffer
  region, 64-byte aligned, **without base64 and without intermediate
  copies**: encode hands `memoryview`s straight to one final ``join``;
  decode wraps slices with zero-copy ``np.frombuffer`` (the resulting
  arrays are read-only views into the blob). Boundaries that hand arrays
  to algorithm/researcher code pass ``deserialize(..., writable=True)`` to
  materialize one copy with v1's writable ``np.load`` semantics.

``deserialize`` auto-detects the format from the magic, so v1 blobs (old
runs, old peers) always decode. Opt out of v2 with ``V6T_WIRE_FORMAT=v1``
(or per call via ``serialize(..., format="v1")``).

JSON-header semantics match v1 exactly: tuples decode as lists, dict keys
stringify, and ``np.float64`` scalars (a ``float`` subclass) ride as plain
floats on the v1 path. Narrower numpy scalars (``np.float32``,
``np.int64``, ...) are preserved through BOTH formats via the ``npscalar``
tag, and raw ``bytes`` payloads are first-class (``bytes`` tag) so
secure-aggregation key adverts no longer pre-encode by hand.

Every encode/decode also feeds `WIRE_STATS` (bytes + seconds, plus the
cryptor's broadcast dedup hits) — the per-round wire accounting surfaced by
``Federation.task_timing`` and `runtime.metrics`.
"""
from __future__ import annotations

import base64
import io
import json
import os
import struct
import threading
import time
from typing import Any

import numpy as np
import torch

# v2 frame magic: 3 ASCII bytes + format version.
MAGIC_V2 = b"V6T\x02"
_HEADER_LEN = struct.Struct("<I")
_ALIGN = 64  # buffer alignment inside the frame (TPU/XLA-friendly)

DEFAULT_FORMAT_ENV = "V6T_WIRE_FORMAT"
_V1_NAMES = ("v1", "json")
_V2_NAMES = ("v2", "binary")


def normalize_format(fmt: str) -> str:
    """Canonicalize a wire-format name to "v1"/"v2"; ValueError on typos —
    config surfaces (node policies) call this at STARTUP so a bad value
    fails the node, not every task."""
    low = fmt.strip().lower()
    if low in _V1_NAMES:
        return "v1"
    if low in _V2_NAMES:
        return "v2"
    raise ValueError(
        f"unknown wire format {fmt!r} (expected v1|json|v2|binary)"
    )


def default_format() -> str:
    """The process-wide wire format: ``V6T_WIRE_FORMAT`` env (v1|json|
    v2|binary), defaulting to v2."""
    fmt = os.environ.get(DEFAULT_FORMAT_ENV, "")
    if not fmt.strip():
        return "v2"
    try:
        return normalize_format(fmt)
    except ValueError as e:
        raise ValueError(f"{DEFAULT_FORMAT_ENV}: {e}") from e


# ------------------------------------------------------------------ metrics
class WireStats:
    """Thread-safe process-wide wire accounting.

    `serialize`/`deserialize` record bytes + seconds per call; the cryptor's
    broadcast path records how many full AES passes it AVOIDED
    (``broadcast_dedup_hits`` — N-1 per N-recipient broadcast). Snapshot via
    `snapshot()`; bench/metrics consumers diff snapshots around a round.
    """

    _FIELDS = (
        "encode_calls", "encode_bytes", "encode_s",
        "decode_calls", "decode_bytes", "decode_s",
        "broadcasts", "broadcast_recipients", "broadcast_dedup_hits",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0 if not f.endswith("_s") else 0.0)

    def record_encode(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.encode_calls += 1
            self.encode_bytes += int(nbytes)
            self.encode_s += float(seconds)

    def record_decode(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.decode_calls += 1
            self.decode_bytes += int(nbytes)
            self.decode_s += float(seconds)

    def record_broadcast(self, n_recipients: int) -> None:
        with self._lock:
            self.broadcasts += 1
            self.broadcast_recipients += int(n_recipients)
            self.broadcast_dedup_hits += max(0, int(n_recipients) - 1)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


WIRE_STATS = WireStats()


# ------------------------------------------------------------------ tensors
def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy, on the host. bfloat16 has no numpy
    dtype without ``ml_dtypes``: its bits come back as 2-byte void, the
    kind a bfloat16 ``jax.Array`` has, which v2 refuses."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _npy_bytes(arr: np.ndarray, bf16: bool = False) -> bytes:
    """``np.save`` of ``arr``. ``bf16``: ``arr`` holds a bfloat16 tensor's
    bits as 2-byte void, and its header names ``'<V2'``, as ``ml_dtypes``'
    bfloat16 does in the reference, not ``'|V2'``."""
    buf = io.BytesIO()
    if bf16:
        np.save(buf, arr.view(np.int16), allow_pickle=False)
        raw = buf.getvalue()
        end = raw.index(b"\n") + 1  # the header ends the first line
        return (raw[:end].replace(b"'descr': '<i2'", b"'descr': '<V2'", 1)
                + raw[end:])
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


# ----------------------------------------------------------- sparse buffers
class SparseVector:
    """Run-length/index sparse buffer — the v2 wire's first-class sparse
    type (gradient-compression PR, docs/compression.md).

    A flat COO vector: ``indices`` (ascending integer positions into a
    dense ``size``-element vector) and parallel ``values`` (any numeric
    dtype — f32 top-k survivors or int8 quantization codes). Positions not
    listed hold ``fill`` (0 by default — exactly what a dropped top-k
    coordinate means).

    On the v2 wire, indices and values ride as TWO aligned raw buffers
    (zero-copy decode, like ndarrays); on the v1 wire a SparseVector
    densifies to a plain ndarray tag so legacy peers decode it without
    knowing the type exists (``to_dense()`` semantics — the existing
    wire_format capability detection picks which encoding a peer gets).
    Decode validates index bounds: a tampered frame whose indices point
    outside ``[0, size)`` is rejected, never scattered out of bounds.
    """

    __slots__ = ("indices", "values", "size", "fill")

    def __init__(
        self,
        indices: Any,
        values: Any,
        size: int,
        fill: float = 0.0,
    ) -> None:
        indices = np.asarray(indices)
        values = np.asarray(values)
        if indices.ndim != 1 or values.ndim != 1:
            raise ValueError("SparseVector indices/values must be 1-D")
        if indices.dtype.kind not in "iu":
            raise ValueError(
                f"SparseVector indices must be integers, got {indices.dtype}"
            )
        _check_binary_dtype(values.dtype)
        if len(indices) != len(values):
            raise ValueError(
                f"SparseVector length mismatch: {len(indices)} indices vs "
                f"{len(values)} values"
            )
        size = int(size)
        if size < 0:
            raise ValueError("SparseVector size must be >= 0")
        if indices.size and (
            int(indices.min()) < 0 or int(indices.max()) >= size
        ):
            raise ValueError(
                "SparseVector index out of bounds for size "
                f"{size}: [{int(indices.min())}, {int(indices.max())}]"
            )
        self.indices = indices
        self.values = values
        self.size = size
        self.fill = fill

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @property
    def density(self) -> float:
        return self.nnz / self.size if self.size else 0.0

    def wire_nbytes(self) -> int:
        """Exact v2 buffer bytes (indices + values, no alignment/header)."""
        return int(self.indices.nbytes) + int(self.values.nbytes)

    def to_dense(self) -> np.ndarray:
        """Materialize the dense vector (the v1-peer fallback encoding)."""
        out = np.full(self.size, self.fill, dtype=self.values.dtype)
        out[self.indices] = self.values
        return out

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, SparseVector)
            and self.size == other.size
            and self.fill == other.fill
            and self.values.dtype == other.values.dtype
            and np.array_equal(self.indices, other.indices)
            and np.array_equal(self.values, other.values)
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"SparseVector(nnz={self.nnz}, size={self.size}, "
            f"dtype={self.values.dtype})"
        )


# ------------------------------------------------------------- v1 (json)
def _encode_v1(obj: Any) -> Any:
    if isinstance(obj, SparseVector):
        # dense materialization for legacy peers: a v1 consumer decodes a
        # plain ndarray with fill at the dropped positions — semantically
        # the decompressed vector (see compress_flat's layout contract)
        return {
            "__v6t__": "ndarray",
            "data": base64.b64encode(_npy_bytes(obj.to_dense())).decode(
                "ascii"),
        }
    if isinstance(obj, np.generic):
        # preserve the scalar TYPE (np.float32(1.5) must not come back as a
        # 0-d ndarray — satellite fix); np.float64/np.int_ subclasses of
        # python numbers never reach this default hook (json handles them)
        return {
            "__v6t__": "npscalar",
            "dtype": obj.dtype.str,
            "data": base64.b64encode(obj.tobytes()).decode("ascii"),
        }
    if isinstance(obj, np.ndarray):
        return {
            "__v6t__": "ndarray",
            "data": base64.b64encode(_npy_bytes(obj)).decode("ascii"),
        }
    if isinstance(obj, torch.Tensor):
        blob = _npy_bytes(_tensor_to_numpy(obj),
                          bf16=obj.dtype == torch.bfloat16)
        return {
            "__v6t__": "ndarray",
            "data": base64.b64encode(blob).decode("ascii"),
        }
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return {
            "__v6t__": "bytes",
            "data": base64.b64encode(bytes(obj)).decode("ascii"),
        }
    try:
        import pandas as pd

        if isinstance(obj, pd.DataFrame):
            return {"__v6t__": "dataframe", "data": obj.to_json(orient="split")}
        if isinstance(obj, pd.Series):
            return {"__v6t__": "series", "data": obj.to_json(orient="split")}
    except ImportError:  # pragma: no cover
        pass
    raise TypeError(f"not JSON-serializable: {type(obj)}")


def _decode_v1(d: dict[str, Any]) -> Any:
    tag = d.get("__v6t__")
    if tag is None:
        return d
    if tag == "ndarray":
        buf = io.BytesIO(base64.b64decode(d["data"]))
        return np.load(buf, allow_pickle=False)
    if tag == "npscalar":
        raw = base64.b64decode(d["data"])
        return np.frombuffer(raw, dtype=np.dtype(d["dtype"]))[0]
    if tag == "bytes":
        return base64.b64decode(d["data"])
    if tag == "dataframe":
        import pandas as pd

        return pd.read_json(io.StringIO(d["data"]), orient="split")
    if tag == "series":
        import pandas as pd

        return pd.read_json(io.StringIO(d["data"]), orient="split", typ="series")
    raise ValueError(f"unknown payload tag {tag!r}")


# ------------------------------------------------------------- v2 (binary)
def _check_binary_dtype(dtype: np.dtype) -> None:
    if dtype.hasobject or dtype.kind == "V":
        raise TypeError(
            f"dtype {dtype} cannot ride the binary wire (object/void); "
            "convert to a plain numeric/bytes representation first"
        )


def _encode_v2(obj: Any, buffers: list[Any]) -> Any:
    """Payload -> JSON-able header structure; raw buffers appended to
    ``buffers`` as memoryviews (no copies here; a tensor's host copy is
    made here)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        # np.float64 subclasses float, so (exactly like v1's json.dumps) it
        # rides as a plain float; narrower np scalars fall through to the
        # npscalar tag below and keep their dtype
        return obj
    if isinstance(obj, SparseVector):
        # first-class sparse node: indices and values as two aligned raw
        # buffers — zero-copy decode, no densification on the wire
        idx = np.ascontiguousarray(obj.indices)
        vals = np.ascontiguousarray(obj.values)
        buffers.append(memoryview(idx).cast("B") if idx.size else b"")
        buffers.append(memoryview(vals).cast("B") if vals.size else b"")
        return {
            "__v6t__": "sparse",
            "index_buffer": len(buffers) - 2,
            "value_buffer": len(buffers) - 1,
            "index_dtype": idx.dtype.str,
            "value_dtype": vals.dtype.str,
            "size": int(obj.size),
            "fill": float(obj.fill),
        }
    if isinstance(obj, np.generic):
        return {
            "__v6t__": "npscalar",
            "dtype": obj.dtype.str,
            "data": base64.b64encode(obj.tobytes()).decode("ascii"),
        }
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        arr = (_tensor_to_numpy(obj) if isinstance(obj, torch.Tensor)
               else obj)
        _check_binary_dtype(arr.dtype)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        # cast("B") rejects zero-size views; an empty array has no bytes
        buffers.append(memoryview(arr).cast("B") if arr.size else b"")
        return {
            "__v6t__": "ndarray",
            "buffer": len(buffers) - 1,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "order": "C",
        }
    if isinstance(obj, (bytes, bytearray, memoryview)):
        if isinstance(obj, bytes):
            buf: Any = memoryview(obj)
        else:
            mv = memoryview(obj)
            if mv.nbytes == 0:
                buf = b""  # cast("B") rejects zero-size views
            elif mv.c_contiguous:
                buf = mv.cast("B")
            else:
                # sliced/strided view (v1 accepted it via bytes()): one
                # unavoidable copy
                buf = memoryview(mv.tobytes())
        buffers.append(buf)
        return {"__v6t__": "bytes", "buffer": len(buffers) - 1}
    if isinstance(obj, dict):
        return {
            _json_key(k): _encode_v2(v, buffers) for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [_encode_v2(v, buffers) for v in obj]
    try:
        import pandas as pd

        if isinstance(obj, pd.DataFrame):
            return {"__v6t__": "dataframe", "data": obj.to_json(orient="split")}
        if isinstance(obj, pd.Series):
            return {"__v6t__": "series", "data": obj.to_json(orient="split")}
    except ImportError:  # pragma: no cover
        pass
    raise TypeError(f"not wire-serializable: {type(obj)}")


def _json_key(k: Any) -> str:
    """Dict-key coercion with json.dumps semantics, so both wire formats
    agree: True->'true', None->'null', numbers via repr, str verbatim —
    anything else is a TypeError exactly like v1's json.dumps."""
    if isinstance(k, str):
        return k
    if k is True:
        return "true"
    if k is False:
        return "false"
    if k is None:
        return "null"
    if isinstance(k, (int, float)):
        return repr(k) if isinstance(k, float) else str(k)
    raise TypeError(
        f"keys must be str, int, float, bool or None, not {type(k)}"
    )


def _align(offset: int) -> int:
    return (offset + _ALIGN - 1) & ~(_ALIGN - 1)


def _serialize_v2(payload: Any) -> bytes:
    buffers: list[Any] = []
    structure = _encode_v2(payload, buffers)
    lengths = [b.nbytes if isinstance(b, memoryview) else len(b)
               for b in buffers]
    header = json.dumps(
        {"payload": structure, "buffers": lengths},
        separators=(",", ":"),
    ).encode("utf-8")
    parts: list[Any] = [MAGIC_V2, _HEADER_LEN.pack(len(header)), header]
    pos = len(MAGIC_V2) + _HEADER_LEN.size + len(header)
    for buf, n in zip(buffers, lengths):
        aligned = _align(pos)
        if aligned != pos:
            parts.append(b"\x00" * (aligned - pos))
        parts.append(buf)
        pos = aligned + n
    # ONE copy total: join gathers the memoryviews into the output frame.
    return b"".join(parts)


def _decode_v2(node: Any, views: list[memoryview], writable: bool) -> Any:
    if isinstance(node, list):
        return [_decode_v2(v, views, writable) for v in node]
    if not isinstance(node, dict):
        return node
    tag = node.get("__v6t__")
    if tag is None:
        return {k: _decode_v2(v, views, writable) for k, v in node.items()}
    if tag == "ndarray":
        dtype = np.dtype(node["dtype"])
        _check_binary_dtype(dtype)
        mv = views[node["buffer"]]
        arr = np.frombuffer(mv, dtype=dtype).reshape(node["shape"])
        # zero-copy view into the frame, read-only by construction;
        # writable=True materializes one copy (v1 np.load semantics)
        return arr.copy() if writable else arr
    if tag == "sparse":
        idx_dtype = np.dtype(node["index_dtype"])
        if idx_dtype.kind not in "iu":
            raise ValueError(
                f"malformed v2 frame: sparse index dtype {idx_dtype} "
                "is not an integer type"
            )
        val_dtype = np.dtype(node["value_dtype"])
        _check_binary_dtype(val_dtype)
        idx = np.frombuffer(views[node["index_buffer"]], dtype=idx_dtype)
        vals = np.frombuffer(views[node["value_buffer"]], dtype=val_dtype)
        if writable:
            idx, vals = idx.copy(), vals.copy()
        try:
            # the ctor enforces the bounds contract: tampered indices
            # pointing outside [0, size) must die HERE, at decode — never
            # reach a consumer's scatter
            return SparseVector(
                idx, vals, int(node["size"]), fill=node.get("fill", 0.0)
            )
        except ValueError as e:
            raise ValueError(f"malformed v2 frame: {e}") from e
    if tag == "npscalar":
        raw = base64.b64decode(node["data"])
        return np.frombuffer(raw, dtype=np.dtype(node["dtype"]))[0]
    if tag == "bytes":
        return bytes(views[node["buffer"]])
    if tag == "dataframe":
        import pandas as pd

        return pd.read_json(io.StringIO(node["data"]), orient="split")
    if tag == "series":
        import pandas as pd

        return pd.read_json(io.StringIO(node["data"]), orient="split",
                            typ="series")
    raise ValueError(f"unknown payload tag {tag!r}")


def _read_v2_header(raw: bytes) -> tuple[dict[str, Any], int]:
    """Parse a v2 frame's header; returns (header dict, buffer-region
    offset). The single definition of the frame prefix layout — shared by
    `deserialize` and `peek_structure` so they can never diverge."""
    prefix = len(MAGIC_V2) + _HEADER_LEN.size
    if len(raw) < prefix:
        raise ValueError("malformed v2 frame: truncated before header")
    (hlen,) = _HEADER_LEN.unpack(raw[len(MAGIC_V2):prefix])
    if len(raw) < prefix + hlen:
        raise ValueError("malformed v2 frame: truncated header")
    try:
        header = json.loads(raw[prefix:prefix + hlen])
        header["payload"], header["buffers"]  # required keys
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"malformed v2 frame header: {e}") from e
    return header, prefix + hlen


def _deserialize_v2(blob: bytes, writable: bool) -> Any:
    header, pos = _read_v2_header(blob)
    mv = memoryview(blob)
    views: list[memoryview] = []
    for n in header["buffers"]:
        off = _align(pos)
        if mv.nbytes < off + n:
            raise ValueError("malformed v2 frame: truncated buffer region")
        views.append(mv[off:off + n])
        pos = off + n
    return _decode_v2(header["payload"], views, writable)


# ---------------------------------------------------------------- public API
def _normalize_blob(blob: bytes | bytearray | memoryview | str) -> bytes:
    if isinstance(blob, str):
        return blob.encode("utf-8")
    if isinstance(blob, (bytearray, memoryview)):
        return bytes(blob)
    return blob


def serialize(payload: Any, format: str | None = None) -> bytes:
    """Payload -> wire bytes. ``format``: "v1"/"json", "v2"/"binary", or
    None to follow ``V6T_WIRE_FORMAT`` (default v2)."""
    fmt = default_format() if format is None else normalize_format(format)
    t0 = time.perf_counter()
    if fmt == "v2":
        blob = _serialize_v2(payload)
    else:
        blob = json.dumps(payload, default=_encode_v1).encode("utf-8")
    WIRE_STATS.record_encode(len(blob), time.perf_counter() - t0)
    return blob


def deserialize(
    blob: bytes | bytearray | memoryview | str, writable: bool = False
) -> Any:
    """Wire bytes -> payload; the format is auto-detected (v2 magic, else
    v1 JSON), so old blobs and old peers keep decoding.

    ``writable=False`` (default) decodes v2 arrays as zero-copy read-only
    views into the blob — the fast path for relays and read-only consumers.
    ``writable=True`` materializes one copy per array (v1 ``np.load``
    semantics); every boundary that hands arrays to third-party algorithm
    code (wrap.py INPUT_FILE, the sandbox OUTPUT_FILE harvest, the node
    daemon's input decode, client result fetches) passes it so in-place
    ``weights += delta`` keeps working exactly as under v1.
    """
    t0 = time.perf_counter()
    raw = _normalize_blob(blob)
    if raw[: len(MAGIC_V2)] == MAGIC_V2:
        out = _deserialize_v2(raw, writable)
    else:
        out = json.loads(raw.decode("utf-8"), object_hook=_decode_v1)
    WIRE_STATS.record_decode(len(raw), time.perf_counter() - t0)
    return out


def peek_structure(blob: bytes | bytearray | memoryview | str) -> Any:
    """The JSON-level structure of a wire blob WITHOUT materializing any
    array buffers: v2 -> the frame's header structure (tagged leaves stay
    as placeholder dicts), v1 -> plain ``json.loads`` with no object hook
    (base64 array strings stay strings). For relays that only need a
    metadata field (e.g. the proxy reading ``input_["method"]``) — decoding
    a 10 MiB weight payload to read one string is the old bug this avoids.
    Not recorded in WIRE_STATS (nothing payload-sized is touched)."""
    raw = _normalize_blob(blob)
    if raw[: len(MAGIC_V2)] == MAGIC_V2:
        return _read_v2_header(raw)[0]["payload"]
    return json.loads(raw.decode("utf-8"))


def wire_nbytes(payload: Any) -> int | None:
    """Cheap on-wire size estimate of ``payload`` in the v2 format — array
    and bytes leaves by exact ``nbytes`` WITHOUT touching (or device->host
    transferring) their data, structure by JSON length, DataFrames by
    in-memory column footprint. None when the payload holds something the
    wire cannot carry (host-mode in-process results may be arbitrary
    objects). Used by the run-lifecycle wire accounting so straggler
    analysis can tell compute-bound from transfer-bound stations.

    Sparse/quantized buffers are sized by what actually rides the wire:
    a `SparseVector` counts its index + value buffers (NOT the dense
    ``size * itemsize`` it stands for), and int8 quantization codes count
    one byte per element via their real ``nbytes`` — so
    ``Run.input/result_wire_bytes`` and ``metrics.wire_totals`` stay
    truthful under compression.
    """
    try:
        total = 0

        def walk(obj: Any) -> Any:
            nonlocal total
            if obj is None or isinstance(obj, (bool, int, float, str)):
                return obj
            if isinstance(obj, SparseVector):
                # two aligned buffers + the sparse header node — never the
                # dense footprint this vector REPLACES on the wire
                total += _align(int(obj.indices.nbytes))
                total += _align(int(obj.values.nbytes))
                total += 128  # header node (tag, dtypes, size, buffer ids)
                return 0
            if isinstance(obj, np.generic):
                total += int(obj.dtype.itemsize) + 32
                return 0
            if isinstance(obj, (bytes, bytearray, memoryview)):
                total += _align(len(obj))
                return 0
            if isinstance(obj, dict):
                return {str(k): walk(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [walk(v) for v in obj]
            nbytes = getattr(obj, "nbytes", None)
            shape = getattr(obj, "shape", None)
            if nbytes is not None and shape is not None:
                # ndarray / tensor (possibly on the card): size from
                # metadata only — never a host copy here
                total += _align(int(nbytes)) + 64
                return 0
            try:
                import pandas as pd

                if isinstance(obj, (pd.DataFrame, pd.Series)):
                    total += int(obj.memory_usage(deep=False).sum()) \
                        if hasattr(obj, "memory_usage") else 0
                    return 0
            except ImportError:  # pragma: no cover
                pass
            raise TypeError(type(obj))

        skeleton = walk(payload)
        total += len(json.dumps(skeleton, separators=(",", ":"),
                                default=str))
        total += len(MAGIC_V2) + _HEADER_LEN.size
        return int(total)
    except (TypeError, ValueError):
        return None
