"""Gradient compression of the per-station delta uplink, on the device.

Counterpart of the device half of ``vantage6_tpu/fed/compression.py``: one
composable ``CompressorSpec`` applied to flat per-station deltas at the
flat-pack seam of ``fed.collectives``:

- **stochastic int8 quantization** with one f32 scale per ``chunk``
  elements and unbiased rounding, ``q = floor(x / scale + u)`` with
  ``u ~ U[0, 1)``, so ``E[q * scale] == x``;
- **top-k sparsification**: the ``k = topk_ratio * n`` largest magnitudes
  survive, their positions ride as an ascending int32 index vector;
- **error feedback**: each station keeps what compression threw away and
  adds it to its next delta before compressing; ``new_ef = acc - hat``
  holds exactly.

Composition order, as in the JAX package: error feedback, then the
``comm_dtype`` cast, then top-k, then int8. Under top-k the int8 scales are
laid out over the dense vector, and a survivor at position ``i``
dequantizes with ``scales[i // chunk]``.

Every function works on a vector ``[n]`` or on a batch ``[..., n]`` with
batched ops (``compress_stacked`` is ``[S, n]``: no per-station loop, which
is what the JAX package's ``vmap`` does). The rounding noise ``u`` is drawn
from a ``torch.Generator`` (jax.random's stream cannot be reproduced), and
every function that draws it also takes it injected as ``noise``, the
padded ``[..., ceil(n / chunk) * chunk]`` uniforms; that is how the parity
tests feed both packages the same draws. Top-k breaks ties by index, the
lower index first, as ``jax.lax.top_k`` does, so the survivors match the
JAX package's on any input.

The host and wire half (below the device ops) follows the JAX module:
``compress_delta``/``decompress_delta`` run the ops as the observed
functions ``compress.delta``/``compress.reconstruct`` inside
``device.compress``/``device.decompress`` spans (synchronised on the card,
so a span covers the device work) and feed the ``v6t_compress_*`` series;
``payload_to_wire``/``wire_to_payload`` carry a payload over
``common.serialization``'s v2 wire as a ``SparseVector``, frames the JAX
package decodes and the other way round, with the same checks on an
untrusted peer's payload; ``DeltaCompressor`` keeps named error-feedback
accumulators for the host-plane exchange (``Federation.compress_update``).
A station's delta stays where it lives: CUDA leaves are flattened and
compressed on the card, and only the payload (indices, int8 codes,
scales) is pulled to the host for the wire. The host plane walks trees in
dict insertion order (the skeleton's order), not ``_tree``'s sorted order.
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from vantage6_tpu_torch.common.serialization import SparseVector
from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.core.mesh import resolve_device
from vantage6_tpu_torch.runtime.profiling import observed_jit as _observed

Pytree = Any

# wire payload marker: decompress_delta recognizes payloads by this key so
# a pass-through (no compressor) tree is returned unchanged
WIRE_TAG = "v6t.compressed"
_WIRE_VERSION = 1

# a generator on the tensor's device, or the seed of a fresh one
Key = torch.Generator | int


@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    """One composable compressor configuration.

    ``topk_ratio``: fraction of delta entries kept (None = dense).
    ``int8``: stochastic int8 quantization of the (kept) values.
    ``chunk``: elements sharing one quantization scale.
    ``error_feedback``: per-station accumulators re-injecting compression
    error into the next round's delta (keep on unless ablating).
    """

    topk_ratio: float | None = None
    int8: bool = False
    chunk: int = 256
    error_feedback: bool = True

    def validate(self) -> None:
        if self.topk_ratio is not None and not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError(
                f"topk_ratio must be in (0, 1], got {self.topk_ratio}"
            )
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")

    @property
    def identity(self) -> bool:
        """True when this spec compresses nothing (dense f32 pass-through)."""
        return self.topk_ratio is None and not self.int8

    def k_for(self, n: int) -> int:
        """Survivor count for an n-element delta."""
        if self.topk_ratio is None:
            return n
        return max(1, min(n, int(round(self.topk_ratio * n))))

    def wire_nbytes(self, n: int) -> int:
        """On-wire bytes of one station's compressed n-element delta
        (metadata only)."""
        if self.identity:
            return 4 * n
        k = self.k_for(n)
        total = 0
        if self.topk_ratio is not None:
            total += 4 * k  # int32 index buffer
        if self.int8:
            # k int8 codes, and one f32 scale per dense chunk
            total += k + 4 * math.ceil(n / self.chunk)
        else:
            total += 4 * k  # f32 values
        return total

    def ratio(self, n: int) -> float:
        """Dense-f32 bytes / compressed bytes for an n-element delta."""
        return 4.0 * n / max(1, self.wire_nbytes(n))


def _chunk_pad(n: int, chunk: int) -> tuple[int, int]:
    """(n_chunks, pad) for an n-element vector at this chunk size."""
    c = -(-n // chunk)
    return c, c * chunk - n


def noise_size(spec: CompressorSpec, n: int) -> int:
    """Rounding uniforms one station draws for an n-element delta: the
    padded length ``ceil(n / chunk) * chunk`` with int8, else 0."""
    if not spec.int8:
        return 0
    c, _ = _chunk_pad(n, spec.chunk)
    return c * spec.chunk


def draw_noise(key: Key, shape: tuple[int, ...],
               device: torch.device) -> torch.Tensor:
    """``u ~ U[0, 1)`` f32 of ``shape`` on ``device`` from ``key``."""
    if isinstance(key, int):
        key = torch.Generator(device=device).manual_seed(key)
    return torch.rand(shape, generator=key, device=device)


def quantize_int8(
    x: torch.Tensor,
    key: Key | None,
    chunk: int,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic int8 quantization with per-chunk scale, over the last
    axis of ``x`` ``[..., n]``.

    Returns ``(q int8 [..., n], scales f32 [..., ceil(n / chunk)])`` with
    ``scale_c = max(|x_c|) / 127`` and ``q = floor(x / scale + u)`` clipped
    to [-127, 127]; an all-zero chunk quantizes to zeros at scale 0. ``u``
    is ``noise`` (``[..., ceil(n / chunk) * chunk]``) or drawn with
    ``key``.
    """
    n = x.shape[-1]
    lead = tuple(x.shape[:-1])
    c, pad = _chunk_pad(n, chunk)
    xp = F.pad(x, (0, pad)).reshape(lead + (c, chunk))
    scales = torch.amax(torch.abs(xp), dim=-1) / 127.0
    s = scales.unsqueeze(-1)
    scaled = torch.where(s > 0, xp / s, torch.zeros((), dtype=xp.dtype,
                                                    device=xp.device))
    if noise is None:
        if key is None:
            raise ValueError("int8 quantization needs a key or noise")
        u = draw_noise(key, tuple(xp.shape), x.device)
    else:
        u = noise.reshape(xp.shape)
    q = torch.clamp(torch.floor(scaled + u), -127, 127).to(torch.int8)
    return q.reshape(lead + (c * chunk,))[..., :n], scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """Inverse of ``quantize_int8`` (exact given the same scales)."""
    n = q.shape[-1]
    lead = tuple(q.shape[:-1])
    c, pad = _chunk_pad(n, chunk)
    qp = F.pad(q, (0, pad)).reshape(lead + (c, chunk)).to(torch.float32)
    return (qp * scales.unsqueeze(-1)).reshape(lead + (c * chunk,))[..., :n]


def topk_sparsify(x: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices (int32, ascending) and values of the k largest-|x| entries
    along the last axis. Equal magnitudes keep the lower index first, as
    ``jax.lax.top_k`` does: a stable descending sort."""
    order = torch.sort(torch.abs(x), dim=-1, descending=True,
                       stable=True).indices[..., :k]
    idx = torch.sort(order, dim=-1).values
    return idx.to(torch.int32), torch.gather(x, -1, idx)


def compress_flat(
    spec: CompressorSpec,
    flat: torch.Tensor,
    key: Key | None,
    noise: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """flat ``[..., n]`` -> payload dict: ``indices`` (top-k), then
    ``q`` + ``scales`` (int8) or ``values``. With int8 the scales cover the
    dense vector and top-k selects dense-position codes."""
    payload: dict[str, torch.Tensor] = {}
    x = flat.to(torch.float32)
    n = x.shape[-1]
    if spec.int8:
        q, scales = quantize_int8(x, key, spec.chunk, noise=noise)
        payload["scales"] = scales
        if spec.topk_ratio is not None:
            idx, _ = topk_sparsify(x, spec.k_for(n))
            payload["indices"] = idx
            payload["q"] = torch.gather(q, -1, idx.to(torch.int64))
        else:
            payload["q"] = q
    elif spec.topk_ratio is not None:
        idx, vals = topk_sparsify(x, spec.k_for(n))
        payload["indices"] = idx
        payload["values"] = vals
    else:
        payload["values"] = x
    return payload


def decompress_flat(spec: CompressorSpec, payload: dict[str, torch.Tensor],
                    n: int) -> torch.Tensor:
    """Payload -> dense f32 ``[..., n]``, bit-identical to the ``hat`` the
    compressor fed its error-feedback update."""
    if spec.topk_ratio is not None:
        idx = payload["indices"].to(torch.int64)
        if spec.int8:
            scale = torch.gather(payload["scales"], -1, idx // spec.chunk)
            vals = payload["q"].to(torch.float32) * scale
        else:
            vals = payload["values"].to(torch.float32)
        out = torch.zeros(tuple(idx.shape[:-1]) + (n,), dtype=torch.float32,
                          device=idx.device)
        return out.scatter_(-1, idx, vals)
    if spec.int8:
        return dequantize_int8(payload["q"], payload["scales"], spec.chunk)
    return payload["values"].to(torch.float32)


def compress_with_feedback(
    spec: CompressorSpec,
    flat: torch.Tensor,
    ef: torch.Tensor | None,
    key: Key | None,
    cast_dtype: torch.dtype | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Error-feedback re-injection -> optional ``cast_dtype`` narrowing
    (cast, then quantize) -> compress -> exact error-feedback update.

    Returns ``(payload, hat, new_ef)``: ``hat`` is the dense decompressed
    delta (what the server reconstructs) and ``new_ef = acc - hat``
    exactly; with ``error_feedback=False`` new_ef is zero."""
    x = flat.to(torch.float32)
    acc = x + ef if (spec.error_feedback and ef is not None) else x
    wire_val = acc if cast_dtype is None else acc.to(cast_dtype).to(
        torch.float32)
    payload = compress_flat(spec, wire_val, key, noise=noise)
    hat = decompress_flat(spec, payload, x.shape[-1])
    new_ef = acc - hat if spec.error_feedback else torch.zeros_like(acc)
    return payload, hat, new_ef


def compress_stacked(
    spec: CompressorSpec,
    flat: torch.Tensor,        # [S, n] per-station flat deltas
    ef: torch.Tensor,          # [S, n] per-station error-feedback accumulators
    keys: Key | None,          # draws every station's noise in one call
    cast_dtype: torch.dtype | None = None,
    noise: torch.Tensor | None = None,  # [S, noise_size(spec, n)]
) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Every station's compress step as batched ops over the ``[S, n]``
    matrix: each row has its own noise, scales, survivors and accumulator.
    Returns stacked (payload, hat [S, n], new_ef [S, n])."""
    return compress_with_feedback(spec, flat, ef, keys,
                                  cast_dtype=cast_dtype, noise=noise)


def ef_norm(ef: torch.Tensor) -> torch.Tensor:
    """L2 norm of an error-feedback accumulator, on the device."""
    e = ef.to(torch.float32)
    return torch.sqrt(torch.sum(e * e))


# ----------------------------------------------------------- host-level API
# the device ops as observed functions: a caller whose delta length
# wobbles from call to call shows up as a named retrace
_compress_obs = _observed(
    "compress.delta", compress_with_feedback,
    static_argnums=(0,), static_argnames=("cast_dtype",),
)
_decompress_obs = _observed(
    "compress.reconstruct", decompress_flat, static_argnums=(0, 2),
)


def _record_compress_telemetry(spec: CompressorSpec, n: int, count: int = 1):
    raw = 4 * n * count
    wire = spec.wire_nbytes(n) * count
    REGISTRY.counter("v6t_compress_calls_total").inc(count)
    REGISTRY.counter("v6t_compress_raw_bytes_total").inc(raw)
    REGISTRY.counter("v6t_compress_wire_bytes_total").inc(wire)
    REGISTRY.gauge("v6t_compress_ratio").set(raw / max(1, wire))


def record_round_telemetry(
    spec: CompressorSpec, n: int, n_stations: int, rounds: int = 1
) -> None:
    """Account an engine round's delta exchange (every station uplinks one
    compressed n-element delta per round) in the ``v6t_compress_*`` series.
    Host-side and metadata-only."""
    _record_compress_telemetry(spec, n, count=n_stations * rounds)


def fused_wire_plan(
    spec: CompressorSpec | None, n: int, n_stations: int, n_rounds: int
) -> dict[str, Any]:
    """Static wire accounting for one fused K-round dispatch: total raw vs
    on-wire delta-uplink bytes over all ``n_rounds`` rounds, and the host
    pulls the fusion saves (one per dispatch instead of one per round).
    Metadata-only; ``spec=None`` (or an identity compressor) accounts the
    dense case."""
    wire_each = (
        4 * n if spec is None or spec.identity else spec.wire_nbytes(n)
    )
    raw = 4 * n * n_stations * n_rounds
    wire = wire_each * n_stations * n_rounds
    return {
        "n_params": n,
        "n_rounds": n_rounds,
        "raw_bytes": raw,
        "wire_bytes": wire,
        "reduction": round(4.0 * n / max(1, wire_each), 2),
        "host_pulls": 1,
        "host_pulls_sequential": n_rounds,
    }


def _sync(t: torch.Tensor) -> None:
    """Wait for the card's work on ``t`` (a span must cover it)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _as_f32(x: Any, device: torch.device) -> torch.Tensor:
    """``x`` as an f32 tensor: a tensor stays on its device, anything else
    is placed on ``device``. A read-only numpy array (a zero-copy wire
    view) is copied first."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.require(x, np.float32, "W"), device=device)


def compress_delta(
    spec: CompressorSpec,
    flat: Any,
    ef: Any = None,
    key: Key | None = None,
    cast_dtype: torch.dtype | None = None,
    station: int | None = None,
    noise: Any = None,
    device: str | torch.device | None = None,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Host-level compress of one flat delta: ``compress_with_feedback``
    recorded as a ``device.compress`` span (no-op outside a trace) and
    counted in telemetry. A tensor ``flat`` is compressed where it lives;
    anything else is placed on ``device`` (CUDA unless ``"cpu"`` is asked
    for).

    Returns ``(payload, hat, new_ef)`` on that device. The int8 rounding
    noise is ``noise`` (``[ceil(n / chunk) * chunk]`` uniforms), or drawn
    with ``key`` (a generator or a seed); ``key=None`` is the fixed seed 0
    (deterministic: fine for tests, wrong for production unbiasedness;
    pass a fresh key per exchange)."""
    from vantage6_tpu_torch.runtime.tracing import TRACER

    dev = flat.device if isinstance(flat, torch.Tensor) else resolve_device(
        device)
    flat = _as_f32(flat, dev)
    n = flat.shape[0]
    ef = torch.zeros_like(flat) if ef is None else _as_f32(ef, dev).to(dev)
    if noise is not None:
        noise = _as_f32(noise, dev).to(dev)
    elif key is None:
        key = 0
    attrs = {
        "n": int(n),
        "raw_bytes": 4 * int(n),
        "wire_bytes": spec.wire_nbytes(int(n)),
    }
    if station is not None:
        attrs["station"] = int(station)
    with TRACER.span(
        "device.compress", kind="device", attrs=attrs, require_parent=True,
    ):
        payload, hat, new_ef = _compress_obs(
            spec, flat, ef, key, cast_dtype=cast_dtype, noise=noise)
        _sync(hat)  # the span must cover the device work
    _record_compress_telemetry(spec, int(n))
    REGISTRY.gauge("v6t_compress_ef_norm").set(float(ef_norm(new_ef)))
    return payload, hat, new_ef


def decompress_delta(
    spec: CompressorSpec, payload: dict[str, Any], n: int,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Host-level decompress (server side) to the dense f32 ``[n]``,
    recorded as a ``device.decompress`` span and counted in telemetry. A
    payload of tensors is decompressed on their device; one of host
    arrays (a decoded wire frame) on ``device`` (CUDA unless ``"cpu"`` is
    asked for)."""
    from vantage6_tpu_torch.runtime.tracing import TRACER

    tensors = [v for v in payload.values() if isinstance(v, torch.Tensor)]
    dev = (resolve_device(device) if device is not None or not tensors
           else tensors[0].device)

    def place(v: Any) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        return torch.as_tensor(np.require(v, requirements="W"), device=dev)

    with TRACER.span(
        "device.decompress", kind="device",
        attrs={"n": int(n), "wire_bytes": spec.wire_nbytes(int(n))},
        require_parent=True,
    ):
        dense = _decompress_obs(
            spec, {k: place(v) for k, v in payload.items()}, int(n))
        _sync(dense)
    REGISTRY.counter("v6t_decompress_calls_total").inc()
    return dense


# -------------------------------------------------------------- wire format
def _host(x: Any) -> np.ndarray:
    """A payload array on the host: a tensor is copied off its device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def payload_to_wire(
    spec: CompressorSpec, payload: dict[str, Any], n: int
) -> dict[str, Any]:
    """Device payload -> wire-serializable dict, as the JAX package writes
    it: the top-k half becomes a first-class ``SparseVector`` (indices +
    int8/f32 values over the dense length), scales and metadata ride
    beside it. Only these arrays leave the card. Legacy v1 peers densify
    the SparseVector automatically (serialization's dense fallback)."""
    out: dict[str, Any] = {
        WIRE_TAG: _WIRE_VERSION,
        "n": int(n),
        "spec": {
            "topk_ratio": spec.topk_ratio,
            "int8": spec.int8,
            "chunk": spec.chunk,
        },
    }
    if spec.topk_ratio is not None:
        vals = payload["q"] if spec.int8 else payload["values"]
        out["sparse"] = SparseVector(
            _host(payload["indices"]), _host(vals), int(n)
        )
    elif spec.int8:
        out["q"] = _host(payload["q"])
    else:
        out["values"] = _host(payload["values"])
    if spec.int8:
        out["scales"] = _host(payload["scales"])
    return out


def spec_from_wire(wire: dict[str, Any]) -> CompressorSpec:
    """Reconstruct the (quantization-relevant) spec a wire payload was
    compressed under: the server must dequantize with the SENDER's
    parameters, not its own config."""
    s = wire.get("spec", {})
    spec = CompressorSpec(
        topk_ratio=s.get("topk_ratio"),
        int8=bool(s.get("int8", False)),
        chunk=int(s.get("chunk", 256)),
    )
    spec.validate()
    return spec


def is_wire_payload(obj: Any) -> bool:
    return isinstance(obj, dict) and WIRE_TAG in obj


# Decompression allocates a dense [n] f32 vector from a payload that can
# be much smaller than n: an UNTRUSTED peer must not turn a 100-byte frame
# into a terabyte allocation. The cap (2**28 elements = 1 GiB f32) is
# overridable for larger models.
_MAX_ELEMENTS_ENV = "V6T_COMPRESS_MAX_ELEMENTS"
_DEFAULT_MAX_ELEMENTS = 2**28


def _max_elements() -> int:
    raw = os.environ.get(_MAX_ELEMENTS_ENV, "")
    try:
        return int(raw) if raw.strip() else _DEFAULT_MAX_ELEMENTS
    except ValueError:
        return _DEFAULT_MAX_ELEMENTS


def wire_to_payload(
    wire: dict[str, Any],
) -> tuple[CompressorSpec, dict[str, Any], int]:
    """Wire dict -> (spec, payload of host arrays, n) for
    :func:`decompress_delta`.

    Tolerates the v1 dense fallback: a frame a legacy peer re-encoded
    dense (SparseVector -> ndarray) decompresses as a non-sparse payload,
    bit for bit, because the int8 scales are laid out over the dense
    vector.

    VALIDATES the peer-supplied metadata before anything allocates: ``n``
    is capped (``V6T_COMPRESS_MAX_ELEMENTS``), a sparse half must span
    exactly ``n``, dense halves must carry exactly ``n`` values, int8
    payloads exactly ``ceil(n / chunk)`` scales, and missing fields raise
    ValueError, never KeyError. The sparse decode itself rejects indices
    outside ``[0, n)``.
    """
    if not is_wire_payload(wire):
        raise ValueError("not a v6t compressed delta payload")
    spec = spec_from_wire(wire)
    try:
        n = int(wire["n"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed compressed payload: bad n ({e!r})") from e
    if n < 0 or n > _max_elements():
        raise ValueError(
            f"malformed compressed payload: n={n} outside [0, "
            f"{_max_elements()}] (raise {_MAX_ELEMENTS_ENV} for larger "
            "models)"
        )

    def field(key: str) -> Any:
        if key not in wire:
            raise ValueError(
                f"malformed compressed payload: missing {key!r}"
            )
        return wire[key]

    payload: dict[str, Any] = {}
    if spec.topk_ratio is not None:
        sp = field("sparse")
        if isinstance(sp, SparseVector):
            if sp.size != n:
                raise ValueError(
                    "malformed compressed payload: sparse size "
                    f"{sp.size} != n {n}"
                )
            payload["indices"] = sp.indices
            payload["q" if spec.int8 else "values"] = sp.values
        else:
            # densified by a legacy v1 hop: the values already sit at their
            # dense positions and the scales are dense-layout, so the
            # payload decompresses as a non-sparse one bit for bit
            spec = dataclasses.replace(spec, topk_ratio=None)
            if spec.int8:
                payload["q"] = np.asarray(sp, np.int8)
            else:
                payload["values"] = np.asarray(sp, np.float32)
    elif spec.int8:
        payload["q"] = np.asarray(field("q"))
    else:
        payload["values"] = np.asarray(field("values"))
    for key, want in (("q", n), ("values", n)):
        if key in payload and spec.topk_ratio is None and len(
            payload[key]
        ) != want:
            raise ValueError(
                f"malformed compressed payload: {key} carries "
                f"{len(payload[key])} values, expected {want}"
            )
    if spec.int8:
        payload["scales"] = np.asarray(field("scales"))
        want = -(-n // spec.chunk)
        if len(payload["scales"]) != want:
            raise ValueError(
                "malformed compressed payload: "
                f"{len(payload['scales'])} scales, expected {want}"
            )
    return spec, payload, n


def decompress_wire_tree(
    payload: Any, device: str | torch.device | None = None,
) -> Any:
    """Wire payload -> dense update tree on ``device`` (CUDA unless
    ``"cpu"`` is asked for); anything that is NOT a compressed delta
    passes through unchanged (mixed compressed/plain result lists fold
    uniformly). The spec rides the wire, so the receiver needs no
    configuration. Without a skeleton the dense flat vector is
    returned."""
    if not is_wire_payload(payload):
        return payload
    spec, host_payload, n = wire_to_payload(payload)
    flat = decompress_delta(spec, host_payload, n,
                            device=resolve_device(device))
    skeleton = payload.get("skeleton")
    if skeleton is None:
        return flat
    return rebuild_from_skeleton(skeleton, flat)


class DeltaCompressor:
    """Stateful compression endpoint: one spec + named error-feedback
    accumulators (the host-plane exchange behind
    ``Federation.compress_update``).

    The accumulators live in THIS process, on the device of the deltas
    they were fed. ``device`` is where trees without tensor leaves are
    compressed and where :meth:`decompress` reconstructs (CUDA unless
    ``"cpu"`` is asked for).
    """

    def __init__(self, spec: CompressorSpec,
                 device: str | torch.device | None = None):
        spec.validate()
        self.spec = spec
        self.device = resolve_device(device)
        self._ef: dict[str, torch.Tensor] = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._name_locks: dict[str, threading.Lock] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # per-INSTANCE entropy for the stochastic-rounding stream: N
        # station processes must not draw the same noise per coordinate,
        # or their rounding errors correlate and the cross-station average
        # stops shrinking as 1/N
        self._seed = int.from_bytes(os.urandom(4), "little")

    def generator(self, seq: int, device: torch.device) -> torch.Generator:
        """The rounding-noise generator of exchange ``seq`` on ``device``,
        the counterpart of the JAX package's ``fold_in(key(seed), seq)``:
        seeded with ``splitmix64((seed << 32) | seq)``, so every bit of
        both reaches the low 32 bits (all a CPU generator keeps)."""
        m = (1 << 64) - 1
        z = (((self._seed << 32) | (seq & 0xFFFFFFFF))
             + 0x9E3779B97F4A7C15) & m
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        return torch.Generator(device=device).manual_seed(z ^ (z >> 31))

    def compress(
        self, tree: Pytree, name: str = "update",
        station: int | None = None,
    ) -> Any:
        if self.spec.identity:
            return tree
        skeleton = tree_skeleton(tree)
        flat = flatten_host(tree, device=self.device)
        n = int(flat.numel())
        # the EF update is a read-compute-write cycle: a PER-NAME mutex
        # serializes the exchanges that share an accumulator (else two
        # concurrent compresses re-inject the same error mass); _lock
        # stays bookkeeping-only
        with self._lock:
            name_lock = self._name_locks.setdefault(name, threading.Lock())
        with name_lock:
            with self._lock:
                ef = self._ef.get(name)
                seq = self._seq
                self._seq += 1
            if ef is None or tuple(ef.shape) != (n,):
                ef = None  # first exchange (or a reshaped model): fresh EF
            payload, _, new_ef = compress_delta(
                self.spec, flat, ef, key=self.generator(seq, flat.device),
                station=station,
            )
            with self._lock:
                self._ef[name] = new_ef
        wire = payload_to_wire(self.spec, payload, n)
        wire["skeleton"] = skeleton
        return wire

    def decompress(self, payload: Any) -> Any:
        return decompress_wire_tree(payload, device=self.device)


def spec_from_env(environ: Any = None) -> CompressorSpec | None:
    """Build a CompressorSpec from ``V6T_COMPRESS`` (None when unset/off).

    Format: comma-separated knobs — ``topk=0.1``, ``int8``, ``chunk=256``,
    ``no-ef`` — e.g. ``V6T_COMPRESS=topk=0.1,int8``; ``off``/empty
    disables. A malformed value raises at startup, not per task.
    """
    raw = (environ or os.environ).get("V6T_COMPRESS", "").strip()
    if not raw or raw.lower() == "off":
        return None
    kw: dict[str, Any] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if part == "int8":
            kw["int8"] = True
        elif part == "no-ef":
            kw["error_feedback"] = False
        elif part.startswith("topk="):
            kw["topk_ratio"] = float(part[5:])
        elif part.startswith("chunk="):
            kw["chunk"] = int(part[6:])
        else:
            raise ValueError(
                f"V6T_COMPRESS: unknown knob {part!r} "
                "(expected topk=F, int8, chunk=N, no-ef)"
            )
    spec = CompressorSpec(**kw)
    spec.validate()
    return spec


# -------------------------------------------------- pytree <-> flat helpers
# The host plane flat-packs by walking the tree in SKELETON order (dict
# insertion order), not _tree's sorted order, so the skeleton the wire
# carries and the flat vector always agree.


def flatten_host(tree: Pytree,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """Concatenate every leaf (skeleton walk order) into one flat f32
    vector on the tensor leaves' device; a tree without tensor leaves is
    placed on ``device`` (the CPU when None)."""
    parts: list[torch.Tensor] = []

    def walk(obj: Any) -> None:
        if isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
        elif isinstance(obj, torch.Tensor):
            parts.append(obj.detach().reshape(-1).to(torch.float32))
        else:
            parts.append(torch.from_numpy(
                np.array(obj, np.float32).reshape(-1)))

    walk(tree)
    if not parts:
        raise ValueError("empty pytree")
    on = [p.device for p in parts if p.device.type != "cpu"]
    dev = on[0] if on else torch.device(device or "cpu")
    parts = [p.to(dev) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _dtype_name(x: Any) -> str:
    """A leaf's skeleton dtype string: numpy's (``'<f4'``), or the NAME
    for a type numpy lacks (``'bfloat16'``), as the JAX package writes
    an ml_dtypes leaf."""
    if isinstance(x, torch.Tensor):
        try:
            return torch.empty(0, dtype=x.dtype).numpy().dtype.str
        except TypeError:
            return str(x.dtype).replace("torch.", "")
    dt = np.asarray(x).dtype
    return dt.name if dt.kind == "V" else dt.str


def tree_skeleton(tree: Pytree) -> Any:
    """JSON-able structure of ``tree`` with each leaf replaced by a
    ``{"__leaf__", "shape", "dtype"}`` placeholder, in SKELETON walk order
    (dict insertion order; pair only with ``flatten_host``).

    Container fidelity: tuples ride a ``{"__v6t_tuple__": [...]}`` marker
    so the round trip gives tuples back. NamedTuples cannot survive a JSON
    hop and are rejected loudly instead of silently downgraded.
    """
    counter = [0]

    def walk(obj: Any) -> Any:
        if isinstance(obj, dict):
            return {k: walk(obj[k]) for k in obj}
        if isinstance(obj, tuple):
            if hasattr(obj, "_fields"):
                raise TypeError(
                    "NamedTuple containers cannot ride the compression "
                    "wire (the class cannot be reconstructed from JSON); "
                    "convert to a dict first"
                )
            return {"__v6t_tuple__": [walk(v) for v in obj]}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        shape = (obj.shape if isinstance(obj, torch.Tensor)
                 else np.shape(obj))
        node = {
            "__leaf__": counter[0],
            "shape": [int(d) for d in shape],
            "dtype": _dtype_name(obj),
        }
        counter[0] += 1
        return node

    return walk(tree)


def _resolve_dtype(s: str) -> torch.dtype:
    """Skeleton dtype string -> torch dtype: numpy's own strings, or a
    name numpy lacks (``bfloat16``, ``float8_*``) as torch's dtype of that
    name. A void result means the string lost its meaning, which must fail
    loud, never silently reinterpret bytes."""
    try:
        dt = np.dtype(s)
        if dt.kind != "V":
            return torch.from_numpy(np.empty(0, dt)).dtype
    except TypeError:
        pass
    dtype = getattr(torch, s, None)
    if isinstance(dtype, torch.dtype):
        return dtype
    raise ValueError(f"cannot reconstruct leaf dtype {s!r} from the skeleton")


def rebuild_from_skeleton(skeleton: Any, flat: Any) -> Any:
    """Inverse of :func:`tree_skeleton` + flat-pack: split ``flat`` back
    into the skeleton's leaf shapes and dtypes, as tensors on ``flat``'s
    device (a numpy ``flat`` gives CPU tensors)."""
    if not isinstance(flat, torch.Tensor):
        flat = torch.from_numpy(np.require(flat, np.float32, "W"))
    sizes: list[int] = []

    def collect(node: Any) -> None:
        if isinstance(node, dict) and "__leaf__" in node:
            sizes.append(math.prod(int(d) for d in node["shape"]))
        elif isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)

    collect(skeleton)
    offsets = np.cumsum([0] + sizes)

    def build(node: Any) -> Any:
        if isinstance(node, dict) and "__leaf__" in node:
            i = int(node["__leaf__"])
            chunk = flat[int(offsets[i]):int(offsets[i]) + sizes[i]]
            return chunk.to(_resolve_dtype(node["dtype"])).reshape(
                [int(d) for d in node["shape"]])
        if isinstance(node, dict) and "__v6t_tuple__" in node:
            return tuple(build(v) for v in node["__v6t_tuple__"])
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return node

    return build(skeleton)
