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

Not ported yet: the host and wire half (``compress_delta``,
``decompress_delta``, ``payload_to_wire``, ``DeltaCompressor``,
``spec_from_env``, the telemetry series), which rides
``common.serialization``'s sparse wire type (ROADMAP.md queue 1 item 9.1).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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
