"""Flash attention in PyTorch, with a hand-written CUDA kernel for Hopper.

Counterpart of ``vantage6_tpu/ops/flash_attention.py``, in the same
``[B, H, T, D]`` layout and with the same public signatures. The forward of
``flash_attention`` is a hand-written CUDA kernel (the port of the Pallas
``_kernel``) for CUDA tensors, and its plain PyTorch version
``kernel_reference`` for CPU tensors; there is no ``interpret`` argument,
the device of the tensors decides. Two kernels serve CUDA tensors, both on
the tensor cores, chosen by ``kernel_variant``:
``csrc/flash_attention_tc.cu`` (wgmma) for bf16 and
``csrc/flash_attention_tf32.cu`` (mma.sync in three TF32 passes, f32
accuracy) for f32, each at every head dim: up to 256 the kernel is
instantiated at a few widths and zero-fills its tiles from the true D up to
the next one; above 256 it cuts O into column slabs of at most 256 and
accumulates q.k over depth chunks (``KernelVariant.split``); the wrapper
zero-pads a D that is not a multiple of 8.
``csrc/flash_attention.cu``, on the CUDA cores, is reachable by
``variant="cuda_core"`` only.

The backward recomputes attention from (q, k, v, o); which implementation
serves a call is decided by what the input shows (``backward_variant``,
the table ``_BWD_DISPATCH``): bf16 CUDA tensors at head dims 1-192 go to
``csrc/flash_attention_bwd_tc.cu`` (``flash_backward_cuda``; wgmma, bf16
products with f32 row statistics and softmax, causal tiles skipped, no
atomics, so repeated calls give the same bits; 129-192 on a pair of
kernels of their own), whose plain version is ``backward_reference``;
every other call (CPU tensors, f32, D > 192) to
``_attention_bwd``, a plain f32 blockwise recompute, as in the JAX
package, where the backward is ``jnp`` and not a Pallas kernel. The
kernel replaces no TPU kernel; it was added because the plain backward,
all f32 on the CUDA cores with every score block in device memory, took
most of a bf16 transformer round on the card.

``q_offset``/``k_offset`` give the global position of the first query/key
token, so the same kernel serves monolithic causal attention (offsets 0)
and each hop of ring attention.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from vantage6_tpu_torch.ops import _build
from vantage6_tpu_torch.runtime.tracing import phase

NEG_INF = -1e30
M_FLOOR = -1e20

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One hand-written forward kernel: its library (``_build.SOURCES``),
    C entry point, tiles (BLOCK_Q, BLOCK_K in its source: the plain version
    at these block sizes rounds p against the same running max), the
    dtypes it takes and the head dims it is instantiated for. A kernel
    that ``pads`` serves every head dim up to its widest: the one above
    it, zero-filled in its tiles, and the wrapper pads D to a multiple of 8.
    ``wide_tiles`` holds the tiles of widths that differ from the rest.
    A kernel with a ``depth`` serves every head dim above its widest too:
    O in column slabs of at most the widest, q.k summed over depth chunks
    of ``depth`` columns, on ``slab_tiles`` (see ``split``)."""

    library: str
    symbol: str
    block_q: int
    block_k: int
    dtypes: tuple
    head_dims: tuple
    pads: bool = False
    wide_tiles: tuple = ()  # ((head dim, block_q, block_k), ...)
    depth: int = 0  # depth chunk above the widest head dim; 0: none
    slab_tiles: tuple = ()  # (block_q, block_k) above the widest

    def width(self, d: int) -> int | None:
        """The instantiated head dim that serves head dim ``d`` (above the
        widest, the width of the full O slabs), or None."""
        if d in self.head_dims:
            return d
        if not self.pads or d < 1:
            return None
        if self.depth and d > self.head_dims[-1]:
            return self.head_dims[-1]
        return next((w for w in self.head_dims if w >= d), None)

    def split(self, d: int) -> tuple[tuple[int, ...], int] | None:
        """Above the widest head dim, what a call at head dim ``d`` runs:
        (the widths of its O slabs, its depth chunks), as the C entry
        point launches them; None at or below it. Full slabs are the
        widest; a tail of at most 128 columns runs at 64 or 128, a wider
        one as one more full slab."""
        slab = self.head_dims[-1]
        if not self.depth or d <= slab:
            return None
        d += -d % 8
        full, tail = divmod(d, slab)
        tails = (() if not tail else (slab,) if tail > 128
                 else (64,) if tail <= 64 else (128,))
        return (slab,) * full + tails, -(-d // self.depth)

    def blocks(self, d: int) -> tuple[int, int]:
        """(block_q, block_k) of the kernel at head dim ``d``."""
        if self.split(d):
            return self.slab_tiles
        w = self.width(d)
        for width, block_q, block_k in self.wide_tiles:
            if width == w:
                return block_q, block_k
        return self.block_q, self.block_k


KERNELS = {
    # wgmma on the tensor cores, cp.async K/V ring (csrc/flash_attention_tc.cu)
    "tensor_core": KernelVariant(
        "flash_attention_tc", "v6t_flash_attention_fwd_tc", 128, 64,
        (torch.bfloat16,), (16, 32, 64, 128, 256), pads=True,
        depth=128, slab_tiles=(128, 64),
    ),
    # mma.sync m16n8k8 in three TF32 passes, cp.async K/V ring
    # (csrc/flash_attention_tf32.cu); 16-key tiles at 256, 32-key tiles
    # above it
    "tf32x3": KernelVariant(
        "flash_attention_tf32", "v6t_flash_attention_fwd_tf32x3", 128, 64,
        (torch.float32,), (8, 16, 32, 64, 128, 256), pads=True,
        wide_tiles=((256, 128, 16),), depth=64, slab_tiles=(128, 32),
    ),
    # f32 FMA on the CUDA cores (csrc/flash_attention.cu)
    "cuda_core": KernelVariant(
        "flash_attention", "v6t_flash_attention_fwd", 64, 64,
        (torch.float32, torch.bfloat16), (8, 16, 32, 64, 128),
    ),
}

# the kernel that serves each dtype, at every head dim
_DISPATCH = {torch.bfloat16: "tensor_core", torch.float32: "tf32x3"}

# the hand-written backward (csrc/flash_attention_bwd_tc.cu: wgmma, two
# kernels a call on 64 x 64 tile pairs), at every head dim up to its widest;
# W = 192 (head dims 129-192) is a pair of its own, two warpgroups a block
BACKWARD_KERNEL = KernelVariant(
    "flash_attention_bwd_tc", "v6t_flash_attention_bwd_tc", 64, 64,
    (torch.bfloat16,), (16, 32, 64, 128, 192), pads=True,
)
# the backward that serves each (device type, dtype) up to the kernel's
# widest head dim; every other call, and a wider head dim, takes the plain
# recompute ``_attention_bwd``. f32 stays plain: bf16 products would be a
# lower precision than an f32 configuration states.
_BWD_DISPATCH = {("cuda", torch.bfloat16): "tensor_core"}


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves a CUDA call: bf16 goes to wgmma, f32 to the
    tensor cores in three TF32 passes (one pass would miss the reference's
    2e-5), at every head dim. bf16 at D = 8, below wgmma's k16 depth, runs
    the D = 16 instantiation on zero-filled columns; above 256 both run
    their slab kernels (``KernelVariant.split``)."""
    if dtype not in _DISPATCH:
        raise ValueError(f"unsupported dtype {dtype} (float32, bfloat16)")
    return _DISPATCH[dtype]


def backward_variant(device: torch.device | str, dtype: torch.dtype,
                     d: int) -> str:
    """The backward that serves a call on ``device`` in ``dtype`` at head
    dim ``d``: ``"tensor_core"`` (``flash_backward_cuda``) or ``"plain"``
    (``_attention_bwd``)."""
    variant = _BWD_DISPATCH.get((torch.device(device).type, dtype))
    if variant is None or BACKWARD_KERNEL.width(d) is None:
        return "plain"
    return variant


def _check_supported(dtype: torch.dtype, d: int, scale: float,
                     variant: str) -> KernelVariant:
    """Raise ValueError unless the kernel ``variant`` takes ``dtype`` at
    head dim ``d`` with ``scale``; return its ``KernelVariant``. Needs no
    card."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"unsupported dtype {dtype} (float32, bfloat16)")
    if not math.isfinite(scale):
        raise ValueError(f"scale must be finite, not {scale}")
    spec = KERNELS[variant]
    if dtype not in spec.dtypes or spec.width(d) is None:
        takes = ("every head dim" if spec.depth
                 else f"head dims 1-{spec.head_dims[-1]}" if spec.pads
                 else f"head dims {spec.head_dims}")
        raise ValueError(f"the {variant} kernel takes {spec.dtypes} at "
                         f"{takes}, not {dtype} at {d}")
    return spec


def _default_scale(d: int, scale: float | None) -> float:
    return 1.0 / (d**0.5) if scale is None else float(scale)


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the sequence axis (dim 2) of a [B, H, T, D] tensor."""
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation from native-dtype inputs (the
    ``preferred_element_type=f32`` of the JAX code): bf16 -> f32 is exact,
    so every product is exact and only the sum order differs."""
    return torch.matmul(a.float(), b.float())


def flash_forward_cuda(q, k, v, q_offset, k_offset, causal, scale,
                       variant=None):
    """Launch a CUDA kernel: o = softmax(q k^T * scale, masked) v.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16),
    q ``[B, H, Tq, D]``, k and v ``[B, H, Tk, D]``, and any finite scale;
    raises on anything the kernel does not take.
    ``variant`` (a key of ``KERNELS``) defaults to
    ``kernel_variant(dtype, D)``. Ragged Tq/Tk are masked inside the
    kernel; a D that is not a multiple of 8 is zero-padded here (one copy
    of q, k and v) and o sliced back."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != q.device:
            raise ValueError("q, k and v must lie on one device")
        if x.dtype != q.dtype:
            raise ValueError("q, k and v must have one dtype")
        if x.dim() != 4:
            raise ValueError(f"{name} must be [B, H, T, D], got {x.shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch q={q.shape} k={k.shape} v={v.shape}")
    variant = kernel_variant(q.dtype, d) if variant is None else variant
    spec = _check_supported(q.dtype, d, scale, variant)
    d_pad = -d % 8 if spec.pads else 0
    if d_pad:
        q, k, v = (torch.nn.functional.pad(x, (0, d_pad)) for x in (q, k, v))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o[..., :d]
    lib = _build.load(spec.library)
    fn = getattr(lib, spec.symbol)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b * h, t_q, t_k, d + d_pad,
            int(q_offset), int(k_offset), int(bool(causal)), float(scale),
            stream,
        )
    _build.check(lib, err, f"flash_attention_fwd ({variant}) launch")
    flash_forward_cuda.launches += 1
    flash_forward_cuda.variant_launches[variant] += 1
    return o[..., :d].contiguous() if d_pad else o


# kernel launches, in all and per variant; reset by the caller
flash_forward_cuda.launches = 0
flash_forward_cuda.variant_launches = dict.fromkeys(KERNELS, 0)


def flash_backward_cuda(q, k, v, o, do, q_offset, k_offset, causal, scale):
    """Launch the backward kernel: (dq, dk, dv) of o = attention(q, k, v)
    for the output gradient ``do``, in the inputs' dtype.

    Takes contiguous 16-byte aligned bf16 CUDA tensors on one device, q,
    o and do ``[B, H, Tq, D]``, k and v ``[B, H, Tk, D]``, D from 1 to 192,
    and any finite scale; raises on anything the kernel does not take (the
    checks of dtype, shapes and scale need no card). Ragged Tq/Tk are
    masked inside the kernel; a D that is not a multiple of 8 is zero-padded
    here (one copy of each input) and the gradients sliced back. The
    kernel's row statistics L and D go to an f32 scratch of ``[B*H, Tq]``
    rows rounded up to 64."""
    spec = BACKWARD_KERNEL
    tensors = (("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    for name, x in tensors:
        if x.dtype not in spec.dtypes:
            raise ValueError(f"the backward kernel takes {spec.dtypes}, not "
                             f"{name} in {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be [B, H, T, D], got {x.shape}")
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or k.shape != v.shape
            or k.shape[:2] != (b, h) or k.shape[3] != d):
        raise ValueError(f"shape mismatch q={q.shape} k={k.shape} "
                         f"v={v.shape} o={o.shape} do={do.shape}")
    if spec.width(d) is None:
        raise ValueError(f"the backward kernel takes head dims 1-"
                         f"{spec.head_dims[-1]}, not {d}")
    if not math.isfinite(scale):
        raise ValueError(f"scale must be finite, not {scale}")
    for name, x in tensors:
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != q.device:
            raise ValueError("q, k, v, o and do must lie on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d_pad = -d % 8
    if d_pad:
        q, k, v, o, do = (torch.nn.functional.pad(x, (0, d_pad))
                          for x in (q, k, v, o, do))
    if any(x.data_ptr() % 16 for x in (q, k, v, o, do)):
        raise ValueError("q, k, v, o and do must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * h == 0:
        return dq[..., :d], dk[..., :d], dv[..., :d]
    lse_rows = -(-t_q // spec.block_q) * spec.block_q
    stats = torch.empty((2, b * h, lse_rows), dtype=torch.float32,
                        device=q.device)
    lib = _build.load(spec.library)
    fn = getattr(lib, spec.symbol)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(),
            _KERNEL_DTYPES[q.dtype], b * h, t_q, t_k, d + d_pad, lse_rows,
            int(q_offset), int(k_offset), int(bool(causal)), float(scale),
            stream,
        )
    _build.check(lib, err, "flash_attention_bwd (tensor_core) launch")
    flash_backward_cuda.launches += 1
    flash_backward_cuda.width_launches[spec.width(d)] += 1
    if d_pad:
        return tuple(x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


# kernel calls, in all and per instantiated width; CUDA calls that the
# plain backward served (f32, D > 192); reset by the caller
flash_backward_cuda.launches = 0
flash_backward_cuda.width_launches = dict.fromkeys(
    BACKWARD_KERNEL.head_dims, 0)
flash_backward_cuda.plain_calls = 0


def kernel_reference(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, H, Tk, D]
    v: torch.Tensor,  # [B, H, Tk, D]
    q_offset: int = 0,
    k_offset: int = 0,
    causal: bool = False,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Plain PyTorch transliteration of the Pallas ``_kernel`` — the
    counterpart of ``interpreter_twin`` and the kernel's plain version.

    Same padding, block shapes, masking and online-softmax update order as
    the TPU kernel; the ``(batch*head, q-block)`` grid cells are independent,
    so they run as one batch dimension and only the key-block loop (the
    kernel's ``fori_loop``) is a Python loop."""
    scale = _default_scale(q.shape[-1], scale)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    block_q = min(block_q, max(t_q, 8))
    block_k = min(block_k, max(t_k, 8))
    pad_q = (-t_q) % block_q
    pad_k = (-t_k) % block_k
    q, k, v = _pad_seq(q, pad_q), _pad_seq(k, pad_k), _pad_seq(v, pad_k)
    tq_p, tk_p = t_q + pad_q, t_k + pad_k
    n_qb = tq_p // block_q
    qc = q.reshape(b * h, n_qb, block_q, d)
    kh = k.reshape(b * h, 1, tk_p, d)
    vh = v.reshape(b * h, 1, tk_p, d)
    dev = q.device
    q_pos = int(q_offset) + torch.arange(tq_p, device=dev).reshape(
        n_qb, block_q, 1
    )
    m = torch.full((b * h, n_qb, block_q), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b * h, n_qb, block_q, d), device=dev)
    for kb in range(tk_p // block_k):
        kblk = kh[:, :, kb * block_k:(kb + 1) * block_k]
        vblk = vh[:, :, kb * block_k:(kb + 1) * block_k]
        s = _f32_matmul(qc, kblk.transpose(-1, -2)) * scale
        k_idx = kb * block_k + torch.arange(block_k, device=dev)
        s = torch.where(k_idx < t_k, s, NEG_INF)
        if causal:
            s = torch.where(q_pos >= int(k_offset) + k_idx, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1)).clamp_min(M_FLOOR)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = _f32_matmul(p.to(vblk.dtype), vblk)
        acc = acc * corr[..., None] + pv
        m = m_new
    denom = torch.where(l > 0, l, 1.0)
    out = (acc / denom[..., None]).to(q.dtype).reshape(b, h, tq_p, d)
    return out[:, :, :t_q]


def _flash_forward(q, k, v, q_offset, k_offset, causal, scale,
                   block_q, block_k):
    """The kernel for CUDA tensors; its plain version for CPU tensors."""
    if q.is_cuda:
        return flash_forward_cuda(q, k, v, q_offset, k_offset, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    return kernel_reference(q, k, v, q_offset, k_offset, causal, scale,
                            block_q, block_k)


def _blockwise_forward(q, k, v, q_offset, k_offset, *, causal, scale,
                       block_k):
    """Online-softmax forward over key blocks (plain; mirrors the kernel)."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    block = min(block_k, t_k)
    pad_k = (-t_k) % block
    k, v = _pad_seq(k, pad_k), _pad_seq(v, pad_k)
    dev = q.device
    q_pos = int(q_offset) + torch.arange(t_q, device=dev)
    m = torch.full((b, h, t_q), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, t_q, d), device=dev)
    for idx0 in range(0, t_k + pad_k, block):
        k_j = k[:, :, idx0:idx0 + block]
        v_j = v[:, :, idx0:idx0 + block]
        s = _f32_matmul(q, k_j.transpose(-1, -2)) * scale
        k_idx = idx0 + torch.arange(block, device=dev)
        valid = (k_idx < t_k)[None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= int(k_offset) + k_idx[None, :])
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1).clamp_min(M_FLOOR))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _f32_matmul(p.to(v_j.dtype), v_j)
        m = m_new
    denom = torch.where(l > 0, l, 1.0)[..., None]
    return (acc / denom).to(q.dtype)


def _attention_bwd(q, k, v, o, do, q_offset, k_offset, causal, scale,
                   block_k: int = 128):
    """Blockwise softmax-attention VJP with flash-style recompute.

    Nothing from the forward is saved except (q, k, v, o); scores and
    probabilities are recomputed blockwise over the key axis, so peak
    transient memory is O(Tq * block_k). Two passes, both f32 regardless of
    the compute dtype:

      pass 1: online-softmax statistics L = m + log(l)  (no V work)
      pass 2, per key block j, with D = rowsum(do * o):
        P_j = exp(S_j - L);  dV_j = P_j^T do;  dP_j = do V_j^T
        dS_j = P_j * (dP_j - D);  dQ += dS_j K_j * scale;
        dK_j = dS_j^T Q * scale.

    Fully-masked query rows have l = 0, so every P_j entry underflows to 0
    and their gradients vanish, matching the forward's zero output.
    """
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    block_k = min(block_k, t_k)
    pad_k = (-t_k) % block_k
    kf = _pad_seq(k, pad_k).float()
    vf = _pad_seq(v, pad_k).float()
    qf, of, dof = q.float(), o.float(), do.float()
    dev = q.device
    q_pos = int(q_offset) + torch.arange(t_q, device=dev)
    starts = range(0, t_k + pad_k, block_k)

    def block_scores(idx0):
        s = torch.matmul(qf, kf[:, :, idx0:idx0 + block_k].transpose(-1, -2))
        s = s * scale
        k_idx = idx0 + torch.arange(block_k, device=dev)
        valid = (k_idx < t_k)[None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= int(k_offset) + k_idx[None, :])
        return torch.where(valid, s, NEG_INF)

    m = torch.full((b, h, t_q), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    for idx0 in starts:
        s = block_scores(idx0)
        m_new = torch.maximum(m, s.amax(-1).clamp_min(M_FLOOR))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    # L normalizer; l == 0 rows (fully masked) keep L = m so P stays 0
    big_l = m + torch.log(torch.where(l > 0, l, 1.0))
    d_term = (dof * of).sum(-1)  # [B, H, Tq]

    dq = torch.zeros((b, h, t_q, d), device=dev)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for idx0 in starts:
        k_j = kf[:, :, idx0:idx0 + block_k]
        v_j = vf[:, :, idx0:idx0 + block_k]
        p = torch.exp(block_scores(idx0) - big_l[..., None])
        dv[:, :, idx0:idx0 + block_k] = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, v_j.transpose(-1, -2))
        ds = p * (dp - d_term[..., None])
        dq = dq + torch.matmul(ds, k_j) * scale
        dk[:, :, idx0:idx0 + block_k] = (
            torch.matmul(ds.transpose(-1, -2), qf) * scale
        )
    return (
        dq.to(q.dtype),
        dk[:, :, :t_k].to(k.dtype),
        dv[:, :, :t_k].to(v.dtype),
    )


def backward_reference(q, k, v, o, do, q_offset=0, k_offset=0, causal=False,
                       scale=None, block=64):
    """The backward kernel's tiled algorithm in plain PyTorch: its plain
    version, as ``kernel_reference`` is the forward's.

    The same 64 x 64 tile pairs (``block``) as the kernel's two passes:
    on causal calls a pair in which every query precedes every key is
    skipped; L = m + log(l) from the online max (floored at ``M_FLOOR``)
    and sum over the visible key tiles in order, l = 0 keeping L = m; D =
    rowsum(do o) in f32; then per visible pair P = exp(S - L), dP = do v^T,
    dS = P (dP - D), with every product taking operands in the inputs'
    dtype and accumulating in f32: P and dS are rounded to that dtype
    where they enter a product (bf16 inputs: as the kernel rounds them; f32
    inputs: no rounding), and dq = scale dS k, dk = scale dS^T q,
    dv = P^T do, returned in the inputs' dtype."""
    scale = _default_scale(q.shape[-1], scale)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    dt = q.dtype
    n_qt, n_kt = -(-t_q // block), -(-t_k // block)
    pad_q, pad_k = n_qt * block - t_q, n_kt * block - t_k
    q, o, do = (_pad_seq(x, pad_q).reshape(b * h, n_qt, block, d)
                for x in (q, o, do))
    k, v = (_pad_seq(x, pad_k).reshape(b * h, n_kt, block, d) for x in (k, v))
    dev = q.device
    rows = torch.arange(block, device=dev)

    def visible(i, j):  # some query of tile i sees some key of tile j
        return not (causal and q_offset + min((i + 1) * block, t_q) - 1
                    < k_offset + j * block)

    def scores(i, j):
        s = _f32_matmul(q[:, i], k[:, j].transpose(-1, -2)) * scale
        qi, kj = i * block + rows[:, None], j * block + rows[None, :]
        ok = (kj < t_k) & (qi < t_q)
        if causal:
            ok = ok & (q_offset + qi >= k_offset + kj)
        return torch.where(ok, s, NEG_INF)

    big_l = torch.empty((b * h, n_qt, block), device=dev)
    for i in range(n_qt):
        m = torch.full((b * h, block), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        for j in range(n_kt):
            if visible(i, j):
                s = scores(i, j)
                m_new = torch.maximum(m, s.amax(-1).clamp_min(M_FLOOR))
                l = (l * torch.exp(m - m_new)
                     + torch.exp(s - m_new[..., None]).sum(-1))
                m = m_new
        big_l[:, i] = torch.where(l > 0, m + torch.log(torch.where(
            l > 0, l, 1.0)), m.clamp_min(M_FLOOR))
    d_term = (do.float() * o.float()).sum(-1)  # [BH, n_qt, block]

    dq = torch.zeros(q.shape, device=dev)
    dk = torch.zeros(k.shape, device=dev)
    dv = torch.zeros(v.shape, device=dev)
    for i in range(n_qt):
        for j in range(n_kt):
            if not visible(i, j):
                continue
            p = torch.exp(scores(i, j) - big_l[:, i, :, None])
            dp = _f32_matmul(do[:, i], v[:, j].transpose(-1, -2))
            ds = p * (dp - d_term[:, i, :, None])
            p, ds = p.to(dt), ds.to(dt)
            dv[:, j] += _f32_matmul(p.transpose(-1, -2), do[:, i])
            dk[:, j] += _f32_matmul(ds.transpose(-1, -2), q[:, i])
            dq[:, i] += _f32_matmul(ds, k[:, j])

    def out(x, t):
        return x.reshape(b, h, -1, d)[:, :, :t].to(dt)

    return out(dq * scale, t_q), out(dk * scale, t_k), out(dv, t_k)


class _RecomputeVJP(torch.autograd.Function):
    """Counterpart of ``_attach_recompute_vjp``: ``forward`` computes
    o = attention(q, k, v); the saved tensors are only (q, k, v, o) — never
    the [Tq, Tk] scores — and the backward is the one ``backward_variant``
    names: the kernel (``flash_backward_cuda``) or ``_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal, scale, forward):
        # profiler ranges: device time of the round by module
        with phase("attention_fwd"):
            o = forward(q, k, v, q_offset, k_offset, causal, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.attrs = (q_offset, k_offset, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with phase("attention_bwd"):
            if backward_variant(q.device, q.dtype, q.shape[-1]) == "plain":
                flash_backward_cuda.plain_calls += q.is_cuda
                dq, dk, dv = _attention_bwd(q, k, v, o, do, *ctx.attrs)
            else:
                dq, dk, dv = flash_backward_cuda(
                    *(x.contiguous() for x in (q, k, v, o, do)), *ctx.attrs)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, H, Tk, D]
    v: torch.Tensor,  # [B, H, Tk, D]
    q_offset: int = 0,
    k_offset: int = 0,
    causal: bool = False,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash attention per (batch, head), layout [B, H, T, D].

    Differentiable: the forward runs the CUDA kernel on CUDA tensors (its
    plain version ``kernel_reference`` on CPU tensors, with these block
    sizes; the kernel picks its own tiles); the backward recomputes
    attention from (q, k, v, o) — the kernel ``flash_backward_cuda`` for
    bf16 CUDA tensors at D <= 192, else ``_attention_bwd``."""
    scale = _default_scale(q.shape[-1], scale)

    def forward(q, k, v, q_offset, k_offset, causal, scale):
        return _flash_forward(q, k, v, q_offset, k_offset, causal, scale,
                              block_q, block_k)

    return _RecomputeVJP.apply(q, k, v, int(q_offset), int(k_offset),
                               bool(causal), scale, forward)


def recompute_attention(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int = 0,
    k_offset: int = 0,
    causal: bool = False,
    scale: float | None = None,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash-memory attention without a kernel: the blockwise plain forward
    (``_blockwise_forward``) plus the same recompute backward as
    ``flash_attention``. Residuals are just (q, k, v, o)."""
    scale = _default_scale(q.shape[-1], scale)

    def forward(q, k, v, q_offset, k_offset, causal, scale):
        return _blockwise_forward(q, k, v, q_offset, k_offset, causal=causal,
                                  scale=scale, block_k=block_k)

    return _RecomputeVJP.apply(q, k, v, int(q_offset), int(k_offset),
                               bool(causal), scale, forward)


def reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int = 0, k_offset: int = 0, causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Dense oracle in the same [B, H, T, D] layout."""
    scale = _default_scale(q.shape[-1], scale)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[2], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[2], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)
