"""Flash attention in PyTorch, with a hand-written CUDA kernel for Hopper.

Counterpart of ``vantage6_tpu/ops/flash_attention.py``, in the same
``[B, H, T, D]`` layout and with the same public signatures. The forward of
``flash_attention`` is a hand-written CUDA kernel (the port of the Pallas
``_kernel``) for CUDA tensors, and its plain PyTorch version
``kernel_reference`` for CPU tensors; there is no ``interpret`` argument,
the device of the tensors decides. Three kernels serve CUDA tensors,
chosen by ``kernel_variant``: ``csrc/flash_attention_tc.cu`` (wgmma) for
bf16 at D >= 16, ``csrc/flash_attention_tf32.cu`` (mma.sync in three TF32
passes, f32 accuracy) for f32 at every D, both on the tensor cores, and
``csrc/flash_attention.cu`` on the CUDA cores for bf16 at D = 8. The
backward is ``_attention_bwd``, a plain blockwise
recompute, as in the JAX package, where it is ``jnp`` and not a Pallas
kernel.

``q_offset``/``k_offset`` give the global position of the first query/key
token, so the same kernel serves monolithic causal attention (offsets 0)
and each hop of ring attention.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from vantage6_tpu_torch.ops import _build

NEG_INF = -1e30
M_FLOOR = -1e20

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One hand-written forward kernel: its library (``_build.SOURCES``),
    C entry point, tiles (BLOCK_Q, BLOCK_K in its source: the plain version
    at these block sizes rounds p against the same running max), and the
    dtypes and head dims it is instantiated for."""

    library: str
    symbol: str
    block_q: int
    block_k: int
    dtypes: tuple
    head_dims: tuple


KERNELS = {
    # wgmma on the tensor cores, cp.async K/V ring (csrc/flash_attention_tc.cu)
    "tensor_core": KernelVariant(
        "flash_attention_tc", "v6t_flash_attention_fwd_tc", 128, 64,
        (torch.bfloat16,), (16, 32, 64, 128),
    ),
    # mma.sync m16n8k8 in three TF32 passes, cp.async K/V ring
    # (csrc/flash_attention_tf32.cu)
    "tf32x3": KernelVariant(
        "flash_attention_tf32", "v6t_flash_attention_fwd_tf32x3", 128, 64,
        (torch.float32,), (8, 16, 32, 64, 128),
    ),
    # f32 FMA on the CUDA cores (csrc/flash_attention.cu)
    "cuda_core": KernelVariant(
        "flash_attention", "v6t_flash_attention_fwd", 64, 64,
        (torch.float32, torch.bfloat16), (8, 16, 32, 64, 128),
    ),
}


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves a CUDA call. bf16 at D >= 16 goes to wgmma;
    f32 goes to the tensor cores in three TF32 passes at every D (one pass
    would miss the reference's 2e-5); bf16 at D = 8, below wgmma's k16
    depth, stays on the CUDA cores."""
    for variant in ("tensor_core", "tf32x3"):
        spec = KERNELS[variant]
        if dtype in spec.dtypes and d in spec.head_dims:
            return variant
    return "cuda_core"


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
    q ``[B, H, Tq, D]``, k and v ``[B, H, Tk, D]``; raises on anything the
    kernel does not take. ``variant`` (a key of ``KERNELS``) defaults to
    ``kernel_variant(dtype, D)``. Ragged Tq/Tk are masked inside the
    kernel."""
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
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, bfloat16)")
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch q={q.shape} k={k.shape} v={v.shape}")
    variant = kernel_variant(q.dtype, d) if variant is None else variant
    spec = KERNELS[variant]
    if q.dtype not in spec.dtypes or d not in spec.head_dims:
        raise ValueError(f"the {variant} kernel takes {spec.dtypes} at head "
                         f"dims {spec.head_dims}, not {q.dtype} at {d}")
    if variant == "tensor_core" and not scale > 0:
        raise ValueError(f"the tensor_core kernel takes scale > 0, not {scale}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
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
            _KERNEL_DTYPES[q.dtype], b * h, t_q, t_k, d,
            int(q_offset), int(k_offset), int(bool(causal)), float(scale),
            stream,
        )
    _build.check(lib, err, f"flash_attention_fwd ({variant}) launch")
    flash_forward_cuda.launches += 1
    flash_forward_cuda.variant_launches[variant] += 1
    return o


# kernel launches, in all and per variant; reset by the caller
flash_forward_cuda.launches = 0
flash_forward_cuda.variant_launches = dict.fromkeys(KERNELS, 0)


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


class _RecomputeVJP(torch.autograd.Function):
    """Counterpart of ``_attach_recompute_vjp``: ``forward`` computes
    o = attention(q, k, v); the saved tensors are only (q, k, v, o) — never
    the [Tq, Tk] scores — and the backward is ``_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal, scale, forward):
        # profiler ranges: device time of the round by module
        with torch.profiler.record_function("attention_fwd"):
            o = forward(q, k, v, q_offset, k_offset, causal, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.attrs = (q_offset, k_offset, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with torch.profiler.record_function("attention_bwd"):
            dq, dk, dv = _attention_bwd(q, k, v, o, do, *ctx.attrs)
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
    attention blockwise from (q, k, v, o) — see ``_attention_bwd``."""
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
