"""The MLA-MoE family's paths on the card (``cuda``-marked: the attention
kernels have no CPU mode, so these skip without a card).

- MLA's attention through ``flash_attention`` at q/k 192 and v 128
  (``mla_moe.attend``): the forward runs the tensor-core kernel at its
  W = 256 instantiation on zero-filled columns, the backward the bf16
  backward kernel at its W = 192 pair. The forward's output is held to
  float64 dense attention on the same bf16 values within 2 bf16 ulps of
  its largest value (the kernel rounds P to bf16 before P V, and the
  output to bf16); the gradients as the backward kernel's own card tests
  hold them (``test_torch_flash_backward_cuda.py``): against float64
  within twice the plain f32 backward's error plus one bf16 ulp of the
  largest gradient, and against the plain backward within 4 bf16 ulps of
  its largest. A round of a small MLA configuration at the same widths
  runs that kernel once a layer a station and the plain backward never.
- The held-expert layer (``mla_moe.moe``) at the published widths (d 2048,
  experts 1408 wide, 8 of 64 held, top-6, a shared MLP 2816 wide) on one
  2,048-token sequence, in bf16, against the plain f32 reference
  (``mla_moe_reference.moe``) on the same bf16 inputs, output and
  gradients. Both route on the same f32 scores of the same values, so only
  the bf16 products differ: each rounds its output to bf16 (2^-9), some
  five roundings deep, so the relative norm error is about 2^-9 x sqrt(5)
  ~ 4e-3; 2e-2 holds it with room, where float8 (2^-4) would not.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from vantage6_tpu_torch.models import mla_moe as M
from vantage6_tpu_torch.models import mla_moe_reference as R
from vantage6_tpu_torch.ops import flash_attention as tfa

ULP = 2.0**-8
BF16_GRAD_TOL = 4 * 2.0**-8
MOE_TOL = 2e-2
PUBLISHED = M.MLAMoEConfig(
    vocab=20480, d_model=2048, n_heads=16, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, kv_lora_rank=512, n_layers=2, first_k_dense=1,
    dense_inter=11264, moe_inter=1408, n_experts=64, top_k=6, n_shared=2,
    held_experts=tuple(range(8)), routed_scale=2.446, dtype=torch.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_mla_attention_runs_the_w256_forward_and_the_w192_backward_kernel(
        cuda):
    g = torch.Generator(device="cpu").manual_seed(4)
    b, t, h = 2, 1024, 16
    scale = 192**-0.5
    q = torch.randn(b, t, h, 192, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(b, t, h, 192, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(b, t, h, 128, generator=g).to(cuda, torch.bfloat16)
    do = torch.randn(b, t, h, 128, generator=g).to(cuda, torch.bfloat16)
    assert tfa.KERNELS["tensor_core"].width(192) == 256
    assert tfa.backward_variant(cuda, torch.bfloat16, 192) == "tensor_core"
    assert tfa.BACKWARD_KERNEL.width(192) == 192
    launches = tfa.flash_forward_cuda.variant_launches["tensor_core"]
    wide = tfa.flash_backward_cuda.width_launches[192]
    plain = tfa.flash_backward_cuda.plain_calls
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = M.attend(qg, kg, vg, "flash")
    dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert tfa.flash_forward_cuda.variant_launches["tensor_core"] == \
        launches + 1
    assert tfa.flash_backward_cuda.width_launches[192] == wide + 1
    assert tfa.flash_backward_cuda.plain_calls == plain
    assert out.shape == (b, t, h, 128) and out.dtype == torch.bfloat16

    # the plain f32 backward on the inputs the kernel got: 192 wide,
    # head-major, v and dO zero-padded
    def head_major(z):
        return F.pad(z, (0, 192 - z.shape[-1])).transpose(1, 2).contiguous()

    qh, kh, vh, doh = (head_major(x) for x in (q, k, v, do))
    oh = tfa.flash_forward_cuda(qh, kh, vh, 0, 0, True, scale)
    plain_grads = tfa._attention_bwd(qh, kh, vh, oh, doh, 0, 0, True, scale)
    q64, k64, v64 = (x.double().transpose(1, 2).requires_grad_()
                     for x in (q, k, v))
    ref = tfa.reference(q64, k64, v64, causal=True, scale=scale)
    ref_grads = torch.autograd.grad(ref, (q64, k64, v64),
                                    do.double().transpose(1, 2))
    ref = ref.detach().transpose(1, 2)
    top = ref.abs().max().item()
    assert (out.double() - ref).abs().max().item() <= 2 * ULP * top
    for name, ours, p, theirs in zip("qkv", (dq, dk, dv), plain_grads,
                                     ref_grads):
        theirs = theirs.transpose(1, 2)
        p = p.transpose(1, 2)[..., :ours.shape[-1]]
        assert ours.shape == theirs.shape == p.shape, name
        top = theirs.abs().max().item()
        err = (ours.double() - theirs).abs().max().item()
        err_plain = (p.double() - theirs).abs().max().item()
        gap = (ours.float() - p.float()).abs().max().item()
        assert err <= 2 * err_plain + ULP * top, (name, err, err_plain, top)
        assert gap <= BF16_GRAD_TOL * p.float().abs().max().item(), (
            name, gap)


@pytest.mark.cuda
def test_engine_round_launches_the_w192_backward_kernel(cuda):
    """A bf16 round of a small MLA configuration at MLA's attention widths
    (q/k 192, v 128) runs the W = 192 backward kernel once a layer a
    station (4 stations x 2 layers) and the plain backward never."""
    from vantage6_tpu_torch.workloads import fed_transformer as ft

    cfg = M.MLAMoEConfig(
        vocab=512, d_model=256, n_heads=2, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, kv_lora_rank=64, n_layers=2, first_k_dense=1,
        dense_inter=512, moe_inter=64, n_experts=8, top_k=2, n_shared=1,
        held_experts=(0, 1, 2, 3), max_len=256, dtype=torch.bfloat16)
    eng = ft.make_engine(4, 1, cfg, lr=1e-3)
    tokens = eng.shard_tokens(torch.randint(
        0, cfg.vocab, (4, 2, 256), generator=torch.Generator().manual_seed(0)))
    params, opt = eng.init(0)
    tfa.flash_backward_cuda.launches = 0
    tfa.flash_backward_cuda.width_launches = dict.fromkeys(
        tfa.BACKWARD_KERNEL.head_dims, 0)
    tfa.flash_backward_cuda.plain_calls = 0
    params, opt, loss = eng.round(params, opt, tokens, torch.ones(4))
    assert torch.isfinite(loss).item()
    assert tfa.flash_backward_cuda.launches == 4 * cfg.n_layers
    assert tfa.flash_backward_cuda.width_launches[192] == 4 * cfg.n_layers
    assert tfa.flash_backward_cuda.plain_calls == 0


@pytest.mark.cuda
def test_held_expert_layer_matches_the_reference_at_published_widths(cuda):
    cfg = PUBLISHED
    gen = torch.Generator(device="cpu").manual_seed(6)
    params = M.init_params(gen, cfg, cuda)
    layer = params["layers"][1]
    buffers = M.init_buffers(gen, cfg, cuda)
    router, bias = buffers["router"][0], buffers["score_bias"][0]
    h = torch.randn(2048, cfg.d_model, generator=gen).to(cuda, torch.bfloat16)
    dy = torch.randn(2048, cfg.d_model, generator=gen).to(cuda,
                                                          torch.bfloat16)
    leaves = [layer["shared_gate"], layer["shared_up"],
              layer["shared_down"]] + [w for ex in layer["experts"]
                                       for w in ex.values()]

    def run(fn, x, tree_leaves, dtype):
        xs = x.clone().requires_grad_()
        ws = [w.clone().requires_grad_() for w in tree_leaves]
        lay = _with(layer, ws)
        out = fn(xs, lay)
        grads = torch.autograd.grad(out, [xs, *ws], dy.to(out.dtype))
        return out, grads

    out, grads = run(lambda x, lay: M.moe(x, lay, router, bias, cfg,
                                          lambda w: w.to(cfg.dtype)),
                     h, leaves, cfg.dtype)
    with R.exact_float32():
        ref, ref_grads = run(lambda x, lay: R.moe(x, lay, router, bias, cfg),
                             h.float(), leaves, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    assert rel(out, ref) < MOE_TOL
    floor = torch.stack([g.norm() for g in ref_grads]).median().item()
    for i, (a, b) in enumerate(zip(grads, ref_grads, strict=True)):
        err = ((a.float() - b).norm() / max(b.norm().item(), floor)).item()
        assert err < MOE_TOL, (i, err)


def _with(layer, ws):
    """``layer`` with its shared MLP's and experts' weights from ``ws`` (in
    the order the test lists them)."""
    it = iter(ws)
    out = dict(layer)
    for key in ("shared_gate", "shared_up", "shared_down"):
        out[key] = next(it)
    out["experts"] = [{k: next(it) for k in ex} for ex in layer["experts"]]
    return out


def test_published_config_is_the_benchmark_width():
    """The widths the card test holds are the configuration's (checked
    without a card)."""
    assert (PUBLISHED.qk_dim, PUBLISHED.v_head_dim, PUBLISHED.n_held) == (
        192, 128, 8)
    assert dataclasses.replace(PUBLISHED, n_layers=7).is_moe(6)
