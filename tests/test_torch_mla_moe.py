"""The MLA-MoE family (``models/mla_moe.py``) against its plain reference
(``models/mla_moe_reference.py``), on the CPU at a small size with every
mechanism present: d 64, 4 heads of q/k 16 + 8 and v 16, a latent of 32,
8 experts of which 4 are held, top-3, a shared MLP, one dense layer and
two MoE layers.

On the CPU the flash path is the kernels' plain version (``kernel_reference``
forward, ``_attention_bwd`` backward), so in float32 the engine and the
reference differ by summation order alone: 1e-5. In bf16 the engine rounds
every product's output, the residual stream and the activations to bf16
(2^-9 relative each) and the reference does not; see ``BF16`` below.
"""
import dataclasses
import math

import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves, tree_unflatten
from vantage6_tpu_torch.models import mla_moe as M
from vantage6_tpu_torch.models import mla_moe_reference as R
from vantage6_tpu_torch.runtime import tracing
from vantage6_tpu_torch.workloads import fed_transformer as FT

CFG = M.MLAMoEConfig(
    vocab=96, d_model=64, n_heads=4, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, kv_lora_rank=32, n_layers=3, first_k_dense=1,
    dense_inter=128, moe_inter=32, n_experts=8, top_k=3, n_shared=1,
    held_experts=(0, 1, 2, 3), routed_scale=2.446, max_len=64)
F32_TOL = 1e-5
# bf16: a bf16 value is within 2^-9 of itself. The engine rounds at some
# 30 points a layer; independent roundings add in quadrature, so the
# logits' and a gradient leaf's relative norm error is a few 2^-9 x
# sqrt(30) ~ 1e-2 over three layers. A routing choice near a tie may
# also flip (the bf16 hidden state moves the biased scores by ~1e-3), and
# moves that token's share of an expert; 4e-2 leaves room for a few.
BF16 = 4e-2
LR = 1e-3


def _setup(seed=0, cfg=CFG, batch=2, seq=16, stations=2):
    gen = torch.Generator().manual_seed(seed)
    params = M.init_params(gen, cfg, "cpu")
    buffers = M.init_buffers(gen, cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab, (stations, batch, seq),
                           generator=gen)
    return params, buffers, tokens


def _rel(a, b, floor=0.0):
    """The norm of a - b over the larger of b's and ``floor``."""
    diff = torch.linalg.vector_norm(a.detach().float() - b.detach())
    return float(diff / max(float(torch.linalg.vector_norm(b.detach())),
                             floor))


def _median_norm(leaves):
    return float(torch.stack([torch.linalg.vector_norm(x.detach())
                              for x in leaves]).median())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attention", ["flash", "recompute"])
def test_logits_loss_and_gradients_match_reference(dtype, attention):
    cfg = dataclasses.replace(CFG, dtype=dtype, attention=attention)
    params, buffers, tokens = _setup()
    tok = tokens[0]
    leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    logits = M.forward_local(tree, tok, cfg, buffers)
    loss = M.loss_local(tree, tok, cfg, buffers)
    grads = torch.autograd.grad(loss, leaves)
    with R.exact_float32():
        ref_leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        ref_tree = tree_unflatten(params, ref_leaves)
        ref_logits = R.forward(ref_tree, tok, cfg, buffers)
        ref_loss = R.loss(ref_tree, tok, cfg, buffers)
        ref_grads = torch.autograd.grad(ref_loss, ref_leaves)
    assert logits.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(logits, ref_logits, atol=F32_TOL,
                                   rtol=F32_TOL)
        torch.testing.assert_close(loss, ref_loss, atol=F32_TOL,
                                   rtol=F32_TOL)
        for g, r in zip(grads, ref_grads, strict=True):
            torch.testing.assert_close(g, r, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert _rel(logits, ref_logits) < BF16
        assert abs(float(loss.detach()) - float(ref_loss.detach())) \
            / float(ref_loss.detach()) < BF16
        # a leaf whose gradient is all but zero (an expert few tokens
        # chose) is held against the median leaf's norm, as the
        # benchmark's check holds it
        floor = _median_norm(ref_grads)
        for g, r in zip(grads, ref_grads, strict=True):
            assert _rel(g, r, floor) < BF16
    assert len(grads) == len(tree_leaves(params))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_round_matches_reference_round(dtype):
    """One ``FedTransformer.round`` (per-station gradients, fed_mean,
    Adam) against the reference's FedSGD + Adam round. Adam's first step
    moves an element by about lr times its gradient's sign, so an element
    whose reference gradient is near zero may step the other way on
    rounding: those (under a thousandth of their leaf's largest) are held
    to 2 lr, the rest to the tolerance."""
    cfg = dataclasses.replace(CFG, dtype=dtype)
    params, buffers, tokens = _setup(seed=1, stations=3)
    eng = FT.make_engine(3, 1, cfg, lr=LR, device="cpu", buffers=buffers)
    new, opt, loss = eng.round(params, eng.optimizer.init(params), tokens,
                               torch.ones(3))
    with R.exact_float32():
        zeros = [torch.zeros_like(p) for p in tree_leaves(params)]
        z = tree_unflatten(params, zeros)
        ref_new, ref_mu, _, ref_loss, ref_g = R.fed_round(
            params, z, z, 0, tokens, cfg, buffers, LR)
    tol = F32_TOL if dtype == torch.float32 else BF16
    assert abs(float(loss) - ref_loss) / ref_loss < tol
    for mu, g in zip(tree_leaves(opt.mu), tree_leaves(ref_g), strict=True):
        if dtype == torch.float32:
            torch.testing.assert_close(mu / 0.1, g, atol=tol, rtol=tol)
        else:
            assert _rel(mu / 0.1, g, _median_norm(tree_leaves(ref_g))) < tol
    for p, r, g in zip(tree_leaves(new), tree_leaves(ref_new),
                       tree_leaves(ref_g), strict=True):
        steady = g.abs() >= 1e-3 * g.abs().max()
        assert torch.all((p - r)[~steady].abs() <= 2 * LR + 1e-6)
        if dtype == torch.float32:
            torch.testing.assert_close(p[steady], r[steady], atol=tol,
                                       rtol=tol)
        else:
            # an element of a leaf near zero in bf16 may also step the
            # other way; a bf16 round's steps agree on most elements
            flipped = ((p - r)[steady].abs() > LR).float().mean()
            assert flipped < 0.1


def _route_layer(logits_bias_free, bias, cfg):
    """A router whose f32 logits for the identity tokens are the rows of
    ``logits_bias_free``."""
    n, e = logits_bias_free.shape
    h = torch.eye(n, cfg.d_model)
    router = torch.zeros(cfg.d_model, e)
    router[:n] = logits_bias_free
    return M.route(h, router, bias, cfg)


def test_router_hand_computed():
    cfg = dataclasses.replace(CFG, n_experts=4, top_k=2,
                              held_experts=(0, 1), routed_scale=2.0)
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0], [-1.0, 0.0, 3.0, 1.0]])
    s = torch.sigmoid(logits)
    choice, weights = _route_layer(logits, torch.zeros(4), cfg)
    order = choice.sort(-1)
    assert order.values.tolist() == [[0, 1], [2, 3]]
    expect = torch.stack([s[0, [0, 1]] / s[0, [0, 1]].sum(),
                          s[1, [2, 3]] / s[1, [2, 3]].sum()]) * 2.0
    torch.testing.assert_close(weights.gather(-1, order.indices), expect)
    # the bias makes expert 2 beat expert 1 for token 0: the choice moves,
    # and the weights are the unbiased scores of the new choice
    bias = torch.tensor([0.0, 0.0, 0.3, 0.0])
    choice, weights = _route_layer(logits, bias, cfg)
    order = choice.sort(-1)
    assert order.values.tolist() == [[0, 2], [2, 3]]
    expect0 = s[0, [0, 2]] / s[0, [0, 2]].sum() * 2.0
    torch.testing.assert_close(weights.gather(-1, order.indices)[0], expect0)
    # the reference's router agrees
    ref_choice, ref_w = R.router(torch.eye(2, cfg.d_model),
                                 _router_matrix(logits, cfg), bias, cfg)
    assert ref_choice.sort(-1).values.tolist() == [[0, 2], [2, 3]]
    torch.testing.assert_close(ref_w.sort(-1).values,
                               weights.sort(-1).values)


def _router_matrix(logits, cfg):
    router = torch.zeros(cfg.d_model, logits.shape[1])
    router[:logits.shape[0]] = logits
    return router


def _moe_layer(gen, cfg, held):
    """A MoE layer's weights holding experts ``held`` of ``cfg``, its
    router and its correction bias."""
    cfg = dataclasses.replace(cfg, held_experts=held)
    full = M.init_params(gen, cfg, "cpu")
    buffers = M.init_buffers(gen, cfg, "cpu")
    return (full["layers"][cfg.first_k_dense], buffers["router"][0],
            buffers["score_bias"][0])


def test_expert_shares_add_up_to_the_uncut_layer():
    """Two chips' shares of an 8-expert layer (experts 0-3 and 4-7), with
    the shared MLP that every chip computes counted once, add up to the
    reference's layer holding all 8."""
    gen = torch.Generator().manual_seed(5)
    uncut, router, bias = _moe_layer(gen, CFG, tuple(range(8)))
    h = torch.randn(40, CFG.d_model, generator=gen)
    parts = []
    for held in ((0, 1, 2, 3), (4, 5, 6, 7)):
        cfg = dataclasses.replace(CFG, held_experts=held)
        layer = dict(uncut, experts=[uncut["experts"][e] for e in held])
        parts.append(M.moe(h, layer, router, bias, cfg, lambda w: w))
    shared = M.swiglu(h, uncut["shared_gate"], uncut["shared_up"],
                      uncut["shared_down"])
    with R.exact_float32():
        whole = R.moe(h, uncut, router, bias, CFG, held=tuple(range(8)))
    torch.testing.assert_close(parts[0] + parts[1] - shared, whole,
                               atol=F32_TOL, rtol=F32_TOL)
    # and each share alone is the reference's layer cut to that share
    with R.exact_float32():
        first = R.moe(h, dict(uncut, experts=uncut["experts"][:4]), router,
                      bias, CFG, held=(0, 1, 2, 3))
    torch.testing.assert_close(parts[0], first, atol=F32_TOL, rtol=F32_TOL)


def test_no_token_slot_dropped_under_skewed_routing():
    """Every token chooses experts 0, 1 and 2 (a bias far above every
    score): each of them takes all N tokens, with no capacity, and the
    layer still equals the dense reference."""
    gen = torch.Generator().manual_seed(7)
    layer, router, _ = _moe_layer(gen, CFG, CFG.held_experts)
    bias = torch.zeros(CFG.n_experts)
    bias[:3] = 10.0
    n = 50
    h = torch.randn(n, CFG.d_model, generator=gen)
    choice, _ = M.route(h, router, bias, CFG)
    sel, sizes, counts = M.held_slots(choice, CFG)
    assert sizes == [n, n, n, 0]
    assert counts.tolist() == sizes
    assert sorted(sel.tolist()) == list(range(n * CFG.top_k))
    out = M.moe(h, layer, router, bias, CFG, lambda w: w)
    with R.exact_float32():
        ref = R.moe(h, layer, router, bias, CFG)
    torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)


def test_held_slots_group_by_held_expert_and_skip_absent_ones():
    cfg = dataclasses.replace(CFG, held_experts=(6, 1))
    choice = torch.tensor([[1, 6, 3], [0, 2, 6], [1, 4, 5]])
    sel, sizes, _ = M.held_slots(choice, cfg)
    assert sizes == [2, 2]  # expert 6 first, as held_experts orders them
    flat = choice.reshape(-1)
    assert flat[sel].tolist() == [6, 6, 1, 1]


def test_rope_turns_only_the_rope_part(monkeypatch):
    """RoPE is applied twice a layer, to q_pe and k_pe, each
    ``qk_rope_dim`` wide, and equals the reference's complex product."""
    widths = []
    orig = M.apply_rope

    def spy(x, cos, sin):
        widths.append(x.shape[-1])
        return orig(x, cos, sin)

    monkeypatch.setattr(M, "apply_rope", spy)
    params, buffers, tokens = _setup()
    M.forward_local(params, tokens[0], CFG, buffers)
    assert widths == [CFG.qk_rope_dim] * (2 * CFG.n_layers)
    x = torch.randn(2, 16, 4, CFG.qk_rope_dim)
    cos, sin = M.rope_tables(16, CFG.qk_rope_dim, CFG.rope_theta,
                             torch.device("cpu"))
    torch.testing.assert_close(M.apply_rope(x, cos, sin),
                               R.rope(x, CFG.rope_theta), atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(M.apply_rope(x, cos, sin)[:, 0], x[:, 0])


def test_attention_pads_v_to_the_qk_width_and_slices_back():
    """q/k 24 wide, v 16: the output is the textbook attention's at v's
    width, scaled by 24^-0.5."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 10, 4, 24, generator=gen)
    k = torch.randn(2, 10, 4, 24, generator=gen)
    v = torch.randn(2, 10, 4, 16, generator=gen)
    out = M.attend(q, k, v, "flash")
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(24)
    s = s.masked_fill(~torch.ones(10, 10, dtype=torch.bool).tril(),
                      float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert out.shape == (2, 10, 4, 16)
    torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("kwargs", [
    {"seq_devices": 2}, {"group": object()}])
def test_make_engine_refuses_what_the_family_lacks(kwargs):
    seq = kwargs.pop("seq_devices", 1)
    with pytest.raises(ValueError, match="one card"):
        FT.make_engine(4, seq, CFG, device="cpu", **kwargs)


def test_ring_attention_is_refused_for_the_family():
    with pytest.raises(ValueError, match="ring"):
        dataclasses.replace(CFG, attention="ring")


def test_make_engine_runs_the_family_through_the_same_round():
    eng = FT.make_engine(4, 1, CFG, device="cpu")
    assert isinstance(eng, FT.FedTransformer)
    params, opt = eng.init(3)
    assert set(params) == {"embed", "head", "final_norm", "layers"}
    tokens = torch.randint(0, CFG.vocab, (4, 2, 16),
                           generator=torch.Generator().manual_seed(3))
    new, opt, loss = eng.round(params, opt, tokens, torch.ones(4))
    assert math.isfinite(float(loss))
    assert opt.count == 1
    # every leaf with a gradient moved (a held expert no token chose has
    # none)
    for a, b, mu in zip(tree_leaves(new), tree_leaves(params),
                        tree_leaves(opt.mu), strict=True):
        assert torch.equal(a, b) == (not mu.any())


def test_moe_ranges_and_counter_under_a_profiler_only(monkeypatch):
    params, buffers, tokens = _setup()
    tok = tokens[0]
    tracing.COUNTERS.drain()

    def step():
        leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        loss = M.loss_local(tree_unflatten(params, leaves), tok, CFG,
                            buffers)
        torch.autograd.grad(loss, leaves)

    marked = []
    orig = tracing._marked

    def spy(name, captured):
        marked.append(name)
        return orig(name, captured)

    monkeypatch.setattr(tracing, "_marked", spy)
    step()
    assert marked == []
    assert tracing.COUNTERS.drain() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    names = {e.name for e in prof.events()}
    moe_layers = CFG.n_layers - CFG.first_k_dense
    for name in ("moe.route", "moe.experts", "moe.combine"):
        assert name in names
        assert marked.count(name) == moe_layers
    # the backward opens one range a held expert a layer
    assert "moe.experts_bwd" in names
    assert marked.count("moe.experts_bwd") == moe_layers * CFG.n_held
    slots = tracing.COUNTERS.drain()[M.SLOTS_COUNTER]
    assert slots.shape == (CFG.n_held,)
    # every held slot counted once a layer; with 4 of 8 held, top-3 of
    # 16 tokens, about half of the 48 slots a layer
    assert 0 < int(slots.sum()) <= moe_layers * tok.numel() * CFG.top_k
