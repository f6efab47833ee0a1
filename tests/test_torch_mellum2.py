"""Mellum2-12B-A2.5B's block in the port, held to the plain float32
reference (``tests/torch_reference/mellum2.py``) at a small size on the
CPU: d 64, 4 query heads of 32 over 2 KV heads (q 128 wide against the
64-wide residual), 8 SwiGLU experts of 48 with top-2 and top-4, layer
kinds sliding x 3 and full (window 8, YaRN on the full layer), 32 tokens
a row, seeded random weights.

Tolerances: the port and the reference run in float32 on the CPU, in
different orders of summation (fused q|k|v and gate|up products, grouped
expert products against per-expert ones, the port's rope in its own
arithmetic), so values agree to ~1e-6 relative and gradients, which sum
over every token, to ~1e-5; 1e-4 leaves room for the worst leaf and
fails on any missing or changed term (a dropped assignment, an unscaled
gate, a wrong rope or window moves the loss by over 1e-2).  Ranks and
the defaults are compared bit for bit.
"""

import math

import pytest
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch import obs
from mpi4torch_tpu_torch.models import transformer as T
from mpi4torch_tpu_torch.parallel import moe as M
from mpi4torch_tpu_torch.utils.tree import value_and_grad
from torch_reference import mellum2 as R

RTOL = 1e-4
SEQ = 32
KINDS = ("sliding", "sliding", "sliding", "full")


def conf(k=2, yarn_orig=16):
    """The reference's configuration (published key names) at the small
    size."""
    return {
        "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 96,
        "num_hidden_layers": 4, "sliding_window": 8,
        "layer_types": [f"{t}_attention" for t in KINDS],
        "rope_parameters": {
            "full_attention": {"rope_type": "yarn", "rope_theta": 500000,
                               "factor": 16,
                               "original_max_position_embeddings":
                                   yarn_orig,
                               "beta_fast": 32, "beta_slow": 1,
                               "attention_factor": 1.2772588722239782},
            "sliding_attention": {"rope_type": "default",
                                  "rope_theta": 500000}},
        "num_experts": 8, "num_experts_per_tok": k, "norm_topk_prob": True,
        "moe_intermediate_size": 48, "rms_norm_eps": 1e-6}


def port_cfg(c):
    full = c["rope_parameters"]["full_attention"]
    return T.TransformerConfig(
        vocab=c["vocab_size"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_layers=c["num_hidden_layers"],
        d_ff=c["moe_intermediate_size"], max_seq=64,
        n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        attn_window=c["sliding_window"], rope=True, rope_theta=500000.0,
        norm="rmsnorm", norm_eps=c["rms_norm_eps"], ffn="swiglu",
        layer_types=KINDS, yarn_factor=float(full["factor"]),
        yarn_original_max=full["original_max_position_embeddings"],
        n_experts=c["num_experts"], moe="dropless",
        experts_per_token=c["num_experts_per_tok"])


def paths(tree, prefix=()):
    """``[(path tuple, leaf)]`` of a nested dict/list tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in paths(tree[k],
                                                       prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in paths(v,
                                                             prefix + (i,))]
    return [(prefix, tree)]


def setup(k=2, seed=0):
    c = conf(k)
    cfg = port_cfg(c)
    params = T.init_transformer(seed, cfg, device="cpu")
    # Norm scales away from 1, so that their gradients are checked at
    # general values.
    g = torch.Generator().manual_seed(seed + 1)
    for blk in params["blocks"]:
        for ln in ("ln1", "ln2"):
            blk[ln]["scale"] = 1 + 0.1 * torch.randn(64, generator=g)
    tokens = torch.randint(0, c["vocab_size"], (4, SEQ), generator=g)
    return c, cfg, params, tokens


def ref_loss_and_grads(c, params, tokens):
    P = {p: t.detach().clone().requires_grad_() for p, t in paths(params)}
    loss = R.loss(c, P, tokens)
    grads = torch.autograd.grad(loss, list(P.values()))
    return float(loss.detach()), dict(zip(P, grads))


def rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def ep_loss(cfg, p, tokens, comm):
    p = T._average_params(cfg, p, None, None, comm)
    return T._mean_over(comm, T.lm_loss(cfg, p, tokens, comm_ep=comm))


# ------------------------------------------------------------- router


@pytest.mark.parametrize("k", [2, 4])
def test_router_float32_renormalised_and_dropless(k):
    """The softmax is taken in float32 from bf16 logits, the gates are
    the top-k probabilities over their sum, and every token keeps k
    distinct experts: the counts sum to T * k (exact integer checks)."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(40, 8, generator=g).bfloat16()
    experts, gates = M.topk_route(logits, k)
    assert gates.dtype == torch.float32 and experts.shape == (40, k)
    p = torch.softmax(logits.float(), -1)
    top = p.gather(1, experts)
    # The chosen are the k largest, and the gates their share of them.
    assert torch.all(top.min(1).values >= p.topk(k, -1).values[:, -1])
    torch.testing.assert_close(gates, top / top.sum(1, keepdim=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(gates.sum(1), torch.ones(40),
                               rtol=1e-6, atol=1e-6)
    assert all(len(set(row.tolist())) == k for row in experts)
    assert int(torch.bincount(experts.flatten(), minlength=8).sum()) == \
        40 * k


# ------------------------------------------------ dropless EP = oracle


@pytest.mark.parametrize("k", [2, 4])
def test_ep2_layer_equals_dense_oracle(k):
    """The expert-parallel layer on 2 rank threads against
    ``moe_topk_ffn_dense`` on the whole batch: the value and every
    gradient; each rank's expert gradient is the oracle's slice."""
    torch.manual_seed(0)
    full = M.init_moe_topk(3, 8, 64, 48, device="cpu")
    x = torch.randn(2 * SEQ, 64)
    ref, g_ref = value_and_grad(
        lambda p: (M.moe_topk_ffn_dense(x, p, k) ** 2).sum(), full)

    def body():
        comm = mpi.COMM_WORLD
        xs = x[comm.rank * SEQ:(comm.rank + 1) * SEQ]
        return value_and_grad(lambda p: comm.Allreduce(
            (M.moe_topk_ffn(comm, xs, p, k) ** 2).sum(), mpi.MPI_SUM),
            M.expert_shard(comm, full))

    outs = mpi.run_ranks(body, 2, device="cpu")
    router = sum(g["router"] for _, g in outs) / 2
    for r, (loss, g) in enumerate(outs):
        assert float(loss) == pytest.approx(float(ref), rel=1e-6)
        # Every rank seeds 1, so the experts see 2 x the oracle's
        # cotangent (the Allreduce adjoint sums them).
        for n in ("w1", "w2"):
            assert rel(g[n] / 2, g_ref[n][4 * r:4 * (r + 1)]) < 1e-5
    assert rel(router, g_ref["router"]) < 1e-5


@pytest.mark.parametrize("k", [2, 4])
def test_ep2_model_equals_reference(k):
    """The whole model under EP=2 (``train_step``'s loss: replicated
    leaves averaged, experts sharded): the loss and every gradient
    against the reference on both ranks' rows; each rank's expert
    gradients are the reference's slice."""
    c, cfg, params, tokens = setup(k)
    loss_ref, g_ref = ref_loss_and_grads(c, params, tokens)

    def body():
        comm = mpi.COMM_WORLD
        mine = T.shard_experts(cfg, params, comm)
        return value_and_grad(
            lambda p: ep_loss(cfg, p, tokens[2 * comm.rank:
                                             2 * comm.rank + 2], comm),
            mine)

    outs = mpi.run_ranks(body, 2, device="cpu")
    for r, (loss, g) in enumerate(outs):
        assert float(loss) == pytest.approx(loss_ref, rel=1e-5)
        for path, grad in paths(g):
            want = g_ref[path]
            if path[-1] in ("w1", "w2"):
                want = want[4 * r:4 * (r + 1)]
            assert rel(grad, want) < RTOL, (r, path, rel(grad, want))


def test_ep2_train_step_equals_reference_sgd():
    """One ``train_step(comm_ep=COMM_WORLD)`` against one SGD step of the
    reference: the loss and every parameter; the replicated leaves end
    bit for bit equal on both ranks."""
    c, cfg, params, tokens = setup(2, seed=4)
    lr = 0.5
    loss_ref, g_ref = ref_loss_and_grads(c, params, tokens)

    def body():
        comm = mpi.COMM_WORLD
        mine = T.shard_experts(cfg, params, comm)
        return T.train_step(cfg, mine, tokens[2 * comm.rank:
                                              2 * comm.rank + 2],
                            comm_ep=comm, lr=lr)

    outs = mpi.run_ranks(body, 2, device="cpu")
    before = dict(paths(params))
    for r, (loss, new) in enumerate(outs):
        assert float(loss) == pytest.approx(loss_ref, rel=1e-5)
        for path, p in paths(new):
            want = before[path] - lr * g_ref[path]
            if path[-1] in ("w1", "w2"):
                want = want[4 * r:4 * (r + 1)]
            # The step moves each leaf by lr * g; compare the move.
            sl = before[path] if path[-1] not in ("w1", "w2") else \
                before[path][4 * r:4 * (r + 1)]
            assert rel(p - sl, want - sl) < RTOL, (r, path)
    for (pa, a), (pb, b) in zip(paths(outs[0][1]), paths(outs[1][1])):
        if pa[-1] not in ("w1", "w2"):
            assert torch.equal(a, b), pa


# ------------------------------------------------------- positions, masks


def test_yarn_frequencies_and_factor_equal_the_formula():
    """At the published head (128) and YaRN settings: ``low`` 18 and
    ``high`` 35, each frequency the blend of the formula (float64 here,
    float32 in the port: 1e-6), and cos and sin scaled by 1.2772...;
    the sliding layers keep the default frequencies exactly."""
    cfg = T.TransformerConfig(
        vocab=8, d_model=2304, n_heads=32, n_layers=4, d_ff=8, max_seq=8,
        n_kv_heads=4, head_dim=128, rope=True, rope_theta=500000.0,
        layer_types=KINDS, yarn_factor=16.0, yarn_original_max=8192)
    hd, theta = 128, 500000.0

    def dim(rot):
        return hd * math.log(8192 / (rot * 2 * math.pi)) / \
            (2 * math.log(theta))

    low, high = math.floor(dim(32)), math.ceil(dim(1))
    assert (low, high) == (18, 35)
    want = []
    for i in range(hd // 2):
        base = theta ** (-2 * i / hd)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(base / 16 * ramp + base * (1 - ramp))
    inv, scale = T.rope_inv_freq(cfg, hd, "full")
    torch.testing.assert_close(inv.double(), torch.tensor(want,
                                                          dtype=torch.float64),
                               rtol=1e-6, atol=0)
    # YaRN's attention factor 0.1 ln(16) + 1, the published value.
    assert scale == 1.2772588722239782
    dflt, one = T.rope_inv_freq(cfg, hd, "sliding")
    assert one == 1.0 and torch.equal(
        dflt, theta ** (-torch.arange(64, dtype=torch.float32) * 2.0 / hd))
    # The reference's frequencies agree.
    r_inv, r_scale = R.rope_frequencies(
        dict(conf(), head_dim=128, rope_parameters={
            "full_attention": dict(conf()["rope_parameters"][
                "full_attention"], original_max_position_embeddings=8192)}),
        "full_attention")
    torch.testing.assert_close(r_inv, inv, rtol=1e-6, atol=0)
    assert r_scale == scale


@pytest.mark.parametrize("kind,first", [("sliding", 13), ("full", 0)])
def test_window_edge_by_layer_kind(kind, first):
    """Query 20 of a sliding layer (window 8) sees keys 13..20 and not
    12; on the full layer it sees keys 0..20.  Probed through the
    attention the port's forward calls with each layer's window: equal
    scores, one-hot values, so the output row is the mean of the seen
    keys' positions."""
    cfg = port_cfg(conf())
    window = cfg.layer_window(KINDS.index(kind))
    s = 24
    q = torch.zeros(1, s, 1, 32)
    k = torch.zeros(1, s, 1, 32)
    v = torch.zeros(1, s, 1, 32)
    v[0, torch.arange(s), 0, torch.arange(s)] = 1.0
    o = T._attention(q, k, v, None, "ring", window)
    seen = torch.nonzero(o[0, 20, 0] > 0).flatten().tolist()
    assert seen == list(range(first, 21))
    assert [cfg.layer_window(i) for i in range(4)] == [8, 8, 8, 0]
    R_keep = R.visible(s, 8 if kind == "sliding" else 0)
    assert torch.nonzero(R_keep[20]).flatten().tolist() == seen


# ------------------------------------------------- head_dim and defaults


def test_head_dim_apart_from_width():
    """``head_dim`` 32 with 4 heads on a 64-wide residual: q is 128 wide,
    ``wqkv`` ``(64, (4 + 2 * 2) * 32)`` and ``wo`` ``(128, 64)``, and the
    one-rank forward's loss and gradients equal the reference's."""
    c, cfg, params, tokens = setup(2, seed=2)
    assert cfg.q_width == 128 and cfg.head_size == 32
    blk = params["blocks"][0]
    assert tuple(blk["wqkv"].shape) == (64, 256)
    assert tuple(blk["wo"].shape) == (128, 64)
    assert tuple(blk["moe"]["w1"].shape) == (8, 64, 96)
    assert tuple(blk["moe"]["w2"].shape) == (8, 48, 64)
    loss_ref, g_ref = ref_loss_and_grads(c, params, tokens)
    loss, g = value_and_grad(lambda p: T.lm_loss(cfg, p, tokens), params)
    assert float(loss) == pytest.approx(loss_ref, rel=1e-5)
    for path, grad in paths(g):
        assert rel(grad, g_ref[path]) < RTOL, path


def test_defaults_keep_the_dense_model_bitwise():
    """A dense Mistral-style configuration with the new fields at their
    defaults, and the same with every layer spelled out as sliding: the
    same loss and gradients, bit for bit."""
    kw = dict(vocab=64, d_model=64, n_heads=4, n_layers=3, d_ff=96,
              max_seq=64, n_kv_heads=2, attn_window=8, rope=True,
              norm="rmsnorm", ffn="swiglu")
    a = T.TransformerConfig(**kw)
    b = T.TransformerConfig(**kw, layer_types=("sliding",) * 3,
                            norm_eps=1e-5, head_dim=16)
    params = T.init_transformer(0, a, device="cpu")
    tokens = torch.randint(0, 64, (2, 24), generator=torch.Generator()
                           .manual_seed(1))
    la, ga = value_and_grad(lambda p: T.lm_loss(a, p, tokens), params)
    lb, gb = value_and_grad(lambda p: T.lm_loss(b, p, tokens), params)
    assert torch.equal(la, lb)
    for (_, x), (_, y) in zip(paths(ga), paths(gb)):
        assert torch.equal(x, y)


def test_grouped_mm_loops_on_the_cpu_only():
    """The per-group loop serves the CPU's float64 operands, equal to the
    products one group at a time; off the CPU, operands that
    ``torch._grouped_mm`` cannot take are refused, not looped over."""
    from mpi4torch_tpu_torch.ops.grouped import grouped_mm
    g = torch.Generator().manual_seed(4)
    x = torch.randn(7, 16, generator=g, dtype=torch.float64)
    w = torch.randn(2, 16, 8, generator=g, dtype=torch.float64)
    torch.testing.assert_close(grouped_mm(x, w, [3, 4]),
                               torch.cat([x[:3] @ w[0], x[3:] @ w[1]]),
                               rtol=0, atol=0)
    with pytest.raises(TypeError, match="grouped_mm"):
        grouped_mm(x.to("meta"), w.to("meta"), [3, 4])


# ----------------------------------------------------- obs and references


def test_moe_ranges_and_counters_only_under_trace():
    """Under ``obs.trace()`` the four ``mpi4torch.moe.*`` ranges reach the
    profiler, and the counters count every assignment once (T * k a
    layer over both ranks, none dropped) and the rows sent; outside it
    there is neither range nor count."""
    c, cfg, params, tokens = setup(2)

    def body():
        comm = mpi.COMM_WORLD
        mine = T.shard_experts(cfg, params, comm)
        x = tokens[2 * comm.rank:2 * comm.rank + 2]
        if comm.rank == 0:
            with torch.profiler.profile() as prof:
                T.lm_loss(cfg, mine, x, comm_ep=comm)
            return {e.name for e in prof.events()}
        T.lm_loss(cfg, mine, x, comm_ep=comm)
        return None

    ranges = {f"mpi4torch.moe.{s}" for s in ("route", "dispatch",
                                              "experts", "combine")}
    obs.reset_metrics()
    names = mpi.run_ranks(body, 2, device="cpu")[0]
    assert not names & ranges
    assert not [k for k in obs.snapshot()["counters"] if "moe" in k]
    with obs.trace():
        names = mpi.run_ranks(body, 2, device="cpu")[0]
    assert ranges <= names
    snap = obs.snapshot()
    counters = snap["counters"]
    for layer in range(4):
        lab = f'{{layer="{layer}"}}'
        assert counters["moe_assignments_total" + lab] == 4 * SEQ * 2
        assert 0 < counters["moe_assignments_sent_total" + lab] <= \
            4 * SEQ * 2
        assert snap["gauges"]["moe_expert_load_max_over_mean" + lab] >= 1.0
    obs.reset_metrics()


def test_the_two_references_agree():
    """The benchmark's copy (query blocks, the products through ``mm``)
    and this reference: the same loss and gradients on the same
    weights."""
    from benchmark.reference import common
    from benchmark.reference import moe_transformer as B

    c, cfg, params, tokens = setup(2, seed=6)
    loss_ref, g_ref = ref_loss_and_grads(c, params, tokens)
    P = {p: t.detach().clone().requires_grad_() for p, t in paths(params)}
    total = B.loss_sum(c, P, tokens, common.mm_f32) / (
        B.n_rows(tokens) * B.positions_per_row(tokens))
    grads = torch.autograd.grad(total, list(P.values()))
    assert float(total) == pytest.approx(loss_ref, rel=1e-6)
    for path, g in zip(P, grads):
        assert rel(g, g_ref[path]) < 1e-5, path
