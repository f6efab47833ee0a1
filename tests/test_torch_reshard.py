"""The port's reshard planner and executor (``mpi4torch_tpu_torch.
reshard``) against the JAX package's (``mpi4torch_tpu.reshard``) on the
CPU.

Plans are equal field for field (strategy, steps and their tables,
groups, chunks, the wire and peak estimates, the adjoint plans) for every
transition, strategy and dtype here.  On eight rank threads, the same
numpy shards go through the JAX package's Mode B (``run_ranks``) and the
port: every transition of the JAX reshard tests' ``CASES`` under the auto
strategy and ``gather``, ``rounds``, ``deterministic_mode``, tree and
rule-driven specs, the block permutation, and the backward of each
(against ``jax.vjp``) give the same bits, and equal the numpy
assemble-and-slice reference.  ``zero3_to_tp``, ``admit_zero3`` on a
2-layer flagship and ``rebalance_experts(strategy=)`` are bitwise the JAX
package's and the port's own unplanned routes.  The error cases, a
``rank_death`` during a reshard, a ``delay`` recovered under retries and
a traced reshard's event stream are the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu import reshard as jrs
from mpi4torch_tpu_torch import config, obs, reshard as rs
from mpi4torch_tpu_torch.reshard.executor import _EAGER_EXEC
from mpi4torch_tpu_torch.runtime import CommError
from mpi4torch_tpu_torch.utils.tree import tree_leaves

NR = 8
G = (16, 8)
FULL = np.random.default_rng(0).standard_normal(G)

# (name, from (mesh, spec), to (mesh, spec), expected auto strategy): the
# JAX package's reshard test table.
CASES = [
    ("migrate", ((8,), (0, None)), ((2, 4), (0, 1)), "alltoall"),
    ("migrate-T", ((8,), (0, None)), ((4, 2), (0, 1)), "alltoall"),
    ("axis-move", ((8,), (0, None)), ((8,), (None, 0)), "alltoall"),
    ("coarsen", ((8,), (0, None)), ((2, 4), ((0,), None)), "allgather"),
    ("refine", ((2, 4), ((0,), None)), ((8,), (0, None)), "local"),
    ("relabel", ((8,), (0, None)), ((2, 4), ((0, 1), None)), "local"),
    ("block-permute", ((2, 4), ((0, 1), None)), ((2, 4), ((1, 0), None)),
     "permute"),
    ("replicate", ((8,), (0, None)), ((8,), (None, None)), "allgather"),
    ("slice", ((8,), (None, None)), ((8,), (0, None)), "local"),
    ("zero-to-tp", ((8,), (0, None)), ((2, 4), (None, 1)), "alltoall"),
]
IDS = [c[0] for c in CASES]


def lay(pkg, pair):
    return pkg.layout(pair[0], *pair[1])


L8, L24 = ((8,), (0, None)), ((2, 4), (0, 1))


def np_shard(pair, r, arr=FULL):
    lt = lay(rs, pair)
    shape = lt.shard_shape(arr.shape)
    return arr[tuple(slice(b * s, (b + 1) * s)
                     for b, s in zip(lt.block(r), shape))]


def weights(pair, seed):
    """A rank-specific cotangent of the target shard per rank."""
    shape = lay(rs, pair).shard_shape(G)
    return np.random.default_rng(seed).standard_normal((NR,) + shape)


@pytest.fixture(autouse=True)
def _restore_config():
    yield
    for cfg in (config, jmpi.config):
        cfg.set_default_reshard_strategy(None)
        cfg.set_comm_retries(0)
        cfg.set_comm_backoff(0.05)
        cfg.set_fault_plan(None)
    config.set_comm_tracer(None)


# ------------------------------------------------------------------ plans

def _fields(obj):
    """A plan or step as nested plain values, with its class name."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            (f.name, _fields(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_fields(v) for v in obj)
    return obj


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plans_equal_jax(case):
    _, fl, tl, want = case
    for strategy in (None, "gather"):
        for tdt, jdt in ((torch.float64, np.float64),
                         (torch.float32, np.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            got = rs.plan_reshard(lay(rs, fl), lay(rs, tl), G, tdt, strategy)
            ref = jrs.plan_reshard(lay(jrs, fl), lay(jrs, tl), G, jdt,
                                   strategy)
            assert _fields(got) == _fields(ref)
            assert _fields(got.adjoint()) == _fields(ref.adjoint())
            assert got.strategy == (strategy or want)
    auto = rs.plan_reshard(lay(rs, fl), lay(rs, tl), G, torch.float64)
    gather = rs.plan_reshard(lay(rs, fl), lay(rs, tl), G, torch.float64,
                             "gather")
    assert auto.peak_bytes < gather.peak_bytes


def test_rounds_permutation_and_resize_plans_equal_jax():
    got = rs.plan_reshard(lay(rs, L8), lay(rs, L24), G, torch.float32,
                          "rounds")
    ref = jrs.plan_reshard(lay(jrs, L8), lay(jrs, L24), G, np.float32,
                           "rounds")
    assert _fields(got) == _fields(ref)
    perm = tuple(np.random.default_rng(3).permutation(16).tolist())
    for strategy in (None, "rounds"):
        got = rs.plan_permutation(lay(rs, L8), 0, perm, G, torch.float64,
                                  strategy)
        ref = jrs.plan_permutation(lay(jrs, L8), 0, perm, G, np.float64,
                                   strategy)
        assert _fields(got) == _fields(ref)
        assert _fields(got.adjoint()) == _fields(ref.adjoint())
    for args, kw in (((37, (3,), 8, 6, np.float32),
                      dict(embed_from=tuple(range(8)),
                           embed_to=(0, 1, 3, 4, 5, 6), exec_size=8)),
                     ((24, (), 6, 8, np.float64),
                      dict(embed_from=(0, 1, 2, 4, 5, 6),
                           embed_to=tuple(range(8)), exec_size=8))):
        for strategy in (None, "gather"):
            got = rs.plan_resize(*args, strategy=strategy, **kw)
            ref = jrs.plan_resize(*args, strategy=strategy, **kw)
            assert _fields(got) == _fields(ref)


def test_planner_rules():
    l8, l24 = lay(rs, L8), lay(rs, L24)
    assert rs.plan_reshard(l8, l8, G, torch.float64).steps == ()
    assert rs.plan_reshard(l8, l24, G, torch.float32) is \
        rs.plan_reshard(l8, l24, G, torch.float32)
    with pytest.raises(CommError, match="cannot serve"):
        rs.plan_reshard(l8, l24, G, torch.float64, strategy="permute")
    with pytest.raises(CommError, match="world size"):
        rs.plan_reshard(l8, rs.layout((4,), 0, None), G, torch.float64)
    with pytest.raises(CommError, match="unknown reshard strategy"):
        rs.plan_reshard(l8, l24, G, torch.float64, strategy="warp")
    config.set_default_reshard_strategy("rounds")
    assert config.default_reshard_strategy() == "rounds"
    assert rs.plan_reshard(l8, l24, G, torch.float64).strategy == "rounds"
    config.set_default_reshard_strategy("auto")
    assert rs.plan_reshard(l8, l24, G, torch.float64).strategy == \
        "alltoall"
    with pytest.raises(ValueError, match="reshard strategy"):
        config.set_default_reshard_strategy("warp")
    assert l24.block(5) == (1, 1) and l24.shard_shape(G) == (8, 2)
    with pytest.raises(CommError, match="not divisible"):
        l8.shard_shape((15, 8))
    with pytest.raises(CommError, match="at most one"):
        rs.Layout((2, 4), ((0,), (0,)))
    with pytest.raises(CommError, match="Layout"):
        rs.executor.as_layout("nope")


def test_step_registry_matches_executor_and_coverage():
    kinds = set(rs.STEP_KINDS)
    assert kinds == set(_EAGER_EXEC) == set(jrs.STEP_KINDS)
    assert rs.STRATEGIES == jrs.STRATEGIES
    exercised = set()
    for _, fl, tl, _w in CASES:
        for strategy in (None, "gather"):
            plan = rs.plan_reshard(lay(rs, fl), lay(rs, tl), G,
                                   torch.float64, strategy)
            for p in (plan, plan.adjoint()):
                exercised |= {s.kind for s in p.steps}
    plan = rs.plan_reshard(lay(rs, L8), lay(rs, L24), G, torch.float64,
                           "rounds")
    exercised |= {s.kind for s in plan.steps + plan.adjoint().steps}
    assert exercised == kinds


# ------------------------------------------------- transitions and VJPs

def _jax_move(fl, tl, w, strategy=None, det=False):
    def body(rank):
        c = jmpi.COMM_WORLD
        x = jnp.asarray(np_shard(fl, rank))
        with jmpi.config.deterministic_mode(det):
            y, vjp = jax.vjp(lambda v: c.Reshard(
                v, lay(jrs, fl), lay(jrs, tl), strategy=strategy), x)
            (g,) = vjp(jnp.asarray(w[rank]))
        return np.asarray(y), np.asarray(g)
    return jmpi.run_ranks(body, NR)


def _port_move(fl, tl, w, strategy=None, det=False):
    def body(rank):
        c = mpi.COMM_WORLD
        x = torch.from_numpy(np_shard(fl, rank).copy()).requires_grad_()
        with config.deterministic_mode(det):
            y = c.Reshard(x, lay(rs, fl), lay(rs, tl), strategy=strategy)
            (g,) = torch.autograd.grad(y, x, torch.from_numpy(w[rank]))
        return y.detach().numpy(), g.numpy()
    return mpi.run_ranks(body, NR, device="cpu")


@pytest.mark.parametrize("strategy", [None, "gather"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_transition_and_vjp_bitwise_jax(case, strategy):
    _, fl, tl, _ = case
    w = weights(tl, 1)
    got = _port_move(fl, tl, w, strategy)
    want = _jax_move(fl, tl, w, strategy)
    for r in range(NR):
        np.testing.assert_array_equal(got[r][0], np_shard(tl, r))
        np.testing.assert_array_equal(got[r][0], want[r][0])
        np.testing.assert_array_equal(got[r][1], want[r][1])


@pytest.mark.parametrize("strategy,det", [("rounds", False),
                                          (None, True), ("gather", True)])
def test_rounds_and_deterministic_mode_bitwise_jax(strategy, det):
    w = weights(L24, 2)
    got = _port_move(L8, L24, w, strategy, det)
    want = _jax_move(L8, L24, w, strategy, det)
    for r in range(NR):
        np.testing.assert_array_equal(got[r][0], np_shard(L24, r))
        for a, b in zip(got[r], want[r]):
            np.testing.assert_array_equal(a, b)


def test_cotangents_redistribute_and_replication_adjoint_sums():
    # L8 -> L24 is pure data movement: the cotangent comes back as the
    # reverse move.  L8 -> replicated sums the ranks' cotangents in
    # ascending rank order.
    w = weights(L24, 3)
    got = _port_move(L8, L24, w)
    wfull = np.zeros(G)
    l24 = lay(rs, L24)
    sh = l24.shard_shape(G)
    for r in range(NR):
        wfull[tuple(slice(b * s, (b + 1) * s)
                    for b, s in zip(l24.block(r), sh))] = w[r]
    for r in range(NR):
        np.testing.assert_array_equal(got[r][1], np_shard(L8, r, wfull))
    repl = ((8,), (None, None))
    w = weights(repl, 4)
    got = _port_move(L8, repl, w)
    acc = w[0]
    for r in range(1, NR):
        acc = acc + w[r]
    for r in range(NR):
        np.testing.assert_array_equal(got[r][1], np_shard(L8, r, acc))


def test_tree_and_rule_driven_specs_bitwise_jax():
    tree = {"w": FULL, "b": FULL[:, 0]}
    rules_from = [(r"w", L8), (r"b", ((8,), (0,)))]
    rules_to = [(r"w", L24), (r"b", ((2, 4), ((0, 1),)))]

    def specs(pkg, rules):
        return pkg.match_partition_rules(
            [(p, lay(pkg, pair)) for p, pair in rules], tree)

    def jbody(rank):
        c = jmpi.COMM_WORLD
        froms, tos = specs(jrs, rules_from), specs(jrs, rules_to)
        out = c.Reshard(jrs.shard_of(tree, froms, rank), froms, tos)
        return jax.tree.map(np.asarray, out)

    def pbody(rank):
        c = mpi.COMM_WORLD
        froms, tos = specs(rs, rules_from), specs(rs, rules_to)
        t = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        out = c.Reshard(rs.shard_of(t, froms, rank), froms, tos)
        return {k: v.numpy() for k, v in out.items()}

    want = jmpi.run_ranks(jbody, NR)
    got = mpi.run_ranks(pbody, NR, device="cpu")
    for r in range(NR):
        for k in tree:
            np.testing.assert_array_equal(got[r][k], want[r][k])
        np.testing.assert_array_equal(got[r]["w"], np_shard(L24, r))


def test_rules_paths_and_matching():
    params = {"blocks": [{"wo": np.zeros((8, 8)), "b": np.zeros(8)}],
              "step": np.zeros(())}
    paths = rs.tree_paths(params)
    assert paths == jrs.tree_paths(params)
    assert paths["blocks"][0]["wo"] == "blocks/0/wo"
    l24 = lay(rs, L24)
    lays = rs.match_partition_rules(
        [(r"blocks/\d+/wo", l24), (r".*", rs.layout((2, 4), 0))], params)
    assert lays["blocks"][0]["wo"] is l24
    assert lays["blocks"][0]["b"].factors == (2,)
    assert lays["step"].spec == () and lays["step"].mesh == (2, 4)
    with pytest.raises(CommError, match="no partition rule"):
        rs.match_partition_rules([(r"w", l24)], {"x": np.zeros((4, 4))})
    with pytest.raises(CommError, match="axis layout"):
        rs.match_partition_rules([(r".*", l24)], {"x": np.zeros((4, 4, 4))})


def test_block_permutation_and_its_gradient_bitwise_jax():
    perm = tuple(np.random.default_rng(3).permutation(16).tolist())
    w = weights(L8, 5)

    def jbody(rank):
        c = jmpi.COMM_WORLD
        x = jnp.asarray(np_shard(L8, rank))
        y, vjp = jax.vjp(lambda v: jrs.reshard_blocks(
            c, v, lay(jrs, L8), 0, perm), x)
        return np.asarray(y), np.asarray(vjp(jnp.asarray(w[rank]))[0])

    def pbody(rank):
        c = mpi.COMM_WORLD
        x = torch.from_numpy(np_shard(L8, rank).copy()).requires_grad_()
        y = rs.reshard_blocks(c, x, lay(rs, L8), 0, perm)
        (g,) = torch.autograd.grad(y, x, torch.from_numpy(w[rank]))
        return y.detach().numpy(), g.numpy()

    want = jmpi.run_ranks(jbody, NR)
    got = mpi.run_ranks(pbody, NR, device="cpu")
    inv = np.empty(16, int)
    inv[list(perm)] = np.arange(16)
    wfull = np.concatenate(list(w))
    for r in range(NR):
        np.testing.assert_array_equal(got[r][0], FULL[list(perm)][2 * r:
                                                                 2 * r + 2])
        np.testing.assert_array_equal(got[r][1], wfull[inv][2 * r:2 * r + 2])
        for a, b in zip(got[r], want[r]):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- scenarios

def test_zero3_to_tp_bitwise_jax():
    from mpi4torch_tpu.parallel import zero as JZ
    from mpi4torch_tpu_torch.parallel import zero as PZ

    params = {"w": FULL, "v": FULL[:10, :6].copy()}   # 10 rows: unaligned
    tp = {"w": ((2, 4), (None, 1)), "v": ((2, 4), (0, None))}
    w = {k: np.random.default_rng(6).standard_normal(
        (NR,) + lay(rs, tp[k]).shard_shape(params[k].shape))
        for k in params}

    def jbody(rank):
        c = jmpi.COMM_WORLD
        p = {k: jnp.asarray(v) for k, v in params.items()}
        shards = JZ.zero3_shard_params(c, p)
        out, vjp = jax.vjp(lambda s: JZ.zero3_to_tp(
            c, s, p, {k: lay(jrs, v) for k, v in tp.items()}), shards)
        (g,) = vjp({k: jnp.asarray(w[k][rank]) for k in params})
        return jax.tree.map(np.asarray, (out, g))

    def pbody(rank):
        c = mpi.COMM_WORLD
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        shards = {k: v.requires_grad_() for k, v in
                  PZ.zero3_shard_params(c, p).items()}
        out = PZ.zero3_to_tp(c, shards, p,
                             {k: lay(rs, v) for k, v in tp.items()})
        keys = sorted(out)
        gs = torch.autograd.grad([out[k] for k in keys],
                                 [shards[k] for k in keys],
                                 [torch.from_numpy(w[k][rank]) for k in keys])
        return ({k: v.detach().numpy() for k, v in out.items()},
                {k: g.numpy() for k, g in zip(keys, gs)})

    want = jmpi.run_ranks(jbody, NR)
    got = mpi.run_ranks(pbody, NR, device="cpu")
    for r in range(NR):
        for k in params:
            np.testing.assert_array_equal(
                got[r][0][k], np_shard(tp[k], r, params[k]))
            np.testing.assert_array_equal(got[r][0][k], want[r][0][k])
            np.testing.assert_array_equal(got[r][1][k], want[r][1][k])


@pytest.mark.parametrize("ffn", ["gelu", "swiglu"])
def test_admit_zero3_bitwise_shard_params_tp_and_jax(ffn):
    from mpi4torch_tpu.models import transformer as JT
    from mpi4torch_tpu.parallel import zero as JZ
    from mpi4torch_tpu.serve import kv as jkv
    from mpi4torch_tpu_torch.models import transformer as PT
    from mpi4torch_tpu_torch.parallel import zero as PZ
    from mpi4torch_tpu_torch.serve import kv as pkv

    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16, ffn=ffn)
    jcfg, pcfg = JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    jparams = jax.tree.map(np.asarray, JT.init_transformer(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    n = 4

    def jbody(rank):
        c = jmpi.COMM_WORLD
        p = jax.tree.map(jnp.asarray, jparams)
        shards = JZ.zero3_shard_params(c, p)
        out = jkv.admit_zero3(jcfg, c, shards, p, dtype=jnp.bfloat16)
        return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                            out)

    def pbody(rank):
        c = mpi.COMM_WORLD
        p = PT.params_from_jax(jparams, "cpu")
        shards = PZ.zero3_shard_params(c, p)
        out = pkv.admit_zero3(pcfg, c, shards, p, dtype=torch.bfloat16)
        ref = pkv.shard_params_tp(pcfg, PZ.zero3_params(c, shards, p), c)
        same = all(torch.equal(a, b.to(torch.bfloat16)) and
                   a.dtype == torch.bfloat16
                   for a, b in zip(tree_leaves(out), tree_leaves(ref)))
        return same, [a.float().numpy() for a in tree_leaves(out)]

    want = jmpi.run_ranks(jbody, n)
    got = mpi.run_ranks(pbody, n, device="cpu")
    for r in range(n):
        assert got[r][0], "admit_zero3 differs from shard_params_tp"
        ref = jax.tree.leaves(want[r])
        assert len(ref) == len(got[r][1])
        for a, b in zip(got[r][1], ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_moe_rebalance_strategies_bitwise_jax_and_alltoall(n):
    from mpi4torch_tpu.parallel import moe as JM
    from mpi4torch_tpu_torch.parallel import moe as PM

    E, epr = 2 * n, 2
    stack = np.random.default_rng(7).standard_normal((E, 3, 4))
    w = np.random.default_rng(8).standard_normal((E, 3, 4))
    perm = PM.balanced_assignment(list(range(E)), n)
    assert perm == JM.balanced_assignment(list(range(E)), n)

    def jbody(rank):
        c = jmpi.COMM_WORLD
        x = jnp.asarray(stack[rank * epr:(rank + 1) * epr])
        y, vjp = jax.vjp(lambda v: JM.rebalance_experts(
            c, {"w": v}, perm)["w"], x)
        g = vjp(jnp.asarray(w[rank * epr:(rank + 1) * epr]))[0]
        return np.asarray(y), np.asarray(g)

    def pbody(rank):
        c = mpi.COMM_WORLD
        out = {}
        # "alltoall" serves the 2-rank snake deal; "permute" never serves
        # a move of single experts out of two-expert shards.
        for strategy in (None, "auto", "rounds") + (
                ("alltoall",) if n == 2 else ()):
            x = torch.from_numpy(
                stack[rank * epr:(rank + 1) * epr].copy()).requires_grad_()
            y = PM.rebalance_experts(c, {"w": x}, perm,
                                     strategy=strategy)["w"]
            (g,) = torch.autograd.grad(y, x, torch.from_numpy(
                w[rank * epr:(rank + 1) * epr]))
            out[strategy] = (y.detach().numpy(), g.numpy())
        return out

    want = jmpi.run_ranks(jbody, n)
    got = mpi.run_ranks(pbody, n, device="cpu")
    with pytest.raises(CommError, match="cannot serve"):
        rs.plan_permutation(rs.layout((n,), 0, None, None), 0, perm,
                            stack.shape, torch.float64, "permute")
    for r in range(n):
        np.testing.assert_array_equal(
            want[r][0], stack[list(perm)][r * epr:(r + 1) * epr])
        for y, g in got[r].values():
            np.testing.assert_array_equal(y, want[r][0])
            np.testing.assert_array_equal(g, want[r][1])


# ----------------------------------------------------------------- errors

def _raises_in_ranks(body, n, exc, match):
    with pytest.raises(exc, match=match):
        mpi.run_ranks(body, n, device="cpu")


def test_error_cases_equal_jax():
    l4 = rs.layout((4,), 0, None)

    def size_mismatch():
        x = torch.zeros(l4.shard_shape(G))
        return mpi.COMM_WORLD.Reshard(x, l4, rs.layout((2, 2), 0, 1))

    _raises_in_ranks(size_mismatch, 3, CommError, "spans 4 ranks")

    def wrong_shard():
        return mpi.COMM_WORLD.Reshard(torch.zeros((3, 3)), lay(rs, L8),
                                      lay(rs, L24))

    _raises_in_ranks(wrong_shard, NR, CommError, "not divisible")
    plan = rs.plan_reshard(lay(rs, L8), lay(rs, L24), G, torch.float32)

    def wrong_plan_shape():
        return rs.execute_plan(mpi.COMM_WORLD, plan,
                               torch.zeros((3, 3), dtype=torch.float32))

    _raises_in_ranks(wrong_plan_shape, NR, CommError, "expects")

    def tree_mismatch():
        return mpi.COMM_WORLD.Reshard({"a": torch.zeros((2, 8))},
                                      {"b": lay(rs, L8)}, lay(rs, L24))

    _raises_in_ranks(tree_mismatch, NR, CommError,
                     "matching the state tree")
    with pytest.raises(CommError, match="rank-thread world"):
        rs.execute_plan(object(), plan, torch.zeros(plan.in_shape))

    def codec_without_wide_hop():
        x = torch.from_numpy(np_shard(L8, mpi.COMM_WORLD.rank).copy())
        return mpi.COMM_WORLD.Reshard(x, lay(rs, L8), lay(rs, L24),
                                      compression="q8")

    _raises_in_ranks(codec_without_wide_hop, NR, ValueError,
                     "wide full-world gather")


@pytest.mark.parametrize("codec", ["q8", "bf16"])
def test_compressed_wide_hop_bitwise_jax(codec):
    # compression= rides the gather strategy's full-world gather through
    # the compressed Allgather; the bits are the JAX package's, and the
    # backward is exact.
    src = FULL.astype(np.float32)
    w = weights(L24, 9).astype(np.float32)

    def jbody(rank):
        c = jmpi.COMM_WORLD
        x = jnp.asarray(np_shard(L8, rank, src))
        y, vjp = jax.vjp(lambda v: c.Reshard(
            v, lay(jrs, L8), lay(jrs, L24), strategy="gather",
            compression=codec), x)
        return np.asarray(y), np.asarray(vjp(jnp.asarray(w[rank]))[0])

    def pbody(rank):
        c = mpi.COMM_WORLD
        x = torch.from_numpy(np_shard(L8, rank, src).copy()).requires_grad_()
        y = c.Reshard(x, lay(rs, L8), lay(rs, L24), strategy="gather",
                      compression=codec)
        (g,) = torch.autograd.grad(y, x, torch.from_numpy(w[rank]))
        return y.detach().numpy(), g.numpy()

    want = jmpi.run_ranks(jbody, NR)
    got = mpi.run_ranks(pbody, NR, device="cpu")
    exact = _port_move(L8, L24, w.astype(np.float64))
    for r in range(NR):
        for a, b in zip(got[r], want[r]):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(got[r][0], np_shard(L24, r, src))
        np.testing.assert_allclose(got[r][0], np_shard(L24, r, src),
                                   atol=2e-2 * np.abs(src).max())
        np.testing.assert_array_equal(got[r][1], exact[r][1])


# ------------------------------------------------------- Mode A (run_spmd)

def _stack(fl, src=FULL):
    return np.stack([np_shard(fl, r, src) for r in range(NR)])


def _jax_spmd(fl, tl, w, strategy=None, det=False, codec=None, src=FULL):
    """The JAX package's Mode A: each rank reads its own row of the stacked
    shards and takes the cotangent of ``vdot(out, w[rank])`` inside the
    body (its Reshard's backward resolves the communicator when it is
    traced, which a VJP from outside ``run_spmd`` does out of the region);
    the stacked outputs and cotangents."""
    def body(xs, ws):
        c = jmpi.COMM_WORLD
        r = jnp.asarray(c.rank + 0)
        x = jax.lax.dynamic_index_in_dim(xs, r, 0, keepdims=False)
        wr = jax.lax.dynamic_index_in_dim(ws, r, 0, keepdims=False)
        y, vjp = jax.vjp(lambda v: c.Reshard(
            v, lay(jrs, fl), lay(jrs, tl), strategy=strategy,
            compression=codec), x)
        return y, vjp(wr)[0]

    with jmpi.config.deterministic_mode(det):
        out, g = jmpi.run_spmd(body, nranks=NR)(
            jnp.asarray(_stack(fl, src)), jnp.asarray(w))
    return np.asarray(out), np.asarray(g)


def _port_spmd(fl, tl, w, strategy=None, det=False, codec=None, src=FULL):
    def body(xs):
        c = mpi.COMM_WORLD
        return c.Reshard(xs[c.rank], lay(rs, fl), lay(rs, tl),
                         strategy=strategy, compression=codec)

    xs = torch.from_numpy(_stack(fl, src)).requires_grad_()
    with config.deterministic_mode(det):
        out = mpi.run_spmd(body, nranks=NR, device="cpu")(xs)
        (g,) = torch.autograd.grad(out, xs, torch.from_numpy(w))
    return out.detach().numpy(), g.numpy()


class TestSpmdParity:
    """The SPMD executor (``run_spmd``) on 8 rank threads: every transition
    of ``CASES``, auto and ``gather``, values equal to the numpy reference
    and BITWISE the JAX package's Mode A and the port's Mode B, cotangents
    (from outside ``run_spmd``) bitwise the port's Mode B and, under
    ``deterministic_mode``, bitwise the JAX package's Mode A.  Outside it
    XLA's native reduce-scatter folds a replication adjoint in its own
    order: within 1e-13 (f64) there."""

    @pytest.mark.parametrize("strategy,det", [(None, True), (None, False),
                                              ("gather", True)])
    @pytest.mark.parametrize("case", CASES, ids=IDS)
    def test_transition_and_vjp_bitwise(self, case, strategy, det):
        _, fl, tl, _ = case
        w = weights(tl, 3)
        po, pg = _port_spmd(fl, tl, w, strategy, det)
        jo, jg = _jax_spmd(fl, tl, w, strategy, det)
        b = _port_move(fl, tl, w, strategy, det)
        np.testing.assert_array_equal(po, jo)
        if det:
            np.testing.assert_array_equal(pg, jg)
        else:
            np.testing.assert_allclose(pg, jg, rtol=1e-13, atol=1e-13)
        for r in range(NR):
            np.testing.assert_array_equal(po[r], np_shard(tl, r))
            np.testing.assert_array_equal(po[r], b[r][0])
            np.testing.assert_array_equal(pg[r], b[r][1])

    def test_rounds_strategy(self):
        w = weights(L24, 4)
        po, pg = _port_spmd(L8, L24, w, "rounds", det=True)
        jo, jg = _jax_spmd(L8, L24, w, "rounds", det=True)
        np.testing.assert_array_equal(po, jo)
        np.testing.assert_array_equal(pg, jg)

    @pytest.mark.parametrize("codec", ["q8", "bf16"])
    def test_compressed_wide_hop(self, codec):
        # The gather hop rides compress/spmd.allgather: bitwise the JAX
        # package's Mode A and the port's Mode B; the backward is exact.
        src = FULL.astype(np.float32)
        w = weights(L24, 9).astype(np.float32)
        po, pg = _port_spmd(L8, L24, w, "gather", codec=codec, src=src)
        jo, jg = _jax_spmd(L8, L24, w, "gather", codec=codec, src=src)
        np.testing.assert_array_equal(po, jo)
        np.testing.assert_array_equal(pg, jg)

        def pbody(rank):
            c = mpi.COMM_WORLD
            x = torch.from_numpy(np_shard(L8, rank, src).copy())
            return c.Reshard(x, lay(rs, L8), lay(rs, L24), strategy="gather",
                             compression=codec).numpy()

        eager = mpi.run_ranks(pbody, NR, device="cpu")
        _, exact = _port_spmd(L8, L24, w.astype(np.float64))
        for r in range(NR):
            np.testing.assert_array_equal(po[r], eager[r])
            assert not np.array_equal(po[r], np_shard(L24, r, src))
        np.testing.assert_array_equal(pg, exact.astype(np.float32))

    def test_tree_specs_and_mesh_communicator(self):
        # A tree of layouts, on a single-axis mesh communicator.
        mesh = mpi.device_mesh({"w": NR}, devices=["cpu"] * NR)
        wc = mpi.comm_from_mesh(mesh, "w")
        fl, tl = lay(rs, L8), lay(rs, L24)

        def body(xs):
            x = xs[wc.rank]
            out = wc.Reshard({"a": x, "b": [x * 2.0]}, fl,
                             {"a": tl, "b": [fl]})
            return out["a"], out["b"][0]

        a, b = mpi.run_spmd(body, mesh=mesh, axis_name="w")(
            torch.from_numpy(_stack(L8)))
        for r in range(NR):
            np.testing.assert_array_equal(a[r].numpy(), np_shard(L24, r))
            np.testing.assert_array_equal(b[r].numpy(), 2.0 * np_shard(L8, r))

    def test_tier_stack_and_size_refused(self):
        mesh = mpi.device_mesh({"dp": 2, "tp": 4}, devices=["cpu"] * 8)
        hc = mpi.comm_from_mesh(mesh, ("dp", "tp"))
        with pytest.raises(CommError, match="flat communicator"):
            mpi.run_spmd(lambda x: hc.Reshard(x, lay(rs, L8), lay(rs, L24)),
                         mesh=mesh, axis_name="dp")(torch.zeros(2, 8))
        with pytest.raises(CommError, match="spans 8 ranks"):
            mpi.run_spmd(lambda x: mpi.COMM_WORLD.Reshard(
                x, lay(rs, L8), lay(rs, L24)), nranks=4, device="cpu")(
                    torch.zeros(2, 8))


def test_cli_smoke_exits_zero(capsys):
    from mpi4torch_tpu_torch.reshard.__main__ import (main,
                                                      reshard_step_problems)

    assert reshard_step_problems() == []
    assert main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("bitwise=ok") == 11 and "reshard-smoke: OK" in out
    # Every planned cell's recorded peak sits below the gather's.
    assert out.count("peak_live") == 10


# --------------------------------------------------- faults and tracing

def _migrate(rank):
    x = torch.from_numpy(np_shard(L8, rank).copy())
    return mpi.COMM_WORLD.Reshard(x, lay(rs, L8), lay(rs, L24)).numpy()


def test_rank_death_during_reshard_is_attributed():
    with mpi.fault_scope([mpi.FaultSpec("rank_death", rank=2,
                                        op="Reshard")]):
        with pytest.raises(mpi.RankFailedError) as ei:
            mpi.run_ranks(_migrate, NR, timeout=20.0, device="cpu")
    assert 2 in ei.value.ranks


def test_delay_during_reshard_recovers_under_retries():
    config.set_comm_retries(5)
    config.set_comm_backoff(0.15)
    with mpi.fault_scope([mpi.FaultSpec("delay", rank=1, op="Reshard",
                                        seconds=0.5)]) as plan:
        out = mpi.run_ranks(_migrate, NR, timeout=0.3, device="cpu")
    assert "delay" in plan.fired_kinds()
    for r in range(NR):
        np.testing.assert_array_equal(out[r], np_shard(L24, r))


FIELDS = ("channel", "op", "payload_bytes", "family", "algorithm", "codec",
          "bucket", "group_size", "shape", "dtype", "status", "retries")


@pytest.mark.parametrize("strategy", [None, "gather", "rounds"])
def test_traced_reshard_events_equal_jax(strategy):
    w = weights(L24, 10)
    with jmpi.obs.trace() as jt:
        _jax_move(L8, L24, w, strategy)
    with obs.trace() as pt:
        _port_move(L8, L24, w, strategy)

    def streams(t):
        return [[tuple(getattr(e, f) for f in FIELDS) + (repr(e.signature),)
                 for e in t.events_for(rank=r)] for r in range(NR)]

    got, want = streams(pt), streams(jt)
    assert all(got) and got == want
    assert {e.op for e in pt.events_for()} <= {
        "Reshard.alltoall", "Reshard.allgather", "Reshard.reduce_scatter",
        "Reshard.permute"}


def test_engine_serves_the_admitted_shards():
    # Two ZeRO-3 rank threads hand their shards to serving: an Engine
    # built on admit_zero3's shards emits the tokens of one built on the
    # gathered parameters, and of generate().
    from mpi4torch_tpu_torch import serve
    from mpi4torch_tpu_torch.models import transformer as PT
    from mpi4torch_tpu_torch.parallel import zero as PZ
    from mpi4torch_tpu_torch.serve import kv as pkv

    cfg = PT.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                               d_ff=64, max_seq=32)
    params = PT.init_transformer(0, cfg, torch.float64, device="cpu")
    prompts = [[1, 5, 9, 2], [7, 3], [4, 4, 8, 1, 6]]

    def body(rank):
        c = mpi.COMM_WORLD
        shards = PZ.zero3_shard_params(c, params)
        out = []
        for kw in (dict(shards=pkv.admit_zero3(cfg, c, shards, params)),
                   dict(params=PZ.zero3_params(c, shards, params))):
            eng = serve.Engine(cfg, kw.get("params"),
                               serve.ServeConfig(slots=2, max_new=6),
                               device="cpu", shards=kw.get("shards"))
            for p in prompts:
                eng.submit(p)
            eng.run()
            out.append([eng.results()[i].tolist() for i in range(3)])
        return out

    got = mpi.run_ranks(body, 2, device="cpu")
    for p, toks in zip(prompts, got[0][0]):
        want = PT.generate(cfg, params, torch.tensor([p]), n_new=6)[0]
        assert toks == want.tolist()
    assert got[0][0] == got[0][1] == got[1][0] == got[1][1]
