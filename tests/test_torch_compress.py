"""The port's compressed Allreduce against the JAX package's Mode B.

Every value comparison is bitwise: the quantized fold oracle
(``constants.reduce_q8_hop``) for each block-q8 codec on ring, bidir and
torus over (2,), (3,), (4,) and (8,) worlds; the compressed ``Allreduce``
value and gradient under ``run_ranks`` against JAX ``run_ranks``; and
``ef_allreduce`` over two steps.  The facade's degrade/raise rules are
held to the JAX package's where both packages serve the call, and to
``NotImplementedError`` naming ROADMAP.md where the port does not yet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import constants as JC
from mpi4torch_tpu.compress import ef as jef
from mpi4torch_tpu_torch import config as pconfig
from mpi4torch_tpu_torch import constants as PC
from mpi4torch_tpu_torch import tune as ptune
from mpi4torch_tpu_torch.compress import ef as pef
from mpi4torch_tpu_torch.compress import eager as peager

CODECS = {"q8": dict(),
          "q8_ef": dict(ef_rounds=2),
          "q8_ef_hop": dict(stochastic=True, hop_ef=True)}
# (world, algorithm, reverse); torus only where a 2-level group exists,
# reverse only where it changes the schedule (bidir).
SCHEDULES = [(n, a, rev) for n in (2, 3, 4, 8)
             for a, rev in (("ring", False), ("bidir", False),
                            ("bidir", True), ("torus", False))
             if a != "torus" or n in (4, 8)]
NUMEL = 1000            # not a multiple of the block: ragged chunks


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    return np.array_equal(a, b)


def _inputs(n, numel=NUMEL, seed=0):
    rng = np.random.default_rng(seed + 17 * n)
    return [(rng.standard_normal(numel) * 3.0).astype(np.float32)
            for _ in range(n)]


def test_multipath_orders_and_split_match_jax():
    for n in (2, 3, 4, 6, 8):
        for algo in ("ring", "bidir", "torus"):
            for inner in ((None,) if algo != "torus" else
                          tuple(g for g in range(1, n + 1) if n % g == 0)):
                for rev in (False, True):
                    assert PC.multipath_ring_orders(
                        n, algo, inner=inner, reverse=rev) == \
                        JC.multipath_ring_orders(n, algo, inner=inner,
                                                 reverse=rev)
    for total in (0, 1, 7, 1000):
        assert PC.multipath_split(total) == JC.multipath_split(total)
    for bad in (dict(algorithm="tree"), dict(algorithm="torus", inner=3)):
        with pytest.raises(ValueError):
            PC.multipath_ring_orders(4, **bad)


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("n, algo, reverse", SCHEDULES)
def test_reduce_q8_hop_bitwise_vs_jax(n, algo, reverse, codec):
    xs = _inputs(n)
    inner = ptune.best_group(n) if algo == "torus" else None
    kw = dict(block=128, algorithm=algo, inner=inner, reverse=reverse,
              **CODECS[codec])
    want = JC.reduce_q8_hop([jnp.asarray(x) for x in xs], **kw)
    got = PC.reduce_q8_hop([torch.from_numpy(x) for x in xs], **kw)
    assert _same_bits(got.numpy(), want)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_reduce_q8_hop_bidir_odd_split_bitwise_vs_jax(codec):
    # 2 x 1025: channel 1 starts at element 513 and fills its chunks
    # exactly, so its hops run on views one element off alignment.
    xs = _inputs(2, numel=1025, seed=5)
    assert PC.multipath_split(1025) == 513
    kw = dict(algorithm="bidir", **CODECS[codec])
    for reverse in (False, True):
        want = JC.reduce_q8_hop([jnp.asarray(x) for x in xs],
                                reverse=reverse, **kw)
        got = PC.reduce_q8_hop([torch.from_numpy(x) for x in xs],
                               reverse=reverse, **kw)
        assert _same_bits(got.numpy(), want)


def test_reduce_q8_hop_keeps_shape_and_dtype():
    xs = [np.random.default_rng(r).standard_normal((3, 5, 7))
          for r in range(3)]
    want = JC.reduce_q8_hop([jnp.asarray(x) for x in xs])
    got = PC.reduce_q8_hop([torch.from_numpy(x) for x in xs])
    assert got.dtype == torch.float64 and tuple(got.shape) == (3, 5, 7)
    assert np.array_equal(got.numpy(), np.asarray(want))
    one = torch.ones(4)
    assert PC.reduce_q8_hop([one]) is one


def _jax_value_and_grad(xs, n, codec, algo):
    def body(r):
        def loss(v):
            y = mpi.COMM_WORLD.Allreduce(v, mpi.MPI_SUM, compression=codec,
                                         algorithm=algo)
            return jnp.vdot(y, y), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(
            jnp.asarray(xs[r]))
        return np.asarray(y), np.asarray(g)

    return mpi.run_ranks(body, n)


def _torch_value_and_grad(xs, n, codec, algo):
    def body(r):
        x = torch.from_numpy(xs[r]).requires_grad_()
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression=codec,
                                   algorithm=algo)
        (g,) = torch.autograd.grad((y * y).sum(), x)
        return y.detach().numpy(), g.numpy()

    return P.run_ranks(body, n, device="cpu")


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("n, algo", [(4, "ring"), (4, "bidir"),
                                     (4, "torus"), (3, "bidir")])
def test_compressed_allreduce_value_and_grad_bitwise_vs_jax(n, algo,
                                                            codec):
    xs = _inputs(n, numel=5000, seed=3)
    want = _jax_value_and_grad(xs, n, codec, algo)
    got = _torch_value_and_grad(xs, n, codec, algo)
    for r in range(n):
        assert _same_bits(got[r][0], want[r][0])
        assert _same_bits(got[r][1], want[r][1])
        assert _same_bits(got[r][0], got[0][0])
        assert _same_bits(got[r][1], got[0][1])


def _grad_tree(rng, step):
    # "c" is carried as float32 bits and used as bfloat16 on both sides.
    return {"a": (rng.standard_normal((40, 33)) * (step + 1))
            .astype(np.float32),
            "b": (rng.standard_normal(700) * 1e-3).astype(np.float32),
            "c": rng.standard_normal((9, 64)).astype(np.float32)}


def _bf16_as_f32(tree):
    return {k: np.asarray(v.astype(jnp.float32)) if k == "c"
            else np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("codec", ["q8", "q8_ef", "q8_ef_hop"])
def test_ef_allreduce_two_steps_bitwise_vs_jax(codec):
    n = 3
    grads = [[_grad_tree(np.random.default_rng(10 * step + r), step)
              for r in range(n)] for step in range(2)]

    def jax_tree(step, r):
        return {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "c"
                else jnp.asarray(v) for k, v in grads[step][r].items()}

    def torch_tree(step, r):
        return {k: torch.from_numpy(v).to(torch.bfloat16) if k == "c"
                else torch.from_numpy(v) for k, v in grads[step][r].items()}

    def jax_body(r):
        resid = jef.ef_init(jax_tree(0, r))
        out = []
        for step in range(2):
            synced, resid = jef.ef_allreduce(mpi.COMM_WORLD,
                                             jax_tree(step, r), resid,
                                             compression=codec)
            out.append((_bf16_as_f32(synced), _bf16_as_f32(resid)))
        return out

    def torch_body(r):
        resid = pef.ef_init(torch_tree(0, r))
        out = []
        for step in range(2):
            synced, resid = pef.ef_allreduce(P.COMM_WORLD,
                                             torch_tree(step, r), resid,
                                             compression=codec)
            out.append(tuple({k: v.float().numpy() for k, v in t.items()}
                             for t in (synced, resid)))
        return out

    want = mpi.run_ranks(jax_body, n)
    got = P.run_ranks(torch_body, n, device="cpu")
    for r in range(n):
        for step in range(2):
            for part in (0, 1):
                for k in ("a", "b", "c"):
                    assert _same_bits(got[r][step][part][k],
                                      want[r][step][part][k])
    if codec != "q8_ef_hop":
        assert np.abs(got[0][0][1]["a"]).max() > 0    # a residual is carried


def test_ef_allreduce_exact_passes_residual_through():
    resid = {"a": torch.ones(3)}
    synced, out = pef.ef_allreduce(P.COMM_WORLD, {"a": torch.full((3,), 2.)},
                                   resid, compression=None)
    assert out is resid and torch.equal(synced["a"], torch.full((3,), 2.))


# --- facade rules ------------------------------------------------------------


def _on_world(n, fn):
    return P.run_ranks(fn, n, device="cpu")


def test_explicit_codec_on_integer_tensor_raises_scope_degrades():
    x = torch.arange(6)
    with pytest.raises(ValueError, match="floating"):
        P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression="q8")

    def fn():
        with pconfig.compression_scope("q8"):
            return P.COMM_WORLD.Allreduce(torch.arange(6), P.MPI_SUM)

    for out in _on_world(2, fn):
        assert torch.equal(out, 2 * torch.arange(6))


def test_non_sum_explicit_raises_scope_degrades():
    def explicit():
        try:
            P.COMM_WORLD.Allreduce(torch.ones(4), P.MPI_MAX,
                                   compression="q8")
        except P.CommError as e:
            return e
        return None

    assert all(isinstance(e, P.CommError) and "MPI_SUM only" in str(e)
               for e in _on_world(2, explicit))

    def scoped(r):
        with pconfig.compression_scope("q8"):
            return P.COMM_WORLD.Allreduce(torch.full((4,), r + 0.5),
                                          P.MPI_MAX)

    for out in _on_world(2, scoped):
        assert torch.equal(out, torch.full((4,), 1.5))


def test_scope_compresses_and_false_overrides_it():
    xs = _inputs(3, numel=300, seed=9)
    exact = xs[0] + xs[1] + xs[2]

    def fn(r):
        x = torch.from_numpy(xs[r])
        with pconfig.compression_scope("q8"):
            lossy = P.COMM_WORLD.Allreduce(x, P.MPI_SUM)
            off = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression=False)
        return lossy.numpy(), off.numpy()

    lossy, off = _on_world(3, fn)[0]
    want = PC.reduce_q8_hop([torch.from_numpy(x) for x in xs]).numpy()
    assert _same_bits(lossy, want) and not np.array_equal(lossy, off)
    assert np.array_equal(off, PC.reduce_ordered(
        P.MPI_SUM, [torch.from_numpy(x) for x in xs]).numpy())
    assert np.linalg.norm(lossy - exact) <= 2.5e-2 * np.linalg.norm(exact)
    assert pconfig.default_compression() is None


def _ring_only_q8():
    return P.compress.BlockQ8Codec(algorithms=("ring",))


def test_explicit_codec_with_explicit_non_ring_algorithm_raises():
    # The JAX facade's reconcile rule: q8 does not ride tree.  The port
    # holds the same rule, and for a codec that rides ring only.
    with pytest.raises(ValueError, match="ring"):
        mpi.COMM_WORLD.Allreduce(jnp.ones(4), mpi.MPI_SUM, compression="q8",
                                 algorithm="tree")
    with pytest.raises(ValueError, match="ring"):
        P.COMM_WORLD.Allreduce(torch.ones(4), P.MPI_SUM, compression="q8",
                               algorithm="tree")
    with pytest.raises(ValueError, match="ring"):
        P.COMM_WORLD.Allreduce(torch.ones(4), P.MPI_SUM,
                               compression=_ring_only_q8(),
                               algorithm="bidir")


def test_scope_codec_yields_to_explicit_exact_algorithm():
    # A scope codec that does not ride an explicit algorithm yields to the
    # exact wire in that algorithm's association.
    xs = _inputs(3, numel=40, seed=6)

    def fn(r, scope, algorithm):
        x = torch.from_numpy(xs[r])
        with pconfig.compression_scope(scope):
            got = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, algorithm=algorithm)
        return got, P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression=False,
                                           algorithm=algorithm)

    for scope, algorithm in ((_ring_only_q8(), "bidir"), ("q8", "tree")):
        got, exact = _on_world(3, lambda r: fn(r, scope, algorithm))[0]
        assert torch.equal(got, exact)


def test_default_algorithm_is_ring_and_bidir_past_bandwidth_crossover():
    x = torch.zeros(1 << 14)
    codec = P.compress.get_codec("q8")
    assert peager.resolve_algorithm(4, x, codec, None) == "ring"
    pconfig.set_bandwidth_crossover_bytes(1 << 16)
    try:
        assert peager.resolve_algorithm(4, x, codec, None) == "bidir"
        assert peager.resolve_algorithm(4, x[:100], codec, None) == "ring"
        # a codec that does not ride bidir stays on ring
        assert peager.resolve_algorithm(4, x, _ring_only_q8(),
                                        None) == "ring"
        with pconfig.deterministic_mode():
            assert peager.resolve_algorithm(4, x, codec, None) == "ring"
        # The same pick on the wire: auto == explicit bidir, bitwise.
        xs = _inputs(4, numel=1 << 14, seed=4)

        def fn(r):
            x = torch.from_numpy(xs[r])
            return (P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression="q8"),
                    P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression="q8",
                                           algorithm="bidir"))

        auto, bidir = _on_world(4, fn)[0]
        assert torch.equal(auto, bidir)
    finally:
        pconfig.set_bandwidth_crossover_bytes(None)


def test_torus_group_rule():
    codec = P.compress.get_codec("q8")
    x = torch.zeros(64)
    assert ptune.resolve_hier_group(8) == 2
    # explicit torus on a prime world raises at the facade
    with pytest.raises(P.CommError, match="factorization"):
        _on_world(5, lambda: P.COMM_WORLD.Allreduce(
            torch.ones(4), P.MPI_SUM, compression="q8", algorithm="torus"))
    pconfig.set_hier_group_size(3)
    try:
        # a group size that does not split this world raises
        with pytest.raises(P.CommError, match="hier_group_size"):
            peager.resolve_algorithm(4, x, codec, "torus")
        assert ptune.resolve_hier_group(6) == 3
    finally:
        pconfig.set_hier_group_size(None)
    with pytest.raises(ValueError):
        pconfig.set_hier_group_size(1)


def test_allreduce_tree_compressed_needs_bucket_bytes_zero():
    # Compressed buckets are ported: with bucket_bytes None (the 4 MiB
    # default), a size or a compression scope, each float bucket rides
    # one compressed Allreduce of the flat bucket (the JAX package's
    # fused form; tests/test_torch_fuse.py holds it bitwise against JAX),
    # and bucket_bytes=0 keeps one compressed Allreduce per leaf.
    xs = [{"w": torch.from_numpy(x[:300]), "b": torch.from_numpy(x[300:])}
          for x in _inputs(3, numel=305, seed=8)]

    def fused_fn(r):
        c = P.COMM_WORLD
        flat = torch.cat([xs[r]["b"], xs[r]["w"]])   # key order: b, w
        want = c.Allreduce(flat, P.MPI_SUM, compression="q8") / 3
        outs = [c.Allreduce_tree(xs[r], P.MPI_SUM, compression="q8",
                                 bucket_bytes=bb, mean=True)
                for bb in (None, 1 << 20)]
        with pconfig.compression_scope("q8"):
            outs.append(c.Allreduce_tree(xs[r], P.MPI_SUM, mean=True))
        return all(torch.equal(o["b"], want[:5])
                   and torch.equal(o["w"], want[5:]) for o in outs)

    assert all(_on_world(3, fused_fn))

    def fn(r):
        fused = P.COMM_WORLD.Allreduce_tree(xs[r], P.MPI_SUM,
                                            compression="q8", bucket_bytes=0,
                                            mean=True)
        leaf = {k: P.COMM_WORLD.Allreduce(v, P.MPI_SUM, compression="q8")
                / 3 for k, v in xs[r].items()}
        return fused, leaf

    for fused, leaf in _on_world(3, fn):
        assert all(torch.equal(fused[k], leaf[k]) for k in leaf)


def test_codec_registry_and_unported_codecs():
    from mpi4torch_tpu_torch import compress

    assert compress.available_codecs() == ("q8", "q8_ef", "q8_ef_hop")
    assert compress.get_codec("none") is None
    assert compress.get_codec(False) is None
    with pytest.raises(ValueError, match="unknown compression"):
        compress.get_codec("q4")
    with pytest.raises(TypeError):
        compress.get_codec(3)
    for name in ("bf16", "bf16r"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            P.COMM_WORLD.Allreduce(torch.ones(3), P.MPI_SUM,
                                   compression=name)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            pconfig.set_default_compression(name)
    with pytest.raises(ValueError, match="unknown"):
        pconfig.set_default_compression("nope")
    pconfig.set_default_compression("q8")
    try:
        assert pconfig.default_compression().name == "q8"
        with pconfig.compression_scope(None):
            assert pconfig.default_compression() is None
    finally:
        pconfig.set_default_compression(None)


@pytest.mark.parametrize("name", ["q8", "q8_ef_hop"])
def test_codec_roundtrip_bitwise_vs_jax(name):
    from mpi4torch_tpu.compress import get_codec as jget
    from mpi4torch_tpu_torch.compress import get_codec as pget

    x = np.random.default_rng(1).standard_normal((17, 31)).astype(np.float32)
    want = jget(name).roundtrip(jnp.asarray(x))
    got = pget(name).roundtrip(torch.from_numpy(x))
    assert got.shape == (17, 31) and _same_bits(got.numpy(), want)


def test_knob_validation():
    with pytest.raises(ValueError):
        pconfig.set_quant_hop_impl("pallas")
    pconfig.set_quant_hop_impl("torch")
    assert pconfig.quant_hop_impl() == "torch"
    pconfig.set_quant_hop_impl("auto")
    for bad in ("lots", -1):
        with pytest.raises(ValueError):
            pconfig.set_bandwidth_crossover_bytes(bad)
    assert pconfig.bandwidth_crossover_bytes() is None
    for name in ("rhd", "tree", "hier"):
        assert ptune.get_algorithm(name).name == name
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ptune.get_algorithm("synth:deadbeef00")
    with pytest.raises(ValueError, match="unknown collective algorithm"):
        ptune.get_algorithm("nope")
