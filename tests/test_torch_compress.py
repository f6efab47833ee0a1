"""The port's compressed Allreduce against the JAX package's Mode B.

Every value comparison is bitwise: the quantized fold oracle
(``constants.reduce_q8_hop``) for each block-q8 codec on ring, bidir and
torus over (2,), (3,), (4,) and (8,) worlds; the compressed ``Allreduce``
value and gradient under ``run_ranks`` against JAX ``run_ranks``; and
``ef_allreduce`` over two steps.  The facade's degrade/raise rules are
held to the JAX package's.  The bf16 codecs (round-to-nearest and
stochastic) and the compressed ``Allgather`` with its reduce-scatter
adjoint are held bitwise to JAX's Mode B for every codec, ``bf16r`` with
the same per-rank call counter.
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


@pytest.mark.parametrize("codec", ["q8", "q8_ef", "q8_ef_hop", "bf16",
                                   "bf16r"])
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
    if codec not in ("q8_ef_hop", "bf16r"):
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
    # Every codec of the JAX package is registered in the port (the bf16
    # pair since their port), resolves by name, and is accepted by the
    # facade and as a process default; unknown names and types raise.
    from mpi4torch_tpu import compress as jcompress
    from mpi4torch_tpu_torch import compress

    assert compress.available_codecs() == \
        ("bf16", "bf16r", "q8", "q8_ef", "q8_ef_hop") == \
        jcompress.available_codecs()
    assert compress.get_codec("none") is None
    assert compress.get_codec(False) is None
    with pytest.raises(ValueError, match="unknown compression"):
        compress.get_codec("q4")
    with pytest.raises(TypeError):
        compress.get_codec(3)
    for name in ("bf16", "bf16r"):
        codec = compress.get_codec(name)
        assert codec.name == name and codec.algorithms == ("ring",)
        assert codec.stochastic == (name == "bf16r")
        assert not codec.schedule_keyed and not codec.hop_fused
        x = torch.ones(3)
        assert torch.equal(
            P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression=name), x)
        pconfig.set_default_compression(name)
        assert pconfig.default_compression() is codec
        pconfig.set_default_compression(None)
    assert compress.get_codec("q8_ef_hop").schedule_keyed
    with pytest.raises(ValueError, match="unknown"):
        pconfig.set_default_compression("nope")
    pconfig.set_default_compression("q8")
    try:
        assert pconfig.default_compression().name == "q8"
        with pconfig.compression_scope(None):
            assert pconfig.default_compression() is None
    finally:
        pconfig.set_default_compression(None)


@pytest.mark.parametrize("name", ["q8", "q8_ef_hop", "bf16", "bf16r"])
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
    # Synthesized names resolve through csched.synth, not the registry,
    # which names them unknown as the JAX package's does.
    with pytest.raises(ValueError, match="unknown collective algorithm"):
        ptune.get_algorithm("synth:deadbeef00")
    with pytest.raises(ValueError, match="unknown collective algorithm"):
        ptune.get_algorithm("nope")


# --- the bf16 codecs and the compressed Allgather ----------------------------

ALL_CODECS = ("q8", "q8_ef", "q8_ef_hop", "bf16", "bf16r")


@pytest.mark.parametrize("name", ["bf16", "bf16r"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bf16_encode_bitwise_vs_jax(name, dtype):
    from mpi4torch_tpu.compress import get_codec as jget
    from mpi4torch_tpu_torch.compress import get_codec as pget
    from mpi4torch_tpu_torch.utils import threefry

    x = (np.random.default_rng(2).standard_normal((13, 77)) * 5) \
        .astype(dtype)
    # ties of round-to-nearest-even: the halfway points between bf16s
    x.reshape(-1)[:4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0]
    for seed in (0, 7):
        jp, jm = jget(name).encode(jnp.asarray(x), jax.random.PRNGKey(seed))
        pp, pm = pget(name).encode(torch.from_numpy(x),
                                   threefry.PRNGKey(seed))
        assert pp["q"].dtype == torch.bfloat16
        assert np.array_equal(pp["q"].view(torch.int16).numpy(),
                              np.asarray(jp["q"]).view(np.int16))
        got = pget(name).decode(pp, pm)
        want = jget(name).decode(jp, jm)
        assert got.dtype == torch.from_numpy(x).dtype
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_bf16r_is_unbiased_and_bf16_error_bounded():
    from mpi4torch_tpu_torch.compress import get_codec
    from mpi4torch_tpu_torch.utils import threefry

    x = torch.from_numpy(np.random.default_rng(3).standard_normal(1 << 16)
                         .astype(np.float32))
    # half a bf16 ulp: at most 2^-8 of |x| (8 significant bits)
    rel = ((get_codec("bf16").roundtrip(x) - x).abs() / x.abs()).max()
    assert rel <= 2.0 ** -8
    err = get_codec("bf16r").roundtrip(x, threefry.PRNGKey(1)) - x
    # one bf16 ulp of |x| bounds each error; the mean is within 4 standard
    # errors of 0
    assert ((err.abs() / x.abs()).max() < 2.0 ** -7).item()
    se = err.std() / len(err) ** 0.5
    assert abs(err.mean().item()) < 4 * se.item()


def _jax_allreduce_twice(xs, n, codec):
    def body(r):
        def loss(v):
            y = mpi.COMM_WORLD.Allreduce(v, mpi.MPI_SUM, compression=codec)
            y2 = mpi.COMM_WORLD.Allreduce(y * 0.5, mpi.MPI_SUM,
                                          compression=codec)
            return jnp.vdot(y2, jnp.arange(y2.size, dtype=y2.dtype)), y2

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(
            jnp.asarray(xs[r]))
        return np.asarray(y), np.asarray(g)

    return mpi.run_ranks(body, n)


def _torch_allreduce_twice(xs, n, codec):
    def body(r):
        x = torch.from_numpy(xs[r]).requires_grad_()
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression=codec)
        y2 = P.COMM_WORLD.Allreduce(y * 0.5, P.MPI_SUM, compression=codec)
        w = torch.arange(y2.numel(), dtype=y2.dtype)
        (g,) = torch.autograd.grad((y2 * w).sum(), x)
        return y2.detach().numpy(), g.numpy()

    return P.run_ranks(body, n, device="cpu")


@pytest.mark.parametrize("codec", ["bf16", "bf16r"])
@pytest.mark.parametrize("n, numel", [(2, 1000), (3, 1000), (4, 70000)])
def test_bf16_allreduce_value_and_grad_bitwise_vs_jax(n, numel, codec):
    # Two Allreduces and their two adjoints: bf16r's call counter advances
    # four times per rank in the same order in both packages; 70000
    # elements take the fold-once path.
    xs = _inputs(n, numel=numel, seed=11)
    want = _jax_allreduce_twice(xs, n, codec)
    got = _torch_allreduce_twice(xs, n, codec)
    for r in range(n):
        for i in (0, 1):
            assert _same_bits(got[r][i], want[r][i])
            assert _same_bits(got[r][i], got[0][i])
    exact = 0.5 * n * np.sum(xs, axis=0)
    assert np.linalg.norm(got[0][0] - exact) <= 1e-2 * np.linalg.norm(exact)


def _gather_inputs(n, seed):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((3, 40 + 37 * r)) * 2).astype(np.float32)
          for r in range(n)]
    ws = [rng.standard_normal((3, sum(x.shape[1] for x in xs)))
          .astype(np.float32) for _ in range(n)]
    return xs, ws


@pytest.mark.parametrize("codec", ALL_CODECS)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_compressed_allgather_value_and_grad_bitwise_vs_jax(n, codec):
    # Uneven shards along axis 1 and a rank-specific cotangent, so the
    # adjoint reduce-scatter sums distinct decoded segments.
    xs, ws = _gather_inputs(n, seed=20 + n)

    def jax_body(r):
        def loss(v):
            y = mpi.COMM_WORLD.Allgather(v, 1, compression=codec)
            return jnp.vdot(y, jnp.asarray(ws[r])), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(
            jnp.asarray(xs[r]))
        return np.asarray(y), np.asarray(g)

    def torch_body(r):
        x = torch.from_numpy(xs[r]).requires_grad_()
        y = P.COMM_WORLD.Allgather(x, 1, compression=codec)
        (g,) = torch.autograd.grad((y * torch.from_numpy(ws[r])).sum(), x)
        return y.detach().numpy(), g.numpy()

    want = mpi.run_ranks(jax_body, n)
    got = P.run_ranks(torch_body, n, device="cpu")
    exact = np.concatenate(xs, axis=1)
    for r in range(n):
        assert got[r][0].shape == exact.shape
        assert got[r][1].shape == xs[r].shape
        assert _same_bits(got[r][0], want[r][0])
        assert _same_bits(got[r][1], want[r][1])
        assert _same_bits(got[r][0], got[0][0])
    rel = np.linalg.norm(got[0][0] - exact) / np.linalg.norm(exact)
    assert rel <= {"q8": 2.5e-2, "q8_ef_hop": 2.5e-2, "q8_ef": 1e-3}.get(
        codec, 1e-2)


def test_compressed_allgather_size_one_and_float64():
    # One rank: the identity (nothing is encoded, as in the JAX package).
    x = torch.ones(3, 4, requires_grad=True)
    assert P.COMM_WORLD.Allgather(x, 0, compression="q8") is x
    # A float64 payload decodes to float64 on both sides.
    xs = [np.random.default_rng(r).standard_normal((5, 2)) for r in range(2)]

    def fn(r):
        return P.COMM_WORLD.Allgather(torch.from_numpy(xs[r]), 0,
                                      compression="bf16").numpy()

    want = mpi.run_ranks(lambda r: np.asarray(mpi.COMM_WORLD.Allgather(
        jnp.asarray(xs[r]), 0, compression="bf16")), 2)
    for got, w in zip(P.run_ranks(fn, 2, device="cpu"), want):
        assert got.dtype == np.float64 and np.array_equal(got, w)


def test_allgather_compression_rules_match_jax():
    def body():
        c = P.COMM_WORLD
        t = torch.arange(4.) + c.rank
        # an explicit codec with the packed path raises; no-compression
        # spellings stay accepted there
        with pytest.raises(ValueError, match="numelem"):
            c.Allgather(t, 0, numelem=2, compression="q8")
        assert torch.equal(c.Allgather(t, 0, numelem=2, compression=False),
                           c.Allgather(t, 0, numelem=2))
        # an explicit codec on an integer tensor raises; a scope codec
        # applies to floating tensors only
        with pytest.raises(ValueError, match="floating"):
            c.Allgather(torch.ones(2, dtype=torch.int32), 0,
                        compression="bf16")
        with pconfig.compression_scope("bf16"):
            scoped = c.Allgather(t / 3, 0)
            ints = c.Allgather(torch.ones(2, dtype=torch.int32), 0)
            off = c.Allgather(t / 3, 0, compression=False)
        explicit = c.Allgather(t / 3, 0, compression="bf16")
        exact = c.Allgather(t / 3, 0)
        return (torch.equal(scoped, explicit), ints.tolist() == [1] * 4,
                torch.equal(off, exact), torch.equal(scoped, exact))

    for same, ints, off, lossless in _on_world(2, body):
        assert same and ints and off and not lossless


def test_allgather_span_carries_codec():
    def body():
        x = torch.ones(8)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            P.COMM_WORLD.Allgather(x, 0, compression="bf16")
            P.COMM_WORLD.Allgather(x, 0)
        return {e.name for e in prof.events()}

    names = P.run_ranks(body, 1, device="cpu")[0]
    assert {"mpi4torch.Allgather.bf16", "mpi4torch.Allgather"} <= names


def test_bf16_rides_ring_only():
    # The JAX rule, both sides consulted: bf16 declares ring only, and an
    # explicit bf16 with an explicit bidir raises in both packages; a
    # scope bf16 yields to an explicit bidir (the exact wire); auto
    # selection past the bandwidth crossover keeps bf16 on ring.
    with pytest.raises(ValueError, match="ring"):
        mpi.COMM_WORLD.Allreduce(jnp.ones(4), mpi.MPI_SUM,
                                 compression="bf16", algorithm="bidir")
    with pytest.raises(ValueError, match="ring"):
        P.COMM_WORLD.Allreduce(torch.ones(4), P.MPI_SUM, compression="bf16",
                               algorithm="bidir")
    for name in ALL_CODECS:
        for algo in ("ring", "bidir", "torus", "tree", "rhd", "hier"):
            assert P.compress.codec_rides_algorithm(
                P.compress.get_codec(name), algo) == \
                mpi.compress.codec_rides_algorithm(
                    mpi.compress.get_codec(name), algo), (name, algo)
    for algo in ("ring", "rhd", "tree", "hier", "bidir", "torus"):
        assert ptune.get_algorithm(algo).codec_capable == \
            mpi.tune.get_algorithm(algo).codec_capable
    xs = _inputs(2, numel=40, seed=12)

    def scoped(r):
        x = torch.from_numpy(xs[r])
        with pconfig.compression_scope("bf16"):
            got = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, algorithm="bidir")
        return torch.equal(got, P.COMM_WORLD.Allreduce(
            x, P.MPI_SUM, compression=False, algorithm="bidir"))

    assert all(_on_world(2, scoped))
    codec = P.compress.get_codec("bf16")
    pconfig.set_bandwidth_crossover_bytes(1 << 10)
    try:
        x = torch.zeros(1 << 12)
        assert ptune.select_auto(nbytes=1 << 14, dtype=torch.float32,
                                 nranks=4, codec=codec) == "ring"
        assert peager.resolve_algorithm(4, x, codec, None) == "ring"
        assert ptune.select_auto(nbytes=1 << 14, dtype=torch.float32,
                                 nranks=4) == "bidir"
    finally:
        pconfig.set_bandwidth_crossover_bytes(None)


def test_register_codec_and_wire_bytes_match_jax():
    from mpi4torch_tpu_torch.compress import codecs as pcodecs

    for name in ALL_CODECS:
        for shape, jdt, pdt in (((1000,), jnp.float32, torch.float32),
                                ((7, 300), jnp.bfloat16, torch.bfloat16)):
            assert P.compress.get_codec(name).wire_bytes(shape, pdt) == \
                mpi.compress.get_codec(name).wire_bytes(shape, jdt)
    custom = P.compress.BF16Codec(name="bf16_test")
    assert P.compress.register_codec(custom) is custom
    try:
        assert P.compress.get_codec("bf16_test") is custom
        xs = _inputs(2, numel=30, seed=13)

        def fn(r):
            x = torch.from_numpy(xs[r])
            return torch.equal(
                P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression="bf16_test"),
                P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression="bf16"))

        assert all(_on_world(2, fn))
    finally:
        del pcodecs._REGISTRY["bf16_test"]
    with pytest.raises(ValueError, match="non-empty"):
        P.compress.register_codec(P.compress.BF16Codec(name=""))


@pytest.mark.parametrize("codec", ["bf16", "bf16r"])
def test_fused_bf16_buckets_bitwise_vs_jax(codec):
    # Allreduce_tree(compression=bf16) rides one compressed Allreduce per
    # bucket through the facade, as in the JAX package.
    n = 3
    trees = [{"w": _inputs(n, 300, seed=14)[r].reshape(30, 10),
              "b": _inputs(n, 7, seed=15)[r]} for r in range(n)]

    def jax_body(r):
        out = mpi.COMM_WORLD.Allreduce_tree(
            {k: jnp.asarray(v) for k, v in trees[r].items()}, mpi.MPI_SUM,
            compression=codec, mean=True)
        return {k: np.asarray(v) for k, v in out.items()}

    def torch_body(r):
        out = P.COMM_WORLD.Allreduce_tree(
            {k: torch.from_numpy(v) for k, v in trees[r].items()},
            P.MPI_SUM, compression=codec, mean=True)
        return {k: v.numpy() for k, v in out.items()}

    want = mpi.run_ranks(jax_body, n)
    got = P.run_ranks(torch_body, n, device="cpu")
    for r in range(n):
        for k in ("w", "b"):
            assert _same_bits(got[r][k], want[r][k])


@pytest.mark.parametrize("codec", ["bf16", "bf16r"])
@pytest.mark.parametrize("n, numel", [(2, 3000), (5, 3000), (4, 70000)])
def test_bf16_payloads_fold_bitwise_vs_jax(n, numel, codec):
    # A bfloat16 tensor: the encode is the identity for both codecs (a
    # bf16 value's low 16 f32 bits are zero, so bf16r's 16-bit noise never
    # carries), the decode widens to f32 and narrows back, and the fold
    # runs in bf16, one rounding a step.  JAX's Mode B dispatches the
    # ordered fold op by op, so each of its bf16 adds rounds too: the
    # results are bitwise equal, fold-once path (70000 elements) included.
    xs = _inputs(n, numel=numel, seed=16)

    def jax_body(r):
        y = mpi.COMM_WORLD.Allreduce(jnp.asarray(xs[r]).astype(jnp.bfloat16),
                                     mpi.MPI_SUM, compression=codec)
        return np.asarray(y.astype(jnp.float32))

    def torch_body(r):
        y = P.COMM_WORLD.Allreduce(torch.from_numpy(xs[r]).bfloat16(),
                                   P.MPI_SUM, compression=codec)
        assert y.dtype == torch.bfloat16
        return y.float().numpy()

    want = mpi.run_ranks(jax_body, n)
    got = P.run_ranks(torch_body, n, device="cpu")
    for r in range(n):
        assert _same_bits(got[r], want[r]) and _same_bits(got[r], got[0])


@pytest.mark.parametrize("codec", ["q8", "bf16"])
def test_allgather_decode_once_under_thread_stress(codec):
    # The compressed Allgather decodes each gathered payload once for all
    # the rank threads (compress/eager.py _decode_each_once).  With more
    # ranks than cores and a short switch interval, every rank's output
    # and gradient must still be the per-rank plain recomputation (each
    # payload decoded on its own), and the memo must be empty once the
    # rendezvous is over.
    import sys

    from mpi4torch_tpu_torch.compress import get_codec
    from mpi4torch_tpu_torch.runtime import effective_rank_context

    n, rounds = 12, 3
    base = get_codec(codec).base()
    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal(
        40 + r).astype(np.float32)) for r in range(n)]
    total = sum(x.numel() for x in xs)
    ws = [torch.from_numpy(np.random.default_rng(100 + r).standard_normal(
        total).astype(np.float32)) for r in range(n)]

    def roundtrip(t):
        payload, meta = base.encode(t, None)
        return base.decode(payload, meta)

    want_out = torch.cat([roundtrip(x) for x in xs])
    decoded_w = [roundtrip(w) for w in ws]
    offs = np.cumsum([0] + [x.numel() for x in xs])

    def body(rank):
        out, grads, left = [], [], []
        for _ in range(rounds):
            x = xs[rank].clone().requires_grad_()
            y = P.COMM_WORLD.Allgather(x, 0, compression=codec)
            (g,) = torch.autograd.grad(torch.dot(y, ws[rank]), x)
            out.append(y.detach())
            grads.append(g)
            world = effective_rank_context().world
            left.append(len(world.__dict__.get("_decode_memo", {})))
        return out, grads, left

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = P.run_ranks(body, n, timeout=60.0, device="cpu")
    finally:
        sys.setswitchinterval(prev)
    for rank, (out, grads, left) in enumerate(got):
        seg = PC.reduce_ordered(P.MPI_SUM, [
            d[offs[rank]:offs[rank + 1]] for d in decoded_w])
        for y, g in zip(out, grads):
            assert torch.equal(y, want_out)
            assert torch.equal(g, seg)
        assert left == [0] * rounds
