"""The port's quantized ring hop and its helpers against the JAX package.

Every comparison is bitwise.  The plain hop (``_torch_hop``, the CPU
route of ``dequant_accum_requant``) is held against the JAX package's
``_hop_jnp`` (jitted, as its fold oracle runs it) and against its Pallas
kernel run interpreted (``impl="pallas"`` off-TPU), for every
``want_resid`` × ``stochastic`` combination; the threefry noise against
``jax.random``; the scale, encode and residual helpers against theirs.
The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4torch_tpu.ops import quant_kernels as jqk
from mpi4torch_tpu_torch.ops import quant_kernels as pqk
from mpi4torch_tpu_torch.utils import threefry


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    return np.array_equal(a, b)


def _operands(nb, block, seed):
    """int8 payload, power-of-two scales, contributions holding a zero
    block, a subnormal block and a large block, and noise."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (nb, block)).astype(np.int8)
    scale = np.array(jqk.po2_scale(jnp.asarray(
        np.abs(rng.standard_normal(nb)) * 0.1 + 1e-3, jnp.float32)))
    mine = (rng.standard_normal((nb, block)) * 3.0).astype(np.float32)
    mine[0] = 0.0
    mine[1] = (rng.standard_normal(block) * 1e-39).astype(np.float32)
    mine[2] *= np.float32(1e30)
    noise = rng.random((nb, block), dtype=np.float32)
    return q, scale, mine, noise


def _port_hop(q, scale, mine, noise, want_resid):
    out = pqk.dequant_accum_requant(
        torch.from_numpy(q), torch.tensor(scale), torch.from_numpy(mine),
        noise=None if noise is None else torch.from_numpy(noise),
        want_resid=want_resid)
    return [None if t is None else t.numpy() for t in out]


# (block, nb): a ragged row count, a multiple of the Pallas row tile
# would be 256 rows, so 300 also pads there.
SHAPES = [(128, 37), (256, 300)]


@pytest.mark.parametrize("block, nb", SHAPES)
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("want_resid", [False, True])
def test_plain_hop_bitwise_vs_jax_jnp_and_pallas(block, nb, stochastic,
                                                 want_resid):
    q, scale, mine, noise = _operands(nb, block, seed=block + nb)
    # Subnormal contributions are kept out of this comparison: the JAX
    # package on the CPU flushes them (tests below pin that difference).
    mine[1] = 0.5
    nz = noise if stochastic else None
    got = _port_hop(q, scale, mine, nz, want_resid)
    jnp_out = jqk._hop_jnp_jit(jnp.asarray(q), jnp.asarray(scale),
                               jnp.asarray(mine),
                               None if nz is None else jnp.asarray(nz),
                               want_resid=want_resid)
    pallas_out = jqk.dequant_accum_requant(
        jnp.asarray(q), jnp.asarray(scale), jnp.asarray(mine),
        noise=None if nz is None else jnp.asarray(nz),
        want_resid=want_resid, impl="pallas")
    for ref in (jnp_out, pallas_out):
        for a, b in zip(got, ref):
            assert (a is None) == (b is None)
            if a is not None:
                assert _same_bits(a, b)


@pytest.mark.parametrize("stochastic", [False, True])
def test_hop0_is_requant_blocks_and_codec_encode(stochastic):
    q, scale, mine, noise = _operands(9, 256, seed=5)
    mine[1] = 0.25
    nz = noise if stochastic else None
    pq, ps = pqk.requant_blocks(torch.from_numpy(mine),
                                None if nz is None else torch.from_numpy(nz))
    jq, js = jqk.requant_blocks(jnp.asarray(mine),
                                None if nz is None else jnp.asarray(nz))
    assert _same_bits(pq.numpy(), jq) and _same_bits(ps.numpy(), js)
    res = pqk.block_residual(torch.from_numpy(mine), pq, ps).numpy()
    assert _same_bits(res, jqk.block_residual(jnp.asarray(mine), jq, js))
    # hop 0 with a residual is the same encode plus block_residual
    h = pqk.dequant_accum_requant(None, None, torch.from_numpy(mine),
                                  noise=None if nz is None
                                  else torch.from_numpy(nz), want_resid=True)
    assert torch.equal(h[0], pq) and torch.equal(h[1], ps)
    assert _same_bits(h[2].numpy(), res)


def test_po2_scale_bitwise_vs_jax():
    rng = np.random.default_rng(3)
    amax = np.concatenate([
        np.abs(rng.standard_normal(2000)) * 10.0 ** rng.integers(-40, 39,
                                                                   2000),
        [0.0, 1e-45, 1e-39, 2.0 ** -126, 127 * 2.0 ** -120, 1.0, 127.0,
         127.5, 3e38, np.inf]]).astype(np.float32)
    got = pqk.po2_scale(torch.from_numpy(amax)).numpy()
    assert _same_bits(got, jqk.po2_scale(jnp.asarray(amax)))
    assert (got >= np.float32(2.0 ** -126)).all()
    finite = np.isfinite(amax)
    assert (127.0 * got[finite].astype(np.float64)
            >= amax[finite]).all()


@pytest.mark.parametrize("total, n, block", [(1000, 3, 128), (4096, 4, 256),
                                             (1, 2, 128), (0, 2, 128)])
def test_chunk_blocks_bitwise_vs_jax(total, n, block):
    flat = np.random.default_rng(total).standard_normal(total) \
        .astype(np.float32)
    got, nb = pqk.chunk_blocks(torch.from_numpy(flat), n, block)
    want, jnb = jqk.chunk_blocks(jnp.asarray(flat), n, block)
    assert nb == jnb and _same_bits(got.numpy(), want)
    assert pqk.ring_salt(1, 1) == jqk.ring_salt(1, 1) == 3


@pytest.mark.parametrize("salt, hop, rank", [(0, 0, 0), (3, 2, 5),
                                             (2, 7, 1), (6, 1, 7)])
@pytest.mark.parametrize("nb, block", [(3, 128), (5, 7), (1, 1)])
def test_hop_noise_bitwise_vs_jax_random(salt, hop, rank, nb, block):
    key = pqk.schedule_key(salt, hop, rank)
    jkey = jqk.schedule_key(salt, hop, rank)
    assert key == tuple(int(v) for v in np.asarray(jkey))
    got = pqk.hop_noise(key, nb, block, device="cpu").numpy()
    assert _same_bits(got, jqk.hop_noise(jkey, nb, block))
    assert ((got >= 0) & (got < 1)).all()


def test_threefry_key_of_a_wide_seed():
    import jax

    for seed in (0, 7, 2**32 + 5):
        want = tuple(int(v) for v in np.asarray(jax.random.PRNGKey(seed)))
        assert threefry.PRNGKey(seed) == want


def test_zero_and_subnormal_blocks():
    # A zero block and a subnormal block both take the smallest normal
    # scale on both sides.  The q values of a subnormal block differ:
    # XLA on the CPU flushes subnormal inputs to zero, while the port
    # (torch on the CPU, and the CUDA kernel, built without flush-to-zero)
    # quantizes them (ROADMAP.md Queue 3).
    _, _, mine, _ = _operands(4, 256, seed=11)
    mine[1] = (np.linspace(-1, 1, 256) * 1.1e-38).astype(np.float32)
    pq, ps = pqk.requant_blocks(torch.from_numpy(mine))
    jq, js = jqk._requant_blocks_jit(jnp.asarray(mine))
    assert _same_bits(ps.numpy(), js)
    assert ps[0].item() == ps[1].item() == 2.0 ** -126
    assert (pq[0] == 0).all()
    for rows in ([0], [2], [3]):
        assert _same_bits(pq.numpy()[rows], np.asarray(jq)[rows])
    want_sub = np.round(mine[1].astype(np.float64) * 2.0 ** 126) \
        .astype(np.int8)
    assert np.array_equal(pq.numpy()[1], want_sub)
    assert (want_sub != 0).sum() > 100
    assert (np.asarray(jq)[1] == 0).all()


def test_non_finite_block_gets_non_finite_scale():
    q, scale, mine, _ = _operands(6, 128, seed=2)
    mine[3, 5] = np.nan
    mine[4, 9] = np.inf
    got = _port_hop(q, scale, mine, None, True)
    want = jqk._hop_jnp_jit(jnp.asarray(q), jnp.asarray(scale),
                            jnp.asarray(mine), None, want_resid=True)
    assert not np.isfinite(got[1][3:5]).any()
    assert _same_bits(got[1][[0, 2, 5]], np.asarray(want[1])[[0, 2, 5]])
    assert _same_bits(got[1][3:5], np.asarray(want[1])[3:5])


def test_impl_dispatch():
    q, scale, mine, _ = _operands(3, 128, seed=1)
    args = [torch.tensor(a) for a in (q, scale, mine)]
    with pytest.raises(ValueError, match="unknown impl"):
        pqk.dequant_accum_requant(*args, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        pqk.dequant_accum_requant(*args, impl="cuda")
    a = pqk.dequant_accum_requant(*args, impl="torch")
    b = pqk.dequant_accum_requant(*args)
    assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))


@pytest.mark.parametrize("block, offset, want", [(256, 0, 4), (128, 0, 4),
                                                 (130, 0, 1), (256, 1, 1),
                                                 (256, 4, 4)])
def test_hop_vec_width_rule(block, offset, want):
    # The kernel's 4-wide accesses need whole 4-element groups and
    # 16-byte aligned float32 operands (an offset of 4 floats keeps that).
    from mpi4torch_tpu_torch.ops import _kernels

    mine = torch.zeros(offset + 4 * block)[offset:]
    q = torch.zeros(4 * block, dtype=torch.int8)
    assert _kernels.hop_vec(block, [mine, None], [q, None]) == want
