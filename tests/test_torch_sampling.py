"""The port's threefry draws and sampled decoding against ``jax.random``
and the JAX package's ``select_token`` / ``generate``.

Keys, random bits and uniforms are bitwise equal to ``jax.random``'s
(jax 0.9.0, ``jax_threefry_partitionable=True``).  The Gumbel noise takes
torch's ``log`` where JAX takes XLA's: it is bitwise equal in bfloat16,
within one ulp of its scale in float32 and float64 and eight in float16.  Sampled tokens are
identical; every comparison checks that the draw did not depend on that
ulp: a row whose perturbed scores are not bitwise JAX's must have a top-2
margin above the largest noise difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu_torch.models import transformer as PT
from mpi4torch_tpu_torch.ops import quant_kernels as pqk
from mpi4torch_tpu_torch.utils import threefry

SEEDS = [0, 7, 1234, 2**32 + 5, 2**40 + 7]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.float16, torch.float16), (jnp.float64, torch.float64)]
_UINT = {16: np.uint16, 32: np.uint32, 64: np.uint64}


def _words(x):
    """Unsigned bit patterns of a float array, for ulp distances."""
    x = np.asarray(x)
    return x.view(_UINT[x.dtype.itemsize * 8]).astype(np.int64)


def _np(t):
    """A torch tensor as numpy in its own dtype (bfloat16 through
    ml_dtypes, which JAX arrays read back as)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_bitwise(seed, num):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.split(key, num)).tolist()
    got = threefry.split(threefry.PRNGKey(seed), num)
    assert [list(k) for k in got] == want
    assert threefry.as_key(np.asarray(key)) == threefry.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_random_bits_bitwise(seed, width):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(key, (5, 37), jnp.dtype(f"uint{width}")))
    got = threefry.random_bits(threefry.PRNGKey(seed), width, (5, 37),
                               device="cpu").numpy()
    assert np.array_equal(got.view(np.uint64), want.astype(np.uint64))


# float64 at a scaled range is the one case torch has no fused
# multiply-add for; it is held within one ulp of the range below.
UNIFORM_CASES = [(d, lo, hi) for d in DTYPES
                 for lo, hi in ((0.0, 1.0), ("tiny", 1.0), (-2.5, 3.0))
                 if not (d[1] == torch.float64 and lo == -2.5)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtypes, lo, hi", UNIFORM_CASES,
                         ids=lambda x: str(x[1]) if isinstance(x, tuple)
                         else str(x))
def test_uniform_bitwise(seed, dtypes, lo, hi):
    jdt, tdt = dtypes
    if lo == "tiny":
        lo = float(jnp.finfo(jdt).tiny)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(key, (33, 65), jdt, lo, hi))
    got = _np(threefry.uniform(threefry.PRNGKey(seed), (33, 65), tdt, lo, hi,
                               device="cpu"))
    assert np.array_equal(_words(got), _words(want))
    assert (got >= lo).all() and (got < hi).all()


def test_uniform_float64_scaled_range_within_one_ulp():
    # Without the fused multiply-add the product's own rounding remains:
    # at most one ulp of the range, whatever the result's magnitude.
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.uniform(key, (64, 65), jnp.float64, -2.5,
                                         3.0))
    got = threefry.uniform(threefry.PRNGKey(3), (64, 65), torch.float64,
                           -2.5, 3.0, device="cpu").numpy()
    assert np.abs(got - want).max() <= np.spacing(5.5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: d[1].__repr__())
def test_gumbel_within_stated_ulps(seed, dtypes):
    jdt, tdt = dtypes
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.gumbel(key, (4096,), jdt))
    got = _np(threefry.gumbel(threefry.PRNGKey(seed), (4096,), tdt,
                              device="cpu"))
    # Near 0 the outer log cancels, so the bound is in ulps of the
    # noise's scale (at least 1), not of each value: bitwise in bfloat16,
    # one ulp in float32 and float64; in float16 XLA's fused logs round
    # otherwise than torch's (8 ulps, the worst of 40 seeds x 4096 draws).
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    scale = np.spacing(np.maximum(np.abs(want), 1).astype(want.dtype))
    ulps = {torch.bfloat16: 0, torch.float16: 8}.get(tdt, 1)
    assert (err <= ulps * scale).all()
    assert np.isfinite(got.astype(np.float64)).all()


def _perturbed_jax(logits, key, temperature, top_k):
    """JAX's perturbed scores of ``select_token``'s sampled branch:
    ``gumbel + logits / temperature`` after the top-k mask."""
    if top_k:
        kth = jax.lax.top_k(logits, top_k)[0][:, -1:]
        logits = jnp.where(logits >= kth, logits, -jnp.inf)
    scaled = logits / temperature
    return jax.random.gumbel(key, scaled.shape, scaled.dtype) + scaled


def _assert_draw_is_robust(port_scores, jax_scores):
    """Each row is decided the same on both sides: its perturbed scores
    are bitwise JAX's, or their top-2 margin exceeds the largest
    difference between the two."""
    p = _np(port_scores).astype(np.float64)
    j = np.asarray(jax_scores).astype(np.float64)
    for pr, jr in zip(p, j):
        finite = np.isfinite(jr)
        if np.array_equal(pr[finite], jr[finite]) and \
                np.array_equal(np.isfinite(pr), finite):
            continue
        gap = np.abs(pr[finite] - jr[finite]).max()
        top2 = np.sort(jr[finite])[-2:]
        assert len(top2) < 2 or top2[1] - top2[0] > gap


@pytest.mark.parametrize("temperature", [0.3, 0.8, 1.7])
@pytest.mark.parametrize("top_k", [0, 1, 50])
@pytest.mark.parametrize("dtypes", DTYPES[:2], ids=["f32", "bf16"])
def test_select_token_and_categorical_match_jax(temperature, top_k, dtypes):
    jdt, tdt = dtypes
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    for seed in range(6):
        logits = (2.0 * rng.standard_normal((3, 300))).astype(np.float32)
        jl = jnp.asarray(logits, jdt)
        pl = torch.from_numpy(logits).to(tdt)
        key = jax.random.PRNGKey(100 + seed)
        pkey = threefry.PRNGKey(100 + seed)
        want = np.asarray(JT.select_token(jl, key, temperature, top_k,
                                          jnp.int32))
        got = PT.select_token(pl, pkey, temperature, top_k).numpy()
        assert got.tolist() == want.tolist()
        scores = PT.perturbed_scores(pl, pkey, temperature, top_k)
        _assert_draw_is_robust(scores, _perturbed_jax(jl, key, temperature,
                                                      top_k))
        # categorical itself, on the unmasked tempered logits.
        jc = np.asarray(jax.random.categorical(key, jl / temperature))
        pc = threefry.categorical(pkey, pl / torch.tensor(temperature,
                                                          dtype=tdt))
        assert pc.tolist() == jc.tolist()
        if top_k == 1:
            # Only the row's largest logits (ties in the dtype) survive.
            assert torch.equal(pl[torch.arange(3), torch.as_tensor(got)],
                               pl.max(dim=-1).values)


def test_greedy_select_token_ignores_the_key():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 50)))
    assert PT.select_token(logits).tolist() == \
        PT.select_token(logits, (1, 2), 0.0, 5).tolist() == \
        torch.argmax(logits, -1).tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_draw_rows_are_their_own_keys_draws(dtype):
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((5, 257))
                              .astype(np.float32)).to(dtype)
    keys = [threefry.split(threefry.PRNGKey(s))[1] for s in range(5)]
    table = torch.tensor(keys, dtype=torch.int64)
    noise = threefry.gumbel(table, (257,), dtype)
    scores = PT.perturbed_scores(logits, table, 0.7, 20)
    for r, key in enumerate(keys):
        own = threefry.gumbel(key, (1, 257), dtype, device="cpu")
        assert torch.equal(noise[r], own[0])
        assert torch.equal(scores[r], PT.perturbed_scores(
            logits[r:r + 1], key, 0.7, 20)[0])
        assert int(PT.select_token(logits, table, 0.7, 20)[r]) == int(
            PT.select_token(logits[r:r + 1], key, 0.7, 20)[0])
    with pytest.raises(ValueError, match="one \\(rows, 2\\) key per row"):
        threefry.categorical(table[:3], logits)


GEN_CFG = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_seq=48)


@pytest.fixture(scope="module")
def gen_weights():
    jcfg = JT.TransformerConfig(**GEN_CFG)
    jparams = JT.init_transformer(jax.random.PRNGKey(3), jcfg,
                                  dtype=jnp.float32)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, PT.TransformerConfig(**GEN_CFG), pparams


def _port_scores(pcfg, pparams, prompt, tokens, key, temperature, top_k):
    """The port's perturbed scores at every step of a ``generate`` whose
    tokens were ``tokens`` (teacher-forced, same key discipline)."""
    cache = PT.init_kv_cache(pcfg, 1, torch.float32, "cpu")
    logits, cache = PT.prefill(pcfg, pparams, cache, prompt)
    out = []
    for i, tok in enumerate(tokens):
        if i:
            logits, cache = PT.decode_step(
                pcfg, pparams, cache, torch.tensor([tokens[i - 1]]),
                prompt.shape[1] + i - 1)
        key, sub = threefry.split(key)
        out.append(PT.perturbed_scores(logits, sub, temperature, top_k))
    return torch.cat(out)


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("temperature, top_k", [(0.8, 0), (1.3, 20)])
def test_generate_sampled_matches_jax(gen_weights, seed, temperature,
                                      top_k):
    jcfg, jparams, pcfg, pparams = gen_weights
    prompt = np.random.default_rng(seed).integers(0, GEN_CFG["vocab"], 9)
    n_new = 12
    want = np.asarray(JT.generate(
        jcfg, jparams, jnp.asarray(prompt, jnp.int32)[None], n_new,
        temperature=temperature, top_k=top_k,
        key=jax.random.PRNGKey(seed)))[0]
    got = PT.generate(pcfg, pparams, torch.as_tensor(prompt)[None], n_new,
                      temperature=temperature, top_k=top_k,
                      key=threefry.PRNGKey(seed))[0]
    assert got.tolist() == want.tolist()
    greedy = PT.generate(pcfg, pparams, torch.as_tensor(prompt)[None],
                         n_new)[0]
    assert greedy.tolist() != got.tolist()      # the sampler ran
    # No step was decided by the noise's last bit: at each step the
    # perturbed scores' top-2 margin is above one float32 ulp of the
    # noise (the gumbel bound above), on the port's own logits.
    scores = _port_scores(pcfg, pparams, torch.as_tensor(prompt)[None],
                          got[len(prompt):].tolist(),
                          threefry.PRNGKey(seed), temperature, top_k)
    top2 = scores.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).min().item()
    ulp = 2.0 ** -23 * scores[scores.isfinite()].abs().max().item()
    assert margin > 4 * ulp


@pytest.mark.parametrize("kw", [
    dict(temperature=-0.5), dict(top_k=-1), dict(top_k=98),
    dict(temperature=0.5), dict(n_new=60)])
def test_generate_validation_matches_jax(gen_weights, kw):
    jcfg, jparams, pcfg, pparams = gen_weights
    kw = dict(kw)
    n_new = kw.pop("n_new", 4)
    prompt = np.arange(5)
    with pytest.raises(ValueError) as jerr:
        JT.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32)[None],
                    n_new, **kw)
    with pytest.raises(ValueError) as perr:
        PT.generate(pcfg, pparams, torch.as_tensor(prompt)[None], n_new,
                    **kw)
    assert str(perr.value) == str(jerr.value)


def test_noise_helpers_take_an_explicit_cpu_device():
    key = pqk.schedule_key(1, 2, 3)
    u = threefry.uniform(key, (4, 8), device="cpu")
    assert u.device.type == "cpu" and u.dtype == torch.float32
    assert torch.equal(pqk.hop_noise(key, 4, 8, device="cpu"), u)
    g = threefry.gumbel(key, (16,), torch.bfloat16, device="cpu")
    assert g.device.type == "cpu" and g.dtype == torch.bfloat16
    assert threefry.random_bits(key, 32, (3,), device="cpu").device.type \
        == "cpu"


def test_noise_helpers_without_cuda_or_device_raise(monkeypatch):
    # No device and no CUDA: resolve_device's error, never counters built
    # on the CPU by default.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    key = pqk.schedule_key(0, 0, 0)
    for draw in (lambda: threefry.uniform(key, (2, 2)),
                 lambda: threefry.gumbel(key, (4,)),
                 lambda: threefry.random_bits(key, 32, (4,)),
                 lambda: pqk.hop_noise(key, 2, 2)):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            draw()
