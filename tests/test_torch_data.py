"""The port's input pipeline against the JAX package's.

``shard_batches`` yields bitwise the JAX package's batches (the same numpy
permutation seeded by ``(seed, epoch)``) for every rank, epoch, shuffle
and remainder case; ``shard_batches_comm`` reads rank and size from a
rank-thread communicator; ``prefetch_to_device`` keeps values and order,
stages at most ``size`` batches ahead, and runs on the CPU only when
asked (CUDA otherwise).
"""

import numpy as np
import pytest
import torch

import mpi4torch_tpu_torch as P
from mpi4torch_tpu.utils import data as jdata
from mpi4torch_tpu_torch.utils import data as pdata


def _dataset(n=23):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    y = np.arange(n, dtype=np.int32)
    return x, y


@pytest.mark.parametrize("size, bs, kw", [
    (1, 4, dict(seed=0)), (4, 2, dict(seed=7)), (3, 3, dict(seed=3, epoch=1)),
    (2, 2, dict(shuffle=False)), (2, 5, dict(seed=11, epoch=4))])
def test_shard_batches_bitwise_vs_jax(size, bs, kw):
    data = _dataset()
    for r in range(size):
        got = list(pdata.shard_batches(data, bs, rank=r, size=size, **kw))
        want = list(jdata.shard_batches(data, bs, rank=r, size=size, **kw))
        assert len(got) == len(want) == 23 // (bs * size)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
            assert gx.dtype == wx.dtype and gy.dtype == wy.dtype


def test_shard_batches_single_array_and_tensor_input():
    out = list(pdata.shard_batches(np.arange(10), 2, shuffle=False))
    assert len(out) == 5 and not isinstance(out[0], tuple)
    t = torch.arange(12.).reshape(6, 2)
    got = list(pdata.shard_batches(t, 2, seed=5))
    want = list(jdata.shard_batches(t.numpy(), 2, seed=5))
    assert all(isinstance(g, torch.Tensor) and np.array_equal(g.numpy(), w)
               for g, w in zip(got, want))
    # a bfloat16 tensor keeps its dtype (numpy has none)
    b16 = list(pdata.shard_batches(t.bfloat16(), 2, seed=5))
    assert all(g.dtype == torch.bfloat16 and torch.equal(g.float(), h)
               for g, h in zip(b16, got))


def test_shard_batches_validation():
    with pytest.raises(ValueError, match="leading axes"):
        list(pdata.shard_batches((np.zeros(3), np.zeros(4)), 1))
    with pytest.raises(ValueError, match="batch_size"):
        list(pdata.shard_batches(np.zeros(3), 0))
    with pytest.raises(ValueError, match="out of range"):
        list(pdata.shard_batches(np.zeros(3), 1, rank=2, size=2))
    with pytest.raises(ValueError, match="zero steps"):
        list(pdata.shard_batches(np.zeros(3), 2, size=2))


def test_shard_batches_comm_on_rank_threads():
    data = _dataset()

    def fn(r):
        return [b[1].tolist() for b in pdata.shard_batches_comm(
            data, 2, P.COMM_WORLD, seed=9)]

    got = P.run_ranks(fn, 3, device="cpu")
    for r in range(3):
        want = [b[1].tolist() for b in jdata.shard_batches(
            data, 2, rank=r, size=3, seed=9)]
        assert got[r] == want


def test_prefetch_keeps_values_order_and_depth():
    data = _dataset(40)
    staged = []

    def batches():
        for b in pdata.shard_batches(data, 4, seed=1):
            staged.append(len(staged))
            yield b

    want = list(pdata.shard_batches(data, 4, seed=1))
    for depth in (1, 2, 3):
        staged.clear()
        it = pdata.prefetch_to_device(batches(), size=depth, device="cpu")
        first = next(it)
        # taking the first batch stages one more: depth + 1 drawn so far
        assert len(staged) == min(depth + 1, len(want))
        rest = list(it)
        got = [first] + rest
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
            assert np.array_equal(gx.numpy(), wx)
            assert np.array_equal(gy.numpy(), wy)


def test_prefetch_validation_and_default_device():
    with pytest.raises(ValueError, match=">= 1"):
        next(pdata.prefetch_to_device(iter([np.zeros(2)]), size=0,
                                      device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(pdata.prefetch_to_device(iter([np.zeros(2)])))
    tree = {"a": np.ones(3), "b": [np.zeros(2)]}
    out = next(pdata.prefetch_to_device(iter([tree]), device="cpu"))
    assert torch.equal(out["a"], torch.ones(3, dtype=torch.float64))
    assert torch.equal(out["b"][0], torch.zeros(2, dtype=torch.float64))
