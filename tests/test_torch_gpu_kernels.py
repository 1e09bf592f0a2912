"""The port's CUDA kernels on the card, against their plain versions.

Imports only torch, numpy and ``sentinel_tpu_torch`` (no JAX, no
``sentinel_tpu``), so it runs on a machine with a card and no JAX::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_kernels.py

Every test is marked ``gpu`` and skips, with its reason, where
``torch.cuda.is_available()`` is false (decided inside the test). The
scatter-add kernel runs every path of ``ops.scatter_add.plan`` — global
with 32- and 64-bit index math, and shared-memory privatisation, each
reached by a shape that ``plan`` itself sends there; the event mode and
the payload instantiations (E = 1, 8, 32 and the generic one) — in int32
and float32, and is compared with ``scatter_add_reference`` and with
``np.add.at``. The streams put a quarter of their keys on 8 hot rows, so
warps with duplicate addresses take the combining branch. Tolerance:
exact.
The float32 sums stay far below 2^24, where float32 addition is exact in
any order.
"""

import numpy as np
import pytest
import torch

from sentinel_tpu_torch.ops import scatter_add as sa

DTYPES = {"int32": (torch.int32, np.int32), "float32": (torch.float32,
                                                        np.float32)}
# (name, payload, E): the event mode and every payload instantiation
MODES = [("event8", False, 8), ("payload1", True, 1), ("payload8", True, 8),
         ("payload32", True, 32), ("payload5", True, 5)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _stream(rng, k, e, n, payload):
    """Keys with a hot set, padding (== k) and a -1; events with a -1;
    amounts with zeros and negatives."""
    keys = np.where(rng.random(n) < 0.25, rng.integers(0, 8, n),
                    rng.integers(0, k, n)).astype(np.int32)
    keys[::29] = k
    keys[3] = -1
    if payload:
        events = None
        amounts = rng.integers(-2, 4, (n, e)).astype(np.int32)
        amounts[rng.random((n, e)) < 0.5] = 0
    else:
        events = rng.integers(0, e, n).astype(np.int32)
        events[5] = -1
        events[7] = e                      # out of range: dropped
        amounts = rng.integers(-2, 4, n).astype(np.int32)
    return keys, events, amounts


def _numpy_add_at(table, keys, events, amounts):
    """The same function in numpy (wrap once, drop the rest, add.at)."""
    k, e = table.shape
    out = table.astype(np.float64)
    if events is None:
        n = keys.shape[0]
        keys = np.repeat(keys, e)
        events = np.tile(np.arange(e, dtype=np.int32), n)
        amounts = amounts.reshape(-1)
    key = np.where(keys < 0, keys + k, keys)
    ev = np.where(events < 0, events + e, events)
    ok = (key >= 0) & (key < k) & (ev >= 0) & (ev < e)
    np.add.at(out, (key[ok], ev[ok]), amounts[ok])
    return out.astype(table.dtype)


def _run(path, dtype, payload, e, k, n=20_000, stride_pad=3, seed=1):
    """One scatter-add through the seam on a shape that ``plan`` sends to
    ``path``, against the plain version and numpy."""
    dev = _card()
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 50, (k, e + stride_pad)).astype(ndt)
    keys, events, amounts = _stream(rng, k, e, n, payload)
    want_np = base.copy()
    want_np[:, :e] = _numpy_add_at(base[:, :e], keys, events, amounts)
    tens = [None if a is None else torch.from_numpy(a).to(dev)
            for a in (keys, events, amounts)]
    want = torch.from_numpy(base).to(dev)
    got = want.clone()
    sa.scatter_add_reference(want[:, :e], *tens)
    view = got[:, :e]
    assert sa.plan_for(view, tens[0], tens[1]).path == path
    before = sa.LAUNCHES["scatter_add"]
    sa.scatter_add(view, *tens)
    torch.cuda.synchronize()
    assert sa.LAUNCHES["scatter_add"] == before + 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), want_np)


@pytest.mark.gpu
@pytest.mark.parametrize("path,k", [(sa.PATH_GLOBAL, 1 << 17),
                                    (sa.PATH_SHARED, 16)])
@pytest.mark.parametrize("mode", [m[0] for m in MODES])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_plan_path_matches_plain_and_numpy(dtype, mode, path, k):
    """A table too large for shared memory takes the global path; a 16-row
    table under a 20k-element stream is privatised."""
    _, payload, e = next(m for m in MODES if m[0] == mode)
    _run(path, dtype, payload, e, k)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [m[0] for m in MODES])
def test_64_bit_index_path_matches_plain(mode):
    """A view of a [2^16, 2^15] int32 table (8 GiB, 2^31 cells): ``plan``
    gives 64-bit index math, and every amount lands inside the view."""
    dev = _card()
    _, payload, e = next(m for m in MODES if m[0] == mode)
    k, stride = 1 << 16, 1 << 15
    rng = np.random.default_rng(2)
    keys, events, amounts = _stream(rng, k, e, 1 << 18, payload)
    tens = [None if a is None else torch.from_numpy(a).to(dev)
            for a in (keys, events, amounts)]
    big = torch.zeros((k, stride), dtype=torch.int32, device=dev)
    view = big[:, :e]
    assert sa.plan_for(view, tens[0], tens[1]).index_bits == 64
    want = torch.zeros((k, e), dtype=torch.int32, device=dev)
    sa.scatter_add_reference(want, *tens)
    sa.scatter_add(view, *tens)
    torch.cuda.synchronize()
    assert torch.equal(view, want)
    assert not bool(big[:, e:].any())
    np.testing.assert_array_equal(
        view.cpu().numpy(),
        _numpy_add_at(np.zeros((k, e), np.int32), keys, events, amounts))


@pytest.mark.gpu
@pytest.mark.parametrize("k,path", [(7264, sa.PATH_SHARED),
                                    (7265, sa.PATH_GLOBAL)])
def test_planned_path_at_the_shared_memory_threshold(k, path):
    """[7264, 8] int32 is exactly 232,448 bytes: the largest table the
    shared path takes (given a stream long enough for it); one row more
    takes the global path."""
    _run(path, "int32", False, 8, k, n=1 << 23, stride_pad=0)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """The seam on a CUDA tensor launches the kernel with its own plan."""
    dev = _card()
    rng = np.random.default_rng(1)
    for ndt in (np.int32, np.float32):
        k = 1 << 16
        counters = rng.integers(0, 50, (k, 8)).astype(ndt)
        keys, events, amounts = _stream(rng, k, 8, 1 << 18, False)
        want = torch.from_numpy(counters).to(dev)
        got = want.clone()
        args = [torch.from_numpy(a).to(dev) for a in (keys, events, amounts)]
        sa.scatter_add_reference(want, *args)
        before = sa.LAUNCHES["scatter_add"]
        sa.scatter_add(got, *args)
        torch.cuda.synchronize()
        assert sa.LAUNCHES["scatter_add"] == before + 1
        assert torch.equal(got, want)
        np.testing.assert_array_equal(
            got.cpu().numpy(), _numpy_add_at(counters, keys, events, amounts))


@pytest.mark.gpu
def test_one_hot_key_combines_exactly():
    """Every element on one cell: warp combining sums whole warps."""
    dev = _card()
    for tdt in (torch.int32, torch.float32):
        n = 1 << 19
        table = torch.zeros((1 << 20, 8), dtype=tdt, device=dev)
        keys = torch.full((n,), 12345, dtype=torch.int32, device=dev)
        events = torch.full((n,), 6, dtype=torch.int32, device=dev)
        amounts = torch.ones(n, dtype=torch.int32, device=dev)
        sa.scatter_add(table, keys, events, amounts)
        torch.cuda.synchronize()
        assert float(table[12345, 6]) == n
        assert float(table.sum()) == n
