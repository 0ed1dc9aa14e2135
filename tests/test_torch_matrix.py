"""The eager engine's dtype x dims matrices: the counterpart of
tests/test_matrix.py on the port.

Four gloo ranks (one spawn for the module) run every case with divergent
per-rank data (``RandomState(100 + r)`` for the sums), held against
numpy's sums of the same data, as the JAX test holds its 8 in-process
ranks: allreduce's sum over every wire dtype x dims 1-3 and its average
per float dtype, allgather and broadcast over every dtype and bool x
dims 1-3, six fused tensors a dtype (at most three wire calls), and a
mixed-dtype group split by wire dtype. Each case is its own test, which
reads its result from the one session.
"""

import numpy as np
import pytest

from torch_engine_workers import (MATRIX_DIMS, MATRIX_GATHER_DTYPES,
                                  MATRIX_SUM_DTYPES, matrix_data,
                                  matrix_session)
from torch_ranks import spawn_ranks

N = 4
AVG_DTYPES = ["float16", "float32", "float64"]
FUSED_DTYPES = ["float32", "float64", "int32"]
MIXED_DTYPES = ["float32", "int64", "float32", "int64"]
CASES = ([("sum", d, k) for d in MATRIX_SUM_DTYPES for k in MATRIX_DIMS]
         + [("avg", d, 2) for d in AVG_DTYPES]
         + [(op, d, k) for op in ("gather", "bcast")
            for d in MATRIX_GATHER_DTYPES for k in MATRIX_DIMS])


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(N, matrix_session, CASES, FUSED_DTYPES, MIXED_DTYPES,
                       timeout=180)


def _each(ranks, key):
    return [ranks[r][key] for r in range(N)]


def _data(case):
    return [matrix_data(case, r, N) for r in range(N)]


@pytest.mark.parametrize("dim", MATRIX_DIMS)
@pytest.mark.parametrize("dtype", MATRIX_SUM_DTYPES)
def test_eager_allreduce_matrix(ranks, dtype, dim):
    """tests/test_matrix.py::test_eager_allreduce_matrix: the exact sum,
    in the input's dtype (int16 and uint16 cross the wire as int32)."""
    case = ("sum", dtype, dim)
    expected = np.sum(np.stack([d.astype(np.float64) for d in _data(case)]),
                      axis=0).astype(dtype)
    for val in _each(ranks, case):
        assert val.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(val, expected)


@pytest.mark.parametrize("dtype", AVG_DTYPES)
def test_eager_allreduce_average_matrix(ranks, dtype):
    """The average per float dtype, within the JAX test's 1e-2."""
    for val in _each(ranks, ("avg", dtype, 2)):
        assert val.dtype == np.dtype(dtype)
        np.testing.assert_allclose(val.astype(np.float64),
                                   np.full((3, 2), (N - 1) / 2), rtol=1e-2)


@pytest.mark.parametrize("dim", MATRIX_DIMS)
@pytest.mark.parametrize("dtype", MATRIX_GATHER_DTYPES)
def test_eager_allgather_matrix(ranks, dtype, dim):
    case = ("gather", dtype, dim)
    expected = np.concatenate(_data(case), axis=0)
    for val in _each(ranks, case):
        assert val.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(val, expected)


@pytest.mark.parametrize("dim", MATRIX_DIMS)
@pytest.mark.parametrize("dtype", MATRIX_GATHER_DTYPES)
def test_eager_broadcast_matrix(ranks, dtype, dim):
    case = ("bcast", dtype, dim)
    expected = _data(case)[dim % N]
    for val in _each(ranks, case):
        assert val.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(val, expected)


@pytest.mark.parametrize("dtype", FUSED_DTYPES)
def test_eager_fused_many_per_dtype(ranks, dtype):
    """Six tensors in flight take at most three wire calls, each exact."""
    for vals, buckets in _each(ranks, ("fused", dtype)):
        assert 1 <= buckets <= 3
        for i, val in enumerate(vals):
            np.testing.assert_array_equal(
                val, np.full((4,), sum(i + r for r in range(N)), dtype))


def test_eager_mixed_dtype_fusion_groups(ranks):
    """A mixed-dtype group splits by wire dtype; every result exact and
    in its own dtype."""
    for vals in _each(ranks, "mixed"):
        for i, (val, dtype) in enumerate(zip(vals, MIXED_DTYPES)):
            assert val.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(
                val, np.full((3,), sum(r + i for r in range(N)), dtype))
