"""The port's data path and index sampling against the JAX package: LIBSVM
parse, shard contents, synthetic data, and the (C, K, H) index tables of
all three --rng modes, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu.data import synth as jax_synth  # noqa: E402
from cocoa_tpu.data.libsvm import load_libsvm_python  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.solvers.base import IndexSampler as JaxSampler  # noqa: E402
from cocoa_tpu.utils import prng as jax_prng  # noqa: E402
from cocoa_torch.data import synth  # noqa: E402
from cocoa_torch.data.libsvm import LibsvmData, load_libsvm  # noqa: E402
from cocoa_torch.data.sharding import resolve_layout, shard_dataset  # noqa: E402
from cocoa_torch.solvers.base import IndexSampler  # noqa: E402
from cocoa_torch.utils import prng  # noqa: E402


def _port_data(jax_data):
    return LibsvmData(labels=jax_data.labels, indptr=jax_data.indptr,
                      indices=jax_data.indices, values=jax_data.values,
                      num_features=jax_data.num_features)


def _assert_same_shards(ds_t, ds_j):
    """Unpadded contents equal; padded shapes may differ."""
    assert ds_t.layout == ds_j.layout
    np.testing.assert_array_equal(ds_t.counts, ds_j.counts)
    for s, m in enumerate(ds_t.counts):
        for f in ("labels", "mask", "sq_norms"):
            np.testing.assert_array_equal(
                getattr(ds_t, f)[s, :m].numpy(),
                np.asarray(getattr(ds_j, f))[s, :m], err_msg=f)
        if ds_t.layout == "dense":
            np.testing.assert_array_equal(ds_t.X[s, :m].numpy(),
                                          np.asarray(ds_j.X)[s, :m])
        else:
            np.testing.assert_array_equal(ds_t.sp_indices[s, :m].numpy(),
                                          np.asarray(ds_j.sp_indices)[s, :m])
            np.testing.assert_array_equal(ds_t.sp_values[s, :m].numpy(),
                                          np.asarray(ds_j.sp_values)[s, :m])
        # padded rows are inert
        assert float(ds_t.mask[s, m:].abs().sum()) == 0.0
        assert float(ds_t.labels[s, m:].abs().sum()) == 0.0


def test_parse_matches_jax():
    for path in (SMALL_TRAIN, SMALL_TEST):
        t = load_libsvm(path, DEMO_NUM_FEATURES)
        j = load_libsvm_python(path, DEMO_NUM_FEATURES)
        for f in ("labels", "indptr", "indices", "values"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def test_parse_edge_cases(tmp_path):
    """Labels, malformed tails and repeated columns as the JAX parser
    reads them; an index past numFeatures is an error."""
    p = tmp_path / "edge.svm"
    p.write_bytes(b"+1 1:0.5 3:2\n-1\n2 2:1 2:3 x:1 4:9\n\n1 1:1e-3 5:\n")
    t = load_libsvm(str(p), 5)
    j = load_libsvm_python(str(p), 5)
    for f in ("labels", "indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    with pytest.raises(ValueError, match="numFeatures"):
        load_libsvm(str(p), 2)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("layout", ["dense", "sparse", "auto"])
def test_tiny_shards_match_jax(tiny_data, k, layout):
    ds_t = shard_dataset(_port_data(tiny_data), k, layout=layout,
                         dtype=torch.float64, device="cpu")
    ds_j = jax_shard(tiny_data, k, layout=layout, dtype=jnp.float64)
    _assert_same_shards(ds_t, ds_j)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_demo_shards_match_jax(small_train, small_test, dtype):
    for data in (small_train, small_test):
        assert resolve_layout(_port_data(data), "auto") == "sparse"
        ds_t = shard_dataset(_port_data(data), 4,
                             dtype=getattr(torch, dtype), device="cpu")
        ds_j = jax_shard(data, 4, dtype=getattr(jnp, dtype))
        _assert_same_shards(ds_t, ds_j)


def test_synth_sparse_matches_jax(tmp_path):
    t = synth.synth_sparse(300, 500, nnz_mean=12, seed=4)
    j = jax_synth.synth_sparse(300, 500, nnz_mean=12, seed=4)
    for f in ("labels", "indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    synth.write_libsvm(t, str(tmp_path / "a.svm"))
    jax_synth.write_libsvm(j, str(tmp_path / "b.svm"))
    assert (tmp_path / "a.svm").read_bytes() == \
        (tmp_path / "b.svm").read_bytes()


def test_java_random_matches_jax():
    for seed in (0, 7, -3, 2**40 + 5):
        a, b = prng.JavaRandom(seed), jax_prng.JavaRandom(seed)
        for bound in (None, 1, 16, 17, 1000, 2**30 + 1):
            assert a.next_int(bound) == b.next_int(bound)
        assert a.next_double() == b.next_double()


@pytest.mark.parametrize("mode", ["reference", "jax", "permuted"])
@pytest.mark.parametrize("seed", [13, 2**31 + 9])
@pytest.mark.parametrize("counts", [(25, 24, 7, 1), (1000, 999, 65536, 24)])
def test_index_tables_match_jax(mode, seed, counts):
    """(C, K, H) tables bit-identical to the JAX host tables, over several
    chunks of rounds (permuted mode crosses epoch boundaries)."""
    h = 37
    t = IndexSampler(mode, seed, h, np.asarray(counts))
    j = JaxSampler(mode, seed, h, np.asarray(counts))
    for t0, c in ((1, 4), (40, 2)):
        mine = t.chunk_indices(t0, c)
        assert mine.dtype == torch.int32 and mine.shape == (c, len(counts), h)
        np.testing.assert_array_equal(mine.numpy(),
                                      np.asarray(j.chunk_indices(t0, c)))
