"""The port's checkpoint module (cocoa_torch/checkpoint.py) against the
JAX package's (cocoa_tpu/checkpoint.py), on the CPU.

The checkpoint behaviours of tests/test_chaos.py:391-470 and
tests/test_serving.py:315 run against both modules (each case counts for
each), then the cross-reads: a port save passes the JAX package's
``validate`` and loads through its ``load_full`` with the same meta and
arrays, a JAX save loads in the port bit for bit, and a bfloat16 array is
the same ``|V2`` bytes in both files, which the port reads back as
bfloat16 (the JAX package writes them but cannot cast them back).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu import checkpoint as jax_ckpt  # noqa: E402
from cocoa_torch import checkpoint as port_ckpt  # noqa: E402

MODULES = [pytest.param(jax_ckpt, id="jax"),
           pytest.param(port_ckpt, id="port")]


def _save_rounds(mod, directory, rounds, alg="CoCoA+", d=8, k=2, n=4):
    rng = np.random.default_rng(0)
    for t in rounds:
        mod.save(str(directory), alg, t, rng.random(d), rng.random((k, n)),
                 seed=0)


def _names(mod, directory, alg="CoCoA+"):
    return [os.path.basename(p) for p in mod.generations(str(directory),
                                                         alg)]


# --- generations and validation (tests/test_chaos.py:391-470) -------------


@pytest.mark.parametrize("mod", MODULES)
def test_keeps_two_generations(mod, tmp_path):
    _save_rounds(mod, tmp_path, [5, 10, 15, 20])
    assert _names(mod, tmp_path) == ["CoCoA+-r000015.npz",
                                     "CoCoA+-r000020.npz"]
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".json")) \
        == ["CoCoA+-r000015.npz.json", "CoCoA+-r000020.npz.json"]
    # another algorithm's files are never claimed
    _save_rounds(mod, tmp_path, [5], alg="CoCoA")
    assert len(mod.generations(str(tmp_path), "CoCoA+")) == 2
    assert len(mod.generations(str(tmp_path), "CoCoA")) == 1


@pytest.mark.parametrize("mod", MODULES)
def test_generations_order_numerically(mod, tmp_path):
    _save_rounds(mod, tmp_path, [999998, 999999, 1000000])
    assert _names(mod, tmp_path) == ["CoCoA+-r999999.npz",
                                     "CoCoA+-r1000000.npz"]
    assert mod.latest(str(tmp_path), "CoCoA+").endswith(
        "CoCoA+-r1000000.npz")


@pytest.mark.parametrize("mod", MODULES)
def test_prune_spares_stale_higher_rounds(mod, tmp_path):
    _save_rounds(mod, tmp_path, [400, 500])   # an earlier run's leftovers
    _save_rounds(mod, tmp_path, [100])        # a fresh run starts over
    assert _names(mod, tmp_path) == ["CoCoA+-r000100.npz",
                                     "CoCoA+-r000400.npz",
                                     "CoCoA+-r000500.npz"]


@pytest.mark.parametrize("mod", MODULES)
def test_stale_temp_files_swept(mod, tmp_path):
    """Temporary files of an earlier interrupted save go at the next save
    of the algorithm; this round's, and other algorithms', stay."""
    stale = ["CoCoA+-r000005.npz.tmp.99", "CoCoA+-r000005.npz.json.tmp.99"]
    kept = ["CoCoA+-r000010.npz.tmp.98", "CoCoA-r000005.npz.tmp.99"]
    for name in stale + kept:
        (tmp_path / name).write_bytes(b"x")
    _save_rounds(mod, tmp_path, [10])
    left = set(os.listdir(tmp_path))
    assert not left & set(stale)
    assert set(kept) <= left


@pytest.mark.parametrize("mod", MODULES)
def test_validate_rejects_bare_npy(mod, tmp_path):
    _save_rounds(mod, tmp_path, [5, 10])
    prev, newest = mod.generations(str(tmp_path), "CoCoA+")
    with open(newest, "wb") as f:
        np.save(f, np.zeros(3))
    assert mod.validate(newest) == "not an npz archive"
    assert mod.latest(str(tmp_path), "CoCoA+") == prev


@pytest.mark.parametrize("mod", MODULES)
def test_validate_catches_corruption(mod, tmp_path):
    _save_rounds(mod, tmp_path, [5, 10])
    good, newest = mod.generations(str(tmp_path), "CoCoA+")
    assert mod.validate(newest) is None
    with open(newest, "r+b") as f:   # a torn copy
        f.truncate(100)
    assert "unreadable" in (mod.validate(newest) or "")
    with open(newest, "wb") as f:    # garbage
        f.write(b"\x00" * 4096)
    assert mod.validate(newest) is not None
    assert mod.validate(good) is None


@pytest.mark.parametrize("mod", MODULES)
def test_validate_catches_shape_mismatch(mod, tmp_path):
    _save_rounds(mod, tmp_path, [5])
    (path,) = mod.generations(str(tmp_path), "CoCoA+")
    meta, arrays = mod.load_full(path)
    arrays["w"] = arrays["w"][:-2]
    with open(path, "wb") as f:
        np.savez(f, _meta=np.array(json.dumps(meta)), **arrays)
    reason = mod.validate(path)
    assert reason is not None and "shape" in reason


@pytest.mark.parametrize("mod", MODULES)
def test_latest_falls_back_to_previous_generation(mod, tmp_path, capsys):
    """A torn newest generation: latest returns the one before, with the
    JAX package's stderr line; both torn: None."""
    _save_rounds(mod, tmp_path, [5, 10])
    prev, newest = mod.generations(str(tmp_path), "CoCoA+")
    with open(newest, "r+b") as f:
        f.truncate(100)
    capsys.readouterr()
    assert mod.latest(str(tmp_path), "CoCoA+") == prev
    err = capsys.readouterr().err
    assert err.startswith(f"checkpoint: {newest} failed validation "
                          f"(unreadable npz")
    assert err.rstrip().endswith("; falling back to the previous "
                                 "generation")
    with open(prev, "r+b") as f:
        f.truncate(100)
    assert mod.latest(str(tmp_path), "CoCoA+") is None


@pytest.mark.parametrize("mod", MODULES)
def test_validation_cache(mod, tmp_path, monkeypatch):
    """tests/test_serving.py:315: an unchanged generation costs one stat;
    a file rewritten in place validates again, a corrupt rewrite too,
    and latest falls back."""
    calls = []
    real = mod._validate

    def counting(path):
        calls.append(path)
        return real(path)

    monkeypatch.setattr(mod, "_validate", counting)
    w = np.ones(8, np.float32)
    p10 = mod.save(str(tmp_path), "CoCoA+", 10, w, None)
    assert mod.latest(str(tmp_path), "CoCoA+") == p10
    assert len(calls) == 1
    for _ in range(5):
        assert mod.latest(str(tmp_path), "CoCoA+") == p10
    assert len(calls) == 1
    mod.save(str(tmp_path), "CoCoA+", 10, w * 2, None)
    assert mod.latest(str(tmp_path), "CoCoA+") == p10
    assert len(calls) == 2
    p20 = mod.save(str(tmp_path), "CoCoA+", 20, w, None)
    assert mod.latest(str(tmp_path), "CoCoA+") == p20
    with open(p20, "wb") as f:
        f.write(b"torn")
    assert mod.latest(str(tmp_path), "CoCoA+") == p10
    assert mod.latest(str(tmp_path), "CoCoA+") == p10


# --- cross-reads ------------------------------------------------------------


def _state(dtype, k=3, n=5, d=11, seed=4):
    rng = np.random.default_rng(seed)
    sched = np.array([1, 2, 0.25, np.inf, 41, 1, 0, 2, 0.125, 0, 0, np.inf,
                      np.inf], np.float32)
    return (rng.normal(size=d).astype(dtype),
            rng.random((k, n)).astype(dtype),
            rng.random((2, k, n)).astype(dtype), sched)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("on", ["tensor", "numpy"])
def test_port_save_reads_in_jax(tmp_path, dtype, on):
    """A port save of tensors (or arrays) passes the JAX package's
    validate and loads through its load_full with the JAX save's meta and
    the same arrays, the sched vector and the accel bank included."""
    w, alpha, hist, sched = _state(dtype)
    put = torch.from_numpy if on == "tensor" else np.asarray
    p = port_ckpt.save(str(tmp_path / "port"), "CoCoA+", 40, put(w),
                       put(alpha), seed=3, sched=sched, hist=put(hist),
                       gap=1.5e-3)
    j = jax_ckpt.save(str(tmp_path / "jax"), "CoCoA+", 40, jnp.asarray(w),
                      jnp.asarray(alpha), seed=3, sched=jnp.asarray(sched),
                      hist=jnp.asarray(hist), gap=1.5e-3)
    assert os.path.basename(p) == os.path.basename(j) == "CoCoA+-r000040.npz"
    assert jax_ckpt.validate(p) is None
    meta_p, arrays_p = jax_ckpt.load_full(p)
    meta_j, arrays_j = jax_ckpt.load_full(j)
    assert meta_p == meta_j
    with open(p + ".json") as f:
        assert json.load(f) == meta_j
    assert sorted(arrays_p) == sorted(arrays_j) == ["alpha", "hist", "w"]
    for name in arrays_j:
        assert arrays_p[name].dtype == arrays_j[name].dtype
        assert arrays_p[name].tobytes() == arrays_j[name].tobytes()
    assert np.array_equal(np.asarray(meta_p["sched"], np.float32), sched)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jax_save_loads_in_port(tmp_path, dtype):
    """A JAX save through the port's latest and load_full: the meta and
    every array bit for bit; the algorithm's spaces stamped as ``_``."""
    w, alpha, hist, sched = _state(dtype)
    path = jax_ckpt.save(str(tmp_path), "Mini-batch CD", 7, jnp.asarray(w),
                         jnp.asarray(alpha), seed=5, sched=sched,
                         hist=jnp.asarray(hist))
    assert port_ckpt.latest(str(tmp_path), "Mini-batch CD") == path
    assert path.endswith("Mini-batch_CD-r000007.npz")
    meta, arrays = port_ckpt.load_full(path)
    assert meta == jax_ckpt.load_full(path)[0]
    assert meta["round"] == 7 and meta["seed"] == 5 and "gap" not in meta
    for name, want in (("w", w), ("alpha", alpha), ("hist", hist)):
        assert arrays[name].dtype == want.dtype
        assert arrays[name].tobytes() == want.tobytes()
    assert np.asarray(meta["sched"], np.float32).tobytes() == \
        sched.tobytes()
    meta3, w3, a3 = port_ckpt.load(path)
    assert meta3 == meta and np.array_equal(w3, w) and \
        np.array_equal(a3, alpha)


def test_bf16_same_bytes_and_read_back(tmp_path):
    """A bfloat16 w and alpha: the port writes the ``|V2`` members the
    JAX package writes, byte for byte, and reads its own file and JAX's
    back as bfloat16 tensors equal to what was saved."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.normal(size=13)).to(torch.bfloat16)
    alpha = torch.from_numpy(rng.random((2, 6))).to(torch.bfloat16)

    def as_jax(t):
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)

    p = port_ckpt.save(str(tmp_path / "port"), "CoCoA+", 2, w, alpha)
    j = jax_ckpt.save(str(tmp_path / "jax"), "CoCoA+", 2, as_jax(w),
                      as_jax(alpha))
    for path in (p, j):
        assert jax_ckpt.validate(path) is None
        assert port_ckpt.validate(path) is None
    with np.load(p) as fp, np.load(j) as fj:
        for name in ("w", "alpha"):
            assert fp[name].dtype.str == fj[name].dtype.str == "|V2"
            assert fp[name].tobytes() == fj[name].tobytes()
        assert str(fp["_meta"]) == str(fj["_meta"])
    for path in (p, j):
        _, arrays = port_ckpt.load_full(path)
        assert arrays["w"].dtype == torch.bfloat16
        assert torch.equal(arrays["w"], w)
        assert torch.equal(arrays["alpha"], alpha)


def test_host_array_owns_its_copy():
    """A save's host copy does not alias the tensor it came from."""
    t = torch.arange(4, dtype=torch.float64)
    a = port_ckpt.host_array(t)
    t += 1
    assert a.tolist() == [0.0, 1.0, 2.0, 3.0]

