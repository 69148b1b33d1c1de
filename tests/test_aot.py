"""Ahead-of-time traced-program cache (utils/aot.py): the contact-class
cold start has a large Python tracing part, which jax.export
serialization skips entirely on a warm run."""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp

from calipso_tpu import TrajOptSolver, Options


def _pendulum(H=5):
    def pend_c(x, u):
        return jnp.array(
            [x[1], u[0] / 0.25 - 9.81 * jnp.sin(x[0]) / 0.5 - 0.1 * x[1] / 0.25]
        )

    def pend_d(y, x, u):
        return y - (x + 0.05 * pend_c(0.5 * (x + y), u))

    xg = jnp.array([np.pi, 0.0])
    ts = TrajOptSolver(
        [lambda x, u, w: 0.1 * x @ x + 0.1 * u @ u] * (H - 1)
        + [lambda x, u, w: 10.0 * x @ x],
        [pend_d] * (H - 1),
        [2] * H,
        [1] * (H - 1),
        equality=[lambda x, u, w: x - w] + [None] * (H - 1),
        parameters=[np.zeros(2)] + [np.zeros(0)] * (H - 1),
        options=Options(),
    )
    ts.initialize_states([np.asarray(xg) * t / (H - 1) for t in range(H)])
    return ts


def test_aot_save_load_round_trip(tmp_path):
    ts = _pendulum()
    bts = ts.batched()
    B = 4
    rng = np.random.default_rng(0)
    th = jnp.asarray(0.2 * rng.normal(size=(B, 2)))

    ref = bts.solve(parameters=th)
    path = str(tmp_path / "pendulum.jaxexport")
    bts.aot_save(path, B)

    bts2 = _pendulum().batched()
    bts2.aot_load(path)
    got = bts2.solve(parameters=th)
    assert int(np.asarray(got.state.solved).sum()) == B
    np.testing.assert_allclose(
        np.asarray(got.state.p.x), np.asarray(ref.state.p.x), rtol=1e-6, atol=1e-8
    )
    # iteration counts identical: it is the same traced program
    np.testing.assert_array_equal(
        np.asarray(got.state.total_i), np.asarray(ref.state.total_i)
    )


def test_cached_batched_key_changes_with_fingerprint(tmp_path, monkeypatch):
    from calipso_tpu.utils import aot

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    ts = _pendulum()
    bts = ts.batched()
    B = 4
    args = bts._example_args(B)
    fn1, cached1 = aot.cached_batched(bts._batched, "t", "fp-a", *args)
    assert not cached1  # first save
    fn2, cached2 = aot.cached_batched(bts._batched, "t", "fp-a", *args)
    assert cached2  # hit
    fn3, cached3 = aot.cached_batched(bts._batched, "t", "fp-b", *args)
    assert not cached3  # different fingerprint -> different key
    assert len(os.listdir(tmp_path / "aot")) == 2  # under the cache root
    rng = np.random.default_rng(1)
    guess = args[0]
    th = jnp.asarray(0.2 * rng.normal(size=(B, 2)), guess.dtype)
    r1 = fn1(guess, th)
    r2 = fn2(guess, th)
    np.testing.assert_allclose(
        np.asarray(r1.state.p.x), np.asarray(r2.state.p.x), rtol=1e-6, atol=1e-8
    )


def test_cached_batched_without_serialization(tmp_path, monkeypatch):
    """Where jax.export cannot serialize (no flatbuffers package), the
    traced program still runs and nothing is written."""
    from calipso_tpu.utils import aot

    def no_flatbuffers(self, *a, **k):
        raise ImportError("Please install 'flatbuffers'")

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.export.Exported, "serialize", no_flatbuffers)
    bts = _pendulum().batched()
    args = bts._example_args(4)
    fn, cached = aot.cached_batched(bts._batched, "t", "fp", *args)
    assert not cached and os.listdir(tmp_path / "aot") == []
    th = jnp.asarray(0.2 * np.random.default_rng(2).normal(size=(4, 2)), args[0].dtype)
    np.testing.assert_allclose(
        np.asarray(fn(args[0], th).state.p.x),
        np.asarray(bts._batched(args[0], th).state.p.x),
        rtol=1e-6, atol=1e-8,
    )


def test_cache_key_changes_with_backend_and_x64(monkeypatch):
    """A program exported for one platform or dtype mode is never served
    to another: the key covers the backend and x64."""
    from calipso_tpu.utils import aot

    k64 = aot.cache_key("fp")
    assert aot.cache_key("fp") == k64
    with jax.enable_x64(False):
        assert aot.cache_key("fp") != k64
    monkeypatch.setattr(aot.jax, "default_backend", lambda: "gpu")
    assert aot.cache_key("fp") != k64


def test_package_hash_ignores_checkout_path(tmp_path):
    """The key hashes source paths relative to the package, so two
    checkouts of the same code at different paths share cache entries,
    and a changed source file changes the key."""
    from calipso_tpu.utils import aot

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(aot.__file__)))
    a, b = tmp_path / "a" / "calipso_tpu", tmp_path / "elsewhere" / "calipso_tpu"
    for dst in (a, b):
        shutil.copytree(pkg, dst, ignore=shutil.ignore_patterns("__pycache__"))
    assert aot._package_hash(str(a)) == aot._package_hash(str(b))
    with open(b / "options.py", "a") as f:
        f.write("\n# edit\n")
    assert aot._package_hash(str(a)) != aot._package_hash(str(b))


def test_batched_solver_aot_round_trip(tmp_path):
    from calipso_tpu import BatchedSolver
    import jax.numpy as jnp

    def build():
        return BatchedSolver(
            lambda x, th: (x - th) @ (x - th),
            lambda x, th: x[:1] - 0.5,
            None,
            3,
            num_parameters=3,
        )

    bs = build()
    B = 4
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.normal(size=(B, 3)))
    th = jnp.asarray(0.1 * rng.normal(size=(B, 3)), x0.dtype)
    ref = bs.solve(x0, th)
    path = str(tmp_path / "nlp.jaxexport")
    bs.aot_save(path, B, dtype=x0.dtype)
    bs2 = build().aot_load(path)
    got = bs2.solve(x0, th)
    np.testing.assert_allclose(
        np.asarray(got.state.p.x), np.asarray(ref.state.p.x), rtol=1e-6, atol=1e-8
    )
