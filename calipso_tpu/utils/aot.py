"""Ahead-of-time program cache for batched solves (round-5 "compile
wall" work).

The d=54 contact program's cold start has a large Python TRACING part
(its split into trace and compile seconds on the H100 is printed by
chip_smoke.py's quadruped_batch phase), and JAX's persistent
compilation cache only covers the XLA part.  This
module serializes the traced program itself with `jax.export`
(StableHLO), so a later process skips tracing entirely: it deserializes
the module (sub-second), compiles (absorbed by the persistent XLA
cache), and runs.

The public entry points are BatchedTrajOptSolver.aot_save/aot_load
(parallel/batch.py).  `cached_batched` is the keyed variant bench.py
uses: the key hashes the package sources, the problem fingerprint, the
backend, x64 and the JAX version, so a code, shape or platform change
retraces instead of serving a stale program.

The reference has no analogue (Julia caches native code per session);
the role matches its precompilation story (SURVEY.md section 6).
"""

from __future__ import annotations

import hashlib
import os

import jax


_REGISTERED = False


def register_serialization():
    """Register the solver's NamedTuple pytrees for jax.export
    serialization (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from calipso_tpu.solver.api import SolveResult
    from calipso_tpu.solver.kkt import Blocks
    from calipso_tpu.solver.solve import State

    for ty in (SolveResult, State, Blocks):
        try:
            jax.export.register_namedtuple_serialization(
                ty, serialized_name=f"calipso_tpu.{ty.__name__}"
            )
        except ValueError:
            pass  # already registered (idempotent across instances)
    _REGISTERED = True


def export_fn(fn, *example_args):
    """Trace + serialize a jitted function at the example arguments.
    Returns the serialized bytes."""
    register_serialization()
    return jax.export.export(fn)(*example_args).serialize()


def load_fn(blob):
    """Deserialize a program saved by export_fn into a callable (jitted,
    so the XLA compile goes through the persistent compilation cache)."""
    register_serialization()
    exp = jax.export.deserialize(blob)
    return jax.jit(exp.call)


def _package_hash(root=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))):
    """Hash of every source file of the package at `root`, by its path
    relative to the package: any code change changes the cache key, so a
    stale traced program is never served, and moving the checkout
    changes nothing."""
    h = hashlib.sha1()
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for f in sorted(filenames):
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                h.update(os.path.relpath(p, root).encode())
                with open(p, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()[:12]


def cache_key(fingerprint: str) -> str:
    """Key of a traced program: the problem fingerprint, the package
    sources, and what the program was exported for -- the backend, x64
    and the JAX version. A program exported for one platform is never
    served to another."""
    parts = (
        fingerprint,
        _package_hash(),
        jax.default_backend(),
        f"x64={bool(jax.config.jax_enable_x64)}",
        jax.__version__,
    )
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


def cache_path(tag: str, fingerprint: str) -> str:
    from calipso_tpu import cache_root

    base = os.path.join(cache_root(), "aot")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, f"{tag}-{cache_key(fingerprint)}.jaxexport")


def cached_batched(fn, tag: str, fingerprint: str, *example_args):
    """Return a callable equivalent to jit(fn) at the example shapes,
    loading the traced program from the keyed cache when present and
    tracing + saving it otherwise. Returns (callable, was_cached). Where
    jax.export cannot serialize (it needs the flatbuffers package),
    nothing is cached and the program traced here is used as it is."""
    path = cache_path(tag, fingerprint)
    if os.path.exists(path):
        with open(path, "rb") as f:
            return load_fn(f.read()), True
    register_serialization()
    exp = jax.export.export(fn)(*example_args)
    try:
        blob = exp.serialize()
    except ImportError:
        return jax.jit(exp.call), False
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return jax.jit(exp.call), False
