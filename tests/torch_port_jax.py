"""The JAX side of the port's CPU tests, made cheaper without changing what
it computes.

- ``jit_apply``: a flax ``model.apply`` as one jitted call. Eagerly, JAX
  compiles and dispatches each op of the model on its own, several times
  the cost of tracing and compiling it once on the CPU (the tiny model's
  eval forward: ~32 s eager, ~8 s jitted, alone on 8 cores). XLA fuses the
  jitted ops, which moves their fp32 rounding by ~1e-6 of the values'
  scale; the tests hold the port at 1e-4 or wider there.
- ``jit_vjp``: ``jax.vjp`` and its pullback as one jitted call, likewise.
- ``memoised_jax_init``: a module-scoped autouse fixture (import it into a
  test module). While the module's tests run:
  - the JAX package's ``eval_lib.init_variables`` returns a copy of its
    first result for the same model config, sample and seed (it is a pure
    function of them). The JAX drivers (``restore_eval_variables``) call
    it once a run, each a ~20 s trace and compile of the whole model's
    init on the CPU; the memo leaves one per config in each test process;
  - JAX keeps the executables that take a second or more to compile in a
    persistent compilation cache shared by the test run's processes (one
    directory under the temporary directory for each pytest-xdist run), so
    that another process or another JAX driver's run compiling the same
    computation (the ``tiny`` model's init and eval renders, which several
    modules and drivers compile) loads it instead. A loaded executable is
    the one compiled: the results are the same bits.
"""
import functools
import hashlib
import os
import tempfile

import jax
import numpy as np
import pytest
from jax._src import compilation_cache

from selfocc_tpu.utils import eval_lib as jeval

_INIT = jeval.init_variables
_INITS = {}


def jit_apply(model, variables, *args, **kwargs):
    """``model.apply(variables, *args, **kwargs)`` through one ``jax.jit``:
    ``args`` are arrays (or pytrees of them), ``kwargs`` static (flags,
    ``method``)."""
    return jax.jit(functools.partial(model.apply, **kwargs))(variables,
                                                             *args)


def jit_vjp(fn, primals, cotangent):
    """``out, pullback = jax.vjp(fn, *primals)`` and ``pullback(cotangent)``
    through one ``jax.jit`` -> (out, the primals' cotangents)."""
    def both(args, cot):
        out, pullback = jax.vjp(fn, *args)
        return out, pullback(cot)
    return jax.jit(both)(tuple(primals), cotangent)


def _init_key(model, cfg, sample, seed):
    digest = hashlib.sha256()
    for k in ("imgs", "lidar2img", cfg.model.head.trans_kw):
        a = np.asarray(sample[k])
        digest.update(repr((k, a.shape, a.dtype.str)).encode())
        digest.update(a.tobytes())
    return type(model).__qualname__, repr(cfg.model), seed, digest.digest()


def memoised_init_variables(model, cfg, sample, seed=42):
    """``eval_lib.init_variables`` with its result kept by (the model's
    class, ``cfg.model``, the sample's arrays, ``seed``); each call gets
    new containers around the same (immutable) arrays."""
    key = _init_key(model, cfg, sample, seed)
    if key not in _INITS:
        _INITS[key] = _INIT(model, cfg, sample, seed)
    return jax.tree_util.tree_map(lambda x: x, _INITS[key])


def shared_cache_dir():
    """The persistent compilation cache of this test run: shared by its
    pytest-xdist workers, new for each run (a process of its own outside
    xdist)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID", f"pid{os.getpid()}")
    return os.path.join(tempfile.gettempdir(),
                        f"selfocc_port_tests_jax_cache_{run}")


@pytest.fixture(scope="module", autouse=True)
def memoised_jax_init():
    patch = pytest.MonkeyPatch()
    patch.setattr(jeval, "init_variables", memoised_init_variables)
    previous = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", shared_cache_dir())
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_compilation_cache_dir", previous)
    compilation_cache.reset_cache()
    patch.undo()
