"""Op registry: the JAX-idiomatic replacement for the reference's fx rewrite passes.

The reference (StableTriton) pattern-matches a traced torch.fx graph and splices in
Triton kernel calls (reference ``src/stabletriton/optimization.py:10-25``, custom
matcher at ``src/stabletriton/optimizers/utils/util.py:344``). JAX already has a
compiler, so the idiomatic equivalent is *op indirection*: the model is written
against named ops, and a *binding* maps each op name to a backend implementation
("reference" = plain jax.numpy, "cudnn" = a cuDNN library kernel). Re-binding an
op is the analog of enabling/disabling one rewrite pass — it gives the same
capability (selective kernel substitution, per-op A/B benchmarking) with no graph
surgery.

Because bindings are read at *trace time*, a bound function behaves like a
compile-time rewrite: different bindings produce different jitted executables.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable

# op name -> backend name -> implementation
_REGISTRY: dict[str, dict[str, Callable]] = {}

# The default backend every op starts bound to.
DEFAULT_BACKEND = "reference"

# Thread-local binding stack so `use_backends` nests correctly even if model
# tracing happens on several threads.
_local = threading.local()


def _binding_stack() -> list[dict[str, str]]:
    if not hasattr(_local, "stack"):
        _local.stack = [{}]
    return _local.stack


def register(op_name: str, backend: str):
    """Decorator: register ``fn`` as the ``backend`` implementation of ``op_name``."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(op_name, {})[backend] = fn
        return fn

    return deco


def registered_ops() -> dict[str, list[str]]:
    """op name -> list of backend names (for introspection / tests)."""
    return {op: sorted(impls) for op, impls in _REGISTRY.items()}


def active_backend(op_name: str) -> str:
    binding = _binding_stack()[-1]
    return binding.get(op_name, DEFAULT_BACKEND)


def resolve(op_name: str) -> Callable:
    """Return the implementation the current binding selects for ``op_name``."""
    impls = _REGISTRY.get(op_name)
    if not impls:
        raise KeyError(f"unknown op {op_name!r}; registered: {sorted(_REGISTRY)}")
    backend = active_backend(op_name)
    fn = impls.get(backend)
    if fn is None:
        raise KeyError(
            f"op {op_name!r} has no backend {backend!r}; available: {sorted(impls)}"
        )
    return fn


def dispatch(op_name: str, *args, **kwargs):
    return resolve(op_name)(*args, **kwargs)


@contextmanager
def use_backends(binding: dict[str, str] | None = None, /, **per_op: str):
    """Bind ops to backends within a scope.

    ``use_backends({"attention": "cudnn"})`` or ``use_backends(attention="cudnn")``.
    Unlisted ops keep their current binding. This is the analog of the reference's
    ordered pass list (``replace_backend``): the set of ops bound away from "reference" is
    exactly the set of rewrite passes that "ran".
    """
    merged = dict(_binding_stack()[-1])
    merged.update(binding or {})
    merged.update(per_op)
    stack = _binding_stack()
    stack.append(merged)
    try:
        yield
    finally:
        stack.pop()


def current_binding() -> dict[str, str]:
    return dict(_binding_stack()[-1])
