"""Named wall-clock timing registry.

Replacement for the DOLFINx C++ timing registry that the reference
uses via ``dolfinx.common.timed`` decorators (11 sites, e.g. reference
``src/networks_fenicsx/mesh.py:29,117,138,425`` and
``src/networks_fenicsx/assembly.py:28,120,164,328``) and queries through
``dolfinx.common.timing(key)`` in the perf harness
(reference ``demos/demo_perf.py:85-150``).

Semantics match the reference: each key accumulates a call count and a total
wall-clock duration; :func:`timing` returns ``(count, timedelta)``.  Device
work is fenced with ``jax.block_until_ready`` where callers opt in via
:func:`timed(..., block=True)` so that asynchronous dispatch does not hide
compute time.
"""

from __future__ import annotations

import datetime
import functools
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, TypeVar

__all__ = [
    "timed",
    "timing",
    "timing_seconds",
    "reset_timings",
    "list_timings",
    "Timer",
    "profiler_trace",
]

F = TypeVar("F", bound=Callable[..., Any])

_lock = threading.Lock()
_registry: dict[str, tuple[int, float]] = {}


def _record(key: str, elapsed: float) -> None:
    with _lock:
        count, total = _registry.get(key, (0, 0.0))
        _registry[key] = (count + 1, total + elapsed)


def _block_on(value: Any) -> None:
    """Fence on any jax arrays contained in ``value``."""
    try:
        import jax

        jax.block_until_ready(value)
    except Exception:
        pass


def timed(key: str, block: bool = False) -> Callable[[F], F]:
    """Decorator mirroring ``dolfinx.common.timed`` (reference ``mesh.py:29``).

    Args:
        key: Registry key, conventionally ``"nxfx:<Class>:<method>"``.
        block: If True, call ``jax.block_until_ready`` on the return value
            before stopping the clock, so asynchronously dispatched device
            work is included in the measurement.
    """

    def decorator(fn: F) -> F:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            t0 = time.perf_counter()
            try:
                result = fn(*args, **kwargs)
                if block:
                    _block_on(result)
                return result
            finally:
                _record(key, time.perf_counter() - t0)

        return wrapper  # type: ignore[return-value]

    return decorator


@contextmanager
def Timer(key: str) -> Iterator[None]:
    """Context-manager form of :func:`timed`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(key, time.perf_counter() - t0)


def timing(key: str) -> tuple[int, datetime.timedelta]:
    """Query cumulative timing, mirroring ``dolfinx.common.timing``
    (used by reference ``demos/demo_perf.py:18,85-150``).

    Returns:
        ``(call_count, total_wall_clock)`` — total as a ``datetime.timedelta``.
        Unknown keys return ``(0, timedelta(0))``.
    """
    with _lock:
        count, total = _registry.get(key, (0, 0.0))
    return count, datetime.timedelta(seconds=total)


def timing_seconds(key: str) -> float:
    """Total seconds accumulated for ``key`` (convenience)."""
    with _lock:
        return _registry.get(key, (0, 0.0))[1]


def reset_timings() -> None:
    """Clear the registry."""
    with _lock:
        _registry.clear()


def list_timings() -> dict[str, tuple[int, float]]:
    """Snapshot of the registry: ``{key: (count, total_seconds)}``."""
    with _lock:
        return dict(_registry)


@contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """Capture a JAX/XLA profiler trace (TensorBoard format) around a block.

    The deep-profiling complement to the named-timer registry (SURVEY §5:
    tracing/profiling): wall-clock phases come from :func:`timed`, per-op
    device timelines from this trace.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
