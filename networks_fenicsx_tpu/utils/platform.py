"""Backend selection and compilation-cache helpers.

Demos and scripts call :func:`apply_platform_env` at startup (before the
backend is initialised) to honor ``NXFX_PLATFORM`` / ``NXFX_CPU_DEVICES``,
and :func:`enable_compilation_cache` to keep compiled executables across
processes.  :func:`gpu_device_record` names the card a measurement ran on.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

__all__ = [
    "apply_platform_env",
    "enable_compilation_cache",
    "default_cache_dir",
    "gpu_device_record",
]


def gpu_device_record(n_cards: int = 1) -> dict:
    """The GPUs a run measures: JAX's view (``platform``, ``kind``,
    ``count`` = ``n_cards``) and, under ``cards``, one
    ``nvidia-smi --query-gpu=name,power.limit`` line per card.

    Raises ``RuntimeError`` unless JAX's first device is a GPU and at least
    ``n_cards`` are visible.
    """
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {d.platform!r} ({d.device_kind})")
    if len(devs) < n_cards:
        raise RuntimeError(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    cards = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    return {"platform": d.platform, "kind": d.device_kind, "count": n_cards, "cards": cards}


def default_cache_dir() -> Path:
    """The fixed in-checkout cache directory used when
    ``JAX_COMPILATION_CACHE_DIR`` is unset (listed in ``.gitignore``)."""
    return Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache(min_compile_time_secs: float = 0.5) -> Path:
    """Enable JAX's persistent compilation cache.

    The role FFCx's on-disk kernel cache plays for the reference
    (``demos/demo_perf.py:41-47,116-132``): a fresh process re-solving the
    same problem structure loads the serialized XLA executable instead of
    recompiling.  Safe to call more than once.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX's own setting is left in
    place and no directory is set here; otherwise the cache lives at the
    fixed :func:`default_cache_dir` (a fixed path, because the path is part
    of the cache key).

    Args:
        min_compile_time_secs: Only compilations at least this slow are
            persisted (skips trivially-recompilable dispatches).

    Returns:
        The cache directory in effect.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        cache_dir = Path(env_dir)
    else:
        cache_dir = default_cache_dir()
        cache_dir.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir


def apply_platform_env() -> None:
    import jax

    platform = os.environ.get("NXFX_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    n_cpu = os.environ.get("NXFX_CPU_DEVICES")
    if n_cpu:
        jax.config.update("jax_num_cpu_devices", int(n_cpu))
