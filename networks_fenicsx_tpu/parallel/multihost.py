"""Multi-host runtime initialisation.

A single host needs nothing: one process drives every local device (all
GPUs of a multi-GPU host, joined by NVLink).  Across hosts, one process per
host runs the same program and must join the JAX distributed runtime before
first device use — the role ``mpiexec`` + ``MPI_Init`` play for the
reference (reference ``.github/workflows/test_package.yml:33-45``,
``mesh.py:227-250`` metadata broadcast; here there is nothing to broadcast —
each controller traces the same program and XLA runs the collectives).

Call :func:`ensure_distributed` once at program start.  It is a no-op
unless multi-host execution is actually configured (explicit arguments,
``NXFX_COORDINATOR`` set, or a SLURM / Open MPI job that
``jax.distributed`` auto-detects), so library code and single-host scripts
can call it unconditionally.

Launch recipe (one process per host)::

    # under SLURM or Open MPI: the launcher's environment is auto-detected
    srun python demo_arterial_tree.py   # calls ensure_distributed() internally

    # explicit coordination when auto-detection is unavailable:
    NXFX_COORDINATOR=10.0.0.2:8476 NXFX_NUM_PROCESSES=4 NXFX_PROCESS_ID=$i \
        python demo_arterial_tree.py

See ``docs/sharding.md`` for the full multi-host section.
"""

from __future__ import annotations

import os

__all__ = ["ensure_distributed", "is_initialized"]

_initialized = False


def is_initialized() -> bool:
    """Whether this process has joined a multi-host JAX runtime."""
    return _initialized


def ensure_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the JAX distributed (multi-host) runtime if one is configured.

    Resolution order for each parameter: explicit argument, then the
    ``NXFX_COORDINATOR`` / ``NXFX_NUM_PROCESSES`` / ``NXFX_PROCESS_ID``
    environment variables, then ``jax.distributed``'s own cluster
    auto-detection (SLURM, Open MPI).

    Returns:
        True if the distributed runtime is active after the call (either
        joined now or already initialised); False when running single-host
        (the call is then a no-op).
    """
    global _initialized
    if _initialized:
        return True

    coordinator_address = coordinator_address or os.environ.get("NXFX_COORDINATOR")
    if num_processes is None and os.environ.get("NXFX_NUM_PROCESSES"):
        num_processes = int(os.environ["NXFX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("NXFX_PROCESS_ID"):
        process_id = int(os.environ["NXFX_PROCESS_ID"])

    # Without an explicit coordinator, only proceed when a cluster
    # environment jax can auto-detect is present; otherwise stay single-host.
    auto_cluster = any(
        os.environ.get(var)
        for var in ("SLURM_JOB_ID", "OMPI_MCA_orte_hnp_uri")
    )
    if coordinator_address is None and not auto_cluster:
        return False

    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True
