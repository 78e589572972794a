"""Guarded multi-host initialisation (parallel.multihost)."""

import networks_fenicsx_tpu.parallel.multihost as mh


def test_single_host_noop(monkeypatch):
    """With no coordinator and no cluster env, the call is a no-op."""
    for var in ("NXFX_COORDINATOR", "NXFX_NUM_PROCESSES", "NXFX_PROCESS_ID",
                "SLURM_JOB_ID", "OMPI_MCA_orte_hnp_uri"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(mh, "_initialized", False)
    called = []
    import jax

    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    assert mh.ensure_distributed() is False
    assert called == []
    assert mh.is_initialized() is False


def test_env_configured_init(monkeypatch):
    """NXFX_COORDINATOR triggers jax.distributed.initialize with the
    resolved process topology; a second call is idempotent."""
    monkeypatch.setenv("NXFX_COORDINATOR", "10.0.0.2:8476")
    monkeypatch.setenv("NXFX_NUM_PROCESSES", "4")
    monkeypatch.setenv("NXFX_PROCESS_ID", "1")
    monkeypatch.setattr(mh, "_initialized", False)
    called = []
    import jax

    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    assert mh.ensure_distributed() is True
    assert called == [
        dict(coordinator_address="10.0.0.2:8476", num_processes=4, process_id=1)
    ]
    assert mh.is_initialized() is True
    assert mh.ensure_distributed() is True  # idempotent: no second init
    assert len(called) == 1


def test_explicit_args_beat_env(monkeypatch):
    monkeypatch.setenv("NXFX_COORDINATOR", "ignored:1")
    monkeypatch.setattr(mh, "_initialized", False)
    called = []
    import jax

    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    assert mh.ensure_distributed("host0:9999", 2, 0) is True
    assert called[0]["coordinator_address"] == "host0:9999"
