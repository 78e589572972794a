"""chip_smoke.py on the CPU: its device gate, and each solve phase at a tiny
size (the phases run at full width only on the GPU)."""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}_under_test", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke")


def _cpu_env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("NXFX_TESTS_ON_DEVICE", None)
    return env


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.phase_device()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_script_fails_without_gpu(where, tmp_path):
    """Non-zero exit and no ok line on the CPU backend, in the checkout and
    in a directory holding nothing but the script."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    p = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       cwd=script.parent, env=_cpu_env(), timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_bench_fails_without_gpu():
    p = subprocess.run([sys.executable, str(REPO / "bench.py")], capture_output=True,
                       text=True, cwd=REPO, env=_cpu_env(), timeout=300)
    assert p.returncode != 0
    assert "no GPU" in p.stdout


def test_checks_fail_on_nan_and_excess():
    chk = cs.Checks()
    assert chk.bound("ok", 1e-12, 1e-10)
    assert not chk.bound("nan", float("nan"), 1e-10)
    assert not chk.bound("excess", 1e-9, 1e-10)
    assert not chk.true("false", False)
    assert chk.count == 4 and chk.failed == ["nan", "excess", "false"]


def test_junction_imbalance_flags_leak():
    """The conservation measure is ~0 on a solution and sees a leak."""
    from networks_fenicsx_tpu import NetworkMesh, network_generation

    mesh = NetworkMesh(network_generation.make_tree(4, 1, 2, arrays=True), N=3)
    _, sol, _ = cs.solve(cs._assembler(mesh))
    assert cs.junction_imbalance(mesh, sol) < 1e-12
    sol[0].values[-1] += 1.0
    assert cs.junction_imbalance(mesh, sol) > 1e-3


PHASES = {
    "main": lambda chk: cs.phase_main(chk, gens=6, N=4),
    "lattice_dct": lambda chk: cs.phase_lattice_dct(chk, 32),
    "lattice_f32": lambda chk: cs.phase_lattice_f32(chk, 32),
    "web": lambda chk: cs.phase_web(chk, 300, expect_mf=False),
    "bed": lambda chk: cs.phase_bed(chk, (3, 12, 8)),
    "mf_lattice": lambda chk: cs.phase_mf_lattice(chk, 48),
    "multi": lambda chk: cs.phase_multi(chk, 4, gens=6, N=4, lattice=16, web=300),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_tiny(phase):
    chk = cs.Checks()
    PHASES[phase](chk)
    assert chk.count > 0 and not chk.failed, chk.failed


def test_multi_phase_sees_single_device_placement():
    """The placement check fails when a 'sharded' solve used one device."""
    chk = cs.Checks()
    from networks_fenicsx_tpu import NetworkMesh, network_generation

    mesh = NetworkMesh(network_generation.make_tree(4, 1, 2, arrays=True), N=2)
    ss, _ = cs._sharded(cs._assembler(mesh, R=np.ones(mesh.num_edges)), cs._one_device())
    cs._spread(chk, "one device", 4, ss.device_io)
    assert chk.failed == ["one device: shards on 4 devices"]
