"""Compile-cache placement and the networkx-free main path."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(code: str, env: dict) -> str:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


CACHE_PROBE = """
import json, jax, jax.numpy as jnp
from networks_fenicsx_tpu.utils.platform import enable_compilation_cache
d = enable_compilation_cache(min_compile_time_secs=0.0)
jax.jit(lambda x: jnp.sin(x) * 3.0 + x.sum())(jnp.ones(17)).block_until_ready()
print(json.dumps({"returned": str(d), "config": jax.config.jax_compilation_cache_dir}))
"""


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compilation_cache_dir(env_set, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    target = tmp_path / "cache"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(target)
    out = json.loads(_run(CACHE_PROBE, env))
    if env_set:
        # JAX's own setting stays in place: the entries land there
        assert out["returned"] == out["config"] == str(target)
        assert any(target.iterdir())
    else:
        assert out["returned"] == out["config"] == str(REPO / ".jax_cache")


NO_NETWORKX = """
import sys
sys.modules["networkx"] = None  # any import of networkx now raises
import numpy as np
import networks_fenicsx_tpu as nf
from networks_fenicsx_tpu.network_generation import make_arterial_tree
mesh = nf.NetworkMesh(make_arterial_tree(5, direction=np.array([0.1, 1.0, 0.0]),
                                         arrays=True), N=4, color_strategy="fast")
asm = nf.HydraulicNetworkAssembler(mesh)
asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / mesh.edge_radius**4)
s = nf.Solver(asm)
s.assemble()
s.solve()
print(s.info.method, float(abs(np.asarray(s.solution_vector())).max()))
"""


def test_main_path_without_networkx():
    out = _run(NO_NETWORKX, dict(os.environ, JAX_PLATFORMS="cpu"))
    method, qmax = out.split()
    assert method == "schur" and float(qmax) > 0


def test_digraph_path_still_uses_networkx():
    """A DiGraph input still works (networkx imported lazily)."""
    from networks_fenicsx_tpu import NetworkMesh, network_generation

    G = network_generation.make_tree(3, 1, 2)
    mesh = NetworkMesh(G, N=2, color_strategy="largest_first")
    assert mesh.num_edges == G.number_of_edges()
