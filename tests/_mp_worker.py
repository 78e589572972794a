"""Worker for the real multi-process (``jax.distributed``) test.

Launched as ``python tests/_mp_worker.py <process_id> <num_processes>
<port>`` by ``test_multiprocess.py`` — the single-controller analog of the
reference CI's genuine ``mpiexec -n 2`` runs (reference
``.github/workflows/test_package.yml:33-45``): two OS processes, four CPU
devices each, joined into one 8-device JAX runtime via
``jax.distributed.initialize`` (gloo CPU collectives), asserting
sharded == serial on a tree and on a lattice.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import jax

# Platform config must land before the first backend initialisation.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_enable_x64", True)


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from networks_fenicsx_tpu.parallel import multihost

    # the REAL entry point (not the mocks of test_multihost.py)
    joined = multihost.ensure_distributed(f"localhost:{port}", nproc, pid)
    assert joined, "ensure_distributed did not join the runtime"
    assert jax.process_index() == pid
    assert jax.device_count() == 4 * nproc, jax.device_count()
    assert len(jax.local_devices()) == 4

    from networks_fenicsx_tpu import (
        HydraulicNetworkAssembler,
        NetworkMesh,
        Solver,
        SolverOptions,
        network_generation,
    )
    from networks_fenicsx_tpu.parallel import ShardedNetworkSolver

    def check(tag, mesh, sharded_sol, ref_sol, method, want_method):
        got = np.concatenate([fn.values for fn in sharded_sol])
        ref = np.concatenate([fn.values for fn in ref_sol])
        scale = max(1.0, np.abs(ref).max())
        err = float(np.max(np.abs(got - ref))) / scale
        assert err < 1e-10, f"{tag}: sharded != serial ({err:.3e})"
        assert method == want_method, f"{tag}: {method} != {want_method}"
        print(f"MP_CHECK[{pid}] {tag}: err={err:.2e} method={method}", flush=True)

    # --- tree (uniformly binary: blocked sharded path over 8 devices)
    G = network_generation.make_tree(5, 2.0, 2.0)
    mesh = NetworkMesh(G, N=2, color_strategy="largest_first")
    E = mesh.num_edges
    R = np.linspace(0.8, 2.2, E)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=0.3, R=R)
    sh = ShardedNetworkSolver(asm)
    sh.assemble()
    sol = sh.solve()

    asm_s = HydraulicNetworkAssembler(mesh)
    asm_s.compute_forms(p_bc_ex=lambda x: x[1], f=0.3, R=R)
    ser = Solver(asm_s)
    ser.assemble()
    check("tree", mesh, sol, ser.solve(), sh.info.method, "schur_sharded_blocked")

    # --- lattice (strip-sharded grid path, ragged ny over 8 devices)
    Gl = network_generation.make_grid(7, 6, arrays=True)
    mesh_l = NetworkMesh(Gl, N=2)
    asm_l = HydraulicNetworkAssembler(mesh_l)
    asm_l.compute_forms(p_bc_ex=lambda x: x[0], f=0.2, R=1.5)
    sl = ShardedNetworkSolver(asm_l)
    sl.assemble()
    sol_l = sl.solve()

    asm_r = HydraulicNetworkAssembler(mesh_l)
    asm_r.compute_forms(p_bc_ex=lambda x: x[0], f=0.2, R=1.5)
    ref_l = Solver(asm_r, options=SolverOptions(method="host_lu"))
    ref_l.assemble()
    check("grid", mesh_l, sol_l, ref_l.solve(), sl.info.method, "schur_sharded_grid")

    # --- unstructured web (no forest/lattice envelope: the GENERAL
    # sharded pipeline — edge-partitioned psum assembly + peel-then-core)
    Gw = network_generation.make_random_network(24, keep=0.6, num_boundary=3, seed=2)
    mesh_w = NetworkMesh(Gw, N=1, color_strategy="fast")
    rng_w = np.random.default_rng(3)
    R_w = rng_w.uniform(0.5, 2.0, mesh_w.num_edges)
    asm_w = HydraulicNetworkAssembler(mesh_w)
    asm_w.compute_forms(p_bc_ex=lambda x: x[0], R=R_w)
    sw = ShardedNetworkSolver(asm_w)
    sw.assemble()
    sol_w = sw.solve()

    asm_wr = HydraulicNetworkAssembler(mesh_w)
    asm_wr.compute_forms(p_bc_ex=lambda x: x[0], R=R_w)
    ref_w = Solver(asm_wr, options=SolverOptions(method="host_lu"))
    ref_w.assemble()
    check("web", mesh_w, sol_w, ref_w.solve(), sw.info.method, "schur_sharded")

    print(f"MP_OK[{pid}]", flush=True)


if __name__ == "__main__":
    main()
