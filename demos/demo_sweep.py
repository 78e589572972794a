"""Batched parameter sweep + adjoint sensitivities (beyond the reference).

No counterpart exists in the reference: these capabilities come from the
fused solve being a pure JAX function.  A resistance sweep over an
arterial tree solves S scenarios in one device dispatch, and reverse-mode
AD gives the sensitivity of an outflow functional with respect to every
vessel resistance at the cost of ~one extra solve."""

from pathlib import Path

import _bootstrap  # noqa: F401  (sys.path + platform setup)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from networks_fenicsx_tpu import (  # noqa: E402
    HydraulicNetworkAssembler,
    NetworkMesh,
    SolverOptions,
    solve_sweep,
)
from networks_fenicsx_tpu.network_generation import make_arterial_tree  # noqa: E402
from networks_fenicsx_tpu.solver import build_schur_executor  # noqa: E402

G = make_arterial_tree(N=6, direction=np.array([0.1, 1.0, 0.0]))
mesh = NetworkMesh(G, N=10, color_strategy="fast")
asm = HydraulicNetworkAssembler(mesh)
R0 = 1.0 / mesh.edge_radius**4
asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0)

# --- sweep: 16 global stiffness scalings in one dispatch
S = 16
scales = np.linspace(0.5, 2.0, S)
res = solve_sweep(asm, R=R0[None, :] * scales[:, None])
root_flux = np.asarray(res.x[:, 0])
print("scale -> root flux (q ∝ 1/R for uniform scaling):")
for s, q in zip(scales[::5], root_flux[::5]):
    print(f"  {s:5.2f} -> {q:9.5f}")

# --- adjoint: d(root flux)/dR_e for every vessel, one backward pass
executor = build_schur_executor(asm, SolverOptions(), jit=False)
_, f_arg, sp, ep = asm.schur_arguments()


def root_outflow(R):
    return executor(R, f_arg, sp, ep)[0][0]


grad = jax.jit(jax.grad(root_outflow))(jnp.asarray(R0))
g = np.asarray(grad)
top = np.argsort(np.abs(g))[::-1][:5]
print("most sensitive vessels (d q_root / d R_e):")
for e in top:
    print(f"  edge {e:3d} (radius {mesh.edge_radius[e]:.3f}): {g[e]: .3e}")

outdir = Path(__file__).parent / "results_sweep"
outdir.mkdir(exist_ok=True)
np.savez(outdir / "sweep.npz", scales=scales, root_flux=root_flux, sensitivity=g)
print(f"saved {outdir / 'sweep.npz'}")
