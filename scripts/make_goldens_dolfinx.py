"""Regenerate the golden files with real DOLFINx/MUMPS (reference stack).

Runs the *reference* package (``networks_fenicsx``, reference
``src/networks_fenicsx/solver.py:58-65`` — PETSc preonly + LU + MUMPS) on
the same demo configurations as ``scripts/make_goldens.py`` and writes
goldens in the identical canonical JSON schema, mapping DOLFINx dofs onto
per-edge chains by physical coordinates.

This script needs the reference's environment (fenics-dolfinx >= 0.10,
petsc4py, mpi4py — e.g. the ghcr.io/fenics/dolfinx/dolfinx:stable
container with this repo and the reference mounted); it is NOT runnable in
this package's own image and exists so CI with that container can cross-check
the committed exact-rational goldens against the reference implementation
itself (BASELINE.md's 1e-8 matching contract).

Usage (inside the reference container)::

    python scripts/make_goldens_dolfinx.py [--outdir tests/goldens_dolfinx]

then compare against tests/goldens/*.json (they should agree to ~1e-8).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

# Configuration table shared with the exact-rational generator.
from make_goldens import CONFIGS  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=str(REPO / "tests" / "goldens_dolfinx"))
    args = ap.parse_args()

    import ufl  # noqa: F401
    from mpi4py import MPI
    from networks_fenicsx import (  # the REFERENCE package
        HydraulicNetworkAssembler,
        NetworkMesh,
        Solver,
        network_generation,
    )

    assert MPI.COMM_WORLD.size == 1, "golden generation is a serial job"

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    for name, spec in CONFIGS.items():
        if spec["graph"] == "grid":
            # lattice topologies are beyond the reference's generators
            # (no make_grid there); the exact-Fraction oracle covers them
            print(f"{name}: skipped (reference has no grid generator)")
            continue
        if spec["graph"] == "tree":
            G = network_generation.make_tree(spec["n"], spec["H"], spec["W"])
        elif spec["graph"] == "random":
            # beyond the reference's generators, but its MUMPS stack can
            # CONSUME the DiGraph — build it with the repo's generator
            # (seeded, deterministic) and cross-validate the unstructured
            # family against DOLFINx too
            from networks_fenicsx_tpu.network_generation import (
                make_random_network,
            )

            G = make_random_network(
                spec["n"],
                keep=spec["keep"],
                num_boundary=spec["num_boundary"],
                seed=spec["seed"],
            )
        else:
            G = network_generation.make_arterial_tree(
                N=spec["n"], direction=np.asarray(spec["direction"])
            )
        edges = [(int(u), int(v)) for u, v in G.edges]
        pos = {n_: np.asarray(G.nodes[n_]["pos"], float) for n_ in G.nodes}
        N = spec["N"]

        k = int(spec.get("flux_degree", 1))
        mesh = NetworkMesh(G, N=N)
        asm = HydraulicNetworkAssembler(mesh, flux_degree=k)

        x = __import__("ufl").SpatialCoordinate(mesh.mesh)
        p_bc = x[0] if spec["p_bc"] == "x" else x[1]
        kwargs = {}
        if spec.get("f") is not None:
            kwargs["f"] = float(spec["f"])
        R_per_edge = None
        if spec.get("R") == "poiseuille":
            radius = np.array([G.edges[e]["radius"] for e in G.edges])
            R_per_edge = 1.0 / radius**4
        elif spec.get("R") == "seeded":
            # same deterministic per-edge values as make_goldens.edge_R;
            # embed them in the written config (list(G.edges) order) so
            # tests/test_golden.py consumes the exact floats
            from make_goldens import edge_R

            R_per_edge = np.asarray(edge_R(spec, G), dtype=np.float64)
            spec = dict(spec, R=R_per_edge.tolist())
        if R_per_edge is not None:
            import dolfinx

            # per-edge R expanded as DG0 data on the parent mesh cells
            # (cells mapped to edges by midpoint — colors != edge ids)
            DG0 = dolfinx.fem.functionspace(mesh.mesh, ("DG", 0))
            Rfun = dolfinx.fem.Function(DG0)
            mids = DG0.tabulate_dof_coordinates()
            Rvals = np.empty(mids.shape[0])
            for c, m in enumerate(mids):
                e = _nearest_edge(m, edges, pos)
                Rvals[c] = R_per_edge[e]
            Rfun.x.array[:] = Rvals
            kwargs["R"] = Rfun
        elif spec.get("R") is not None:
            kwargs["R"] = float(spec["R"])
        asm.compute_forms(p_bc_ex=p_bc, **kwargs)

        solver = Solver(asm)
        solver.assemble()
        sol = solver.solve()

        # degree-k Lagrange flux dofs sit at the k·N+1 equispaced
        # along-edge nodes, so the chain index is over N·k intervals
        flux = np.full((len(edges), k * N + 1), np.nan)
        for color, q in enumerate(sol[:-2]):
            V = q.function_space
            coords = V.tabulate_dof_coordinates()
            for d, xc in enumerate(coords):
                e = _nearest_edge(xc, edges, pos)
                i = _chain_index(xc, edges[e], pos, k * N)
                flux[e, i] = q.x.array[d]
        assert np.all(np.isfinite(flux)), "unmapped flux dofs"

        p = sol[-2]
        pressure = np.full((len(edges), N), np.nan)
        pmids = p.function_space.tabulate_dof_coordinates()
        for d, xc in enumerate(pmids):
            e = _nearest_edge(xc, edges, pos)
            c = _chain_index(xc, edges[e], pos, N, cell=True)
            pressure[e, c] = p.x.array[d]
        assert np.all(np.isfinite(pressure)), "unmapped pressure dofs"

        lam_fun = sol[-1]
        lam = {}
        lcoords = lam_fun.function_space.tabulate_dof_coordinates()
        for d, xc in enumerate(lcoords):
            node = min(pos, key=lambda n_: np.linalg.norm(_pad(pos[n_]) - xc))
            lam[str(int(node))] = float(lam_fun.x.array[d])

        payload = {
            "config": spec,
            "edges": edges,
            "N": N,
            "flux": flux.tolist(),
            "pressure": pressure.tolist(),
            "lam": lam,
            "generator": "scripts/make_goldens_dolfinx.py (DOLFINx + MUMPS)",
        }
        (outdir / f"{name}.json").write_text(json.dumps(payload))
        print(f"{name}: written")


def _pad(p: np.ndarray) -> np.ndarray:
    out = np.zeros(3)
    out[: p.shape[0]] = p
    return out


def _nearest_edge(xc, edges, pos) -> int:
    """Index of the edge whose segment is closest to point ``xc``."""
    best, best_d = 0, np.inf
    for e, (u, v) in enumerate(edges):
        a, b = _pad(pos[u]), _pad(pos[v])
        ab = b - a
        t = np.clip(np.dot(xc - a, ab) / max(np.dot(ab, ab), 1e-300), 0.0, 1.0)
        d = np.linalg.norm(xc - (a + t * ab))
        if d < best_d:
            best, best_d = e, d
    return best


def _chain_index(xc, edge, pos, N: int, cell: bool = False) -> int:
    """Along-edge node index (0..N) or cell index (0..N-1) of point ``xc``."""
    a, b = _pad(pos[edge[0]]), _pad(pos[edge[1]])
    ab = b - a
    t = np.dot(xc - a, ab) / np.dot(ab, ab)
    if cell:
        return int(np.clip(np.floor(t * N), 0, N - 1))
    return int(np.clip(np.rint(t * N), 0, N))


if __name__ == "__main__":
    main()
