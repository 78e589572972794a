"""ADIOS2 ``.bp`` output in the VTX schema (gated on ``adios2``).

The reference exports every solution block through DOLFINx's
``io.VTXWriter`` — an ADIOS2 BP dataset carrying a ``vtk.xml`` attribute
that ParaView's VTX reader understands (reference
``post_processing.py:55-78``; SURVEY §2b N8).  This module provides the
same artifact here: :func:`write_bp` mirrors
:func:`networks_fenicsx_tpu.io.vtk.write_vtu`'s signature and writes one
(or, via ``VTXTimeSeriesWriter``, many) time steps into a ``.bp`` dataset
with the VTX variable layout:

* ``NumberOfNodes`` / ``NumberOfCells`` — uint32 scalars (per step),
* ``geometry`` — (nodes, 3) float64,
* ``connectivity`` — (cells, nodes_per_cell + 1) int64, leading count
  per cell (the VTK legacy convention the VTX schema uses),
* ``types`` — uint32 scalar VTK cell type id,
* ``step`` — float64 time stamp,
* one variable per point/cell field, referenced from the ``vtk.xml``
  attribute's ``<PointData>`` / ``<CellData>`` sections.

``adios2`` is not installable in every environment (this image has no
egress); like the DOLFINx golden generator, everything here degrades to
a clear :class:`RuntimeError` when the module is missing and
auto-activates where it exists (e.g. the reference's dolfinx container).
``tests/test_post_processing.py`` round-trips the dataset through
``adios2`` when available and skips otherwise;
``tests/test_bp_mocked.py`` executes the full writer logic (variable
declarations, shapes, step structure, ``vtk.xml``) against a recording
fake ``adios2`` so the code path is exercised in every environment.

Known, intentional deltas from DOLFINx's ``VTXWriter`` output: DOLFINx
additionally writes ``NumberOfConnectivityIds``, ``vtkOriginalPointIds``
and ``vtkGhostType`` variables (parallel-read metadata its VTX reader
path tolerates being absent for serial datasets); this writer omits
them.  Field data is always written as float64 point/cell scalars (the
only shapes :mod:`networks_fenicsx_tpu.post_processing` produces).
Validation against ParaView's VTX reader requires an adios2+ParaView
environment and has not been performed in this image — the round-trip
test pins the variable layout, not reader acceptance.
"""

from __future__ import annotations

from pathlib import Path
from xml.sax.saxutils import quoteattr

import numpy as np
import numpy.typing as npt

VTK_VERTEX = 1
VTK_LINE = 3

__all__ = ["have_adios2", "write_bp", "VTXTimeSeriesWriter"]


def have_adios2() -> bool:
    """True when the ``adios2`` python bindings are importable."""
    try:
        import adios2  # noqa: F401
    except ImportError:
        return False
    return True


def _vtk_xml(point_names: list[str], cell_names: list[str]) -> str:
    """The ``vtk.xml`` attribute body ParaView's VTX reader consumes."""
    pd = "".join(
        f"<DataArray Name={quoteattr(n)} />" for n in point_names
    )
    cd = "".join(
        f"<DataArray Name={quoteattr(n)} />" for n in cell_names
    )
    return (
        '<VTKFile type="UnstructuredGrid" version="0.1" '
        'byte_order="LittleEndian">'
        "<UnstructuredGrid>"
        '<Piece NumberOfPoints="NumberOfNodes" NumberOfCells="NumberOfCells">'
        '<Points><DataArray Name="geometry" /></Points>'
        "<Cells>"
        '<DataArray Name="connectivity" /><DataArray Name="types" />'
        "</Cells>"
        f'<PointData><DataArray Name="TIME">step</DataArray>{pd}</PointData>'
        f"<CellData>{cd}</CellData>"
        "</Piece></UnstructuredGrid></VTKFile>"
    )


def _prepare(points, cells):
    points = np.asarray(points, dtype=np.float64)
    pts3 = np.zeros((points.shape[0], 3), dtype=np.float64)
    pts3[:, : points.shape[1]] = points
    cells = np.asarray(cells, dtype=np.int64)
    if cells.ndim == 1:
        cells = cells[:, None]
    conn = np.empty((cells.shape[0], cells.shape[1] + 1), dtype=np.int64)
    conn[:, 0] = cells.shape[1]
    conn[:, 1:] = cells
    return pts3, conn


class VTXTimeSeriesWriter:
    """Multi-step VTX ``.bp`` writer (the ``VTXWriter.write(t)`` analog).

    Usage::

        with VTXTimeSeriesWriter(path, points, cells, VTK_LINE) as w:
            w.write(0.0, point_data={"pressure": p0})
            w.write(0.5, point_data={"pressure": p1})

    The geometry is written every step (the VTX reader expects step-local
    geometry); field name sets must stay identical across steps.
    """

    def __init__(
        self,
        path: str | Path,
        points: npt.NDArray[np.floating],
        cells: npt.NDArray[np.integer],
        cell_type: int = VTK_LINE,
    ):
        try:
            import adios2
        except ImportError as e:  # pragma: no cover - env-dependent
            raise RuntimeError(
                "ADIOS2 .bp output needs the adios2 python bindings "
                "(available e.g. in the dolfinx containers); use the "
                ".vtu/.pvd writers in this environment"
            ) from e
        self._adios2 = adios2
        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._pts3, self._conn = _prepare(points, cells)
        self._cell_type = int(cell_type)
        self._names: tuple[list[str], list[str]] | None = None
        if not hasattr(adios2, "Stream"):  # pragma: no cover - old adios2
            raise RuntimeError(
                "ADIOS2 >= 2.10 (the Stream API) is required for .bp "
                "output; older bindings are untested here"
            )
        self._stream = adios2.Stream(str(self._path), "w")

    def write(
        self,
        time: float,
        point_data: dict[str, npt.NDArray] | None = None,
        cell_data: dict[str, npt.NDArray] | None = None,
    ) -> None:
        point_data = dict(point_data or {})
        cell_data = dict(cell_data or {})
        names = (sorted(point_data), sorted(cell_data))
        if self._names is None:
            self._names = names
            self._vtkxml = _vtk_xml(*names)
        elif names != self._names:
            raise ValueError(
                "VTX steps must carry the same field names "
                f"(first step {self._names}, got {names})"
            )
        s = self._stream
        n_pts = np.uint32(self._pts3.shape[0])
        n_cells = np.uint32(self._conn.shape[0])

        def _put_arr(name: str, arr: np.ndarray) -> None:
            arr = np.ascontiguousarray(arr)
            shape = list(arr.shape)
            s.write(name, arr, shape, [0] * len(shape), shape)

        s.begin_step()
        s.write("NumberOfNodes", n_pts)
        s.write("NumberOfCells", n_cells)
        s.write("types", np.uint32(self._cell_type))
        s.write("step", np.float64(time))
        _put_arr("geometry", self._pts3)
        _put_arr("connectivity", self._conn)
        for name in self._names[0]:
            vals = np.asarray(point_data[name], dtype=np.float64)
            if vals.shape[0] != self._pts3.shape[0]:
                raise ValueError(
                    f"point field {name!r}: {vals.shape[0]} values for "
                    f"{self._pts3.shape[0]} points"
                )
            _put_arr(name, vals)
        for name in self._names[1]:
            vals = np.asarray(cell_data[name], dtype=np.float64)
            if vals.shape[0] != self._conn.shape[0]:
                raise ValueError(
                    f"cell field {name!r}: {vals.shape[0]} values for "
                    f"{self._conn.shape[0]} cells"
                )
            _put_arr(name, vals)
        if self._first_step():
            s.write_attribute("vtk.xml", self._vtkxml)
        s.end_step()

    def _first_step(self) -> bool:
        # attributes are global in BP; write them exactly once.
        done = getattr(self, "_attrs_written", False)
        self._attrs_written = True
        return not done

    def close(self) -> None:
        self._stream.close()

    def __enter__(self) -> "VTXTimeSeriesWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_bp(
    path: str | Path,
    points: npt.NDArray[np.floating],
    cells: npt.NDArray[np.integer],
    cell_type: int = VTK_LINE,
    point_data: dict[str, npt.NDArray] | None = None,
    cell_data: dict[str, npt.NDArray] | None = None,
    time: float = 0.0,
) -> Path:
    """Write one step of an unstructured grid as a VTX-schema ``.bp``.

    Mirror of :func:`networks_fenicsx_tpu.io.vtk.write_vtu` for the
    reference's ADIOS2 output format (reference
    ``post_processing.py:68-78``).  Raises ``RuntimeError`` when the
    ``adios2`` bindings are absent.
    """
    path = Path(path)
    with VTXTimeSeriesWriter(path, points, cells, cell_type) as w:
        w.write(time, point_data=point_data, cell_data=cell_data)
    return path
