"""Minimal VTK XML (VTU) writer/reader for network meshes.

Host-side replacement for the reference's ADIOS2 VTXWriter / XDMF output
(reference ``post_processing.py:55-97`` via ``dolfinx.io``): solutions and
meshes are written as ``.vtu`` unstructured-grid files (ParaView
compatible) from gathered host arrays.  The reference's ``.bp``/ADIOS2
backend is mirrored by :mod:`.bp`; VTU is the dependency-free
visualisation path (SURVEY §2b row N8).

Two encodings:

* ``"binary"`` (default for large grids): inline base64 VTK binary data —
  bit-exact float64 round trip at ~1/8 the size of ASCII and none of the
  float-formatting cost, making full-scale exports (2.6M-cell benchmark
  meshes) practical.
* ``"ascii"``: human-readable, used for small demo files.
"""

from __future__ import annotations

import base64
from pathlib import Path

import numpy as np
import numpy.typing as npt

__all__ = ["write_vtu", "read_vtu", "write_pvd", "read_pvd", "VTK_VERTEX", "VTK_LINE"]

VTK_VERTEX = 1
VTK_LINE = 3

# grids with more data values than this default to the binary encoding
_BINARY_THRESHOLD = 4096

_VTK_TYPES = {"Float64": np.float64, "Int64": np.int64}


def _fmt_ascii(a: np.ndarray) -> str:
    flat = np.asarray(a).ravel()
    if flat.dtype.kind in "iu":
        return " ".join(str(int(v)) for v in flat)
    # 17 significant digits: exact float64 round trip
    return " ".join(f"{float(v):.17g}" for v in flat)


def _fmt_binary(a: np.ndarray) -> str:
    """VTK inline-binary payload: base64(uint64 byte count || raw LE data)."""
    raw = np.ascontiguousarray(a).tobytes()
    header = np.uint64(len(raw)).tobytes()
    return base64.b64encode(header + raw).decode("ascii")


def _data_array(name: str | None, a: np.ndarray, vtk_type: str, ncomp: int, binary: bool) -> str:
    from xml.sax.saxutils import quoteattr

    name_attr = f" Name={quoteattr(name)}" if name else ""
    if binary:
        return (
            f'<DataArray type="{vtk_type}"{name_attr} '
            f'NumberOfComponents="{ncomp}" format="binary">\n'
            f"{_fmt_binary(a)}\n</DataArray>"
        )
    return (
        f'<DataArray type="{vtk_type}"{name_attr} '
        f'NumberOfComponents="{ncomp}" format="ascii">\n'
        f"{_fmt_ascii(a)}\n</DataArray>"
    )


def write_vtu(
    path: str | Path,
    points: npt.NDArray[np.floating],
    cells: npt.NDArray[np.integer],
    cell_type: int = VTK_LINE,
    point_data: dict[str, npt.NDArray] | None = None,
    cell_data: dict[str, npt.NDArray] | None = None,
    fmt: str = "auto",
) -> Path:
    """Write an unstructured grid of uniform cell type to a ``.vtu`` file.

    Args:
        path: Output file (parent directories are created).
        points: (n_pts, gdim) coordinates; padded to 3D as VTK requires.
        cells: (n_cells, nodes_per_cell) connectivity.
        cell_type: VTK cell type id (1 = vertex, 3 = line).
        point_data / cell_data: Named scalar or vector arrays.
        fmt: ``"ascii"``, ``"binary"`` (inline base64, bit-exact float64) or
            ``"auto"`` (binary once the grid exceeds a few thousand values —
            the reference's large-scale outputs go through binary
            ADIOS2/HDF5 likewise, reference ``post_processing.py:68-97``).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points, dtype=np.float64)
    pts3 = np.zeros((points.shape[0], 3))
    pts3[:, : points.shape[1]] = points
    cells = np.asarray(cells, dtype=np.int64)
    if cells.ndim == 1:
        cells = cells.reshape(-1, 1)
    n_cells, npc = (cells.shape[0], cells.shape[1]) if cells.size else (0, 1)

    if fmt == "auto":
        fmt = "binary" if (pts3.size + cells.size) > _BINARY_THRESHOLD else "ascii"
    if fmt not in ("ascii", "binary"):
        raise ValueError(f"unknown vtu format {fmt!r}")
    binary = fmt == "binary"

    def _named_arrays(data: dict[str, npt.NDArray] | None) -> str:
        if not data:
            return ""
        parts = []
        for name, arr in data.items():
            arr = np.asarray(arr, dtype=np.float64)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            parts.append(_data_array(name, arr, "Float64", ncomp, binary))
        return "\n".join(parts)

    offsets = npc * np.arange(1, n_cells + 1, dtype=np.int64)
    types = np.full(n_cells, cell_type, dtype=np.int64)

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian" header_type="UInt64">
<UnstructuredGrid>
<Piece NumberOfPoints="{points.shape[0]}" NumberOfCells="{n_cells}">
<Points>
{_data_array(None, pts3, "Float64", 3, binary)}
</Points>
<Cells>
{_data_array("connectivity", cells, "Int64", 1, binary)}
{_data_array("offsets", offsets, "Int64", 1, binary)}
{_data_array("types", types, "Int64", 1, binary)}
</Cells>
<PointData>
{_named_arrays(point_data)}
</PointData>
<CellData>
{_named_arrays(cell_data)}
</CellData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    path.write_text(xml)
    return path


def write_pvd(path: str | Path, entries: list[tuple[float, str]]) -> Path:
    """Write a ParaView collection (``.pvd``) listing timestamped datasets.

    The time-series container pairing with :func:`write_vtu` frames —
    functional parity for the reference's timestamped ADIOS2 output
    (reference ``post_processing.py:68-78``, ``vtx.write(0.0)``): ParaView
    opens the ``.pvd`` and exposes the frames as an animated series.

    Args:
        path: Output ``.pvd`` file.
        entries: ``(timestep, file)`` pairs; files are stored as given
            (use paths relative to the ``.pvd`` location).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    from xml.sax.saxutils import quoteattr

    rows = "\n".join(
        f'<DataSet timestep="{float(t):.17g}" group="" part="0" '
        f"file={quoteattr(str(f))}/>"
        for t, f in entries
    )
    path.write_text(
        '<?xml version="1.0"?>\n'
        '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">\n'
        f"<Collection>\n{rows}\n</Collection>\n</VTKFile>\n"
    )
    return path


def read_pvd(path: str | Path) -> list[tuple[float, str]]:
    """Read a ``.pvd`` collection written by :func:`write_pvd`."""
    import xml.etree.ElementTree as ET

    root = ET.parse(Path(path)).getroot()
    coll = root.find("./Collection")
    if coll is None:
        raise ValueError(f"no Collection in PVD file {path}")
    return [
        (float(ds.get("timestep")), ds.get("file"))
        for ds in coll.findall("DataSet")
    ]


def read_vtu(path: str | Path):
    """Read a ``.vtu`` written by :func:`write_vtu` (ascii or binary).

    Returns ``(points, cells, point_data, cell_data)`` with the same array
    dtypes that were written — binary files round-trip bit-exactly.
    """
    import xml.etree.ElementTree as ET

    root = ET.parse(Path(path)).getroot()
    piece = root.find("./UnstructuredGrid/Piece")
    assert piece is not None, "not an UnstructuredGrid VTU"

    def decode(da) -> np.ndarray:
        dtype = _VTK_TYPES[da.get("type")]
        ncomp = int(da.get("NumberOfComponents", "1"))
        text = (da.text or "").strip()
        if da.get("format") == "binary":
            raw = base64.b64decode(text)
            nbytes = int(np.frombuffer(raw[:8], dtype=np.uint64)[0])
            arr = np.frombuffer(raw[8 : 8 + nbytes], dtype=dtype)
        else:
            arr = np.array(text.split(), dtype=dtype) if text else np.empty(0, dtype)
        return arr.reshape(-1, ncomp) if ncomp > 1 else arr

    points = decode(piece.find("./Points/DataArray"))
    cells_da = {da.get("Name"): da for da in piece.findall("./Cells/DataArray")}
    connectivity = decode(cells_da["connectivity"])
    offsets = decode(cells_da["offsets"])
    npc = int(offsets[0]) if offsets.size else 1
    cells = connectivity.reshape(-1, npc)

    def named(tag: str) -> dict[str, np.ndarray]:
        sec = piece.find(tag)
        if sec is None:
            return {}
        return {da.get("Name"): decode(da) for da in sec.findall("DataArray")}

    return points, cells, named("./PointData"), named("./CellData")
