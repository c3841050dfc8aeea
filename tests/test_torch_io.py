"""The port's io/vtu.py against the reference package's, on the CPU: the
five cases of tests/test_io.py (VTU round trip, Möbius quads, the PVD
series, XDMF, XDMF round trip) run through both packages on the same
meshes. Every file the port writes reads back through the reference's
reader as the reference's own does, and its text equals the reference's
byte for byte wherever the package name does not appear."""

import numpy as np
import pytest

from proximalgalerkin_tpu import io as ref_io
from proximalgalerkin_tpu.mesh import unit_square_mesh as ref_square
from proximalgalerkin_tpu.mesh.manifolds import mobius_strip as ref_mobius

from proximalgalerkin_torch import io
from proximalgalerkin_torch.mesh import unit_square_mesh
from proximalgalerkin_torch.mesh.manifolds import mobius_strip


def _same_text(a, b):
    """Both files' bytes, the package names taken out, are equal."""
    def strip(p):
        return p.read_bytes().replace(b"proximalgalerkin_torch", b"") \
            .replace(b"proximalgalerkin_tpu", b"")
    assert strip(a) == strip(b), (a, b)


def _same_read(read_port, read_ref, path_port, path_ref):
    """The port's file read by both readers, and the reference's file by
    its own, give one mesh and one data dict."""
    got = [read_port(path_port), read_ref(path_port), read_ref(path_ref)]
    for mesh, data in got[1:]:
        m0, d0 = got[0]
        assert mesh.cell_type == m0.cell_type
        assert np.array_equal(mesh.points, m0.points)
        assert np.array_equal(mesh.cell_vertices, m0.cell_vertices)
        assert data.keys() == d0.keys()
        assert all(np.array_equal(data[k], d0[k]) for k in data)
    return got[0]


def test_vtu_roundtrip(tmp_path):
    mesh, rmesh = unit_square_mesh(4, 4), ref_square(4, 4)
    u = np.arange(mesh.points.shape[0], dtype=float)
    p = io.write_vtu(tmp_path / "m.vtu", mesh, point_data={"u": u})
    q = ref_io.write_vtu(tmp_path / "r.vtu", rmesh, point_data={"u": u})
    _same_text(p, q)
    mesh2, data = _same_read(io.read_vtu, ref_io.read_vtu, p, q)
    assert mesh2.num_cells == mesh.num_cells
    assert mesh2.points.shape == mesh.points.shape
    # point merge may permute: compare sorted values
    assert np.allclose(np.sort(data["u"]), np.sort(u))


def test_vtu_manifold_quads(tmp_path):
    mesh, rmesh = mobius_strip(12, 3), ref_mobius(12, 3)
    p = io.write_vtu(tmp_path / "mob.vtu", mesh)
    q = ref_io.write_vtu(tmp_path / "rmob.vtu", rmesh)
    _same_text(p, q)
    mesh2, _ = _same_read(io.read_vtu, ref_io.read_vtu, p, q)
    assert mesh2.cell_type == "quadrilateral"
    assert mesh2.num_cells == mesh.num_cells
    assert mesh2.gdim == 3


def test_pvd_series(tmp_path):
    mesh, rmesh = unit_square_mesh(2, 2), ref_square(2, 2)
    for writer, m, d in ((io.PVDWriter, mesh, "port"),
                         (ref_io.PVDWriter, rmesh, "ref")):
        w = writer(tmp_path / d / "series.pvd")
        for t in (0.0, 0.5, 1.0):
            w.write(m, t, point_data={"u": np.full(9, t)})
        w.close()
    port, ref = tmp_path / "port", tmp_path / "ref"
    text = (port / "series.pvd").read_text()
    assert text.count("DataSet") == 3
    assert (port / "series_data" / "step_000002.vtu").exists()
    _same_text(port / "series.pvd", ref / "series.pvd")
    for k in range(3):
        f = f"series_data/step_{k:06d}.vtu"
        _same_text(port / f, ref / f)
        _same_read(io.read_vtu, ref_io.read_vtu, port / f, ref / f)


def test_xdmf(tmp_path):
    mesh, rmesh = unit_square_mesh(3, 3), ref_square(3, 3)
    p = io.write_xdmf(tmp_path / "m.xdmf", mesh,
                      point_data={"u": np.zeros(16)})
    q = ref_io.write_xdmf(tmp_path / "r.xdmf", rmesh,
                          point_data={"u": np.zeros(16)})
    assert p.exists()
    assert "Triangle" in p.read_text()
    _same_text(p, q)


@pytest.mark.parametrize("cells", [(3, 3), (4, 2)])
def test_xdmf_roundtrip(tmp_path, cells):
    mesh, rmesh = unit_square_mesh(*cells), ref_square(*cells)
    u = np.linspace(0, 1, mesh.points.shape[0])
    p = io.write_xdmf(tmp_path / "rt.xdmf", mesh, point_data={"u": u})
    q = ref_io.write_xdmf(tmp_path / "rrt.xdmf", rmesh, point_data={"u": u})
    _same_text(p, q)
    mesh2, data = _same_read(io.read_xdmf, ref_io.read_xdmf, p, q)
    assert mesh2.num_cells == mesh.num_cells
    assert np.allclose(mesh2.points, mesh.points)
    assert np.allclose(data["u"], u)
