"""The port's host setup is a copy of the reference's numpy code: mesh,
dofmap, dof points, boundary dofs, the ELL sparsity pattern and the P1
operator (CSR values, DIA packing, lumped mass, obstacle, interior mask)
must be bit-identical to proximalgalerkin_tpu's on the same mesh."""

import numpy as np
import pytest

import proximalgalerkin_tpu.la.ell as ref_ell
import proximalgalerkin_tpu.mesh as ref_mesh
import proximalgalerkin_tpu.native as ref_native
import proximalgalerkin_tpu.spaces as ref_spaces
from proximalgalerkin_tpu.models.obstacle_p1 import \
    P1ObstacleSolver as RefSolver

import proximalgalerkin_torch.la.ell as pt_ell
import proximalgalerkin_torch.mesh as pt_mesh
import proximalgalerkin_torch.native as pt_native
import proximalgalerkin_torch.spaces as pt_spaces
from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver

MESHES = {
    "right32": dict(nx=32, ny=32),
    "crossed12": dict(nx=12, ny=12, diagonal="crossed"),
}


def _mesh(pkg, name):
    kw = dict(MESHES[name])
    return pkg.rectangle_mesh(kw.pop("nx"), kw.pop("ny"), p0=(-1.0, -1.0),
                              p1=(1.0, 1.0), **kw)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_and_space_identical(name):
    mr, mt = _mesh(ref_mesh, name), _mesh(pt_mesh, name)
    assert mr.cell_type == mt.cell_type
    _same(mr.points, mt.points)
    _same(mr.cell_vertices, mt.cell_vertices)
    Vr = ref_spaces.FunctionSpace.create(mr, 1)
    Vt = pt_spaces.FunctionSpace.create(mt, 1)
    assert Vr.num_dofs == Vt.num_dofs
    _same(Vr.dofmap, Vt.dofmap)
    _same(Vr.dof_points, Vt.dof_points)
    _same(Vr.boundary_dofs(), Vt.boundary_dofs())


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ell_pattern_identical(name):
    V = pt_spaces.FunctionSpace.create(_mesh(pt_mesh, name), 1)
    dm, bd = V.dofmap.astype(np.int64), V.boundary_dofs()
    pr = ref_ell.EllPattern._build_uncached(dm, V.num_dofs,
                                            np.asarray(bd, np.int64))
    pt = pt_ell.EllPattern._build_uncached(dm, V.num_dofs,
                                           np.asarray(bd, np.int64))
    assert (pr.num_dofs, pr.nnz, pr.width) == (pt.num_dofs, pt.nnz,
                                               pt.width)
    for field in ("slot_map", "keep", "diag_ones", "ell_gather",
                  "ell_cols"):
        _same(getattr(pr, field), getattr(pt, field))
    # the cached build returns the same pattern
    pc = pt_ell.EllPattern.build(dm, V.num_dofs, bd)
    _same(pc.ell_gather, pt.ell_gather)


def test_native_helpers_identical():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 500, size=4000)
    for a, b in zip(ref_native.unique_with_inverse(keys),
                    pt_native.unique_with_inverse(keys)):
        _same(a, b)
    vals = rng.standard_normal(4000)
    _same(ref_native.scatter_add(vals, keys, 500),
          pt_native.scatter_add(vals, keys, 500))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_p1_operator_identical(name):
    sr = RefSolver(_mesh(ref_mesh, name))
    st = P1ObstacleSolver(_mesh(pt_mesh, name), device="cpu")
    _same(sr.A_csr_host, st.A_csr_host)
    assert tuple(sr.dia.offsets) == st.dia.offsets
    _same(np.asarray(sr.dia.data), st.dia.data.numpy())
    _same(np.asarray(sr.M_L), st.M_L.numpy())
    _same(np.asarray(sr.phi), st.phi.numpy())
    _same(np.asarray(sr.interior), st.interior.numpy())
    assert sr.cg_max == st.cg_max
