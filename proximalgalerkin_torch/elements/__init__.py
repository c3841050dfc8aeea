from .cells import ReferenceCell, reference_cell
from .quadrature import cell_quadrature, gauss_legendre_01
from .orthopoly import tabulate_orthonormal, num_modes
from .lagrange import LagrangeElement, lagrange_element

__all__ = [
    "ReferenceCell", "reference_cell", "cell_quadrature", "gauss_legendre_01",
    "tabulate_orthonormal", "num_modes", "LagrangeElement", "lagrange_element",
]
