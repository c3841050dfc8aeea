from .mesh import Mesh
from .generation import (
    interval_mesh, unit_interval_mesh, rectangle_mesh, unit_square_mesh,
    box_mesh, unit_cube_mesh,
)

__all__ = [
    "Mesh", "interval_mesh", "unit_interval_mesh", "rectangle_mesh",
    "unit_square_mesh", "box_mesh", "unit_cube_mesh",
]
