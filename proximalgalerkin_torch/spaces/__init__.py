from .space import FunctionSpace, MixedSpace, DirichletBC
from .dofmap import build_dofmap

__all__ = ["FunctionSpace", "MixedSpace", "DirichletBC", "build_dofmap"]
