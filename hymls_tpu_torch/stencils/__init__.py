from .generators import (
    laplace2d, laplace3d, laplace2d_neumann, laplace3d_neumann, star3d,
    uniflow2d,
    darcy2d, darcy3d, darcyb2d, stokes2d, stokes2d_b, stokes3d,
    stretched2d, create_matrix, create_testvector,
    create_nullspace,
)

__all__ = [
    "laplace2d", "laplace3d", "laplace2d_neumann", "laplace3d_neumann", "star3d", "uniflow2d",
    "darcy2d", "darcy3d", "darcyb2d", "stokes2d", "stokes2d_b",
    "stokes3d", "stretched2d", "create_matrix",
    "create_testvector", "create_nullspace",
]
