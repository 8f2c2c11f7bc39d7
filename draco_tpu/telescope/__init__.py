"""Telescope models and beam-transfer products (driftscan replacement).

The reference consumes these from the external ``driftscan`` package
(``drift.core.telescope/beamtransfer/manager`` — usage catalogued in
SURVEY.md section 1 L0).  Here they are rebuilt device-first: beam transfer
matrices are generated on device via the native SHT and stored as dense
[l, m] tensors ready for batched GEMM projections, and the per-m SVD/KL
products are computed with batched ``jax.lax.linalg`` factorizations.
"""

from .core import (  # noqa: F401
    TransitTelescope,
    SimpleUnpolarisedTelescope,
    SimplePolarisedTelescope,
    UnpolarisedCylinderTelescope,
    PolarisedCylinderTelescope,
    PolarisedDishArray,
    UnpolarisedDishArray,
)
from .beamtransfer import BeamTransfer  # noqa: F401
from .manager import ProductManager  # noqa: F401
