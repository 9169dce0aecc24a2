"""The STARK LDE + commit pipeline and the distributed layer (a mesh of
ranks on ``torch.distributed``)."""

from .mesh import AXIS, make_mesh, sharded  # noqa: F401
from .dist_ntt import (  # noqa: F401
    distributed_ntt, distributed_ntt_values, distributed_ntt_xfe_values)
from .dist_merkle import (  # noqa: F401
    distributed_merkle_root,
    distributed_merkle_root_limbs,
)
