"""User-facing re-exports (mirrors twenty-first/src/prelude.rs): the names
of ``twenty_first_tpu/prelude.py``, from the port's own modules."""

from .math.b_field_element import (  # noqa: F401
    BFieldElement,
    bfe,
    bfe_vec,
    bfe_array,
)
from .math.x_field_element import (  # noqa: F401
    XFieldElement,
    xfe,
    xfe_vec,
    xfe_array,
)
from .math.polynomial import Polynomial  # noqa: F401
from .math.bfield_codec import bfield_codec  # noqa: F401
from .tip5.digest import Digest  # noqa: F401
from .tip5.tip5 import Tip5  # noqa: F401
from .util_types.sponge import Domain, Sponge  # noqa: F401
from .util_types.merkle_tree import (  # noqa: F401
    MerkleTree,
    MerkleTreeInclusionProof,
)
from .util_types.mmr import (  # noqa: F401
    ArchivalMmr,
    LeafMutation,
    Mmr,
    MmrAccumulator,
    MmrMembershipProof,
    MmrSuccessorProof,
)
