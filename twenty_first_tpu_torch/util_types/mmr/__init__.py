from . import shared_basic  # noqa: F401
from . import shared_advanced  # noqa: F401
from .mmr_trait import LeafMutation, Mmr  # noqa: F401
from .mmr_membership_proof import MmrMembershipProof  # noqa: F401
from .mmr_accumulator import MmrAccumulator, bag_peaks  # noqa: F401
from .archival_mmr import ArchivalMmr  # noqa: F401
from .mmr_successor_proof import MmrSuccessorProof  # noqa: F401
