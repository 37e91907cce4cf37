"""Device-side lattice primitives (L0/L1 of the reference layer map).

Counterparts of the external ``primus-fhe`` crates the reference
depends on (``algebra``/``lattice``/``fhe_core``; see SURVEY.md §2.2). All
semantics are pinned by the reference call sites cited in each module.
"""

from tfhe_omr.ops.modmath import PrimeField
from tfhe_omr.ops.ntt import NegacyclicNtt

__all__ = ["PrimeField", "NegacyclicNtt"]
