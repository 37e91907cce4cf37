"""tfhe_omr — a TFHE/RLWE framework in JAX implementing InstantOMR.

A from-scratch JAX/XLA re-design of the capabilities of the
``xiangxiecrypto/tfhe-omr`` reference (InstantOMR: Oblivious Message Retrieval
via two-layer TFHE functional bootstrapping + RLWE digest packing).

Architecture (batched, not a port):

* every primitive is *batched over the message axis* — the reference runs a
  deep scalar pipeline per message and parallelises with rayon threads
  (reference ``omr_core/examples/omr.rs:160-164``); here the whole per-message
  pipeline is one jitted program operating on ``(batch, ...)`` arrays and
  scaled across devices with ``jax.sharding`` / ``shard_map``.
* polynomial coefficient axes are kept *major to batch* in the hot loops
  (layout ``(N, 2, B)``), so NTT butterflies run with the batch as the minor
  axis.
* monomial rotations inside blind rotation are NTT-domain pointwise products
  against a tiny ``2N``-entry twiddle table instead of data gathers.

Subpackage map (counterpart of the reference layer map, see SURVEY.md §1):

* :mod:`tfhe_omr.ops`      — L0/L1: modular arithmetic, NTT, gadget
  decomposition, blind rotation, key switching, homomorphic trace.
* :mod:`tfhe_omr.core`     — L2/L3: parameters, key generation, the
  Sender / Detector / Retriever protocol roles, LUTs, payloads, digest codec.
* :mod:`tfhe_omr.parallel` — device-mesh sharding of detection + digest
  reduction (the counterpart of the reference's rayon data parallelism).
* :mod:`tfhe_omr.utils`    — timing/CSV/size-accounting helpers.
* :mod:`tfhe_omr.native`   — C++ host runtime (mod-p linear algebra for
  the client-side decoder) with a NumPy fallback.
"""

import jax

# Exact 64-bit lattice arithmetic requires x64 mode. This must run before any
# jax.numpy arrays are created by this package.
jax.config.update("jax_enable_x64", True)

from tfhe_omr.utils.cache import compile_cache_dir  # noqa: E402

# The bootstrapping programs are large graphs; persist their compilations
# across processes (JAX itself honours JAX_COMPILATION_CACHE_DIR when set).
_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)

from tfhe_omr.core.params import OmrParameters, RetrievalParams  # noqa: E402
from tfhe_omr.core.payload import PAYLOAD_LENGTH, random_payloads  # noqa: E402
from tfhe_omr.core.keygen import KeyGen, SecretKeyPack  # noqa: E402
from tfhe_omr.core.sender import Sender  # noqa: E402
from tfhe_omr.core.detector import Detector  # noqa: E402
from tfhe_omr.core.retriever import Retriever  # noqa: E402
from tfhe_omr.core.errors import OmrError  # noqa: E402

__all__ = [
    "OmrParameters",
    "RetrievalParams",
    "PAYLOAD_LENGTH",
    "random_payloads",
    "KeyGen",
    "SecretKeyPack",
    "Sender",
    "Detector",
    "Retriever",
    "OmrError",
]

__version__ = "0.1.0"
