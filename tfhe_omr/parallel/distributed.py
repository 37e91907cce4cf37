"""Multi-host launch helper.

The reference is single-process (rayon shared memory; SURVEY.md §2.4). This
framework scales the same data-parallel program across processes with the
JAX multi-controller runtime: every process runs the identical script, clues
are sharded over the global ``data`` mesh axis, the detection key is
replicated, and the digest ``psum`` is the only collective — no
application-level communication code is needed beyond the mesh.

Typical use in each process::

    from tfhe_omr.parallel import distributed
    distributed.init()          # jax.distributed.initialize()
    mesh = make_data_mesh()     # now spans all hosts' devices
    sharded = ShardedDetector(detector, mesh)
"""

from __future__ import annotations

import jax


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> int:
    """Initialise the JAX multi-controller runtime (no-op if single-host).

    Pass the coordinator address, process count and process id explicitly
    where the environment does not describe a cluster. Returns the global
    device count.
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    else:
        try:
            jax.distributed.initialize()
        except Exception:
            # single-process environments (no cluster env vars) — fine
            pass
    return len(jax.devices())


def is_multihost() -> bool:
    return jax.process_count() > 1
