"""Multi-host (multi-process) runtime glue.

The reference is single-process (SURVEY.md §2.5); this framework's
multi-chip design is single-controller JAX: every host runs the same
program, ``jax.distributed.initialize`` wires the hosts into one global
device mesh, and from then on the mesh/pjit machinery (``parallel.mesh``,
``fit(mesh=...)``) is host-count-agnostic — ``fit`` already feeds each
process only its own data shard (``NativeLoader(shard=...)`` +
``jax.make_array_from_process_local_data``).

This module is the thin, explicit seam for a multi-process launcher:

    from tensor_ops.parallel.distributed import init_distributed
    init_distributed()              # env-driven (TOPS_* variables)
    mesh = make_mesh(len(jax.devices()))   # GLOBAL device count
    fit(net, loss, be, X, Y, mesh=mesh, ...)

Pass ``coordinator_address``/``num_processes``/``process_id`` explicitly
or via the TOPS_COORDINATOR / TOPS_NUM_PROCESSES / TOPS_PROCESS_ID
environment variables.
"""

from __future__ import annotations

import os
from typing import Optional

_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> dict:
    """Initialize the multi-process JAX runtime (idempotent).

    Argument resolution order: explicit args > TOPS_* env vars.
    Single-process runs (no coordinator configured) are a no-op.
    Returns a summary dict: {initialized, process_index, process_count, local_devices,
    global_devices}.
    """
    global _initialized
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "TOPS_COORDINATOR")
    if num_processes is None and "TOPS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TOPS_NUM_PROCESSES"])
    if process_id is None and "TOPS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TOPS_PROCESS_ID"])

    if not _initialized and coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        _initialized = True

    return {
        "initialized": _initialized,
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def shutdown_distributed() -> None:
    """Tear down the distributed client (end-of-program hygiene)."""
    global _initialized
    if _initialized:
        import jax

        jax.distributed.shutdown()
        _initialized = False
