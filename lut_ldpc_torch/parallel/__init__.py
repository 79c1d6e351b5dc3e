"""Data parallelism over slots (counterpart of lut_ldpc_tpu/parallel).

The reference scales Monte-Carlo BER out by running one binary per seed
per host and merging result files offline; the JAX package runs one SPMD
program over a device mesh.  Here a mesh is an ordered tuple of
(rank, torch.device) slots: every slot simulates its own global batch
with the generator a single-device run gives that batch, and the counters
are gathered (gloo across processes) in global-batch order.  Within a
process the slots of several cards run at once, one host thread a card
(``run_by_device``).
"""

from .mesh import (
    DPMesh,
    Slot,
    dp_mesh,
    dp_mesh_2d,
    make_dp_step,
    make_dp_step_2d,
    multihost_init,
    run_by_device,
)

__all__ = ["DPMesh", "Slot", "dp_mesh", "dp_mesh_2d", "make_dp_step",
           "make_dp_step_2d", "multihost_init", "run_by_device"]
