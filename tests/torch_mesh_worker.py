"""One rank of the port's two-process mesh (tests/test_torch_mesh.py).

    python torch_mesh_worker.py <rank> <world> <port> <outdir>

Joins a gloo group on localhost, builds a mesh of one CPU slot a rank,
runs the simulator and the DE explorer over it, and writes what it saw to
<outdir>/rank<rank>.json.  Imports nothing of jax or the JAX package.
"""

import json
import os
import sys

sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["lut_ldpc_tpu"] = None

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mesh_setup import ens36, sim_config, small_codec  # noqa: E402


def main():
    rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from lut_ldpc_torch.design import DELutGPU
    from lut_ldpc_torch.parallel import dp_mesh
    from lut_ldpc_torch.sim import BERSim

    mesh = dp_mesh(devices=["cpu"])
    assert len(mesh) == world and mesh.local == (rank,)
    codec = small_codec()
    res = BERSim(sim_config(), codec.graph, codec=codec, mesh=mesh).run(seed=0, verbose=False)
    ach, Pe = DELutGPU(ens36(), maxiter_de=30, max_ni_de_iters=30,
                       mesh=mesh).evolve_batch([0.8, 0.85, 0.9])
    out = {name: getattr(res, name).tolist() for name in
           ("frames", "frame_errors", "data_bit_errors", "uncoded_bit_errors",
            "decode_iters")}
    out.update(ach=ach.tolist(), Pe=Pe.tolist())
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    assert not [m for m in sys.modules if m.startswith("lut_ldpc_tpu.")]
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
