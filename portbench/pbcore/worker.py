"""One process of a cell that runs across processes, one card each.

    python3 portbench/pbcore/worker.py RUNDIR RANK PORT

``RUNDIR/spec.json`` says what to run.  The process joins the others with
``init_distributed`` on ``localhost:PORT``, runs the fit loop over
``auto_mesh()`` (every process the same seeded fits; process 0 decides when
the window closes and the others follow it), and writes its record to
``RUNDIR/rank<RANK>.pkl``.
"""

import json
import os
import pickle
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]

KEEP = ("records", "window_s", "opened", "peak", "trace", "rates", "attempted", "failed",
        "forbidden")


def main(rundir, rank, port):
    import torch
    import torch.distributed as dist

    from mogp_tpu_torch.parallel import auto_mesh, init_distributed
    from pbcore import cells, data, faults, fitloop, guard

    with open(os.path.join(rundir, "spec.json")) as f:
        spec = json.load(f)
    if spec.get("fault"):
        faults.FAULTS[spec["fault"]]()
    n = spec["processes"]
    init_distributed("localhost:{}".format(port), n, rank)
    if spec["device"] == "cuda":
        mesh, device = auto_mesh(), torch.device("cuda", torch.cuda.current_device())
    else:
        mesh, device = auto_mesh(n, device="cpu"), torch.device("cpu")
    cell = cells.load(spec["workload"], spec.get("overrides"))

    def agree(go_on):
        flag = torch.tensor([int(go_on)])
        dist.broadcast(flag, 0)
        return bool(flag.item())

    out = fitloop.run(cell, data.Seeds(spec["seed"]), spec["seconds"], spec["trace"], device,
                      mesh=mesh, agree=agree, barrier=dist.barrier)
    out["forbidden"] = guard.forbidden_modules()
    with open(os.path.join(rundir, "rank{}.pkl".format(rank)), "wb") as f:
        pickle.dump({k: out[k] for k in KEEP}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
