"""Gang verification workload: prove that the injected env runs a real job.

    python -m k8s_dra_driver_gpu_tpu_torch.train.verify --require-gang \\
        [--steps 1] [--device cpu --local-devices N]

The port of ``k8s_dra_driver_gpu_tpu/train/verify.py``. Like the
launcher (``train/main.py``), it is started once per node and joins the
gang only from the ComputeDomain channel env (TPU_COORDINATOR_ADDRESS /
TPU_PROCESS_ID / TPU_NUM_PROCESSES) through ``initialize_distributed``,
with a rank per local card (``--local-devices N`` ranks with ``--device
cpu``; a node without the env and with several local ranks meets alone
at a local port, as the launcher's does, and so reports a gang). It runs
cross-rank all-reduces and real sharded train steps over the global mesh,
and local rank 0 of each node prints ONE JSON line, for a harness (or an
operator) to compare across pods:

  - ``devSum``: an all-reduce of 1 a rank == the global rank count:
    every card took part;
  - ``rankSum``: an all-reduce of (process id + 1) a rank: data from
    EVERY node crossed the collective (a gang that silently degraded to
    one node gets it wrong);
  - ``loss``: after ``--steps`` sharded train steps of the tiny model, in
    full: equal on every node iff the gang ran one global computation.

The mesh is ``parallel.mesh.plan_for``'s over the gang, as the
reference's is (at 4 ranks tp=4, which splits the tiny model's 2 kv
heads; ``models.llama.attention_block`` gathers them whole). With
TPU_NUM_SLICES > 1 it leads with a "dcn" axis over the slices
(``parallel.mesh.build_multislice_mesh``) and the batch shards over
("dcn", "dp", "fsdp"), the multislice recipe. ``--require-gang`` exits 2
when there is no channel env.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .main import (LOCAL_RANK_VAR, _run_local_ranks, join_gang, node_ranks,
                   synthetic_batch, validate_gang_env)

ENV_KEYS = ("TPU_COORDINATOR_ADDRESS", "TPU_PROCESS_ID", "TPU_NUM_PROCESSES",
            "TPU_WORKER_HOSTNAMES", "TPU_DOMAIN_CHANNELS",
            "COMPUTE_DOMAIN_UUID", "MEGASCALE_COORDINATOR_ADDRESS",
            "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID")


def run(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="torch-train-verify")
    p.add_argument("--local-devices", type=int, default=None,
                   help="local ranks of this node with --device cpu "
                        "(default 1); on the card, one per visible card")
    p.add_argument("--steps", type=int, default=1,
                   help="sharded train steps to run after the all-reduce "
                        "proof")
    p.add_argument("--batch-per-process", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=16)
    p.add_argument("--require-gang", action="store_true",
                   help="fail unless the ComputeDomain channel env is "
                        "present (the e2e contract check)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1 (the train-step proof is the point)")
    if args.local_devices is not None and args.local_devices < 1:
        p.error("--local-devices must be >= 1")

    device, local_ranks = node_ranks(p, args.device, args.local_devices)
    if args.batch_per_process % local_ranks:
        p.error(f"--batch-per-process {args.batch_per_process} rows do not "
                f"split over {local_ranks} local ranks")
    if args.require_gang and validate_gang_env() is None:
        print("verify: no ComputeDomain channel env "
              "(TPU_COORDINATOR_ADDRESS unset) but --require-gang",
              file=sys.stderr)
        return 2
    if local_ranks > 1 and LOCAL_RANK_VAR not in os.environ:
        return _run_local_ranks(argv, local_ranks,
                                module="k8s_dra_driver_gpu_tpu_torch.train."
                                       "verify")
    local_rank = int(os.environ.get(LOCAL_RANK_VAR, "0"))

    import torch.distributed as dist

    joined = join_gang(device, local_rank, local_ranks)
    try:
        return _verify(args, device, local_rank, local_ranks, joined)
    finally:
        dist.destroy_process_group()


def _verify(args, device: torch.device, local_rank: int, local_ranks: int,
            joined: bool) -> int:
    import torch.distributed as dist

    from ..models import llama
    from ..parallel.mesh import (build_mesh, build_multislice_mesh,
                                 plan_for)
    from .train import make_sharded_train

    world, rank = dist.get_world_size(), dist.get_rank()
    nodes, pid = world // local_ranks, rank // local_ranks
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = llama.LlamaConfig.tiny()
    num_slices = int(os.environ.get("TPU_NUM_SLICES", "1"))
    if num_slices > 1:
        if world % num_slices:
            raise SystemExit(f"TPU_NUM_SLICES={num_slices} does not divide "
                             f"{world} global devices")
        mesh = build_multislice_mesh(num_slices,
                                     plan_for(world // num_slices))
        batch_axes = ("dcn", "dp", "fsdp")
    else:
        mesh = build_mesh(plan_for(world))
        batch_axes = None

    # The collective proof: every rank and every node contributed.
    dev_sum = torch.ones((), dtype=torch.float32, device=device)
    rank_sum = torch.full((), pid + 1.0, dtype=torch.float32, device=device)
    dist.all_reduce(dev_sum)
    dist.all_reduce(rank_sum)

    # Real sharded training over the gang's mesh: the node's synthetic
    # rows of each step, split over its local ranks.
    init_fn, step_fn, layout, _ = make_sharded_train(mesh, cfg,
                                                     batch_axes=batch_axes)
    state = init_fn(llama.init(cfg, torch.Generator(device=device)
                               .manual_seed(0), device))
    rows = args.batch_per_process // local_ranks
    for step in range(args.steps):
        node_rows = synthetic_batch(step, args.batch_per_process,
                                    args.seq_len, cfg.vocab_size, pid)
        state, loss = step_fn(state, layout(
            node_rows[local_rank * rows:(local_rank + 1) * rows]))
    loss = loss.item()
    if local_rank == 0:
        print(json.dumps({
            "processId": pid,
            "numProcesses": nodes,
            "globalDevices": world,
            "localDevices": local_ranks,
            "devSum": dev_sum.item(),
            "rankSum": rank_sum.item(),
            "steps": state.step,
            # In full: the nodes must agree bitwise.
            "loss": repr(loss),
            "gang": joined,
            "numSlices": num_slices,
            "sliceId": int(os.environ.get("TPU_SLICE_ID", "0")),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "env": {key: os.environ.get(key, "") for key in ENV_KEYS},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
