"""Training launcher of the port: consumes the env contract the DRA
driver injects.

    python -m k8s_dra_driver_gpu_tpu_torch.train.main --model flagship \\
        --seq-len 4096 --batch-size 4 [--steps 10] [--tp N] \\
        [--steps-per-call K] [--device cuda] [--local-devices N]

The port of ``k8s_dra_driver_gpu_tpu/train/main.py::run``: the dense
families and ``--model moe-tiny``. It is started once per node, as the
reference's process is: a pod whose claim carries a ComputeDomain
channel gets

  TPU_COORDINATOR_ADDRESS / TPU_PROCESS_ID / TPU_NUM_PROCESSES
      -> one process per node (the plugin counts nodes); absent = a gang
         of this node alone;
  TPU_INIT_TIMEOUT_S -> the rendezvous timeout (default 300 s).

The reference's process drives every local chip; here the launcher
starts one worker per local card (``--local-devices N`` with ``--device
cpu``), re-running itself with a private local-rank variable. With L
local ranks, worker l of node p is global rank p * L + l of a world of
TPU_NUM_PROCESSES * L, on card l, in one ``torch.distributed`` gang over
TCP at the coordinator (NCCL; gloo with ``--device cpu``), whose store
global rank 0 hosts. A worker that fails makes the launcher stop its
other workers and exit non-zero.

Every run of a dense family, a gang of one included, builds a (dp,
fsdp, sp, tp) mesh over the gang (``parallel.mesh.plan_for``, ``--tp``
honoured) and trains through ``train.make_sharded_train``
(``make_scanned_sharded_train`` with ``--steps-per-call`` > 1).
``--model moe-tiny`` trains the tiny MoE-Llama through
``models.llama_moe.make_moe_train`` on a (dp, ep) mesh sized as the
reference sizes it (``moe_mesh_shape``); ``--tp``, ``--steps-per-call``
> 1 and ``--mu-dtype`` are refused with it, and so is a ``--batch-size``
that dp does not divide. Every family trains from fp32 master weights
from a seeded init, in the model's compute dtype, on JAX's synthetic
next-token batches: each node
draws its ``--batch-size`` rows from ``np.random.RandomState(step * 65521
+ process_id)`` and local rank l takes rows [l b / L, (l + 1) b / L), the
order in which ``make_array_from_process_local_data`` lays a process's
rows over its devices, so the global batch is ``--batch-size`` times the
node count in the reference's row order. Global rank 0 logs "step N loss
X (T tok/s)" every 10 steps and at the last, throughput (global tokens)
counted from the end of the first (warm-up) call. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("k8s_dra_driver_gpu_tpu_torch.train")

# Set by the launcher on the workers it starts: the worker's local rank.
LOCAL_RANK_VAR = "TORCH_TRAIN_LOCAL_RANK"


class GangEnvError(ValueError):
    """The injected ComputeDomain gang env is inconsistent.

    Raised BEFORE touching torch.distributed: every one of these
    misconfigurations would otherwise surface as a hang (a gang member
    waiting for peers that never come) or a silently wrong mesh.
    """


def validate_gang_env(env=os.environ) -> dict | None:
    """Check the injected env contract; None when not in a gang.

    Returns {"coordinator", "process_id", "num_processes"} when the
    pod carries a ComputeDomain channel. The contract (injected by the
    CD plugin):
      - TPU_COORDINATOR_ADDRESS implies TPU_PROCESS_ID and
        TPU_NUM_PROCESSES (a partial contract means a broken prepare,
        not a single-process run -- fail loudly, don't guess),
      - TPU_WORKER_HOSTNAMES, when present, is positional by process
        id, so its length must equal TPU_NUM_PROCESSES,
      - 0 <= process_id < num_processes.
    """
    coordinator = env.get("TPU_COORDINATOR_ADDRESS", "")
    if not coordinator:
        return None
    missing = [k for k in ("TPU_PROCESS_ID", "TPU_NUM_PROCESSES")
               if not env.get(k)]
    if missing:
        raise GangEnvError(
            f"TPU_COORDINATOR_ADDRESS is set but {', '.join(missing)} "
            "missing: the ComputeDomain channel env is partial (broken "
            "prepare?); refusing to guess single-process defaults")
    try:
        process_id = int(env["TPU_PROCESS_ID"])
        num_processes = int(env["TPU_NUM_PROCESSES"])
    except ValueError as e:
        raise GangEnvError(f"non-integer gang env: {e}") from e
    if not 0 <= process_id < num_processes:
        raise GangEnvError(
            f"TPU_PROCESS_ID={process_id} out of range for "
            f"TPU_NUM_PROCESSES={num_processes}")
    hostnames = env.get("TPU_WORKER_HOSTNAMES", "")
    if hostnames:
        n = len(hostnames.split(","))
        if n != num_processes:
            raise GangEnvError(
                f"TPU_WORKER_HOSTNAMES lists {n} worker(s) but "
                f"TPU_NUM_PROCESSES={num_processes}; the list is "
                "positional by process id and must match exactly")
    # rpartition: the host may be a bracketed IPv6 literal
    # ("[fd00::1]:8476") -- only the LAST colon separates the port.
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise GangEnvError(
            f"TPU_COORDINATOR_ADDRESS={coordinator!r} is not host:port")
    return {
        "coordinator": coordinator,
        "process_id": process_id,
        "num_processes": num_processes,
    }


def initialize_distributed(env=os.environ, device: str = "cuda",
                           local_rank: int = 0, local_ranks: int = 1) -> bool:
    """``torch.distributed`` from the ComputeDomain channel env, if present.

    Returns True when a gang was joined: the default process group over
    TCP at ``TPU_COORDINATOR_ADDRESS`` (an IPv6 literal keeps its
    brackets; global rank 0 hosts the store there), in which this
    process, local rank ``local_rank`` of the node's ``local_ranks``, is
    rank ``TPU_PROCESS_ID * local_ranks + local_rank`` of
    ``TPU_NUM_PROCESSES * local_ranks``: NCCL on card ``local_rank``, or
    gloo for ``device="cpu"``. ``TPU_INIT_TIMEOUT_S`` bounds the
    rendezvous (default 300 s), so an unreachable coordinator is a clear
    error, not an indefinite hang.
    """
    import torch.distributed as dist

    gang = validate_gang_env(env)
    if gang is None:
        return False
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    rank = gang["process_id"] * local_ranks + local_rank
    world = gang["num_processes"] * local_ranks
    timeout = int(env.get("TPU_INIT_TIMEOUT_S", "300"))
    dist.init_process_group(
        backend, init_method="tcp://" + gang["coordinator"],
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    logger.info("joined gang: process %s/%s, local rank %s/%s, rank %s/%s "
                "via %s (%s)", gang["process_id"], gang["num_processes"],
                local_rank, local_ranks, rank, world, gang["coordinator"],
                backend)
    return True


def synthetic_batch(step: int, batch_size: int, seq_len: int,
                    vocab_size: int, process_id: int = 0) -> np.ndarray:
    """Step ``step``'s tokens [batch_size, seq_len + 1], int32, of shard
    ``process_id``: the JAX launcher's draw for the same step and shard."""
    rng = np.random.RandomState(step * 65521 + process_id)
    return rng.randint(0, vocab_size,
                       (batch_size, seq_len + 1)).astype(np.int32)


def moe_mesh_shape(world: int, n_experts: int) -> tuple[int, int]:
    """(dp, ep) of the MoE trainer over ``world`` ranks, as the reference
    sizes it: ep takes as many ranks as divide both the rank count and
    the expert count, dp the rest."""
    ep = min(world, n_experts)
    while ep > 1 and (world % ep or n_experts % ep):
        ep -= 1
    return world // ep, ep


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torch-train")
    p.add_argument("--model", choices=["tiny", "flagship", "llama3-8b",
                                       "moe-tiny"], default="tiny")
    p.add_argument("--mu-dtype", choices=["f32", "bf16"], default=None,
                   help="Adam first-moment dtype; bf16 frees 2 bytes a "
                        "parameter (the flagship default)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8,
                   help="rows per node, split over its local ranks; the "
                        "global batch is this times TPU_NUM_PROCESSES")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel size (default: planned)")
    p.add_argument("--steps-per-call", type=int,
                   default=int(os.environ.get("STEPS_PER_CALL", "1")),
                   help="optimizer steps per call (see "
                        "train.scanned_train_step) [STEPS_PER_CALL]")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    p.add_argument("--local-devices", type=int, default=None,
                   help="local ranks of this node with --device cpu "
                        "(default 1); on the card, one per visible card")
    return p


def run(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = _parser()
    args = p.parse_args(argv)
    if args.model == "flagship" and args.seq_len % 128:
        p.error("--seq-len must be a multiple of 128 for the flagship "
                "config (its chunked loss walks 128-position chunks)")
    if args.steps < 1:
        p.error("--steps must be >= 1")
    if args.steps_per_call < 1:
        p.error("--steps-per-call must be >= 1")
    if args.local_devices is not None and args.local_devices < 1:
        p.error("--local-devices must be >= 1")
    if args.model == "moe-tiny":
        if args.mu_dtype:
            p.error("--mu-dtype applies to the dense families only "
                    "(the MoE trainer builds its own optimizer)")
        if args.tp and args.tp != 1:
            p.error("--tp applies to the dense families only; "
                    "--model moe-tiny uses a (dp, ep) mesh")
        if args.steps_per_call > 1:
            p.error("--steps-per-call applies to the dense families "
                    "only (the MoE trainer is manual-SPMD)")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from ..ops import resolve_device

    device = resolve_device(args.device)
    if device.type == "cpu":
        local_ranks = args.local_devices or 1
    elif args.local_devices is not None:
        p.error("--local-devices is for --device cpu: on the card the "
                "launcher runs a rank per visible card")
    else:
        local_ranks = torch.cuda.device_count()
    if args.batch_size % local_ranks:
        p.error(f"--batch-size {args.batch_size} rows a node do not split "
                f"over its {local_ranks} local ranks")
    gang = validate_gang_env()  # a broken contract fails here, first
    if args.model == "moe-tiny":
        from ..models.llama_moe import LlamaMoEConfig

        world = (gang["num_processes"] if gang else 1) * local_ranks
        dp, ep = moe_mesh_shape(world, LlamaMoEConfig.tiny().n_experts)
        if args.batch_size % dp:
            p.error(f"--batch-size {args.batch_size} must be divisible "
                    f"by dp={dp} ({world} devices / ep={ep})")
    if local_ranks > 1 and LOCAL_RANK_VAR not in os.environ:
        return _run_local_ranks(argv, local_ranks)
    local_rank = int(os.environ.get(LOCAL_RANK_VAR, "0"))

    import torch.distributed as dist

    if not initialize_distributed(device=str(device), local_rank=local_rank,
                                  local_ranks=local_ranks):
        # A gang of one: the same sharded path over a one-rank group.
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                                store=dist.HashStore(), rank=0, world_size=1)
    try:
        return _train(args, device, local_rank, local_ranks)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_local_ranks(argv: list[str], local_ranks: int) -> int:
    """Start this launcher once per local rank, each with
    ``LOCAL_RANK_VAR`` set, and wait for them. Without a gang env the node
    is a gang alone, meeting at a free local port. When a worker fails the
    others are stopped (a collective would wait for it forever) and its
    exit code is returned."""
    env = dict(os.environ)
    if validate_gang_env(env) is None:
        env.update(TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
                   TPU_PROCESS_ID="0", TPU_NUM_PROCESSES="1")
    workers = [subprocess.Popen(
        [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.main",
         *argv], env={**env, LOCAL_RANK_VAR: str(rank)})
        for rank in range(local_ranks)]
    try:
        while True:
            codes = [w.poll() for w in workers]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                logger.error("a local rank exited with %s; stopping the "
                             "others", failed[0])
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()


def _train(args, device: torch.device, local_rank: int,
           local_ranks: int) -> int:
    import torch.distributed as dist

    from ..models import llama, llama_moe
    from ..parallel.mesh import build_expert_mesh, build_mesh, plan_for
    from .train import (make_optimizer, make_scanned_sharded_train,
                        make_sharded_train)

    world, rank = dist.get_world_size(), dist.get_rank()
    node = rank // local_ranks  # TPU_PROCESS_ID
    rows = args.batch_size // local_ranks
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(0)
    scan_fn = scan_layout = None
    if args.model == "moe-tiny":
        cfg = llama_moe.LlamaMoEConfig.tiny()
        dp, ep = moe_mesh_shape(world, cfg.n_experts)
        mesh = build_expert_mesh(ep, dp)
        mu = "f32"
        init_fn, step_fn, layout, _ = llama_moe.make_moe_train(mesh, cfg)
        state = init_fn(llama_moe.init(cfg, gen, device))
    else:
        mesh = build_mesh(plan_for(world, tp=args.tp))
        cfg = {"tiny": llama.LlamaConfig.tiny,
               "flagship": llama.LlamaConfig.flagship,
               "llama3-8b": llama.LlamaConfig.llama3_8b}[args.model]()
        mu = args.mu_dtype or ("bf16" if args.model == "flagship"
                               else "f32")
        optimizer = make_optimizer(
            mu_dtype=torch.bfloat16 if mu == "bf16" else None)
        init_fn, step_fn, layout, _ = make_sharded_train(mesh, cfg,
                                                         optimizer)
        if args.steps_per_call > 1:
            _, scan_fn, scan_layout, _ = make_scanned_sharded_train(
                mesh, cfg, optimizer)
        state = init_fn(llama.init(cfg, gen, device, dtype=torch.float32))
    logger.info("device %s, mesh %s, model %s, mu %s, batch %d x %d per "
                "node over %d local rank(s), %d rank(s)", device,
                dict(zip(mesh.mesh_dim_names, mesh.shape)), args.model, mu,
                args.batch_size, args.seq_len, local_ranks, world)

    def local_batch(step: int) -> np.ndarray:
        batch = synthetic_batch(step, args.batch_size, args.seq_len,
                                cfg.vocab_size, node)
        return batch[local_rank * rows:(local_rank + 1) * rows]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tokens_per_step = args.batch_size * (world // local_ranks) * args.seq_len
    t0, first_timed, step = time.perf_counter(), None, 0
    k = args.steps_per_call
    while step < args.steps:
        prev = step
        # K full steps a call while they fit; the tail takes single steps
        # on the same batches in the same order.
        if scan_fn is not None and step + k <= args.steps:
            state, losses = scan_fn(state, scan_layout(np.stack(
                [local_batch(step + i) for i in range(k)])))
            loss = losses[-1]
            step += k
        else:
            state, loss = step_fn(state, layout(local_batch(step)))
            step += 1
        if first_timed is None:
            sync()  # the first call warms caches and builds kernels
            t0, first_timed = time.perf_counter(), step
        if rank == 0 and (prev // 10 != step // 10 or step == args.steps):
            value = loss.item()
            dt = time.perf_counter() - t0
            done = step - first_timed
            tps = tokens_per_step * done / dt if dt > 0 and done > 0 else 0.0
            logger.info("step %d loss %.4f (%.0f tok/s)", step, value, tps)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(run())
