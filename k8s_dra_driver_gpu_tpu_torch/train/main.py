"""Training launcher of the port: consumes the env contract the DRA
driver injects.

    python -m k8s_dra_driver_gpu_tpu_torch.train.main --model flagship \\
        --seq-len 4096 --batch-size 4 [--steps 10] [--tp N] \\
        [--steps-per-call K] [--device cuda]

The port of ``k8s_dra_driver_gpu_tpu/train/main.py::run``, dense path. A
pod whose claim carries a ComputeDomain channel gets

  TPU_COORDINATOR_ADDRESS / TPU_PROCESS_ID / TPU_NUM_PROCESSES
      -> ``torch.distributed.init_process_group`` over TCP at the
         coordinator, one process per card (NCCL; gloo with
         ``--device cpu``); absent = a gang of one;
  TPU_INIT_TIMEOUT_S -> the rendezvous timeout (default 300 s).

Every run, a gang of one included, builds a (dp, fsdp, sp, tp) mesh over
the gang (``parallel.mesh.plan_for``, ``--tp`` honoured) and trains
through ``train.make_sharded_train`` (``make_scanned_sharded_train`` with
``--steps-per-call`` > 1): fp32 master weights from a seeded init, the
model's compute dtype, and JAX's synthetic next-token batches, each
process drawing its own shard from ``np.random.RandomState(step * 65521
+ process_id)``, so the global batch is ``--batch-size`` times the
process count. Logs "step N loss X (T tok/s)" every 10 steps and at the
last, throughput (global tokens) counted from the end of the first
(warm-up) call. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger("k8s_dra_driver_gpu_tpu_torch.train")


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


def initialize_distributed(env=os.environ, device: str = "cuda") -> bool:
    """``torch.distributed`` from the ComputeDomain channel env, if present.

    Returns True when a gang was joined: the default process group over
    TCP at ``TPU_COORDINATOR_ADDRESS`` (an IPv6 literal keeps its
    brackets), rank ``TPU_PROCESS_ID`` of ``TPU_NUM_PROCESSES``, NCCL on
    the cards (each process on card ``process_id % cards``) or gloo for
    ``device="cpu"``. ``TPU_INIT_TIMEOUT_S`` bounds the rendezvous
    (default 300 s), so an unreachable coordinator is a clear error,
    not an indefinite hang.
    """
    import torch.distributed as dist

    gang = validate_gang_env(env)
    if gang is None:
        return False
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(gang["process_id"] % torch.cuda.device_count())
    timeout = int(env.get("TPU_INIT_TIMEOUT_S", "300"))
    dist.init_process_group(
        backend, init_method="tcp://" + gang["coordinator"],
        rank=gang["process_id"], world_size=gang["num_processes"],
        timeout=datetime.timedelta(seconds=timeout))
    logger.info("joined gang: process %s/%s via %s (%s)", gang["process_id"],
                gang["num_processes"], gang["coordinator"], backend)
    return True


def synthetic_batch(step: int, batch_size: int, seq_len: int,
                    vocab_size: int, process_id: int = 0) -> np.ndarray:
    """Step ``step``'s tokens [batch_size, seq_len + 1], int32, of shard
    ``process_id``: the JAX launcher's draw for the same step and shard."""
    rng = np.random.RandomState(step * 65521 + process_id)
    return rng.randint(0, vocab_size,
                       (batch_size, seq_len + 1)).astype(np.int32)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torch-train")
    p.add_argument("--model", choices=["tiny", "flagship", "llama3-8b"],
                   default="tiny")
    p.add_argument("--mu-dtype", choices=["f32", "bf16"], default=None,
                   help="Adam first-moment dtype; bf16 frees 2 bytes a "
                        "parameter (the flagship default)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8,
                   help="rows per process; the global batch is this "
                        "times TPU_NUM_PROCESSES")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel size (default: planned)")
    p.add_argument("--steps-per-call", type=int,
                   default=int(os.environ.get("STEPS_PER_CALL", "1")),
                   help="optimizer steps per call (see "
                        "train.scanned_train_step) [STEPS_PER_CALL]")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p


def run(argv: list[str] | None = None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    if args.model == "flagship" and args.seq_len % 128:
        p.error("--seq-len must be a multiple of 128 for the flagship "
                "config (its chunked loss walks 128-position chunks)")
    if args.steps < 1:
        p.error("--steps must be >= 1")
    if args.steps_per_call < 1:
        p.error("--steps-per-call must be >= 1")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    import torch.distributed as dist

    from ..ops import resolve_device

    device = resolve_device(args.device)
    if not initialize_distributed(device=str(device)):
        # A gang of one: the same sharded path over a one-rank group.
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                                store=dist.HashStore(), rank=0, world_size=1)
    try:
        return _train(args, device)
    finally:
        dist.destroy_process_group()


def _train(args, device: torch.device) -> int:
    import torch.distributed as dist

    from ..models import llama
    from ..parallel.mesh import build_mesh, plan_for
    from .train import (make_optimizer, make_scanned_sharded_train,
                        make_sharded_train)

    num_shards, shard_id = dist.get_world_size(), dist.get_rank()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = build_mesh(plan_for(num_shards, tp=args.tp))
    cfg = {"tiny": llama.LlamaConfig.tiny,
           "flagship": llama.LlamaConfig.flagship,
           "llama3-8b": llama.LlamaConfig.llama3_8b}[args.model]()
    mu = args.mu_dtype or ("bf16" if args.model == "flagship" else "f32")
    optimizer = make_optimizer(
        mu_dtype=torch.bfloat16 if mu == "bf16" else None)
    init_fn, step_fn, layout, _ = make_sharded_train(mesh, cfg, optimizer)
    scan_fn = scan_layout = None
    if args.steps_per_call > 1:
        _, scan_fn, scan_layout, _ = make_scanned_sharded_train(
            mesh, cfg, optimizer)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_fn(llama.init(cfg, gen, device, dtype=torch.float32))
    logger.info("device %s, mesh %s, model %s, mu %s, batch %d x %d per "
                "process, %d processes", device,
                dict(zip(mesh.mesh_dim_names, mesh.shape)), args.model, mu,
                args.batch_size, args.seq_len, num_shards)

    def local_batch(step: int) -> np.ndarray:
        return synthetic_batch(step, args.batch_size, args.seq_len,
                               cfg.vocab_size, shard_id)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tokens_per_step = args.batch_size * num_shards * args.seq_len
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
        if prev // 10 != step // 10 or step == args.steps:
            value = loss.item()
            dt = time.perf_counter() - t0
            done = step - first_timed
            tps = tokens_per_step * done / dt if dt > 0 and done > 0 else 0.0
            logger.info("step %d loss %.4f (%.0f tok/s)", step, value, tps)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(run())
