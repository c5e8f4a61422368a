"""Single-process training launcher of the port.

    python -m k8s_dra_driver_gpu_tpu_torch.train.main --model flagship \\
        --seq-len 4096 --batch-size 4 [--steps 10] [--device cuda]

The port of ``k8s_dra_driver_gpu_tpu/train/main.py::run`` for one device:
fp32 master weights from a seeded init, the model's compute dtype, the
optimizer of ``train.make_optimizer`` (the flagship recipe defaults to a
bf16 first moment), and JAX's synthetic next-token batches, drawn from
``np.random.RandomState(step * 65521 + 0)``. Logs "step N loss X (T
tok/s)" every 10 steps and at the last, throughput counted from the end
of the first (warm-up) step. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

logger = logging.getLogger("k8s_dra_driver_gpu_tpu_torch.train")


def synthetic_batch(step: int, batch_size: int, seq_len: int,
                    vocab_size: int) -> np.ndarray:
    """Step ``step``'s tokens [batch_size, seq_len + 1], int32: the JAX
    launcher's draw for the same step on shard 0, a single process."""
    rng = np.random.RandomState(step * 65521 + 0)
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
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
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
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from ..models import llama
    from ..ops import resolve_device
    from .train import TrainState, make_optimizer, train_step

    device = resolve_device(args.device)
    cfg = {"tiny": llama.LlamaConfig.tiny,
           "flagship": llama.LlamaConfig.flagship,
           "llama3-8b": llama.LlamaConfig.llama3_8b}[args.model]()
    mu = args.mu_dtype or ("bf16" if args.model == "flagship" else "f32")
    optimizer = make_optimizer(
        mu_dtype=torch.bfloat16 if mu == "bf16" else None)
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init(cfg, gen, device, dtype=torch.float32)
    state = TrainState(params, optimizer.init(params), 0)
    logger.info("device %s, model %s, mu %s, batch %d x %d", device,
                args.model, mu, args.batch_size, args.seq_len)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tokens_per_step = args.batch_size * args.seq_len
    t0, first_timed = time.perf_counter(), None
    while state.step < args.steps:
        prev = state.step
        batch = torch.from_numpy(synthetic_batch(
            state.step, args.batch_size, args.seq_len, cfg.vocab_size))
        state, loss = train_step(state, batch.to(device), cfg=cfg,
                                 optimizer=optimizer)
        if first_timed is None:
            sync()  # the first step warms caches and builds kernels
            t0, first_timed = time.perf_counter(), state.step
        if prev // 10 != state.step // 10 or state.step == args.steps:
            value = loss.item()
            dt = time.perf_counter() - t0
            done = state.step - first_timed
            tps = tokens_per_step * done / dt if dt > 0 and done > 0 else 0.0
            logger.info("step %d loss %.4f (%.0f tok/s)", state.step, value,
                        tps)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(run())
