"""The workload's side of the cooperative migration contract
(``pkg/migration.py``): a trainer that moves warm with its claim.

Every prepared container carries the contract in its CDI env
(``kubeletplugin/cdi.py``): ``TPU_DRA_MIGRATION_INTENT_ANNOTATION`` names
the claim annotation the migration controller stamps when it has
reserved a destination, ``TPU_DRA_MIGRATION_ACK_ANNOTATION`` the one the
workload writes back once its state is durable. This trainer reads its
claim after every step; on an intent it saves its state with
``TrainCheckpointer`` as the step it reached, writes the ack (``step-N``)
and stops. Started again under the claim's new allocation, it restores
the newest checkpoint and trains on, so its losses are those of an
uninterrupted run. A save that fails acks ``failed``, the controller's
cue for the cold fallback. No gang: one process, one device.

The annotation names come from the env alone (the controller's names
when it lacks them), so a workload needs nothing of the controller.
"""

from __future__ import annotations

import os
import time

import torch

from ..models import llama
from .checkpoint import TrainCheckpointer
from .main import synthetic_batch
from .train import TrainState, make_optimizer, train_step, tree_leaves

RESOURCE = ("resource.k8s.io", "v1")
INTENT_ENV = "TPU_DRA_MIGRATION_INTENT_ANNOTATION"
ACK_ENV = "TPU_DRA_MIGRATION_ACK_ANNOTATION"
# The controller's names (``pkg/migration.py``) and its failed-save ack.
INTENT_DEFAULT = "resource.tpu.dra/migration-intent"
ACK_DEFAULT = "resource.tpu.dra/migration-ack"
ACK_FAILED = "failed"


class ClaimWatch:
    """The claim's two contract annotations, named by the CDI env (the
    controller's names when the env lacks them)."""

    def __init__(self, kube, namespace: str, name: str, env=os.environ):
        self.kube, self.namespace, self.name = kube, namespace, name
        self.intent_key = env.get(INTENT_ENV) or INTENT_DEFAULT
        self.ack_key = env.get(ACK_ENV) or ACK_DEFAULT

    def intent(self) -> str | None:
        claim = self.kube.get(*RESOURCE, "resourceclaims", self.name,
                              namespace=self.namespace)
        return (claim.get("metadata", {}).get("annotations") or {}).get(
            self.intent_key)

    def ack(self, value: str) -> None:
        self.kube.patch(*RESOURCE, "resourceclaims", self.name,
                        {"metadata": {"annotations": {self.ack_key: value}}},
                        namespace=self.namespace)


def run(cfg: llama.LlamaConfig, steps: int, checkpoint_dir: str, *,
        device, seed: int = 0, batch_size: int = 1, seq_len: int = 128,
        watch: ClaimWatch | None = None, on_step=None) -> dict:
    """Train ``cfg`` to step ``steps`` from the newest checkpoint under
    ``checkpoint_dir`` (or from ``seed``'s init), on the launcher's
    synthetic batches. After each step ``on_step(step, loss)`` runs, then
    ``watch`` is read; an intent saves the state, acks and stops.
    Returns the losses by step and how the run ended."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = llama.init(cfg, gen, device)
    optimizer = make_optimizer()
    state = TrainState(params, optimizer.init(params), 0)
    ckpt = TrainCheckpointer(checkpoint_dir, max_to_keep=1)
    out: dict = {"losses": {}, "restored_from": None,
                 "params": sum(t.numel() for t in tree_leaves(params))}
    if ckpt.latest_step() is not None:
        t0 = time.perf_counter()
        state = ckpt.restore(state)
        out.update(restored_from=state.step,
                   restore_s=time.perf_counter() - t0,
                   restored_at=time.time())
    while state.step < steps:
        tokens = torch.from_numpy(synthetic_batch(
            state.step, batch_size, seq_len, cfg.vocab_size)).to(device)
        state, loss = train_step(state, tokens, cfg=cfg,
                                 optimizer=optimizer)
        out["losses"][state.step] = loss.item()
        if on_step is not None:
            on_step(state.step, out["losses"][state.step])
        intent = watch.intent() if watch is not None else None
        if intent is None:
            continue
        t0 = time.perf_counter()
        try:
            ckpt.save(state.step, state)
        except Exception:
            watch.ack(ACK_FAILED)
            raise
        save_s = time.perf_counter() - t0
        watch.ack(f"step-{state.step}")
        out.update(acked=state.step, intent=intent, save_s=save_s,
                   checkpoint_bytes=ckpt.nbytes(state.step))
        return out
    out["done"] = state.step
    return out

