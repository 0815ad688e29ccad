"""The Trainer: checkpoint/restart fault tolerance + hedged data loading.

The port of ``repro.training.train_loop``. Restart contract (tested):
``Trainer(...).run(n)`` after a crash resumes from the latest checkpoint
and — because the data pipeline is a pure function of the step and the
step runs the same operations on the same inputs — produces the
parameters and optimizer state of an uninterrupted run bit for bit. On
the card that holds under ``deterministic()`` (some CUDA backward
kernels sum with atomics in an order that varies run to run); on the CPU
it always holds.

The loop runs eagerly: no ``torch.compile``, no CUDA graph. The model's
parameters are made trainable (``requires_grad_``): the port's init
makes them without gradient, for serving.

Under a ``ShardCtx`` (``ctx=``) every rank of its mesh runs the Trainer:
each draws the one-device model's weights from the same seed, one part
at a time, and keeps its shard (``ShardedModel.init``); each takes its
rows of the same global batch (``sharding.batch_rows``); the step is
``make_train_step(..., ctx=ctx)``. A checkpoint is gathered before it
is written, so it has the one-device layout (the JAX package's
checkpoints store gathered arrays too); rank 0 writes it, and every rank
restores it through ``ckpt.restore(..., shardings=)``, its own shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, HedgedPrefetcher, MarkovSource
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.ctx import ShardCtx
from repro_torch.models import lm
from repro_torch.training.optimizer import Optimizer, make_optimizer
from repro_torch.training.step import make_train_step

# the cuBLAS workspace setting that ``torch.use_deterministic_algorithms``
# asks for on CUDA (also the workspace PyTorch gives an sm_90 card anyway)
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside, restored after:
    the bitwise-resume contract on the card. ``CUBLAS_WORKSPACE_CONFIG``
    must be set before CUDA initialises (``CUBLAS_WORKSPACE``)."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
        raise RuntimeError("set CUBLAS_WORKSPACE_CONFIG=:4096:8 before "
                           "CUDA initialises for deterministic algorithms")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50           # 0: no checkpoints
    keep_last: int = 3
    async_ckpt: bool = True
    hedged_loader_k: int = 1       # >1 => redundant loader workers
    log_every: int = 10
    fail_at_step: int | None = None  # fault-injection hook (tests)


class Trainer:
    """``on_step(step, model, opt_state, metrics)``, where given, is
    called after every step (the step's gradients still in ``p.grad``)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig,
                 tcfg: TrainerConfig, opt: Optimizer | None = None,
                 source=None, log_fn: Callable[[str], None] = print,
                 device="cuda", on_step: Callable | None = None,
                 ctx: ShardCtx | None = None):
        self.cfg = cfg
        self.dcfg = dcfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt = opt or make_optimizer(cfg.optimizer, lr=1e-3)
        self.source = source or MarkovSource(cfg, dcfg)
        self.loader = HedgedPrefetcher(self.source,
                                       k=max(1, tcfg.hedged_loader_k))
        self.log = log_fn
        self.on_step = on_step
        self.ctx = ctx
        self._step_fn = make_train_step(cfg, self.opt, ctx=ctx)
        self._writer = ctx is None or collectives.flat_index(
            collectives.mesh_coords(ctx.mesh),
            collectives.mesh_sizes(ctx.mesh), ctx.mesh.mesh_dim_names) == 0
        self._ckpt = ckpt.AsyncCheckpointer(tcfg.ckpt_dir,
                                            keep_last=tcfg.keep_last) \
            if tcfg.async_ckpt and tcfg.ckpt_every > 0 and self._writer \
            else None
        self.metrics_history: list[dict] = []

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> tuple[lm.LM, dict, int]:
        """(model, optimizer state, 0); under a ctx the model is this
        rank's ``ShardedModel``."""
        if self.ctx is not None:
            model = sharding.ShardedModel.init(self.cfg, self.ctx, seed,
                                               self.device)
            return model, self.opt.init(model.shards, model.groups,
                                        sharded=model), 0
        model = lm.init(torch.Generator(self.device).manual_seed(seed),
                        self.cfg).requires_grad_(True)
        opt_state = self.opt.init(dict(model.named_parameters()),
                                  lm.leaf_groups(model))
        return model, opt_state, 0

    def restore_or_init(self, seed: int = 0) -> tuple[lm.LM, dict, int]:
        last = (ckpt.latest_step(self.tcfg.ckpt_dir)
                if self.tcfg.ckpt_every > 0 else None)
        model, opt_state, _ = self.init_state(seed)
        if last is None:
            return model, opt_state, 0
        if self.ctx is not None:
            state = ckpt.restore(
                self.tcfg.ckpt_dir, last,
                {"params": model.shards, "opt": opt_state},
                shardings={"params": model.shardings(),
                           "opt": sharding.to_shardings(
                               model.opt_specs(opt_state), self.ctx.mesh)})
            model.shards.update(state["params"])
            self.log(f"[trainer] resumed from step {last}")
            return model, state["opt"], last
        params = dict(model.named_parameters())
        state = ckpt.restore(self.tcfg.ckpt_dir, last,
                             {"params": params, "opt": opt_state})
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["params"][name])
        self.log(f"[trainer] resumed from step {last}")
        return model, state["opt"], last

    def _batch(self, step: int) -> dict[str, torch.Tensor]:
        """The step's batch on the device: under a ctx, this rank's rows
        of the global batch."""
        batch = {k: torch.from_numpy(v) for k, v in
                 self.loader.get(step).items()}
        if self.ctx is not None:
            batch = sharding.batch_rows(batch, self.ctx)
        return {k: v.to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def run(self, num_steps: int, seed: int = 0) -> dict:
        model, opt_state, start = self.restore_or_init(seed)
        t0 = time.time()
        for step in range(start, num_steps):
            if self.tcfg.fail_at_step is not None and \
                    step == self.tcfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            model, opt_state, metrics = self._step_fn(
                model, opt_state, self._batch(step), step)
            if step % self.tcfg.log_every == 0 or step == num_steps - 1:
                loss = float(metrics["loss"])
                self.metrics_history.append(
                    {"step": step, "loss": loss,
                     "grad_norm": float(metrics["grad_norm"])})
                self.log(f"[trainer] step {step} loss {loss:.4f} "
                         f"({time.time() - t0:.1f}s)")
            if self.on_step is not None:
                self.on_step(step, model, opt_state, metrics)
            if self.tcfg.ckpt_every > 0 and (
                    (step + 1) % self.tcfg.ckpt_every == 0
                    or step == num_steps - 1):
                self._save(step + 1, model, opt_state)
        if self._ckpt:
            self._ckpt.wait()
        if self.ctx is not None:  # the checkpoint is whole before any reads
            mesh = self.ctx.mesh
            collectives.all_reduce(torch.zeros(1), mesh,
                                   mesh.mesh_dim_names)
        return {"model": model, "opt": opt_state,
                "history": self.metrics_history,
                "loader_duplicate_wins": self.loader.duplicate_wins}

    def _save(self, step: int, model: lm.LM, opt_state: dict) -> None:
        if self.ctx is not None:  # gathered on every rank, written by one
            mesh = self.ctx.mesh
            tree = {"params": model.full_params(),
                    "opt": sharding.gather_tree(
                        opt_state, model.opt_specs(opt_state), mesh)}
            if not self._writer:
                return
        else:
            tree = {"params": dict(model.named_parameters()),
                    "opt": opt_state}
        if self._ckpt:
            self._ckpt.save(step, tree)
        else:
            ckpt.save(self.tcfg.ckpt_dir, step, tree,
                      keep_last=self.tcfg.keep_last)
