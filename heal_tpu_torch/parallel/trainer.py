"""Training runtime (torch): one train step and one eval step.

Counterpart of heal_tpu/parallel/trainer.py, on one device or on a
(data, agent, model) device mesh (``mesh``; parallel/sharding.py):
  * train step: forward in train mode (batch-statistics BN, running
    buffers updated) -> loss (+ ``single_weight`` * the "_single" loss of
    the per-agent labels) -> backward -> optimizer step at the scheduled
    learning rate;
  * bf16 compute policy (JAX trainer.py:93-103,128-168): f32 MASTER
    parameters in the optimizer; a bf16 copy of them runs the forward and
    backward (``torch.func.functional_call``), so the gradients
    accumulate back into the f32 parameters through the cast; the batch
    is not cast (points stay f32); outputs are cast to f32 before the
    loss; BN buffers stay f32;
  * frozen modules (``fix_modules``, HEAL stage 2; parallel/freezing.py):
    no gradient and no optimizer slot for their parameters, and eval mode
    in the train step, so their weights and running statistics keep the
    loaded values bit for bit;
  * random streams (JAX trainer.py:86-92,119-126,171-172): each train
    step opens a ``comm`` and a ``dropout`` torch.Generator on the
    model's device, seeded by (``rng_seed``, step) alone
    (:func:`step_streams`), so a step draws the same whatever ran before
    it; Where2comm's threshold sampling and the fusion transformers'
    dropout draw from them (models/layers.rng_streams). ``rng_seed=None``
    opens none, as JAX's step without rngs;
  * device mesh: one process per device. The model was placed by
    ``sharding.shard_state`` before its optimizer was built; each rank
    steps on its ``shard_batch(global batch, mesh, axes=("data",))``.
    After ``backward`` (and the zero fill below, so every rank reduces
    the same list in the same order) the gradients are all-reduced in
    buckets to the global batch's (``Mesh.reduce_gradients``, an explicit
    reduce: the bf16 policy's ``functional_call`` bypasses a
    ``DistributedDataParallel`` wrapper's forward, so its reducer would
    never run), then the optimizer steps; the scalar aux terms are
    averaged over the world. Batch-norm moments, the losses' batch-wide
    normalisers and the dropout masks are the global batch's
    (sharding.py), so a step computes the loss and gradients one process
    computes on the same global batch.
Steps return their aux dict as device scalars and never synchronise
(under a mesh the collectives are queued on the device like the rest).
The tracer's spans (heal_tpu_torch/trace.py): ``train.step`` opens a
request around each step; inside it ``train.forward`` (forward and
loss), ``train.backward`` and ``train.optimizer`` (the zero gradients'
fill, the learning rate and the optimizer's step).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .. import trace
from ..models.layers import rng_streams
from .freezing import freeze, frozen_eval
from .sharding import sharded_parameters

STREAMS = ("comm", "dropout")


def step_streams(seed: int, step: int, device) -> dict:
    """The named generators of train step ``step``: each seeded from
    (seed, step, its index in STREAMS) through numpy's SeedSequence."""
    device = torch.device(device)
    out = {}
    for k, name in enumerate(STREAMS):
        state = np.random.SeedSequence((seed, step, k)).generate_state(2)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(state[0]) << 32 | int(state[1]))
        out[name] = gen
    return out


def _label_targets(batch: dict) -> dict:
    """The label arrays the losses read (JAX trainer.py
    ``_label_targets``): the anchor labels; the anchor-free ones
    (CenterPoint) and the two-stage ones (fpvrcnn_loss: the per-agent
    stage-1 labels and the ego-frame ground truth) when the batch has
    them; each camera type's depth bins."""
    out = {k: batch[k] for k in ("pos_equal_one", "neg_equal_one", "targets")}
    for key in ("heatmap", "box_targets", "reg_mask",
                "pos_equal_one_single", "neg_equal_one_single",
                "targets_single", "gt_boxes", "gt_mask"):
        if key in batch:
            out[key] = batch[key]
    for key, value in batch.items():
        if key.startswith("inputs_") and isinstance(value, dict):
            if "depth_bins" in value:
                out[f"depth_bins_{key[len('inputs_'):]}"] = value["depth_bins"]
    return out


def _single_targets(batch: dict) -> dict:
    """(B, L, ...) single-agent labels -> flat (B*L, ...)."""
    out = {}
    for key in ("pos_equal_one", "neg_equal_one", "targets"):
        v = batch[f"{key}_single"]
        out[key] = v.reshape((-1,) + tuple(v.shape[2:]))
    return out


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_f32(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return tree.float()
    return tree


def _map_arrays(batch: dict, fn) -> dict:
    """``fn`` over the numpy arrays and tensors of a nested batch, once per
    object: collate aliases identical arrays (``points`` and
    ``inputs_m1/points``), so each buffer is converted once."""
    memo: dict = {}

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        if id(x) not in memo:
            memo[id(x)] = (x, fn(x))  # keep x alive: its id stays unique
        return memo[id(x)][1]

    return conv(batch)


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def pin(batch: dict, device) -> dict:
    """numpy batch -> CPU tensors, page-locked when ``device`` is a CUDA
    device (the host half of :func:`to_device`, which the input pipeline
    runs in its worker thread, data/prefetch.py)."""
    cuda = torch.device(device).type == "cuda"
    return _map_arrays(batch, lambda x: (_host_tensor(x).pin_memory() if cuda
                                         else _host_tensor(x)))


def to_device(batch: dict, device) -> dict:
    """numpy (or :func:`pin`\\ ned) batch -> tensors on ``device`` (the
    host->device boundary). Each buffer crosses once; CUDA copies go from
    pinned memory without blocking the host, on the current stream, so the
    steps queued after them see the data."""
    device = torch.device(device)

    def conv(x):
        t = _host_tensor(x)
        if device.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(device, non_blocking=True)
        return t.to(device)

    return _map_arrays(batch, conv)


@dataclasses.dataclass
class Trainer:
    model: torch.nn.Module
    criterion: Callable
    optimizer: torch.optim.Optimizer
    # learning rate of update k (parallel/schedulers.build_lr_schedule)
    schedule: Callable[[int], float]
    supervise_single: bool = False
    single_weight: float = 1.0
    bf16: bool = False
    step: int = 0  # updates taken (the schedule's count)
    # top-level modules kept at their loaded values (the model's own
    # ``fix_modules`` in tools/train.py)
    fix_modules: tuple = ()
    # base seed of the per-step ``comm`` and ``dropout`` streams; None
    # opens no stream
    rng_seed: int | None = 0
    # parallel/sharding.Mesh of this rank; None: one device
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            unplaced = [type(m).__name__ for m in self.model.modules()
                        if hasattr(type(m), "mesh") and m.mesh is not self.mesh]
            if unplaced:
                raise ValueError(
                    f"{sorted(set(unplaced))} not on the mesh: place the "
                    "model with sharding.shard_state before building its "
                    "optimizer")
            if hasattr(type(self.criterion), "mesh"):
                self.criterion.mesh = self.mesh
        self._sharded = sharded_parameters(self.model)
        if self.fix_modules:
            freeze(self.model, self.fix_modules)
            held = [p for g in self.optimizer.param_groups
                    for p in g["params"] if not p.requires_grad]
            if held:
                raise ValueError(
                    f"the optimizer holds {len(held)} frozen parameters; "
                    "build it from freezing.trainable_parameters(model) "
                    "(Adam's weight decay would move them)"
                )

    def _forward(self, batch: dict) -> dict:
        if not self.bf16:
            return self.model(batch)
        params = {
            k: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
            for k, p in self.model.named_parameters()
        }
        out = torch.func.functional_call(self.model, params, (batch,))
        return _to_f32(out)

    def outputs(self, batch: dict) -> dict:
        """The train-mode forward's outputs, which the loss reads."""
        return self._forward(batch)

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Train-mode forward and loss (running BN buffers move, but not
        those of the frozen modules)."""
        self.model.train()
        frozen_eval(self.model, self.fix_modules)
        out = self.outputs(batch)
        loss, aux = self.criterion(out, _label_targets(batch))
        if "comm_rate" in out:  # where2comm's bandwidth, as JAX logs it
            aux = dict(aux, comm_rate=out["comm_rate"])
        if self.supervise_single:
            loss_s, aux_s = self.criterion(out, _single_targets(batch),
                                           "_single")
            loss = loss + self.single_weight * loss_s
            aux = dict(aux, **{f"{k}_single": v for k, v in aux_s.items()})
        return loss, aux

    def gradients(self, batch: dict) -> dict[str, Any]:
        """Forward, loss and backward on a device batch (see
        :func:`to_device`; under a mesh, this rank's slice of the global
        batch): each trainable parameter's ``.grad`` then holds the step's
        gradient, the global batch's under a mesh. -> the aux terms."""
        self.optimizer.zero_grad(set_to_none=True)
        with trace.span("train.forward"), self.streams():
            loss, aux = self.loss(batch)
        with trace.span("train.backward"):
            loss.backward()
        # a parameter the loss does not reach (VoxelNet's direction head:
        # its loss has no direction term) has a zero gradient in JAX, and
        # optax still applies the weight decay to it: so here too
        params = [p for group in self.optimizer.param_groups
                  for p in group["params"]]
        with trace.span("train.optimizer"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            self.mesh.reduce_gradients(params, self._sharded)
        return self._global(dict(aux, total_loss=loss))

    def train_step(self, batch: dict) -> dict[str, Any]:
        """One update on a device batch (:meth:`gradients`, then the
        optimizer at the scheduled learning rate). After it, each
        parameter's ``.grad`` holds this step's gradient. The step is a
        request of the tracer (span ``train.step``)."""
        with trace.request("train.step"):
            aux = self.gradients(batch)
            with trace.span("train.optimizer"):
                lr = self.schedule(self.step)
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.step()
            self.step += 1
            return aux

    def _global(self, aux: dict) -> dict:
        """The aux terms detached; under a mesh each scalar is averaged
        over the world (the global batch's value)."""
        aux = {k: v.detach() for k, v in aux.items()}
        if self.mesh is None:
            return aux
        scalars = {k: v for k, v in aux.items() if v.dim() == 0}
        return dict(aux, **self.mesh.mean_scalars(scalars))

    def streams(self):
        """The context of this step's random streams (none without a
        seed)."""
        if self.rng_seed is None:
            return contextlib.nullcontext()
        device = next(self.model.parameters()).device
        return rng_streams(self.model,
                           **step_streams(self.rng_seed, self.step, device))

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict[str, Any]:
        """Eval-mode forward (running statistics, f32) and the loss (under
        a mesh every rank steps together, and the scalars are the global
        batch's)."""
        self.model.eval()
        loss, aux = self.criterion(self.model(batch), _label_targets(batch))
        return self._global(dict(aux, total_loss=loss))
