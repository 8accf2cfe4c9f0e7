"""The (data, agent, model) device mesh over torch.distributed.

Counterpart of heal_tpu/parallel/sharding.py. JAX drives every device
from one process and annotates the batch and the weights; XLA inserts
the collectives, so every reduction is over the GLOBAL batch. The port
runs one process per device (a rank), so each axis is explicit code:

  data  -- the batch dimension: rank (d, a, m) holds samples
           [d*B/D, (d+1)*B/D) of each global batch (:func:`shard_batch`);
  agent -- the packed agent axis of ``inputs_mX``: the heterogeneous
           models (heter_pyramid.py, heter_baseline.py) run their agent
           branches on this rank's L_m/A agents and gather the BEV
           features over the agent group before the slot scatter: the
           physical V2X round. Models without per-type branches run the
           whole agent axis on every rank;
  model -- out channels (tensor parallel): :func:`shard_state` keeps this
           rank's out-channel slice of every conv / dense kernel (and
           bias) that :func:`param_pspec`'s rule admits; the layer gathers
           its output over the model group.

What stays global, as in JAX: the train-mode batch-norm moments
(Σx, Σx² and the count, all-reduced over the world inside the graph by
``Mesh.world_sum``: models/layers.Norm, encoders.MaskedBatchNorm and the
PFN), the losses' batch-wide normalisers
(``losses/point_pillar_loss.batch_divisor``) and the dropout masks
(layers.Dropout: the global draw, this rank's rows).

The gradient. Every collective's backward is its exact adjoint (an
all-reduce's is an all-reduce; a gather's sums the gradient over the
group and keeps this rank's slice), so after each rank's ``backward``
a parameter's ``.grad`` on rank r is d(Σ_r' L_r')/dθ_r, with L_r' rank
r''s loss. Ranks that share a data index compute the same loss, so
Σ_r' L_r' = N * L for the global loss L and N ranks; the step's
gradient is the sum over the ranks that hold the same parameter (the
world, or for a model-sharded one the ranks of its model index),
divided by N (``Mesh.reduce_gradients``).

Rank r sits at (r // (A*M), r // M % A, r % M): ``model`` innermost, as
in JAX. The backend follows the device (NCCL for cuda, gloo for the CPU;
tools/train.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "agent", "model")
BUCKET_BYTES = 25 << 20  # gradient all-reduce bucket, DDP's default


def factor_mesh(n: int) -> tuple[int, int, int]:
    """Split n devices into (data, agent, model), giving each axis a share
    where n allows (JAX's ``factor_mesh``)."""
    model = 2 if n % 2 == 0 and n > 1 else 1
    agent = 2 if (n // model) % 2 == 0 and n // model > 1 else 1
    return n // (agent * model), agent, model


def parse_devices(spec) -> tuple[int, int, int]:
    """``--devices`` as JAX's train.py reads it: "N" (data parallel) or
    "DxAxM"; missing axes are 1."""
    dims = [int(d) for d in str(spec).lower().split("x")]
    data, agent, model = (dims + [1, 1])[:3]
    return data, agent, model


# keys whose dim 1 is the (padded) agent axis
_AGENT_DIM1 = ("points", "point_mask", "agent_modality")


def batch_pspec(keys: tuple, leaf) -> tuple:
    """JAX's spec of one batch leaf, as a tuple of axis names: the batch
    dim -> data; the packed agent dim of ``inputs_*``, ``slots_*``,
    ``*_single``, the raw point packs and ``agent_mask`` -> agent."""
    if getattr(leaf, "ndim", 0) == 0:
        return ()
    agent_dim1 = any(
        k.startswith(("inputs_", "slots_")) or k.endswith("_single")
        or k in _AGENT_DIM1 or k == "agent_mask"
        for k in keys)
    if agent_dim1 and leaf.ndim >= 2:
        return ("data", "agent")
    return ("data",)


def param_pspec(shape: tuple, model_size: int) -> tuple:
    """JAX's tensor-parallel spec of a parameter in JAX's layout: the last
    (out-channel) dim of a >= 2-D kernel over ``model`` where
    ``model_size`` divides it and it is at least twice ``model_size``."""
    if len(shape) >= 2 and column_rule(shape[-1], model_size):
        return (None,) * (len(shape) - 1) + ("model",)
    return ()


def column_rule(size: int, model_size: int) -> bool:
    return size % model_size == 0 and size >= 2 * model_size


def _fit(spec: tuple, shape: tuple, mesh_shape: dict) -> tuple:
    """Drop the axes the mesh does not have or that do not divide their
    dim (that dim is then replicated)."""
    return tuple(a if a in mesh_shape and dim % mesh_shape[a] == 0 else None
                 for dim, a in zip(shape, spec))


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the backward sums the gradient over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """Concatenate the group's equal parts along ``dim``; the backward
    sums the gradient over the group and keeps this rank's part."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        ctx.dim, ctx.group, ctx.index, ctx.n = dim, group, index, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, \
            None, None


class Mesh:
    """This rank's place in a (data, agent, model) grid of processes.

    ``shape`` and ``coords`` map each axis to its size and this rank's
    index; ``groups`` to the process group of the ranks that differ from
    this one along that axis only (None for an axis of size 1), plus
    ``"world"`` and ``"replica"`` (the ranks of this model index).
    Built by :func:`make_mesh`; without ``groups`` it only slices
    (:meth:`take`, :func:`shard_batch`)."""

    def __init__(self, shape: dict, coords: dict, groups: dict | None = None):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = groups or {}
        self.size = int(np.prod([self.shape[a] for a in AXES]))

    def __repr__(self):
        return ("Mesh(" + ", ".join(f"{a}={self.coords[a]}/{self.shape[a]}"
                                    for a in AXES) + ")")

    @property
    def rank(self) -> int:
        """This rank's index in the world (``model`` innermost)."""
        d, a, m = (self.coords[x] for x in AXES)
        return (d * self.shape["agent"] + a) * self.shape["model"] + m

    def splits(self, axis: str, n: int) -> bool:
        """Whether a dim of size ``n`` is split over ``axis`` (``_fit``)."""
        return self.shape[axis] > 1 and n % self.shape[axis] == 0

    def take(self, x, dim: int, axis: str):
        """This rank's part of ``x`` (tensor or numpy) along ``dim``."""
        n = x.shape[dim] // self.shape[axis]
        lo = self.coords[axis] * n
        if isinstance(x, torch.Tensor):
            return x.narrow(dim, lo, n)
        index = [slice(None)] * x.ndim
        index[dim] = slice(lo, lo + n)
        return x[tuple(index)]

    def gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """The parts of ``axis``'s group concatenated along ``dim``, in
        the graph; identity for an axis of size 1."""
        if self.shape[axis] == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.groups[axis],
                             self.shape[axis], self.coords[axis])

    def world_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over every rank, in the graph (an all-reduce also on a world
        of one rank)."""
        return _AllReduce.apply(x, self.groups["world"])

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the data group, outside the graph."""
        x = x.detach().clone()
        if self.shape["data"] > 1:
            dist.all_reduce(x, group=self.groups["data"])
        return x

    def reduce_gradients(self, params, sharded: set) -> None:
        """The step's gradient (module docstring): every ``.grad`` summed
        over the ranks holding the same parameter, in buckets of
        BUCKET_BYTES, and divided by the world size. ``sharded``: ids of
        the model-sharded parameters. Every rank passes the same list in
        the same order."""
        rep = [p for p in params if id(p) not in sharded]
        shd = [p for p in params if id(p) in sharded]
        for group, ps in ((self.groups["world"], rep),
                          (self.groups.get("replica"), shd)):
            for bucket in _buckets(ps):
                flat = torch.cat([p.grad.reshape(-1) for p in bucket])
                dist.all_reduce(flat, group=group)
                flat.mul_(1.0 / self.size)
                offset = 0
                for p in bucket:
                    n = p.grad.numel()
                    p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
                    offset += n

    def mean_scalars(self, scalars: dict) -> dict:
        """Each scalar's mean over the world (the global loss terms: the
        ranks of one data index hold equal values)."""
        keys = sorted(scalars)
        if not keys:
            return {}
        flat = torch.stack([scalars[k].detach().to(torch.float64)
                            for k in keys])
        dist.all_reduce(flat, group=self.groups["world"])
        flat /= self.size
        return {k: flat[i].to(scalars[k].dtype) for i, k in enumerate(keys)}


def _buckets(params):
    """Consecutive runs of one dtype and device, each under BUCKET_BYTES
    (or one parameter)."""
    bucket, nbytes = [], 0
    for p in params:
        size = p.grad.numel() * p.grad.element_size()
        if bucket and (nbytes + size > BUCKET_BYTES
                       or p.grad.dtype != bucket[0].grad.dtype
                       or p.grad.device != bucket[0].grad.device):
            yield bucket
            bucket, nbytes = [], 0
        bucket.append(p)
        nbytes += size
    if bucket:
        yield bucket


def make_mesh(n: int | None = None, data: int | None = None, agent: int = 1,
              model: int = 1) -> Mesh:
    """The mesh of this rank over the initialised world of ``n`` ranks
    (one per device). ``data`` defaults to what agent and model leave.
    Every rank calls it, in the same order as every other group it makes."""
    world = dist.get_world_size()
    n = n or world
    if data is None:
        if n % (agent * model):
            raise ValueError(f"{n} ranks do not split into agent {agent} x "
                             f"model {model}")
        data = n // (agent * model)
    if data * agent * model != n or n != world:
        raise ValueError(f"mesh {data}x{agent}x{model} over a world of "
                         f"{world} ranks")
    shape = dict(zip(AXES, (data, agent, model)))
    grid = np.arange(n).reshape(data, agent, model)
    rank = dist.get_rank()
    coords = dict(zip(AXES, (int(i) for i in
                             np.argwhere(grid == rank)[0])))
    groups = {"world": dist.group.WORLD}
    for k, axis in enumerate(AXES):
        if shape[axis] == 1:
            continue
        lines = np.moveaxis(grid, k, -1).reshape(-1, shape[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    if model > 1:
        for m in range(model):
            ranks = [int(r) for r in grid[:, :, m].reshape(-1)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups["replica"] = g
    else:
        groups["replica"] = groups["world"]
    return Mesh(shape, coords, groups)


def shard_batch(batch, mesh: Mesh, axes: tuple = ("data", "agent")):
    """This rank's slice of a global (numpy or tensor) batch under JAX's
    rules (:func:`batch_pspec`, :func:`_fit`), splitting over ``axes``
    only. The trainer's input is ``axes=("data",)``: every leaf keeps its
    whole agent axis, and the heterogeneous models take their agents'
    part of ``inputs_*`` themselves."""
    shape = {a: mesh.shape[a] for a in axes}
    lead = set()

    def place(keys, x):
        if isinstance(x, dict):
            return {k: place(keys + (k,), v) for k, v in x.items()}
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        spec = _fit(batch_pspec(keys, x), x.shape, shape)
        for dim, axis in enumerate(spec):
            if axis is not None:
                if dim == 0:
                    lead.add(x.shape[0])
                x = mesh.take(x, dim, axis)
        return x

    out = place((), batch)
    if len(lead) > 1:
        raise ValueError(f"batch leaves disagree on the batch size: {lead}")
    return out


def shard_state(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Place ``model`` (the whole seeded or loaded model, on its device)
    on the mesh, in place: every module with a ``mesh`` attribute gets
    ``mesh`` (batch norms, dropout, the agent branches), and under a
    model axis each column layer (a type with ``column_dims``: the
    kernel's out-channel dim, the output's channel dim; models/layers.py),
    ungrouped, whose out channels pass JAX's rule keeps this rank's
    out-channel slice of its kernel and bias and gathers its output
    (``tp``). Build the optimizer after it."""
    for m in model.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh
    msize = mesh.shape["model"]
    if msize == 1:
        return model
    for m in list(model.modules()):
        dims = getattr(type(m), "column_dims", None)
        if dims is None or getattr(m, "groups", 1) != 1 or not column_rule(
                m.kernel.shape[dims[0]], msize):
            continue
        kdim = dims[0]
        for name, dim in (("kernel", kdim), ("bias", -1)):
            p = getattr(m, name, None)
            if p is None:
                continue
            part = mesh.take(p.data, dim % p.dim(), "model").clone()
            if p.dim() == 4 and p.is_contiguous(
                    memory_format=torch.channels_last):
                part = part.contiguous(memory_format=torch.channels_last)
            setattr(m, name, torch.nn.Parameter(part,
                                                requires_grad=p.requires_grad))
        m.tp = mesh
    return model


def sharded_parameters(model: torch.nn.Module) -> set:
    """ids of the model-sharded parameters of ``model``."""
    return {id(p) for m in model.modules() if getattr(m, "tp", None)
            for p in (m.kernel, getattr(m, "bias", None)) if p is not None}


def full_tensors(model: torch.nn.Module, tensors: dict) -> dict:
    """``tensors`` (name -> tensor, e.g. the state_dict or the gradients)
    in the one-device layout: each model-sharded kernel and bias gathered
    over its model group. Every rank calls it."""
    out = dict(tensors)
    for name, m in model.named_modules():
        mesh = getattr(m, "tp", None)
        if mesh is None:
            continue
        kdim = type(m).column_dims[0]
        for leaf, dim in (("kernel", kdim), ("bias", -1)):
            key = f"{name}.{leaf}" if name else leaf
            if key in out and out[key] is not None:
                with torch.no_grad():
                    out[key] = mesh.gather(out[key], dim, "model")
    return out


def full_state_dict(model: torch.nn.Module) -> dict:
    """``model``'s state_dict in the one-device layout (checkpoints)."""
    return full_tensors(model, model.state_dict())
