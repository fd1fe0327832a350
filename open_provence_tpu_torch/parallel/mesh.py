"""The (data, model) mesh over ``torch.distributed`` ranks, the sharding
rules and the two collectives of tensor parallelism.

Counterpart of the JAX package's ``parallel/mesh.py``. The port runs SPMD:
every rank runs the same program on the same inputs, as JAX's one program
runs over its devices, and every number a user reads is the same, within
fp32 reduction order, as on one device.

* ``data`` splits the pair rows of each batch; gradients sum over it.
* ``model`` (tensor parallelism) splits the attention heads and the MLP's
  intermediate columns, Megatron's way: ``attn.Wqkv`` and ``mlp.Wi`` by
  output, ``attn.Wo`` and ``mlp.Wo`` by input, everything else replicated
  (``param_sharding_rules``). GSPMD's column split of the packed Wqkv is
  placement only; here each rank computes on its shard, so a rank's Wqkv
  shard is its heads' q, k and v rows and its Wi shard pairs input rows
  with their gate rows, each a self-contained piece of the computation.

Without a process group ``create_mesh()`` is the 1 × 1 mesh of one
process and every collective here is skipped. Collectives go through
``all_reduce`` alone, which ``gloo`` also takes on CUDA tensors (its
``all_gather`` does not): a gather sums a zero-padded buffer.
"""

from __future__ import annotations

import os
from collections.abc import Mapping, Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a (data, model) mesh: the mesh shape, this rank's
    coordinates, the global ranks in mesh order (``devices``, [data,
    model]) and a process group for each axis and for the whole mesh (None
    where the axis has one member or there is no process group)."""

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    devices: Any = None
    data_group: Any = None
    model_group: Any = None
    group: Any = None

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def is_main(self) -> bool:
        """Data rank 0 of model rank 0: the rank that writes files and logs."""
        return self.data_rank == 0 and self.model_rank == 0

    def all_reduce(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """Sum ``t`` in place over ``axis`` (``"data"``, ``"model"`` or None
        for the whole mesh); returns ``t``."""
        group = {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group, None: self.group}[axis]
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def barrier(self) -> None:
        if self.group is not None:
            # A one-element all-reduce: a barrier that needs no device_ids
            # under nccl and works alike under gloo.
            dist.all_reduce(torch.zeros(1, device=_collective_device(self.group)),
                            group=self.group)


def _collective_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(
    data: int | None = None,
    model: int = 1,
    devices: Sequence[int] | None = None,
) -> Mesh | None:
    """Build a (data, model) mesh over ``devices`` (global ranks; default
    every rank of the default process group), with the JAX function's
    rules: ``data=None`` takes ``len(devices) // model``, and a mesh larger
    than the devices raises. The mesh takes the first data × model of them,
    rank ``devices[d * model + m]`` at (d, m).

    Every rank of the default group must call this (``new_group`` is
    collective); a rank outside the mesh gets None."""
    world, rank = _world()
    devices = list(range(world)) if devices is None else [int(d) for d in devices]
    n = len(devices)
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"Mesh {data}x{model} needs {data * model} devices, have {n}")
    grid = np.asarray(devices[: data * model]).reshape(data, model)
    if world == 1:
        return Mesh(data, model, 0, 0, grid)

    def groups(rows) -> dict[tuple[int, ...], Any]:
        # new_group is called for every row by every rank, in one order.
        return {tuple(r): dist.new_group(list(map(int, r))) for r in rows}

    model_groups = groups(grid) if model > 1 else {}
    data_groups = groups(grid.T) if data > 1 else {}
    members = tuple(int(r) for r in grid.reshape(-1))
    if members == tuple(range(world)):
        whole = dist.group.WORLD
    else:
        whole = dist.new_group(list(members))
    if rank not in members:
        return None
    d, m = (int(i[0]) for i in np.nonzero(grid == rank))
    return Mesh(
        data, model, d, m, grid,
        data_group=data_groups.get(tuple(int(r) for r in grid[:, m])),
        model_group=model_groups.get(tuple(int(r) for r in grid[d])),
        group=whole if data * model > 1 else None,
    )


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    ``LOCAL_RANK``; 0 without one)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_from_env(device: str | torch.device | None) -> bool:
    """Initialize the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) when it
    names more than one rank; returns whether one is initialized.

    The backend is ``nccl`` when every rank of the host has a card of its
    own (``device`` None, which then means card ``LOCAL_RANK``), and
    ``gloo`` on the CPU or where ranks share a card, which nccl refuses."""
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    own_cards = (
        device is None and torch.cuda.is_available()
        and local_ranks <= torch.cuda.device_count()
    )
    if own_cards:
        torch.cuda.set_device(local_rank())
    dist.init_process_group("nccl" if own_cards else "gloo")
    return True


# --- sharding rules ---------------------------------------------------------


def param_sharding_rules(name: str, shape: Sequence[int]) -> tuple[int, int] | None:
    """How the tensor ``name`` (the port's state-dict names) of ``shape``
    splits over ``model``: (dim, blocks) — the dim is cut into ``blocks``
    equal blocks and a rank takes its part of each — or None (replicated).

    * ``attn.Wqkv`` [3H, H] and its bias: dim 0 in 3 blocks (q, k, v), so a
      rank's rows are its heads' q, then k, then v;
    * ``mlp.Wi`` [2I, H] and its bias: dim 0 in 2 blocks (input, gate), so
      input row j still pairs with gate row j;
    * ``attn.Wo`` [H, H], ``mlp.Wo`` [H, I]: dim 1 (their inputs); their
      biases are replicated and added once, after the sum over ``model``;
    * embeddings, norms, heads and classifiers: replicated."""
    if ".attn.Wqkv." in name:
        return (0, 3)
    if ".mlp.Wi." in name:
        return (0, 2)
    if (".attn.Wo." in name or ".mlp.Wo." in name) and len(shape) == 2:
        return (1, 1)
    return None


def _pieces(t: torch.Tensor, rule: tuple[int, int], parts: int, index: int) -> list[torch.Tensor]:
    """Rank ``index``'s piece of each block of ``t`` (views)."""
    dim, blocks = rule
    block = t.shape[dim] // blocks
    if block % parts:
        raise ValueError(f"a block of {block} along dim {dim} does not split over {parts} ranks")
    width = block // parts
    return [t.narrow(dim, b * block + index * width, width) for b in range(blocks)]


def shard_state_dict(full_sd: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's tensors of the full state dict under tensor parallelism
    over ``mesh.model`` (``param_sharding_rules``); replicated tensors are
    passed through. Differentiable: a gradient flows back into the full
    tensors, zero outside this rank's rows or columns."""
    if mesh.model == 1:
        return dict(full_sd)
    out = {}
    for name, t in full_sd.items():
        rule = param_sharding_rules(name, t.shape)
        if rule is not None:
            t = torch.cat(_pieces(t, rule, mesh.model, mesh.model_rank), rule[0])
        out[name] = t
    return out


def scatter_into_full(name: str, local: torch.Tensor, full_shape: Sequence[int],
                      mesh: Mesh) -> torch.Tensor:
    """A zero tensor of ``full_shape`` holding ``local`` at this rank's place
    (``local`` itself for a replicated tensor)."""
    rule = param_sharding_rules(name, full_shape)
    if rule is None or mesh.model == 1:
        return local
    full = local.new_zeros(tuple(full_shape))
    places = _pieces(full, rule, mesh.model, mesh.model_rank)
    for place, piece in zip(places, local.split(places[0].shape[rule[0]], rule[0])):
        place.copy_(piece)
    return full


def gather_state_dict(local_sd: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: the full tensors, on every rank
    of the model group (each shard summed into a zero-padded buffer)."""
    if mesh.model == 1:
        return dict(local_sd)
    out = {}
    for name, t in local_sd.items():
        rule = param_sharding_rules(name, t.shape)
        if rule is None:
            out[name] = t
            continue
        shape = list(t.shape)
        shape[rule[0]] *= mesh.model
        out[name] = mesh.all_reduce(scatter_into_full(name, t.detach(), shape, mesh), MODEL_AXIS)
    return out


def check_tensor_parallel(num_heads: int, intermediate: int, model: int) -> None:
    """Raise unless the heads and the MLP's intermediate width split evenly
    over ``model`` ranks."""
    if num_heads % model:
        raise ValueError(f"num_attention_heads={num_heads} does not divide by model={model}")
    if intermediate % model:
        raise ValueError(f"intermediate_size={intermediate} does not divide by model={model}")


# --- the two collectives of tensor parallelism (Megatron's f and g) ---------


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group backward.
    At the input of each column-parallel block (and on a norm scale folded
    into its GEMM), whose backward gives only this rank's columns' share."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone(), MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward. After each
    row-parallel product, whose output is a partial sum. Not
    ``torch.distributed.nn.functional.all_reduce``: its backward sums the
    cotangent again, which is already the same on every rank here, and so
    scales every gradient by the group's size."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor | None, mesh: Mesh | None) -> torch.Tensor | None:
    if x is None or mesh is None or mesh.model == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    if mesh is None or mesh.model == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)
