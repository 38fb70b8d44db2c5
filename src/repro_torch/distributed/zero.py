"""ZeRO-3 storage over a ``DeviceMesh`` in the JAX package's specs.

A mesh trainer (``repro_torch.runtime.trainer``) keeps on each rank only
its block of every master, gradient and optimizer state, where the JAX
package's ``state_specs`` place it (:class:`Placed`). A layer's parameters
are gathered whole at use, one part of a layer at a time (the model's
``gather`` hook, :meth:`Zero.gather`), and dropped after it; their
gradients land on the shards already cut to the spec (:class:`_Gather`'s
backward).

The compute is split over the mesh (:class:`MeshSplit`): the batch over its
mesh dims (``plan.batch``; each rank trains its rows), and the rest over
the ``model`` axis, where the model runs this rank's block of the
sequence, heads, ``d_ff`` or experts (``sharding.RankView``,
``repro_torch.distributed.parallel``); where ``model`` splits nothing
(a sequence that does not divide over it, and no heads, experts or
``d_ff`` to split) its ranks compute the same rows alike. Reductions
follow from that:

  - a gradient is a ``Partial`` sum over the split's mesh dims (the
    batch's and ``model``, unless ``model`` splits the batch or has one
    rank) and a ``Replicate`` over the others, redistributed to the
    parameter's spec: one reduce-scatter where the dim is split, an
    all-reduce where it is not, a local slice on the other dims;
  - each rank's loss is weighted by ``1 / `` the split's ranks, so the
    ranks' sum is the global batch's loss whether a rank holds rows of
    its own or rows that ``model`` ranks share;
  - a sum over a tensor's elements (the global norm, Adafactor's row and
    column means and its update RMS) is all-reduced over the mesh dims that
    split that tensor (:meth:`Placed.sum`), never over its replicas;
  - a tensor no mesh dim of more than one rank splits takes the meshless
    arithmetic, so a 1x1 mesh trains bit for bit as no mesh.

Every collective is a ``torch.distributed`` call of ``parallel`` on one
mesh dim's group (no DTensor), so a mesh of gloo ranks runs on the card too.

Serving takes the same storage without gradients (``Zero.place`` cuts a
whole model's parameters to this rank's blocks; ``repro_torch.runtime.
place_on_mesh``): its gathers run under no grad, and ``gather(modules,
keep=axis)`` leaves a parameter split along the tensor dim that ``axis``
cuts (the embedding table's and the unembedding's vocab blocks).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from . import parallel as P
from .sharding import Spec, axes_of


def _coordinate(mesh) -> List[int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return list(coord)


def _all_reduce(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """``x`` summed in place over the ranks that differ on mesh ``dims``
    (one all-reduce a dim, in order)."""
    for d in dims:
        P.all_reduce_(x, mesh.get_group(d))
    return x


class Placed:
    """Where one tensor of the state lies: its global ``shape``, its
    ``spec`` over ``mesh`` (one entry a dim), this rank's block (``index``,
    a slice a dim) and ``split``, the mesh dims of more than one rank that
    split it. ``sum_dims`` are the mesh dims that split the compute: its
    gradient is a partial sum over them."""

    def __init__(self, mesh, spec: Spec, shape: Sequence[int],
                 sum_dims: Sequence[int] = (), one_collective: bool = True):
        self.mesh = mesh
        self.shape = tuple(int(n) for n in shape)
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        names = tuple(mesh.mesh_dim_names)
        coord = _coordinate(mesh)
        index, split, tensor_dim = [], [], {}
        for i, (n, entry) in enumerate(zip(self.shape, self.spec)):
            dims = [names.index(a) for a in axes_of(entry)]
            if dims != sorted(dims):
                raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
            blocks = math.prod(mesh.size(d) for d in dims)
            if n % blocks:
                raise ValueError(f"dim of {n} does not divide over {entry!r} ({blocks})")
            block = 0
            for d in dims:
                block = block * mesh.size(d) + coord[d]
                if mesh.size(d) > 1:
                    tensor_dim[d] = i
            step = n // blocks
            index.append(slice(block * step, (block + 1) * step))
            split += [d for d in dims if mesh.size(d) > 1]
        self.index = tuple(index)
        self.split = tuple(sorted(split))
        #: the tensor dim each mesh dim of ``split`` cuts
        self.tensor_dim = tensor_dim
        self.local_shape = tuple(s.stop - s.start for s in self.index)
        self.sum_dims = tuple(sum_dims)
        self.one_collective = one_collective

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a contiguous copy)."""
        return full[self.index].contiguous().clone()

    def full(self, local: torch.Tensor, keep: Sequence[int] = ()) -> torch.Tensor:
        """The whole tensor from every rank's block (an all-gather over each
        mesh dim that splits it, the minor one first; a copy where none
        does): a new tensor, never ``local`` itself. Along the mesh dims
        ``keep`` it stays this rank's block."""
        out, gathered = local.detach(), False
        for d in reversed(self.split):
            if d in keep:
                continue
            out = P.all_gather(out, self.tensor_dim[d], self.mesh.get_group(d))
            gathered = True
        return out if gathered else out.clone()

    def _slice(self, g: torch.Tensor, d: int) -> torch.Tensor:
        """``g``'s block on mesh dim ``d`` along the tensor dim it cuts."""
        i = self.tensor_dim[d]
        step = g.shape[i] // self.mesh.size(d)
        c = _coordinate(self.mesh)[d]
        return g.narrow(i, c * step, step)

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """A whole gradient of this rank's share of the compute summed over
        the split's ranks and cut to this rank's block, mesh dim by mesh dim
        in order: a reduce-scatter where the dim is summed and cuts the
        tensor (without ``one_collective``: an all-reduce and a slice), an
        all-reduce where it is summed only, a slice where it cuts only. The
        same numbers either way (each element summed over the same dims in
        the same order)."""
        if not self.sum_dims:
            for d in self.split:
                g = self._slice(g, d)
            return g.contiguous()
        for d in range(self.mesh.ndim):
            if self.mesh.size(d) == 1:
                continue
            cuts, summed = d in self.split, d in self.sum_dims
            if summed and cuts and self.one_collective:
                g = P.reduce_scatter(g, self.tensor_dim[d], self.mesh.get_group(d))
            elif summed:
                g = P.all_reduce_(g.contiguous().clone(), self.mesh.get_group(d))
                if cuts:
                    g = self._slice(g, d)
            elif cuts:
                g = self._slice(g, d)
        return g.contiguous()

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (a partial sum over this rank's block) summed in place over
        the ranks that hold the other blocks."""
        return _all_reduce(x, self.mesh, self.split)


class _Gather(torch.autograd.Function):
    """The whole parameter from its shard; the backward reduces the whole
    gradient into the shard (:meth:`Placed.reduce`)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, placed: Placed) -> torch.Tensor:
        ctx.placed = placed
        return placed.full(local)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.placed.reduce(g), None


class _BatchSum(torch.autograd.Function):
    """A sum over the batch's ranks whose backward is the same sum (every
    rank's loss holds the summed value)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, split: "MeshSplit") -> torch.Tensor:
        ctx.split = split
        return _all_reduce(x.clone(), split.mesh, split.batch_dims)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_reduce(g.clone(), ctx.split.mesh, ctx.split.batch_dims), None


class MeshSplit:
    """How the mesh splits the compute. The rows of the global batch this
    rank trains: ``plan.batch(B)``'s mesh axes split each microbatch's rows
    into blocks, the first axis major, and this rank takes the block of its
    coordinate on them (the rows JAX's ``device_put`` gives its device);
    ``batch_dims`` are those axes' dims of more than one rank. The model
    axis ``model_axis``, unless it splits the batch or has one rank, splits
    the rest of the compute (``model``, its dim; else None). ``dims`` are
    both: every gradient is a partial sum over them, and ``frac`` is one
    rank's share of them: each rank's loss is its mean over its own rows
    and positions times ``frac``, so the sum over ``dims`` is the global
    batch's loss."""

    def __init__(self, mesh, axes: Tuple[str, ...], global_batch: int, microbatches: int,
                 model_axis=None):
        names = tuple(mesh.mesh_dim_names)
        all_dims = [names.index(a) for a in axes]
        coord = _coordinate(mesh)
        self.mesh = mesh
        self.blocks = math.prod(mesh.size(d) for d in all_dims)
        self.block = 0
        for d in all_dims:
            self.block = self.block * mesh.size(d) + coord[d]
        self.batch_dims = tuple(d for d in all_dims if mesh.size(d) > 1)
        m = names.index(model_axis) if model_axis in names else None
        self.model = m if m is not None and mesh.size(m) > 1 and m not in all_dims else None
        self.dims = tuple(sorted(self.batch_dims + (() if self.model is None else (m,))))
        self.microbatches = mb = max(1, microbatches)
        if global_batch % (mb * self.blocks):
            raise ValueError(
                f"a global batch of {global_batch} in {mb} microbatches does not "
                f"split over the {self.blocks} blocks of the batch axes {axes}")
        self.frac = 1.0 / (self.blocks * (1 if self.model is None else mesh.size(m)))

    def rows(self, x):
        """This rank's rows of a global batch array (numpy or torch): its
        block of every microbatch, microbatches in order."""
        mb = self.microbatches
        per = x.shape[0] // mb // self.blocks
        parts = x.reshape((mb, self.blocks, per) + tuple(x.shape[1:]))[:, self.block]
        return parts.reshape((mb * per,) + tuple(x.shape[1:]))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed in place over the split's ranks (``dims``)."""
        return _all_reduce(x, self.mesh, self.dims)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of ``x`` from every rank's rows
        (:meth:`rows` with one microbatch): an all-gather along dim 0 over
        each of ``batch_dims``, the minor one first."""
        for d in reversed(self.batch_dims):
            x = P.all_gather(x, 0, self.mesh.get_group(d))
        return x

    def grad_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The differentiable sum over the batch's ranks (the MoE
        load-balancing loss's statistics: the model axis's ranks route
        the same whole rows)."""
        return _BatchSum.apply(x, self)


class Zero:
    """A model's parameters as this rank's shards, and the hooks that
    gather them at use. ``specs(path, shape)`` gives a leaf's per-unit spec
    (the JAX spec less a stacked leaf's unit dim)."""

    def __init__(self, mesh, split: MeshSplit, specs, one_collective: bool):
        self.mesh = mesh
        self.split = split
        self.specs = specs
        self.one_collective = one_collective
        self.placed: Dict[Tuple[int, str], Placed] = {}
        self._names: Dict[Tuple[int, str], str] = {}

    def placed_for(self, path: str, shape: Sequence[int]) -> Placed:
        return Placed(self.mesh, self.specs(path, tuple(shape)), shape,
                      self.split.dims, self.one_collective)

    def placer(self, path_of):
        """``init_params``'s ``place``: given the (meta) model, records each
        parameter slot's leaf path (``path_of(name)``; drawing replaces the
        parameter objects, not the modules) and returns the function that
        swaps a drawn module's parameters for this rank's shards."""

        def place(model: nn.Module):
            for mname, mod in model.named_modules():
                for pname in mod._parameters:
                    self._names[(id(mod), pname)] = path_of(
                        f"{mname}.{pname}" if mname else pname)
            return self._put

        return place

    def place(self, model: nn.Module, path_of) -> None:
        """Cut every parameter of a whole ``model`` to this rank's block
        (``path_of(name)``: a parameter's leaf path), as drawing through
        :meth:`placer` would."""
        self.placer(path_of)(model)
        self._put(model)

    @torch.no_grad()
    def _put(self, module: nn.Module, recurse: bool = True) -> None:
        mods = module.modules() if recurse else [module]
        for mod in mods:
            for pname, p in list(mod._parameters.items()):
                if p is None:
                    continue
                pl = self.placed_for(self._names[(id(mod), pname)], p.shape)
                self.placed[(id(mod), pname)] = pl
                mod._parameters[pname] = nn.Parameter(pl.local(p), requires_grad=p.requires_grad)

    def attach(self, model: nn.Module) -> None:
        """Install the hooks: the model's ``gather`` and, where the batch is
        split, each MoE layer's ``batch_sum``."""
        model.gather = self.gather
        if self.split.batch_dims:
            for mod in model.modules():
                if hasattr(mod, "batch_sum"):
                    mod.batch_sum = self.split.grad_sum

    @contextlib.contextmanager
    def gather(self, modules, keep=None):
        """The own parameters of ``modules`` whole for the context: each an
        all-gather of its shards (a copy where no rank splits it), dropped
        on exit (autograd keeps what the backward needs). With ``keep`` (a
        mesh axis name) each stays this rank's block along the tensor dim
        that axis splits, with no backward (serving)."""
        swapped = []
        kept = () if keep is None else (tuple(self.mesh.mesh_dim_names).index(keep),)
        try:
            for mod in modules:
                for pname, p in list(mod._parameters.items()):
                    if p is None:
                        continue
                    swapped.append((mod, pname, p))
                    placed = self.placed[(id(mod), pname)]
                    mod._parameters[pname] = (placed.full(p, kept) if kept
                                              else _Gather.apply(p, placed))
            yield
        finally:
            for mod, pname, p in reversed(swapped):
                mod._parameters[pname] = p

    def placed_leaves(self, model: nn.Module, leaves) -> Dict[str, List[Placed]]:
        """The ``Placed`` of every tensor of ``leaves`` (the model's
        ``param_leaves``), leaf by leaf."""
        by_param = {}
        for mod in model.modules():
            for pname, p in mod._parameters.items():
                if p is not None:
                    by_param[id(p)] = self.placed[(id(mod), pname)]
        return {k: [by_param[id(p)] for p in ps] for k, ps in leaves.items()}


def writer(mesh) -> bool:
    """Whether this rank writes the checkpoints: the one at the mesh's
    origin (every rank without a mesh)."""
    return mesh is None or not any(_coordinate(mesh))


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh``: an all-reduce over each dim in turn
    reaches every rank."""
    if mesh is not None:
        _all_reduce(torch.zeros(1, device=mesh.device_type), mesh, range(mesh.ndim))


def in_mesh(mesh) -> bool:
    return mesh is None or mesh.get_coordinate() is not None

