"""Sharding policy: parameters, batches, kernel dispatch under a mesh.

The JAX package's ``parallel/sharding.py`` in the port, with its rule table
copied as data (the port imports nothing of the JAX package):

* :func:`param_shardings` — path-pattern rules mapping each parameter to its
  per-dim mesh axes (Megatron column/row TP for the attention and MLP
  products, FSDP over the largest divisible axis, replication otherwise).
  The port keeps JAX's names and layouts (Linear kernels (in, out), DHWIO
  conv kernels), so the table applies dim for dim.
* :class:`ParamSharding` — where each parameter, gradient and Adam moment of
  a model lies on a mesh, and the collectives that move them.
* :func:`batch_slice` / :func:`shard_process_local_batch` — the rows of a
  global batch a rank holds: split over the (data, fsdp) coordinates, the same
  rows on every tensor rank, the whole batch where it does not divide.
* :func:`mesh_info` and the dispatch log — which implementation each kernel
  call took under the active mesh.
* :func:`constrain` — a no-op: the port's activations are the rank's own.

**Placement that differs from JAX's on purpose.** JAX splits the QKV
projection's output columns over ``tensor`` contiguously and lets the
partitioner move q, k and v where the chain needs them. The port's attention
runs on the rank's heads, so its tensor shard of ``qkv_projection`` is the
rank's heads from each of the q, k and v thirds (:data:`BY_HEADS`). The
per-dim axes are JAX's; only the order of the columns in a shard differs.
Checkpoints and the weight bridge see the full tensors.
"""

from __future__ import annotations

import math
import re
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from video_vae_tpu_torch.parallel.mesh import batch_ranks, mesh_coordinate, mesh_shape
from video_vae_tpu_torch.utils.debug import global_max_abs, global_norm

AxisName = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisName, ...]

# ---------------------------------------------------------------------------
# Active-mesh context
# ---------------------------------------------------------------------------

_ACTIVE_MESH: List[DeviceMesh] = []


@contextmanager
def activate_mesh(mesh: Optional[DeviceMesh]):
    """Make ``mesh`` the one kernel dispatch and :func:`constrain` see."""
    if mesh is None:
        yield
        return
    _ACTIVE_MESH.append(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.pop()


def active_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def _axis_size(mesh, axis: AxisName) -> int:
    """The size of ``axis`` (a name or a tuple of names) on ``mesh`` (a mesh or
    a {name: size} dict); 1 for None."""
    shape = mesh if isinstance(mesh, dict) else mesh_shape(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(shape.get(a, 1) for a in axis)
    return shape.get(axis, 1)


def _prune_spec_for_shape(mesh, shape: Sequence[int], axes: Sequence[AxisName]) -> Spec:
    """Drop any spec entry whose mesh-axis product doesn't divide the dim."""
    sizes = mesh if isinstance(mesh, dict) else mesh_shape(mesh)
    out = []
    for dim, axis in zip(shape, axes):
        if axis is None:
            out.append(None)
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        if any(a not in sizes for a in names):
            out.append(None)
            continue
        size = _axis_size(sizes, axis)
        out.append(axis if (size > 1 and dim % size == 0) else None)
    return tuple(out)


def constrain(x: torch.Tensor, *axes: AxisName) -> torch.Tensor:
    """The JAX sharding constraint; a no-op here, where every activation is
    the rank's own (its rows, and under TP its heads)."""
    return x


# ---------------------------------------------------------------------------
# Kernel dispatch under a mesh. JAX shard_maps a Pallas call over the batch
# or falls back to the partitioner's chain; the port runs every kernel on the
# rank's local tensors (the counterpart of the shard_map), and under tensor > 1
# the attention and MLP kernels give way to the module chain. Each decision is
# logged so that a test or the dry run can assert which implementation ran.
# ---------------------------------------------------------------------------

_dispatch_log: list = []


def dispatch_log() -> tuple:
    """The record of (op, impl, batch axes) dispatch decisions."""
    return tuple(_dispatch_log)


def clear_dispatch_log() -> None:
    _dispatch_log.clear()


def log_dispatch(op: str, impl: str, axes) -> None:
    # bounded: a long run keeps its first decisions; consumers clear the log
    # around the region they assert on
    if len(_dispatch_log) < 4096:
        _dispatch_log.append((op, impl, tuple(axes) if axes else None))


def mesh_info(batch: int, *, tensor_safe: bool = True):
    """(mesh, axes) for a batch-parallel kernel call, JAX's rule.

    (None, None) when no mesh is active or every axis has size 1; (mesh,
    None) when a sharded mesh is active but the call cannot run on batch
    shards (a tensor > 1 mesh for a ``tensor_safe=False`` op, or a batch the
    (data, fsdp) axes do not divide); (mesh, axes) otherwise.
    """
    mesh = active_mesh()
    shape = mesh_shape(mesh)
    if mesh is None or all(s <= 1 for s in shape.values()):
        return None, None
    if not tensor_safe and shape.get("tensor", 1) > 1:
        return mesh, None
    axes = tuple(a for a in ("data", "fsdp") if shape.get(a, 1) > 1)
    size = math.prod(shape[a] for a in axes)
    if not axes or batch % size:
        return mesh, None
    return mesh, axes


def _batch_axes() -> Optional[tuple]:
    shape = mesh_shape(active_mesh())
    return tuple(a for a in ("data", "fsdp") if shape.get(a, 1) > 1) or None


def takes_chain() -> bool:
    """Whether a ``tensor_safe=False`` op (attention, MLP) must take the module
    chain: a tensor > 1 mesh is active."""
    return _axis_size(mesh_shape(active_mesh()), "tensor") > 1


def log_chain(op: str) -> None:
    log_dispatch(op, "chain", _batch_axes())


def log_kernel(op: str, x: torch.Tensor) -> None:
    """Log a call of a kernel's wrapper: ``"kernel"`` on a CUDA tensor, where it
    launches, ``"plain"`` on the CPU, where its plain version runs."""
    log_dispatch(op, "kernel" if x.is_cuda else "plain", _batch_axes())


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

# (path regex, per-rank axis specs). First match wins. Paths are '/'-joined
# parameter paths, e.g. "encoder/layers/0/TemporalAttention/qkv_projection/kernel".
# Column-parallel (output dim on 'tensor') for QKV and MLP-in; row-parallel
# (input dim on 'tensor') for out-projections and MLP-out: the standard
# Megatron split, one all-reduce per sublayer.
_PARAM_RULES: List[Tuple[str, dict]] = [
    (r".*qkv_projection/kernel$", {2: ("fsdp", "tensor")}),
    (r".*qkv_projection/bias$", {1: ("tensor",)}),
    (r".*out_projection/kernel$", {2: ("tensor", "fsdp")}),
    (r".*linear1/kernel$", {2: ("fsdp", "tensor")}),
    (r".*linear1/bias$", {1: ("tensor",)}),
    (r".*linear2/kernel$", {2: ("tensor", "fsdp")}),
    # Patch embed / heads: shard the wide axis over fsdp only.
    (r".*(upsample|downsample|linear|spatial_compression|variance_estimator|spatial_decompression)/kernel$",
     {2: ("fsdp", None)}),
    # Conv kernels (t,kh,kw,in,out): shard output channels over fsdp.
    (r".*conv.*/kernel$|.*patch_mixer/kernel$|.*final_conv/kernel$|.*upsample/kernel$",
     {5: (None, None, None, None, "fsdp")}),
]

# Parameters whose tensor shard is the rank's heads of each of the q, k and v
# thirds (see the module docstring), not a contiguous block.
BY_HEADS = r".*qkv_projection/(kernel|bias)$"


def _spec_for_path(path: str, shape: Sequence[int]) -> Tuple[AxisName, ...]:
    for pattern, by_rank in _PARAM_RULES:
        if re.match(pattern, path):
            axes = by_rank.get(len(shape))
            if axes is not None:
                return tuple(axes)
    # Default: FSDP-shard the largest axis (ZeRO-3 style); replicate scalars.
    if len(shape) == 0:
        return ()
    largest = max(range(len(shape)), key=lambda i: (shape[i], -i))  # np.argmax: the first largest
    return tuple("fsdp" if i == largest else None for i in range(len(shape)))


def _named(params) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        params = params.named_parameters()
    elif isinstance(params, dict):
        params = params.items()
    return [(name.replace(".", "/"), p) for name, p in params]


def param_shardings(params, mesh) -> Dict[str, Spec]:
    """{'/'-joined path: per-dim mesh axes} for a module's parameters, or for
    (name, tensor) pairs or a {name: tensor} dict (Adam moments are keyed by
    their parameter's path, so they take its spec). With fsdp = tensor = 1
    every spec is all None: replication."""
    out = {}
    for name, p in _named(params):
        shape = tuple(p.shape)
        out[name] = _prune_spec_for_shape(mesh, shape, _spec_for_path(name, shape))
    return out


def replicated(mesh) -> Spec:
    return ()


def batch_sharding(mesh, ndim: int, batch_axes: AxisName = ("data", "fsdp")) -> Spec:
    """Batch dim sharded over data(+fsdp), everything else replicated."""
    return (batch_axes, *([None] * (ndim - 1)))


# ---------------------------------------------------------------------------
# Batch ingest
# ---------------------------------------------------------------------------


def batch_slice(global_batch: int, mesh: Optional[DeviceMesh], coordinate: Optional[dict] = None) -> slice:
    """The rows of a global batch this rank holds (``coordinate`` defaults to
    the rank's own): its (data, fsdp) block, the same on every tensor rank;
    every row where data·fsdp does not divide the batch."""
    if mesh is None:
        return slice(0, global_batch)
    spec = _prune_spec_for_shape(mesh, (global_batch,), [("data", "fsdp")])
    if spec[0] is None:
        return slice(0, global_batch)
    coord = mesh_coordinate(mesh) if coordinate is None else coordinate
    shape = mesh_shape(mesh)
    index = coord["data"] * shape["fsdp"] + coord["fsdp"]
    n = global_batch // batch_ranks(mesh)
    return slice(index * n, (index + 1) * n)


def shard_process_local_batch(batch: dict, mesh: Optional[DeviceMesh]) -> dict:
    """The rank's rows of each array of a global batch (see :func:`batch_slice`)."""
    return {key: val[batch_slice(len(val), mesh)] for key, val in batch.items()}


_ROWS: List[Tuple[slice, int]] = []


@contextmanager
def local_rows(rows: slice, total: int):
    """Declare that the batch this rank computes is ``rows`` of a global batch
    of ``total``: the model's random draws are then made at the global
    batch's shape and this rank keeps its rows (:func:`draw_local`), so a
    sharded step takes the same draws as one process does for the whole batch."""
    _ROWS.append((rows, total))
    try:
        yield
    finally:
        _ROWS.pop()


def draw_local(fn, shape: Sequence[int], **kw) -> torch.Tensor:
    """``fn(shape, **kw)`` (e.g. ``torch.randn``) for this rank's rows: under
    :func:`local_rows` drawn for every row of the global batch and sliced.
    The leading dim may be the rows times a factor (the b-major rollouts)."""
    if not _ROWS:
        return fn(tuple(shape), **kw)
    rows, total = _ROWS[-1]
    count = rows.stop - rows.start
    if shape[0] % count:
        raise ValueError(f"a draw of {shape[0]} rows for {count} local rows")
    k = shape[0] // count
    full = fn((total * k, *shape[1:]), **kw)
    return full[rows.start * k: rows.stop * k]


# ---------------------------------------------------------------------------
# Where a model's parameters lie, and the collectives that move them
# ---------------------------------------------------------------------------


def _split(t: torch.Tensor, dim: int, parts: int, index: int, by_heads: bool) -> torch.Tensor:
    """Piece ``index`` of ``parts`` along ``dim``: contiguous, or by heads
    (the same piece of each of three equal thirds, concatenated)."""
    if not by_heads:
        n = t.shape[dim] // parts
        return t.narrow(dim, index * n, n)
    thirds = t.unflatten(dim, (3, parts, t.shape[dim] // (3 * parts)))
    return thirds.select(dim + 1, index).flatten(dim, dim + 1)


def _join(pieces: Sequence[torch.Tensor], dim: int, by_heads: bool) -> torch.Tensor:
    """The inverse of :func:`_split` over every piece, in index order."""
    if not by_heads:
        return torch.cat(list(pieces), dim=dim)
    thirds = [p.unflatten(dim, (3, p.shape[dim] // 3)) for p in pieces]
    return torch.stack(thirds, dim=dim + 1).flatten(dim, dim + 2)


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


class ParamSharding:
    """How a model's parameters lie on a (data, fsdp, tensor) mesh.

    Three forms of a parameter:

    * the *full* tensor: the JAX tree's, what checkpoints and the weight
      bridge hold;
    * the *compute view*, the module's parameter: its tensor piece (the
      rank's heads or columns or rows, :data:`BY_HEADS`), whole over fsdp;
    * the *shard*: the compute view's fsdp piece, a view into it. The
      gradient reduction hands the optimizer the shards' gradients, the
      optimizer updates shards and keeps its moments at their shape, and
      :meth:`gather_shards` all-gathers the updated shards over fsdp.

    Between steps every rank holds the whole parameter over fsdp: the
    gradients after the reduction, the moments and the update are sharded
    as JAX places them, the parameters' memory is not (ZeRO-2's footprint
    rather than ZeRO-3's).

    Without a mesh (``mesh=None``: one device) every form is the parameter
    itself and every collective does nothing.
    """

    def __init__(self, params, mesh: Optional[DeviceMesh] = None):
        self.mesh = mesh
        self.sizes = {"data": 1, "fsdp": 1, "tensor": 1, **mesh_shape(mesh)}
        self.coord = mesh_coordinate(mesh) if mesh is not None else {a: 0 for a in self.sizes}
        self.ranks = math.prod(self.sizes.values())
        named = _named(params)
        self.names = [n for n, _ in named]
        self.full_shapes = {n: tuple(p.shape) for n, p in named}
        self.specs = param_shardings(named, mesh if mesh is not None else {})
        self.by_heads = {n: re.match(BY_HEADS, n) is not None for n in self.names}
        initialised = mesh is not None and dist.is_available() and dist.is_initialized()
        self.groups = {a: mesh.get_group(a) for a in ("data", "fsdp", "tensor")} if initialised else {}
        # the flattened (data, fsdp) mesh build_mesh made (a cached lookup)
        self.batch_group = mesh[("data", "fsdp")]._flatten("batch").get_group() if initialised else None

    def axis_dim(self, name: str, axis: str) -> Optional[int]:
        """The dim of parameter ``name`` split over ``axis``, or None."""
        for d, a in enumerate(self.specs[name]):
            if a == axis:
                return d
        return None

    def piece(self, name: str, t: torch.Tensor, axis: str) -> torch.Tensor:
        """This rank's piece along ``axis`` (``t`` itself where it is not split)."""
        d = self.axis_dim(name, axis)
        if d is None:
            return t
        heads = self.by_heads[name] and axis == "tensor"
        return _split(t, d, self.sizes[axis], self.coord[axis], heads)

    def compute_view(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return self.piece(name, full, "tensor")

    def shard(self, name: str, compute: torch.Tensor) -> torch.Tensor:
        return self.piece(name, compute, "fsdp")

    def owns(self, name: str) -> bool:
        """Whether this rank counts its piece of ``name`` in a global sum: each
        piece once, on the rank at coordinate 0 of every axis it is not split over."""
        used = set(self.specs[name])
        return all(self.coord[a] == 0 for a in ("data", "fsdp", "tensor") if a not in used)

    def grad_norm(self, shard_grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The f32 global norm of every rank's gradient shards, each piece counted once."""
        if self.ranks == 1:
            return global_norm(shard_grads)
        return global_norm(shard_grads, owned=[self.owns(n) for n in self.names])

    def grad_max_abs(self, shard_grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """max |g| over every rank's gradient shards."""
        return global_max_abs(shard_grads, sharded=self.ranks > 1)

    def _gather(self, name: str, t: torch.Tensor, axis: str) -> torch.Tensor:
        d = self.axis_dim(name, axis)
        if d is None:
            return t
        return _join(_all_gather(t, self.groups[axis]), d, self.by_heads[name] and axis == "tensor")

    def full(self, name: str, t: torch.Tensor, *, shard: bool = False) -> torch.Tensor:
        """The full tensor of a compute view, or of a shard (``shard=True``).
        A collective: every rank of the mesh calls it, in the same order."""
        if shard:
            t = self._gather(name, t, "fsdp")
        return self._gather(name, t, "tensor")

    def reduce_mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor averaged over the batch group (the data and fsdp ranks of
        this tensor coordinate), in one f32 all-reduce of their concatenation."""
        n = self.sizes["data"] * self.sizes["fsdp"]
        if n == 1 or not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.batch_group)
        flat.div_(n)
        return _unflatten(flat, tensors)

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """Every (data, fsdp) rank's ``t`` of this tensor coordinate, concatenated
        along dim 0 in batch order (the rows :func:`batch_slice` gives them)."""
        if self.sizes["data"] * self.sizes["fsdp"] == 1:
            return t
        return torch.cat(_all_gather(t, self.batch_group))

    def reduce_gradients(self, metrics: List[torch.Tensor], grads: List[torch.Tensor]):
        """(the metrics, the gradients) of the global batch from this rank's, each
        averaged over the batch group. A gradient split over fsdp comes back as
        this rank's shard of it: the fsdp-major concatenation of every such
        gradient is reduce-scattered over the fsdp ranks, and the shard then
        all-reduced over the data ranks. The metrics and the other gradients go
        in one all-reduce over the batch group (:meth:`reduce_mean`)."""
        fsdp = self.sizes["fsdp"]
        split = [fsdp > 1 and self.axis_dim(n, "fsdp") is not None for n in self.names]
        whole = self.reduce_mean(metrics + [g for g, s in zip(grads, split) if not s])
        metrics, whole = whole[:len(metrics)], iter(whole[len(metrics):])
        pieces = [(n, g) for n, g, s in zip(self.names, grads, split) if s]
        if not pieces:
            return metrics, list(whole)
        flat = torch.cat([_split(g, self.axis_dim(n, "fsdp"), fsdp, i, False).reshape(-1).float()
                          for i in range(fsdp) for n, g in pieces])
        mine = flat.new_empty(flat.numel() // fsdp)
        dist.reduce_scatter_tensor(mine, flat, group=self.groups["fsdp"])
        if self.sizes["data"] > 1:
            dist.all_reduce(mine, group=self.groups["data"])
        mine.div_(self.sizes["data"] * fsdp)
        shards = iter(_unflatten(mine, [self.shard(n, g) for n, g in pieces]))
        return metrics, [next(shards) if s else next(whole) for s in split]

    def gather_shards(self, params: Iterable[torch.Tensor]) -> None:
        """After an update of the shards: every rank's fsdp shards written into
        the compute views, in one all-gather of their concatenation."""
        if self.sizes["fsdp"] == 1:
            return
        views = [(name, p) for name, p in zip(self.names, params) if self.axis_dim(name, "fsdp") is not None]
        if not views:
            return
        mine = torch.cat([self.shard(name, p.data).reshape(-1) for name, p in views])
        for index, flat in enumerate(_all_gather(mine, self.groups["fsdp"])):
            start = 0
            for name, p in views:
                d = self.axis_dim(name, "fsdp")
                target = _split(p.data, d, self.sizes["fsdp"], index, False)
                target.copy_(flat[start:start + target.numel()].view(target.shape))
                start += target.numel()


def _unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``flat`` cut into tensors of the shapes and dtypes of ``like``, in order."""
    out, start = [], 0
    for t in like:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def model_sharding(model: nn.Module) -> ParamSharding:
    """The model's :class:`ParamSharding`: the one ``train/setup.py:create_sharded_model``
    attached, else (made once) that of one device, whose collectives do nothing."""
    sharding = getattr(model, "sharding", None)
    if sharding is None:
        sharding = model.sharding = ParamSharding(model)
    return sharding


def shard_state(tree: Dict[str, torch.Tensor], mesh: DeviceMesh,
                coordinate: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Each full tensor of a {path: tensor} state cut to the piece the rules
    give this rank (or the rank at ``coordinate``): its tensor piece, then its
    fsdp piece."""
    coord = mesh_coordinate(mesh) if coordinate is None else coordinate
    sizes = mesh_shape(mesh)
    out = {}
    for name, t in tree.items():
        spec = param_shardings({name: t}, mesh)[name]
        for axis in ("tensor", "fsdp"):
            if axis in spec:
                heads = axis == "tensor" and re.match(BY_HEADS, name.replace(".", "/")) is not None
                t = _split(t, spec.index(axis), sizes[axis], coord[axis], heads)
        out[name] = t
    return out
