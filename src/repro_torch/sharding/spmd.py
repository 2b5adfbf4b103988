"""The sharded train step on a (data, model) rank grid: what XLA's GSPMD
partitioner makes of the JAX launcher's ``jit(make_train_step)`` under a
mesh (``repro/launch/train.py:526-533``), written with explicit
collectives over ``torch.distributed``.  No JAX module is its
counterpart; it is held against the JAX package's single-device
``make_train_step``, whose loss GSPMD preserves.

**Storage.**  Each rank holds exactly its block of every leaf of
``params``, ``master``, ``m`` and ``v``, as the copied rules
(``rules.train_state_shardings``: ``fsdp=True``, ``hybrid`` for a hybrid
model) place it over the grid (:class:`Layout`); a spec entry that names
several axes orders the blocks major to minor, as JAX does.  The state
is built leaf by leaf from the seeded full initialisation
(:func:`init_state`): each leaf is sliced to the rank's block as soon as
it is drawn and the rest freed, so a rank never holds more than one
whole leaf, and with the same seed the blocks are the single device's
``make_train_state`` cut by the rules.

**Compute, model axis 1.**  Each rank runs its rows of the batch (split
over the data axes as ``rules.batch_shardings`` says; :func:`local_rows`).
The model is the single device's (``models.model.loss_fn``) given a
:class:`Gather`: before a layer runs, each of its leaves is gathered from
the blocks (all-gathers over the axes its spec names) inside the layer's
checkpoint, so the backward's recompute gathers it again and nothing
whole outlives its layer; the embedding, norm and head leaves are
gathered once a step.  The gather's backward reduce-scatters the leaf's
gradient back onto this rank's block (and all-reduces it over the axes
the spec does not name): a sum over the data ranks of each one's
gradient of its loss / D, the gradient of the global batch's mean loss.
AdamW then runs on the blocks (``optim.adamw``'s math), clipped by the
global norm summed from the blocks, each counted once.

**Compute, model axis > 1.**  Each model member computes its share of
every block, with explicit collectives over the grid's ``tp`` group
(``core.heteropp``'s ``_TPCopy``, identity forward and summed backward,
on each replicated input a member uses in part, and ``_TPReduce``, the
summed forward, on each member's part of an output); activations stay
replicated over the model axis.  :func:`member_cut` says which part of
each block leaf a member uses:

- attention and MLP (dense, vlm, the moe and whisper attention, whisper's
  encoder, decoder and cross-attention, zamba2's shared block): Megatron
  shards (``rules.tp_body_dim``: column ``wq wk wv bq bk bv wi wg``, row
  ``wo``) over the member's heads and ff slice; where the kv heads are
  fewer than the members, each member uses its query heads' kv head
  whole.  Whisper's cross K/V come from the replicated encoder output,
  which passes ``_TPCopy`` (:meth:`Gather.cross_kv`);
- moe: expert parallelism.  A member holds E / M experts, routes the
  replicated tokens with the whole router, fills and runs its experts'
  capacity buffer and combines them into its part of the output, which
  one all-reduce sums (``models.moe.moe_block(experts=)``);
- ssm (mamba2, zamba2's ssm blocks): head sharding.  A member owns nh / M
  heads: its dinner / M channels of z and x (in_proj's and the conv's
  columns), of ``dt``, ``A_log``, ``D``, ``dt_bias`` and the gated norm,
  and out_proj's rows (row-parallel).  B and C are every head's, so each
  member computes them whole; the gated norm's mean of squares is the
  model group's sum (``models.ssm.mamba2_forward(mean_sq=)``).

A part whose count the model axis does not split (:func:`whole_parts`:
``attention`` where M does not divide the query heads, or the kv heads
neither divide M nor are divided by it; ``mlp``, ``d_ff``; ``experts``;
``ssm``, the mamba2 heads) is computed whole on every member, as the
single device computes it, on the replicated activations: no
``_TPCopy`` in, no ``_TPReduce`` out.  Its leaves are gathered whole
(:func:`member_cut` gives them None), and the other parts of the same
block keep their shards.  The parts a grid computes whole are named in
each step's ``whole`` and ``stats["whole"]``, in the launcher's
metadata and in the dry-run's record; nothing is replicated without a
name.

Where the rules put the model axis on a leaf's member dim and the
member's part is its block, only the data axes are gathered; else the
leaf is gathered whole and the member's part taken from it.  The backward
sums each leaf's gradient over the members (each holds its part's, zero
elsewhere, or, for a leaf every member uses in part, such as B and C's
columns, the router or a shared kv head, a partial sum); a leaf every
member computes alike (norms, embeddings, a whole part's leaves) is
sliced to the member's rule block, or averaged where its spec does not
name the model axis: each member holds the same whole gradient, which a
sum would count M times.  A moe block's auxiliary and z losses are
alike on every member, so where its experts are sharded their gradient
is scaled by 1 / M before the sums, which count it once; with the
experts whole the router is such an alike leaf and the losses keep
their weight.

**What is exact.**  The persistent state is exactly what the JAX rules
give each device.  Only the transient activation layout departs from
GSPMD's: GSPMD keeps sequence-parallel activations between blocks
(``sp=True``); here they are whole rows of the rank's batch, replicated
over the model axis.  A moe model's load-balance loss takes its expert
fractions over the whole batch (:class:`Gather` gives ``moe_block`` the
data ranks' sum of its top-1 counts), as the single device's does.  The batch must split evenly over the data axes
(where GSPMD would replicate a batch that does not, this raises).

**Counts.**  The step's ``stats`` after each call: the bytes, calls and
wall ms of the step's all-gathers, reduce-scatters and all-reduces by
axis (``data``, ``model``, ``world``); :func:`state_bytes` the rank's
persistent bytes, :func:`block_bytes` their closed form from the specs.
On a grid of counting stand-ins (``comm.p2p.Grid.standin``) the same
step runs on meta tensors (:func:`abstract_state`, ``read_metrics``
False) and counts each collective without moving it: the dry-run's
estimate (``launch/dryrun.py``).

**Serving.**  :func:`make_prefill_step` and :func:`make_decode_step` are
the JAX dry-run's sharded serve steps (``repro/launch/dryrun.py:171-191``)
on the same grid: the weights are the rank's blocks under the FSDP
placement (:func:`param_specs`), gathered layer by layer as in training;
a batch the data axes do not divide is replicated over them; and each
rank holds exactly its block of the cache as ``rules.cache_shardings``
places it (:class:`KVCut`): an attention cache's kv heads over the model
axis (each member decodes its own heads' block), else its sequence (each
member holds a slot range of every kv head, decodes every head over it
with ``flash_decode``'s slot offset and log-sum-exp, and the members'
partials are combined, :func:`combine_partials`), else the whole cache
on every member (the only placements of a whole attention's cache: kv
heads the model axis divides would make it a sharded one); an ssm
state's heads over the model axis, its conv window whole on every
member (:class:`ServeGather`).  Where the rule
places a cache by other dims than the step computes on (a hybrid
model's stacked (G, per, B, ...) ssm cache: its ``per`` over data, its
batch or conv channels over model, or its state whole), each rank still
stores the rule's block and the step moves it to the block its layers
compute on and back once a group (:meth:`Layout.reblock`), counted as
every collective is: what GSPMD does implicitly.  A whisper cross cache
(L, B, S_enc, KV, hd) carries its sequence at dim 2, which :class:`KVCut`
is told.  The weights a decode step takes are :func:`decode_params`.
A whole part runs as the single device runs it, over the rank's block
of the cache: a whole attention decodes every head on its slots and
applies ``wo`` whole, a whole ssm part's state is moved to every head
of it and back where the rule shards it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..comm.p2p import CountingComm
from ..core.dataparallel.grad_sync import replica_grad_norm
from ..core.heteropp import _TPCopy, _TPReduce, _tp_block_forward, _tp_local_cfg
from ..models import attention, layers, moe as moe_lib, ssm as ssm_lib, transformer as tfm
from ..kernels import ops as kops
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw
from ..training.serve_step import abstract_serve_cache, cache_plan
from ..training.train_step import TrainState, abstract_train_state, train_state_from
from ..tree import flatten, tree_leaves
from . import rules

PyTree = Any


def _unflatten(flat: Dict[str, Any]) -> PyTree:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return out


def _all_gather(comm, part: torch.Tensor, dim: int) -> torch.Tensor:
    shape = list(part.shape)
    shape[dim] *= comm.world_size
    out = torch.empty(shape, dtype=part.dtype, device=part.device)
    return comm.all_gather_(out, part.contiguous(), dim)


class Layout:
    """One rank's place on a mesh (``launch.mesh.make_local_mesh``'s
    mesh and grid): its coordinates, the blocks of a spec it holds, and
    the collectives that move a leaf between its blocks and its whole.
    The model axis is the grid's ``tp`` group, the data axes (pod major)
    its ``dp`` group; a spec entry naming some data axes without the
    others has no group and raises."""

    def __init__(self, mesh, grid):
        self.mesh, self.grid = mesh, grid
        self.data_axes = rules.data_axes(mesh)
        self.model_axis = rules.model_axis(mesh)
        self.data = math.prod(mesh.shape[a] for a in self.data_axes)
        self.model = mesh.shape[self.model_axis] if self.model_axis else 1
        if self.data * self.model != grid.D * grid.T or grid.S != 1:
            raise ValueError(f"a mesh of {dict(mesh.shape)} on a grid of (dp {grid.D}, "
                             f"pipe {grid.S}, tp {grid.T})")
        self._subs: Dict[str, Any] = {}

    def units(self, entry) -> Tuple[str, ...]:
        """An entry's axes as the groups that hold them, major to minor:
        ``"model"``, ``"data"`` (every data axis, in order) or, for one
        data axis named without the others (the cache rule's fallback
        onto the first, ``pod`` on a two-pod mesh), ``"data.<axis>"``."""
        axes, out, i = rules.entry_axes(entry), [], 0
        while i < len(axes):
            if axes[i] == self.model_axis:
                out.append("model")
                i += 1
                continue
            run = tuple(axes[i:i + len(self.data_axes)])
            if run == self.data_axes:
                out.append("data")
                i += len(run)
            elif axes[i] in self.data_axes:
                out.append("data." + axes[i])
                i += 1
            else:
                raise NotImplementedError(f"spec entry {entry!r}: the mesh {dict(self.mesh.shape)} "
                                          f"has no axis {axes[i]!r}")
        return tuple(out)

    def comm(self, unit):
        if unit == "model":
            return self.grid.tp
        if unit == "data":
            return self.grid.dp
        return self._sub(unit[len("data."):])

    def _sub(self, axis):
        """The group of the ranks that differ in data axis ``axis`` alone:
        a counting stand-in on a stand-in grid; a live grid's local meshes
        name one data axis, so there it raises."""
        if axis not in self._subs:
            if self.mesh.shape[axis] == 1:
                self._subs[axis] = None
            elif not isinstance(self.grid.dp, CountingComm):
                raise NotImplementedError(
                    f"the data axis {axis!r} alone of {self.data_axes}: a live grid holds "
                    f"the data axes as one group")
            else:
                self._subs[axis] = CountingComm(self.mesh.shape[axis],
                                                self.index("data." + axis))
        return self._subs[axis]

    def size(self, unit) -> int:
        if unit == "model":
            return self.model
        return self.data if unit == "data" else self.mesh.shape[unit[len("data."):]]

    def index(self, unit) -> int:
        if unit == "model":
            return self.grid.k
        if unit == "data":
            return self.grid.d
        axis = unit[len("data."):]               # the data axes' index, pod major
        inner = math.prod(self.mesh.shape[a]
                          for a in self.data_axes[self.data_axes.index(axis) + 1:])
        return self.grid.d // inner % self.mesh.shape[axis]

    def block_slices(self, spec, shape):
        """(dim, start, length) of this rank's block of a leaf."""
        out = []
        for dim, entry in enumerate(spec):
            n, idx = 1, 0
            for u in self.units(entry):
                n, idx = n * self.size(u), idx * self.size(u) + self.index(u)
            if n == 1:
                continue
            if shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split into "
                                 f"{n} blocks ({entry!r})")
            w = shape[dim] // n
            out.append((dim, idx * w, w))
        return out

    def block(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the whole leaf ``t``, a new tensor."""
        for dim, start, w in self.block_slices(spec, t.shape):
            t = t.narrow(dim, start, w)
        return t.clone(memory_format=torch.contiguous_format)

    def copies(self, spec) -> int:
        """How many ranks hold each block of a leaf of this spec."""
        named = math.prod(self.size(u) for e in spec for u in self.units(e))
        return self.data * self.model // named

    def gather(self, block: torch.Tensor, spec) -> torch.Tensor:
        """The whole leaf from every rank's block (all-gathers, minor axis
        first)."""
        x = block
        for dim, entry in enumerate(spec):
            for u in reversed(self.units(entry)):
                comm = self.comm(u)
                if comm is not None:
                    x = _all_gather(comm, x, dim)
        return x

    def reblock(self, block: torch.Tensor, from_spec, to_spec, shape) -> torch.Tensor:
        """This rank's ``to_spec`` block of a leaf of whole shape ``shape``
        whose ``from_spec`` block it holds: the all-gathers over the axes
        ``from_spec`` names (:meth:`gather`, counted as every collective
        is), narrowed to the ``to_spec`` block, a new tensor (``block``
        itself where the specs agree).  What GSPMD does implicitly between
        two placements of a leaf."""
        if tuple(from_spec) == tuple(to_spec):
            return block
        x = self.gather(block, from_spec)
        for dim, start, w in self.block_slices(to_spec, shape):
            x = x.narrow(dim, start, w)
        return x.clone(memory_format=torch.contiguous_format)

    def reduce(self, full: torch.Tensor, spec, *, model: str = "sum",
               data: bool = True) -> torch.Tensor:
        """This rank's block of the sum of every rank's ``full`` (a whole
        leaf's gradient, this rank's part of it): a reduce-scatter over
        each axis the spec names, an all-reduce over the others.  Over
        the model axis, ``model`` says what the members' parts are:
        ``"sum"``, parts of the whole (a Megatron shard's gradient, zero
        elsewhere); ``"equal"``, alike (computed on replicated
        activations): the block is sliced, or averaged where the spec
        does not name the axis; ``"local"``, already this member's block
        along the model axis (its Megatron shard), which the spec then
        leaves out: no model collective.  With ``data`` False the data
        axes are left alone (ZeRO-1 reduces them once a step)."""
        x, named = full, set()
        for dim, entry in enumerate(spec):
            for u in self.units(entry):
                named.add(u)
                comm = self.comm(u)
                if comm is None or (u == "data" and not data):
                    continue
                if u == "model" and model == "equal":
                    w = x.shape[dim] // comm.world_size
                    x = x.narrow(dim, comm.rank * w, w)
                else:
                    x = comm.reduce_scatter_(x, dim)
        if x is full or not x.is_contiguous():
            x = x.contiguous().clone()
        if data and "data" not in named and self.grid.dp is not None:
            self.grid.dp.all_reduce_(x)
        if "model" not in named and self.grid.tp is not None and model != "local":
            self.grid.tp.all_reduce_(x)
            if model == "equal":
                x.div_(self.model)
        return x

    def routing_sum(self, counts: torch.Tensor, n: int):
        """``models.moe.moe_block``'s ``routing_sum``: top-1 counts and
        tokens over the data ranks."""
        return self.grid.dp.all_reduce_(counts.clone()), n * self.data

    def groups(self):
        """The groups of each axis the counts are given by: a data axis
        alone (:meth:`_sub`) counts as ``data``."""
        subs = [c for c in self._subs.values() if c is not None]
        return {"data": [self.grid.dp] + subs, "model": [self.grid.tp],
                "world": [self.grid.world]}

    def reset_counts(self) -> None:
        for comms in self.groups().values():
            for comm in comms:
                if comm is not None:
                    comm.reset_counts()

    def counts(self) -> Dict[str, float]:
        """The collectives since :meth:`reset_counts`, by axis: bytes
        (all-gathers: what arrives; reduce-scatters and all-reduces: the
        tensors given), calls and wall ms."""
        out = {}
        for axis, comms in self.groups().items():
            comms = [c for c in comms if c is not None]
            for kind in ("gather", "scatter", "reduce"):
                out[f"{axis}_{kind}_bytes"] = sum(getattr(c, kind + "_bytes") for c in comms)
                out[f"{axis}_{kind}_calls"] = sum(getattr(c, kind + "_calls") for c in comms)
                out[f"{axis}_{kind}_ms"] = sum(getattr(c, kind + "_seconds")
                                               for c in comms) * 1e3
        return out


class _Gathered(torch.autograd.Function):
    """A leaf gathered whole from this rank's block; the backward
    reduces its gradient back onto the block (``Layout.reduce``)."""

    @staticmethod
    def forward(ctx, block, layout, spec, model, data):
        ctx.args = (layout, spec, model, data)
        return layout.gather(block, spec)

    @staticmethod
    def backward(ctx, g):
        layout, spec, model, data = ctx.args
        return layout.reduce(g, spec, model=model, data=data), None, None, None, None


class _AllSum(torch.autograd.Function):
    """The sum over the model group in the forward and in the backward:
    a total that every member computes from its part and uses whole (the
    gated norm's sum of squares)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_(g.contiguous().clone()), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``s`` backward."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _experts_sum(y, tp):
    """A moe block's output: the members' expert combines summed."""
    return _TPReduce.apply(y, tp)


def _norm_mean_sq(xf, tp):
    """The gated norm's mean of squares over the whole dinner, from this
    member's channels ``xf``: the model group's sum of squares."""
    total = _AllSum.apply(xf.square().sum(dim=-1, keepdim=True), tp)
    return total / (xf.shape[-1] * tp.world_size)


# the part of a block each leaf's path belongs to, by the key that names it
_PART_KEYS = (("ssm", "ssm"), ("moe", "experts"), ("mlp", "mlp"), ("attn", "attention"),
              ("xattn", "attention"))


def whole_parts(cfg: ModelConfig, model: int) -> Dict[str, str]:
    """The parts of a block that each member of a model axis of ``model``
    computes whole, each with the count that does not split over the
    members: ``attention`` (``num_heads`` the axis does not divide, or
    ``num_kv_heads`` that neither divide it nor are divided by it; whisper's
    encoder, decoder and cross attention and zamba2's shared block follow
    it), ``mlp`` (``d_ff``), ``experts`` (``num_experts``) and ``ssm``
    (``ssm_nheads``, mamba2's and zamba2's ssm blocks).  Empty where every
    part splits.  ``analysis.card_lint.member_heads`` reads the heads a
    member computes from it."""
    out: Dict[str, str] = {}
    if model == 1:
        return out
    if cfg.family != "ssm":
        H, KV = cfg.num_heads, cfg.num_kv_heads
        if H % model:
            out["attention"] = f"num_heads={H}"
        elif KV % model and model % KV:
            out["attention"] = f"num_kv_heads={KV}"
    if cfg.family not in ("ssm", "moe") and cfg.d_ff % model:
        out["mlp"] = f"d_ff={cfg.d_ff}"
    if cfg.family == "moe" and cfg.num_experts % model:
        out["experts"] = f"num_experts={cfg.num_experts}"
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_nheads % model:
        out["ssm"] = f"ssm_nheads={cfg.ssm_nheads}"
    return out


def part_of(path: str) -> Optional[str]:
    """The block part (:func:`whole_parts`' names) a parameter path lies in,
    None for a norm, an embedding or a position table."""
    keys = path.split("/")
    return next((part for key, part in _PART_KEYS if key in keys), None)


def member_cut(cfg: ModelConfig, M: int, k: int):
    """``cut(path, shape)`` for a leaf of whole shape ``shape``: None where
    member ``k`` of ``M`` uses it whole and alike with the others (norms,
    embeddings, positions, every leaf of a part it computes whole,
    :func:`whole_parts`), else (dim, ranges): the ranges (start, length)
    of dim ``dim`` (counted from the end) it computes with, in order,
    gathered whole where they are not its block."""
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    whole = whole_parts(cfg, M)

    def ssm(name):
        di, nh = cfg.ssm_dinner, cfg.ssm_nheads
        bc, ch, hh = 2 * cfg.ssm_ngroups * cfg.ssm_state, di // M, nh // M
        x, heads = (k * ch, ch), (k * hh, hh)
        return {"in_proj": (-1, [x, (di + k * ch, ch), (2 * di, bc),
                                 (2 * di + bc + k * hh, hh)]),
                "conv_w": (-1, [x, (di, bc)]), "conv_b": (-1, [x, (di, bc)]),
                "A_log": (-1, [heads]), "D": (-1, [heads]), "dt_bias": (-1, [heads]),
                "scale": (-1, [x]), "out_proj": (-2, [x])}[name]

    def cut(path, shape):
        if part_of(path) in whole:
            return None
        parts = path.split("/")
        name = parts[-1]
        if "ssm" in parts:
            return ssm(name)
        if "moe" in parts:
            n = cfg.num_experts // M
            return (-1, [(0, shape[-1])]) if name == "router" else (-3, [(k * n, n)])
        stacked = 0 if parts[0] == "shared_attn" else \
            2 if cfg.family == "hybrid" and parts[0] == "blocks" else 1
        d = rules.tp_body_dim(path, len(shape) - stacked)
        if d is None:
            return None
        dim = d - (len(shape) - stacked)
        if name in ("wk", "wv", "bk", "bv") and KV < M:
            return dim, [(k * KV // M * hd, hd)]        # its query heads' kv head
        w = shape[dim] // M
        return dim, [(k * w, w)]

    return cut


class Gather:
    """The model's access to one rank's blocks (``models.model.loss_fn(...,
    gather=)``): ``gather(tree, where)`` gathers a (sub)tree whose path in
    the params is ``where`` (a layer of a stack, a hybrid group, or a
    whole non-stacked entry), and ``block`` runs one block on what it
    returns.  At model > 1 a block's leaves come back as this member's
    parts of them (:func:`member_cut`) and ``block`` is the member's share
    of the block (:meth:`member_block`).  ``data`` False leaves the data
    axes out of the backward (ZeRO-1); ``routing`` is the moe blocks'
    ``routing_sum`` (:meth:`Layout.routing_sum`)."""

    def __init__(self, cfg: ModelConfig, layout: Layout, specs: Dict[str, Any],
                 shapes: Dict[str, Tuple[int, ...]], *, data: bool = True, routing=None):
        self.cfg, self.layout, self.specs, self.shapes = cfg, layout, specs, shapes
        self.data, self.routing = data, routing
        M, k = layout.model, layout.grid.k
        self.tp = M > 1
        self.whole = whole_parts(cfg, M)
        self.lcfg = _tp_local_cfg(cfg, M, self.whole)
        self.cut = member_cut(cfg, M, k)
        self.experts = (k * cfg.num_experts // M, cfg.num_experts // M) \
            if cfg.family == "moe" and "experts" not in self.whole else None

    def __call__(self, tree, where: str):
        layout = self.layout

        def one(path, leaf):
            full = self.shapes[path]
            spec = self.specs[path][len(full) - leaf.ndim:]
            cut = self.cut(path, full) if self.tp else None
            if cut is None:
                return _Gathered.apply(leaf, layout, spec, "equal", self.data)
            dim, ranges = cut
            d, w = leaf.ndim + dim, full[dim] // layout.model
            if ranges == [(layout.grid.k * w, w)] and \
                    rules.entry_axes(spec[d]) == (layout.model_axis,):
                own = spec[:d] + (None,) + spec[d + 1:]
                return _Gathered.apply(leaf, layout, own, "local", self.data)
            x = _Gathered.apply(leaf, layout, spec, "sum", self.data)
            parts = [x.narrow(d, start, n) for start, n in ranges]
            return parts[0] if len(parts) == 1 else torch.cat(parts, d)

        return rules.map_with_path(one, tree, where + "/")

    def block(self, p, cfg, x, kind, *, backend="auto", **kw):
        if not self.tp:
            return tfm.block_forward(p, cfg, x, kind, backend=backend,
                                     routing_sum=self.routing, **kw)
        return self.member_block(p, cfg, x, kind, backend=backend, **kw)

    def cross_kv(self, p, cfg, enc):
        """A decoder layer's cross K/V (``attention.encode_cross_kv``): at
        model > 1 this member's kv heads, from the replicated encoder
        output, whose gradient is then the members' sum."""
        if not self.tp or "attention" in self.whole:
            return attention.encode_cross_kv(p, cfg, enc)
        return attention.encode_cross_kv(p, self.lcfg, _TPCopy.apply(enc, self.layout.grid.tp))

    def block_whole(self, kind) -> Tuple[str, ...]:
        """The sub-blocks of a ``kind`` block computed whole
        (``heteropp._tp_block_forward``'s ``whole``): ``"attention"``, and
        ``"ffn"`` where its MLP (a moe block's experts) is whole."""
        ffn = "experts" if kind == "moe" else "mlp"
        return tuple(w for w, part in (("attention", "attention"), ("ffn", ffn))
                     if part in self.whole)

    def member_block(self, p, cfg, x, kind, *, backend="auto", **kw):
        """This member's share of one block on the replicated ``x``, each
        part of an output summed over the model group before its residual
        add: the Megatron block (``heteropp._tp_block_forward``; a moe
        block's experts in its MLP's place), or a mamba2 block's heads; a
        part computed whole (:func:`whole_parts`) is the single device's.
        Returns (x, metrics) as ``transformer.block_forward``."""
        tp, M = self.layout.grid.tp, self.layout.model
        if kind == "ssm":
            if "ssm" in self.whole:
                return tfm.block_forward(p, cfg, x, kind, backend=backend)
            h = _TPCopy.apply(layers.apply_norm(p["ln1"], x, cfg.norm), tp)
            y, _, _ = ssm_lib.mamba2_forward(p["ssm"], cfg, h, backend=backend,
                                             mean_sq=lambda xf: _norm_mean_sq(xf, tp))
            return x + _TPReduce.apply(y, tp), {}
        ffn = None
        if kind == "moe" and "experts" in self.whole:
            def ffn(h):
                return moe_lib.moe_block(p["moe"], cfg, h, self.routing)
        elif kind == "moe":
            def ffn(h):
                y, m = moe_lib.moe_block(p["moe"], cfg, h, self.routing, experts=self.experts)
                return _experts_sum(y, tp), {
                    k: _ScaleGrad.apply(v, 1.0 / M) if k in ("moe_aux_loss", "moe_z_loss")
                    else v for k, v in m.items()}
        return _tp_block_forward(p, cfg, self.lcfg, x, tp, backend=backend, ffn=ffn,
                                 whole=self.block_whole(kind), **kw)


# ---------------------------------------------------------------------------
# the state
# ---------------------------------------------------------------------------

def state_specs(cfg: ModelConfig, mesh, *, fsdp: bool = True) -> TrainState:
    """The JAX launcher's placement: ``rules.train_state_shardings`` of
    the abstract state."""
    return rules.train_state_shardings(abstract_train_state(cfg), mesh,
                                       hybrid=cfg.family == "hybrid", fsdp=fsdp)


def _creation_order(cfg: ModelConfig):
    """The parameter paths in the order the initializers make them (the
    generator's draw order), from a pass on the meta device."""
    made = []
    with layers.leaf_hook(lambda t: made.append(t) or t):
        meta = M.abstract_params(cfg)
    path_of = {id(t): path for path, t in flatten(meta).items()}
    return [path_of[id(t)] for t in made]


def init_state(cfg: ModelConfig, layout: Layout, specs: TrainState,
               generator: torch.Generator, *, device) -> TrainState:
    """This rank's blocks of the seeded single-device state
    (``make_train_state(cfg, generator)``), built leaf by leaf: each
    parameter is drawn whole, cut to its parameter and master blocks
    (``specs.params``, ``specs.opt_state["master"]``) and freed; m and v
    are zeros of the master's blocks."""
    pspecs, ospecs = flatten(specs.params), flatten(specs.opt_state["master"])
    order = iter(_creation_order(cfg))
    masters: Dict[str, torch.Tensor] = {}

    def keep(t):
        path = next(order)
        masters[path] = layout.block(t, ospecs[path]).float()
        return layout.block(t, pspecs[path])

    with layers.leaf_hook(keep):
        params = M.init_params(cfg, generator, device=device)
    master = _unflatten({p: masters[p] for p in sorted(masters)})
    zeros = lambda: _unflatten({p: torch.zeros_like(t) for p, t in sorted(masters.items())})
    return train_state_from(params, {"master": master, "m": zeros(), "v": zeros()}, 0)


def tree_blocks(tree: PyTree, layout: Layout, specs: Dict[str, Any]) -> PyTree:
    """This rank's blocks of a whole tree of weights or of a serve cache
    (meta tensors too: the dry-run's), ``specs`` a flat dict of specs by
    path (:func:`cache_leaves`' paths)."""
    return cache_tree({p: layout.block(t, specs[p]) for p, t in cache_leaves(tree).items()})


def abstract_state(cfg: ModelConfig, layout: Layout, specs: TrainState) -> TrainState:
    """This rank's blocks of the state on the meta device, nothing drawn
    or allocated: ``abstract_train_state`` cut by ``specs`` as
    :func:`init_state` cuts the drawn one."""
    whole = abstract_train_state(cfg)
    cut = lambda tree, spec: tree_blocks(tree, layout, flatten(spec))
    return train_state_from(cut(whole.params, specs.params),
                            {k: cut(whole.opt_state[k], specs.opt_state[k])
                             for k in ("master", "m", "v")}, 0)


def state_bytes(state: TrainState) -> int:
    """The rank's persistent bytes: parameters, master, m and v."""
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(state.params) + tree_leaves(state.opt_state))


def block_bytes(cfg: ModelConfig, layout: Layout, specs: TrainState) -> Dict[str, int]:
    """The closed form of a rank's persistent bytes: each leaf's bytes
    over the number of blocks its spec makes, by part (params, master,
    m, v)."""
    abstract = abstract_train_state(cfg)
    out = {}
    for part, tree, spec in (("params", abstract.params, specs.params),
                             *((k, abstract.opt_state[k], specs.opt_state[k])
                               for k in ("master", "m", "v"))):
        sp = flatten(spec)
        out[part] = sum(t.numel() * t.element_size() * layout.copies(sp[p])
                        // (layout.data * layout.model)
                        for p, t in flatten(tree).items())
    return out


def full_state(state: TrainState, layout: Layout, specs: TrainState) -> TrainState:
    """The whole state on the CPU, gathered leaf by leaf (every rank takes
    part; each gets every leaf), for a single-device checkpoint."""
    def whole(tree, spec):
        sp = flatten(spec)
        with torch.no_grad():
            return _unflatten({p: layout.gather(t.detach(), sp[p]).to("cpu", copy=True)
                               for p, t in flatten(tree).items()})

    return TrainState(whole(state.params, specs.params),
                      {k: whole(state.opt_state[k], specs.opt_state[k])
                       for k in ("master", "m", "v")}, state.step)


def shard_state(read, layout: Layout, specs: TrainState, *, device) -> TrainState:
    """This rank's blocks of a whole state read leaf by leaf: ``read(name)``
    is a leaf of the single-device checkpoint format (``0/<path>``,
    ``1/{master,m,v}/<path>``, ``2`` the step)."""
    def part(prefix, spec):
        return _unflatten({p: layout.block(read(f"{prefix}/{p}"), s).to(device)
                           for p, s in flatten(spec).items()})

    opt = {k: part(f"1/{k}", specs.opt_state[k]) for k in ("master", "m", "v")}
    return train_state_from(part("0", specs.params), opt, int(read("2")))


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

def local_rows(batch_size: int, layout: Layout, accum_steps: int = 1, *,
               serving: bool = False) -> torch.Tensor:
    """The global batch rows this rank takes, microbatch-major: of each of
    the ``accum_steps`` microbatches (consecutive row blocks, as the
    single device splits them), the block ``rules.batch_shardings`` gives
    this rank's data index.  ``serving``: a batch the rules do not split
    over the data axes is replicated over them (every row on every rank),
    as GSPMD replicates it; training refuses it."""
    if batch_size % accum_steps:
        raise ValueError(f"batch {batch_size} does not split into {accum_steps} "
                         f"microbatches")
    mb = batch_size // accum_steps
    spec = rules.batch_shardings(torch.empty((mb,), device="meta"), layout.mesh)
    if serving and spec[0] is None:
        return torch.arange(batch_size)
    if layout.data > 1 and layout.units(spec[0]) != ("data",):
        raise NotImplementedError(
            f"a microbatch of {mb} rows does not split over the data axes "
            f"{dict((a, layout.mesh.shape[a]) for a in layout.data_axes)}; the port "
            f"takes batches that divide by the data degree")
    per = mb // layout.data
    start = layout.grid.d * per
    return torch.cat([torch.arange(i * mb + start, i * mb + start + per)
                      for i in range(accum_steps)])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def grads_and_metrics(cfg, state, batch, gather, *, accum_steps, remat, backend,
                      scale, remat_policy=None, accum_dtype="float32"):
    """Each microbatch's loss (``M.loss_fn`` through ``gather``) and the
    gradient of ``scale`` x it w.r.t. the rank's blocks, accumulated in
    ``accum_dtype`` and averaged over ``accum_steps`` as the single
    device's step does.  Returns (block gradients in leaf order, the rank's mean loss
    and metrics as one fp32 vector, the metric names)."""
    leaves = tree_leaves(state.params)
    mbs = [{k: v.chunk(accum_steps, dim=0)[i] for k, v in batch.items()}
           for i in range(accum_steps)]
    grads, sums, names = None, None, None
    for mb in mbs:
        loss, metrics = M.loss_fn(state.params, cfg, mb, remat=remat,
                                  remat_policy=remat_policy, backend=backend,
                                  gather=gather)
        g = torch.autograd.grad(loss * scale, leaves)
        if accum_steps > 1:
            g = [t.to(layers.DTYPES[accum_dtype]) for t in g]
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        names = ["loss"] + sorted(metrics)
        vec = torch.stack([loss.detach().float()] +
                          [metrics[k].detach().float() for k in names[1:]])
        sums = vec if sums is None else sums + vec
    if accum_steps > 1:
        grads = [g / accum_steps for g in grads]
        sums = sums / accum_steps
    return grads, sums, names


def read_out(names, vec, opt_m, read: bool = True) -> Dict[str, Any]:
    """A step's metrics by name from the vector of its loss and model
    metrics and the optimizer's: floats read from the device, or with
    ``read`` False the 0-d tensors (a step on meta tensors has nothing
    to read)."""
    if not read:
        return dict(zip(names, vec.unbind(0)), grad_norm=opt_m["grad_norm"], lr=opt_m["lr"])
    out = dict(zip(names, vec.tolist()))
    out.update(grad_norm=float(opt_m["grad_norm"]), lr=opt_m["lr"])
    return out


def make_train_step(cfg: ModelConfig, layout: Layout,
                    opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                    accum_steps: int = 1, accum_dtype: str = "float32",
                    remat: bool = True, remat_policy=None, backend: str = "auto",
                    read_metrics: bool = True):
    """``train_step(state, batch) -> (state, metrics)`` on this rank's
    blocks (:func:`init_state`) and rows (:func:`local_rows`); the
    metrics are the single device's (the loss and each model metric the
    mean over the data ranks) as floats (0-d tensors with
    ``read_metrics`` False: :func:`read_out`); ``train_step.stats`` holds
    the last step's collectives (:meth:`Layout.counts`) and, under
    ``"whole"``, the parts each member computes whole
    (:func:`whole_parts`, also ``train_step.whole``);
    ``train_step.specs`` the state's specs.  ``remat_policy`` as
    ``models.model.loss_fn``'s, ``accum_dtype`` as the single device's
    ``make_train_step``'s."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    specs = state_specs(cfg, layout.mesh)
    pspecs = flatten(specs.params)
    shapes = {p: tuple(t.shape) for p, t in flatten(M.abstract_params(cfg)).items()}
    moe = cfg.family == "moe" and layout.grid.dp is not None
    gather = Gather(cfg, layout, pspecs, shapes,
                    routing=layout.routing_sum if moe else None)
    leaf_specs = [pspecs[p] for p in sorted(pspecs)]
    D = layout.data

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        layout.reset_counts()
        grads, vec, names = grads_and_metrics(
            cfg, state, batch, gather, accum_steps=accum_steps, remat=remat,
            remat_policy=remat_policy, accum_dtype=accum_dtype, backend=backend,
            scale=1.0 / D)
        with torch.no_grad():
            if layout.grid.dp is not None:
                layout.grid.dp.all_reduce_(vec).div_(D)
            gnorm = replica_grad_norm(grads, leaf_specs, dict(layout.mesh.shape),
                                      layout.grid.world.all_reduce_)
            it = iter(grads)
            gtree = _unflatten({p: next(it) for p in sorted(pspecs)})
            _, _, opt_m = adamw.apply_update(opt_cfg, state.opt_state, gtree, state.step,
                                             state.params, grad_norm=gnorm)
        state.step += 1
        train_step.stats = dict(layout.counts(), whole=dict(gather.whole))
        return state, read_out(names, vec, opt_m, read_metrics)

    train_step.stats = {}
    train_step.specs = specs
    train_step.whole = dict(gather.whole)
    return train_step


# ---------------------------------------------------------------------------
# serving: the sharded prefill and decode steps
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The JAX dry-run's placement of the served weights, by path:
    ``rules.tree_param_shardings`` (FSDP, so the weights are sharded over
    the data axes in serving too)."""
    return flatten(rules.tree_param_specs(M.abstract_params(cfg), mesh,
                                          hybrid=cfg.family == "hybrid", fsdp=True))


def init_params(cfg: ModelConfig, layout: Layout, generator: torch.Generator, *,
                device) -> PyTree:
    """This rank's blocks of the seeded single-device parameters
    (``M.init_params(cfg, generator)``), each leaf cut as it is drawn."""
    specs = param_specs(cfg, layout.mesh)
    order = iter(_creation_order(cfg))
    with layers.leaf_hook(lambda t: layout.block(t, specs[next(order)])):
        return M.init_params(cfg, generator, device=device)


def cache_leaves(tree: PyTree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of a serve cache: dicts by key, a whisper cache's
    cross (k, v) pair by index (``cross/0``, ``cross/1``)."""
    if isinstance(tree, (dict, tuple)):
        items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
        out: Dict[str, torch.Tensor] = {}
        for k, v in items:
            out.update(cache_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def cache_tree(flat: Dict[str, torch.Tensor]) -> PyTree:
    """:func:`cache_leaves`' inverse."""
    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return tuple(node[str(i)] for i in range(len(node)))
        return node

    return fix(_unflatten(flat))


def _cache_specs(cache: PyTree, mesh) -> Dict[str, Any]:
    return {p: rules.cache_shardings(t, mesh) for p, t in cache_leaves(cache).items()}


def cache_specs(cfg: ModelConfig, mesh, batch: int, seq_len: int) -> Dict[str, Any]:
    """The JAX dry-run's placement of the decode cache, by path:
    ``rules.cache_shardings`` of ``abstract_serve_cache(cfg, batch,
    seq_len)``."""
    return _cache_specs(abstract_serve_cache(cfg, batch, seq_len), mesh)


def _whole_cache_specs(cfg, mesh, batch, cache_len):
    """The rule's specs of a cache of ``cache_len`` slots (a prefill's) and
    its leaves on the meta device, by path."""
    whole = M.init_cache(cfg, batch, cache_len, device=torch.device("meta"))
    return _cache_specs(whole, mesh), cache_leaves(whole)


def cache_block_bytes(cfg: ModelConfig, layout: Layout, batch: int, cache_len: int) -> int:
    """The closed form of a rank's cache bytes: each leaf's bytes over the
    number of blocks its spec makes."""
    specs, whole = _whole_cache_specs(cfg, layout.mesh, batch, cache_len)
    return sum(t.numel() * t.element_size() * layout.copies(specs[p])
               // (layout.data * layout.model) for p, t in whole.items())


def cache_bytes(cache: PyTree) -> int:
    return sum(t.numel() * t.element_size() for t in cache_leaves(cache).values())


class KVCut:
    """Where a rank's block of an attention cache lies under the rule's
    spec, the cache's kv heads at dim ``heads`` of ``shape`` and its
    slots at dim ``seq`` (a self cache (L, B, KV, S, hd): 2 and 3; a
    whisper cross cache (L, B, S_enc, KV, hd): 3 and 2): ``mode``
    ``"heads"`` (its members' kv heads, every slot: the Megatron block's
    own), ``"seq"`` (every kv head, slots ``slot0`` … ``slot0 + slots -
    1`` of ``cache_len``) or ``"whole"`` (every kv head and slot on every
    member).  A spec that puts the model axis on another dim is refused."""

    def __init__(self, layout: Layout, spec, shape, *, heads: int = 2, seq: int = 3):
        self.cache_len, self.slot0, self.slots, self.mode = shape[seq], 0, shape[seq], "whole"
        for dim, start, w in layout.block_slices(spec, shape):
            if "model" not in layout.units(spec[dim]):
                continue
            if dim == heads:
                self.mode = "heads"
            elif dim == seq:
                self.mode, self.slot0, self.slots = "seq", start, w
            else:
                raise NotImplementedError(
                    f"a cache of shape {tuple(shape)} sharded over its dim {dim} "
                    f"({spec!r}): the grid shards a cache's kv heads or its sequence")


def combine_partials(out: torch.Tensor, lse: torch.Tensor, tp) -> torch.Tensor:
    """Attention over a cache sharded over its sequence, from each model
    member's partial over its block ``out`` (B, H, hd) and its fp32
    log-sum-exp ``lse`` (B, H; -inf where the block holds no live slot):
    Σ e^(lse_k - m) out_k / Σ e^(lse_k - m) over the members, through
    one all-gather of the (B, H, hd + 1) partials over the model group."""
    part = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    every = _all_gather(tp, part, 0)                       # (M, B, H, hd + 1)
    lses = every[..., -1]
    m = lses.max(dim=0).values
    w = torch.exp(lses - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    num = (w[..., None] * every[..., :-1]).sum(dim=0)
    return (num / w.sum(dim=0)[..., None]).to(out.dtype)


class ServeGather(Gather):
    """:class:`Gather` for the serve steps: a rank's blocks of the served
    weights gathered layer by layer as the train step gathers them, its
    block of the cache of a ``batch`` of rows (``rules.cache_shardings``;
    :class:`KVCut`), and each block's member share at decode and at
    prefill:

    - attention, kv-head-sharded cache: the Megatron block's decode on its
      heads' block (``attention.decode_self_attention`` on ``lcfg``);
    - attention, cache sharded over its sequence or whole on every member:
      ``attention.decode_on_block``, every head over the block's slots,
      the members' partials combined (:func:`combine_partials`) where the
      sequence is sharded; at prefill each member writes every kv head's
      rows of its slots (``attention.write_block``), the kv heads it does
      not compute gathered over the model group;
    - moe: the member's E / M experts on the replicated tokens;
    - ssm: the member's heads and its heads' block of the state; the conv
      cache is every channel's on every member, so the members' x
      channels of it are gathered over the model group;
    - hybrid (zamba2): the rule stacks the ssm cache (G, per, B, ...) and
      so places it by other dims than an ssm cache's (the conv cache's
      ``per`` over data and its batch or channels over model, the state's
      ``per`` over data, or the state whole).  Each rank stores its rule
      block; before a group's ssm layers run, the group's blocks move to
      the block they compute on (the rank's data rows, the member's heads
      of the state, every conv channel: ``ssm_in``, :meth:`Layout.reblock`)
      and after them back (``ssm_out``), once a group, counted as every
      collective is.  The shared block's cache is an attention cache;
    - audio (whisper): the encoder and decoder layers as the member's
      Megatron share; the cross cache (L, B, S_enc, KV, hd) carries its
      sequence at dim 2, so :class:`KVCut` is told so.  Over its
      sequence, each member writes every kv head's rows of its encoder
      slots at prefill and at decode attends every head over them through
      ``flash_decode`` (the last slot the position, every slot live) with
      each head's log-sum-exp, the partials combined; whole or over its
      kv heads, the member's heads attend their kv heads.

    - a part computed whole (:func:`whole_parts`): the single device's on
      the rank's rows.  A whole attention's cache lies over its sequence
      (every head over the block's slots, the partials combined, ``wo``
      whole) or whole; a whole ssm part's state is the rule's block, moved
      to every head and back where the rule shards it over the model axis
      (an ssm model) or moved with the group's (zamba2).

    Each part of a block's output is summed over the model group before
    its residual add, as in training.  ``moved`` counts the bytes and
    calls of the ssm cache's moves by axis (among the step's
    collectives), ``copied`` the bytes of the cross cache's blocks
    transposed into ``flash_decode``'s layout."""

    def __init__(self, cfg: ModelConfig, layout: Layout, specs, shapes, cache_len: int,
                 batch: int):
        super().__init__(cfg, layout, specs, shapes)
        self.cache_len = cache_len
        self.rows = len(local_rows(batch, layout, serving=True))
        self.cspecs, self.leaves = _whole_cache_specs(cfg, layout.mesh, batch, cache_len)
        kv = {"hybrid": "attn/k", "audio": "self/k"}.get(cfg.family, "k")
        self.kv = KVCut(layout, self.cspecs[kv], self.leaves[kv].shape) \
            if kv in self.cspecs else None
        self.xkv = KVCut(layout, self.cspecs["cross/0"], self.leaves["cross/0"].shape,
                         heads=3, seq=2) if cfg.family == "audio" else None
        M_, k, KV = layout.model, layout.grid.k, cfg.num_kv_heads
        if "attention" in self.whole:
            # every head on every member: nothing to gather along the heads
            self.heads, self.kv_heads, self.every_head = (0, cfg.num_heads), (0, KV), None
            if "heads" in (getattr(self.kv, "mode", None), getattr(self.xkv, "mode", None)):
                raise NotImplementedError("a whole attention's cache sharded over its kv heads")
        else:
            self.heads = (k * cfg.num_heads // M_, cfg.num_heads // M_)
            self.kv_heads = (k * KV // M_, max(1, KV // M_))
            self.every_head = self._gather_heads
        # a whole ssm part's layer cache: by leaf, the rule's spec of a
        # layer's slice, the block its layer computes on (the rule's less its
        # model axis) and the slice's whole shape
        self.ssm_model = {}
        if cfg.family == "ssm" and "ssm" in self.whole:
            for key in ("conv", "state"):
                spec = self.cspecs[key][1:]
                compute = tuple(None if "model" in layout.units(e) else e for e in spec)
                self.ssm_model[key] = (spec, compute, tuple(self.leaves[key].shape[1:]))
        if cfg.family == "hybrid":
            rows = rules.batch_shardings(torch.empty((batch,), device="meta"), layout.mesh)[0]
            heads = layout.model_axis if M_ > 1 and "ssm" not in self.whole else None
            # by leaf of a group's (per, B, ...) slice: the rule's spec, the
            # block the layers compute on, the slice's whole shape
            self.ssm = {key: (self.cspecs["ssm/" + key][1:], compute,
                              tuple(self.leaves["ssm/" + key].shape[1:]))
                        for key, compute in (("conv", (None, rows, None, None)),
                                             ("state", (None, rows, heads, None, None)))}
        self.reset()

    def reset(self):
        self.moved = {f"{a}_{w}": 0 for a in ("data", "model") for w in ("bytes", "calls")}
        self.copied = 0

    def _zeros(self, spec, shape, like):
        shape = list(shape)
        for dim, _, w in self.layout.block_slices(spec, shape):
            shape[dim] = w
        return torch.zeros(shape, dtype=like.dtype, device=like.device)

    def init_cache(self, batch: int, cache_len: int, *, device) -> PyTree:
        """Zeros of this rank's block of the cache of the step's batch
        (``batch`` its rows)."""
        if (batch, cache_len) != (self.rows, self.cache_len):
            raise ValueError(f"a cache of {batch} rows and {cache_len} slots for a step of "
                             f"{self.rows} and {self.cache_len}")
        return cache_tree({p: self._zeros(self.cspecs[p], t.shape,
                                          torch.empty((), dtype=t.dtype, device=device))
                           for p, t in self.leaves.items()})

    def _gather_heads(self, t):
        return _all_gather(self.layout.grid.tp, t, 2)

    def cache_writer(self, kv):
        """What a layer's prefill writes its K/V with: its block of the
        cache (``attention.prefill_into_cache``) where it holds its own
        kv heads, else a writer of every kv head's rows of its slots."""
        if self.kv.mode == "heads":
            return kv
        cfg, cut = self.cfg, self.kv

        def write(k, v):
            every = lambda t: attention.every_kv_head(t, self._gather_heads,
                                                      cfg.num_kv_heads)
            attention.write_block(kv, every(k), every(v), cut.slot0, cut.cache_len)

        return write

    def write_cross(self, ekv, cross):
        """A decoder layer's prefill of its cross cache blocks ``cross``
        (k, v) from its cross K/V ``ekv`` (B, S_enc, KV or this member's kv
        heads, hd): its own kv heads where the rule shards them, else
        every kv head of its encoder slots, the heads it does not compute
        gathered over the model group."""
        cut = self.xkv
        for t, block in zip(ekv, cross):
            if cut.mode != "heads":
                t = attention.every_kv_head(t, self._gather_heads, self.cfg.num_kv_heads)
                t = t.narrow(1, cut.slot0, cut.slots)
            block.copy_(t)

    def prefill_ssm(self, p, cfg, x, cache, *, backend="auto"):
        """One ssm layer's prefill: its output, its final state (the
        member's heads) and conv tail (every channel) written to ``cache``."""
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if not self.tp or "ssm" in self.whole:
            y, final, tail = ssm_lib.mamba2_forward(p["ssm"], cfg, h, backend=backend)
            final, tail = self._to_rule("state", final), self._to_rule("conv", tail)
        else:
            tp = self.layout.grid.tp
            y, final, tail = ssm_lib.mamba2_forward(
                p["ssm"], cfg, _TPCopy.apply(h, tp), backend=backend,
                mean_sq=lambda xf: _norm_mean_sq(xf, tp))
            y = _TPReduce.apply(y, tp)
            ch = p["ssm"]["A_log"].shape[-1] * cfg.ssm_headdim
            tail = torch.cat([_all_gather(tp, tail[..., :ch], 2), tail[..., ch:]], dim=-1)
        cache["conv"].copy_(tail)
        cache["state"].copy_(final)
        return x + y

    def _from_rule(self, key, t):
        """A whole ssm part's layer cache ``t`` (the rule's block) moved to
        the block its layer computes on: every head of the rank's rows."""
        if key not in self.ssm_model:
            return t
        rule, compute, shape = self.ssm_model[key]
        return self._reblock(t, rule, compute, shape)

    def _to_rule(self, key, t):
        """``_from_rule``'s inverse."""
        if key not in self.ssm_model:
            return t
        rule, compute, shape = self.ssm_model[key]
        return self._reblock(t, compute, rule, shape)

    def _reblock(self, t, src, dst, shape):
        """:meth:`Layout.reblock`, its gathers' bytes and calls by axis
        also added to ``moved``."""
        before = self.layout.counts()
        out = self.layout.reblock(t, src, dst, shape)
        after = self.layout.counts()
        for axis in ("data", "model"):
            for what in ("bytes", "calls"):
                key = f"{axis}_gather_{what}"
                self.moved[f"{axis}_{what}"] += after[key] - before[key]
        return out

    def ssm_in(self, cache):
        """A hybrid group's ssm cache blocks (its slice of the rule's
        placement) moved to the blocks its layers compute on."""
        return {key: self._reblock(cache[key], rule, compute, shape)
                for key, (rule, compute, shape) in self.ssm.items()}

    def ssm_out(self, blocks, cache):
        """``ssm_in``'s inverse: the compute ``blocks`` moved back to the
        rule's placement, written into the group's ``cache`` in place."""
        for key, (rule, compute, shape) in self.ssm.items():
            new = self._reblock(blocks[key], compute, rule, shape)
            if new is not cache[key]:
                cache[key].copy_(new)

    def prefill_group(self, gp, cfg, x, cache, *, backend="auto"):
        """A hybrid group's ssm layers at prefill on the group's gathered
        leaves, their final states and conv tails written to compute
        blocks, which then move to the group's ``cache`` (``ssm_out``)."""
        c = {key: self._zeros(compute, shape, cache[key])
             for key, (_, compute, shape) in self.ssm.items()}
        for i, p in enumerate(tfm.unstack(self(gp, "blocks"))):
            x = self.prefill_ssm(p, cfg, x, tfm.layer(c, i), backend=backend)
        self.ssm_out(c, cache)
        return x

    def decode_group(self, gp, cfg, x, cache, pos, *, backend="auto"):
        """A hybrid group's ssm layers for one token: the group's ``cache``
        moved to the compute blocks (``ssm_in``), each layer's recurrent
        step on them, and back (``ssm_out``)."""
        c = self.ssm_in(cache)
        for i, p in enumerate(tfm.unstack(self(gp, "blocks"))):
            ci = tfm.layer(c, i)
            x, new = self.block_decode(p, cfg, x, ci, pos, "ssm", backend=backend)
            for key, t in new.items():
                ci[key].copy_(t)
        self.ssm_out(c, cache)
        return x

    def _gather_x(self, x):
        return _all_gather(self.layout.grid.tp, x, 1), self.layout.grid.k * x.shape[-1]

    def cross_decode(self, p, cfg, h, enc_kv, *, backend="auto"):
        """The member's share of a decoder layer's cross-attention for one
        token on its cross cache blocks ``enc_kv`` (the single device's
        ``cross_attention`` at Sq 1), through its ``wo`` rows: a part of
        the model group's sum."""
        cut, (k, v) = self.xkv, enc_kv
        if cut.mode != "seq":
            if cut.mode == "whole":
                first, n = self.kv_heads
                k, v = k[:, :, first:first + n], v[:, :, first:first + n]
            return attention.cross_attention(p, self.lcfg, h, (k, v), backend)
        B, hd = h.shape[0], cfg.head_dim
        q = h @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
        q = q.reshape(B, 1, -1, hd)
        if self.every_head is not None:
            q = self.every_head(q)                                    # (B, 1, H, hd)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))    # (B, KV, slots, hd)
        self.copied += 2 * kt.numel() * kt.element_size()
        out, lse = kops.flash_decode(q[:, 0], kt, vt, cut.cache_len - 1, slot0=cut.slot0,
                                     cache_len=cut.cache_len, return_lse=True)
        out = combine_partials(out, lse, self.layout.grid.tp)
        first, n = self.heads
        return out[:, first:first + n].reshape(B, 1, n * hd) @ p["wo"]

    def block_decode(self, p, cfg, x, cache, pos, kind, *, ring=False, window=0,
                     enc_kv=None, backend="auto"):
        """The rank's share of one block for one token (``transformer.
        block_decode``'s contract; ``enc_kv`` a decoder layer's cross
        cache blocks)."""
        if not self.tp:
            return tfm.block_decode(p, cfg, x, cache, pos, kind, ring=ring, window=window,
                                    enc_kv=enc_kv, backend=backend)
        tp = self.layout.grid.tp
        total = lambda t: _TPReduce.apply(t, tp)
        same = lambda t: t
        whole = self.block_whole(kind)
        atotal = same if "attention" in whole else total
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if kind == "ssm" and "ssm" in self.whole:
            c = {key: self._from_rule(key, t) for key, t in cache.items()}
            y, new = ssm_lib.mamba2_decode_step(p["ssm"], cfg, h, c)
            return x + y, {key: self._to_rule(key, t) for key, t in new.items()}
        if kind == "ssm":
            y, cache = ssm_lib.mamba2_decode_step(
                p["ssm"], cfg, h, cache, mean_sq=lambda xf: _norm_mean_sq(xf, tp),
                gather_x=self._gather_x)
            return x + total(y), cache
        kw = dict(ring=ring, rope=cfg.family != "audio", window=window)
        if self.kv.mode == "heads":
            a, cache = attention.decode_self_attention(p["attn"], self.lcfg, h, cache, pos,
                                                       backend=backend, **kw)
        else:
            cut = self.kv
            a, cache = attention.decode_on_block(
                p["attn"], cfg, self.lcfg, h, cache, pos, slot0=cut.slot0,
                cache_len=cut.cache_len, heads=self.heads, gather_heads=self.every_head or same,
                combine=(lambda out, lse: combine_partials(out, lse, tp))
                if cut.mode == "seq" else None, **kw)
        x = x + atotal(a)
        if kind == "dec_cross":
            h = layers.apply_norm(p["ln3"], x, cfg.norm)
            x = x + atotal(self.cross_decode(p["xattn"], cfg, h, enc_kv, backend=backend))
        h = layers.apply_norm(p["ln2"], x, cfg.norm)
        ftotal = same if "ffn" in whole else total
        if kind == "moe":
            y, _ = moe_lib.moe_block(p["moe"], cfg, h, experts=self.experts)
            return x + (y if "ffn" in whole else _experts_sum(y, tp)), cache
        return x + ftotal(layers.apply_mlp(p["mlp"], h, cfg.mlp)), cache


def decode_params(cfg: ModelConfig, params: PyTree) -> PyTree:
    """The weights a decode step reads: all but a whisper model's encoder
    and its decoder's cross K/V projections, which run at prefill only
    (JAX's jit leaves the arguments a step does not read out of the
    compiled step, so its decode takes none of them)."""
    if cfg.family != "audio":
        return params
    unread = lambda p: p.split("/")[0] in ("enc_blocks", "enc_pos", "enc_final_norm") or \
        p.split("/")[1:2] == ["xattn"] and p.split("/")[-1] in ("wk", "wv", "bk", "bv")
    return _unflatten({p: t for p, t in flatten(params).items() if not unread(p)})


def _serve_gather(cfg, layout, cache_len, batch):
    specs = param_specs(cfg, layout.mesh)
    shapes = {p: tuple(t.shape) for p, t in flatten(M.abstract_params(cfg)).items()}
    return ServeGather(cfg, layout, specs, shapes, cache_len, batch)


def _next_token(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def _serve_stats(layout, gather):
    """A serve call's collectives (:meth:`Layout.counts`), of them the
    ssm cache's moves (``reblock_<axis>_bytes`` and ``_calls``), the
    bytes its cross caches' blocks were copied in (``copy_bytes``), and
    the parts each member computes whole (``whole``)."""
    return dict(layout.counts(), copy_bytes=gather.copied, whole=dict(gather.whole),
                **{f"reblock_{k}": v for k, v in gather.moved.items()})


def make_prefill_step(cfg: ModelConfig, layout: Layout, cache_len: int, *, batch: int,
                      backend: str = "auto"):
    """``prefill_step(params, batch) -> (logits, next token, cache)`` on
    this rank's blocks of the weights (:func:`init_params`) and its rows
    of the ``batch`` prompts (``local_rows(batch, ..., serving=True)``):
    the JAX dry-run's ``jit(make_prefill_step)`` with the weights and
    batch sharded (``repro/launch/dryrun.py:176-181``).  The cache it
    returns is the rank's block of the rules' placement of the whole cache
    of ``cache_len`` + the prefix's slots, where the JAX prefill leaves its
    output's layout to GSPMD.  ``prefill_step.stats`` holds the call's
    collectives (:func:`_serve_stats`)."""
    eff = cache_len + cfg.num_prefix_tokens
    gather = _serve_gather(cfg, layout, eff, batch)

    def prefill_step(params, batch):
        layout.reset_counts()
        gather.reset()
        with torch.no_grad():
            cache, logits, _ = M.prefill(params, cfg, batch, eff, backend=backend,
                                         gather=gather)
        prefill_step.stats = _serve_stats(layout, gather)
        return logits, _next_token(logits), cache

    prefill_step.stats = {}
    prefill_step.whole = dict(gather.whole)
    prefill_step.specs = gather.specs
    prefill_step.cache_specs = gather.cspecs
    return prefill_step


def make_decode_step(cfg: ModelConfig, layout: Layout, seq_len: int, *, batch: int,
                     backend: str = "auto"):
    """``decode_step(params, cache, tokens, pos) -> (logits, next token,
    cache)`` on this rank's blocks of the weights and of the cache
    (``rules.cache_shardings``, :func:`cache_specs`) of ``batch`` rows and
    its rows of ``tokens``: the JAX dry-run's ``jit(make_decode_step)``
    with the cache in and out under the rules, donated
    (``repro/launch/dryrun.py:183-191``); the cache is updated in place.
    ``decode_step.plan`` is ``cache_plan(cfg, seq_len)``; ``.stats`` the
    call's collectives (:func:`_serve_stats`)."""
    plan = cache_plan(cfg, seq_len)
    gather = _serve_gather(cfg, layout, max(plan["cache_len"], 1), batch)

    def decode_step(params, cache, tokens, pos):
        layout.reset_counts()
        gather.reset()
        with torch.no_grad():
            logits, cache = M.decode_step(params, cfg, tokens, cache, pos,
                                          ring=plan["ring"], window=plan["window"],
                                          backend=backend, gather=gather)
        decode_step.stats = _serve_stats(layout, gather)
        return logits, _next_token(logits), cache

    decode_step.stats = {}
    decode_step.whole = dict(gather.whole)
    decode_step.plan = plan
    decode_step.specs = gather.specs
    decode_step.cache_specs = gather.cspecs
    return decode_step
