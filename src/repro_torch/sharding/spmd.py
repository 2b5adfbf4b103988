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

**Compute, model axis > 1.**  The blocks run Megatron tensor parallelism
through the pipeline runtime's ``core.heteropp._tp_block_forward`` (its
``_TPCopy`` and ``_TPReduce`` all-reduces over the model group): each
member keeps its Megatron shard of each layer leaf
(``rules.tp_body_dim``: column ``wq wk wv bq bk bv wi wg``, row ``wo``):
where the rules put the model axis on that dim its block is the shard
and only the data axes are gathered, else it gathers the leaf whole and
slices it; activations stay replicated over the model axis.  A Megatron leaf's
gradient is summed over the model members (each holds its shard's part);
a leaf every member computes alike (norms, embeddings) is sliced, or
averaged where its spec does not name the model axis.  Dense and vlm
models only: GSPMD runs every family at model > 1, but the port lacks
moe's expert parallelism and the head sharding of the ssm, hybrid and
audio blocks, and refuses them by name (:func:`check_grid`).

**What is exact.**  The persistent state is exactly what the JAX rules
give each device.  Only the transient activation layout departs from
GSPMD's: GSPMD keeps sequence-parallel activations between blocks
(``sp=True``); here they are whole rows of the rank's batch, replicated
over the model axis.  A moe model's load-balance loss takes its expert
fractions over the whole batch (:class:`Gather` gives ``moe_block`` the
data ranks' sum of its top-1 counts), as the single device's does.  The batch must split evenly over the data axes
(where GSPMD would replicate a batch that does not, this raises).

**Counts.**  The step's ``stats`` after each call: the bytes and wall ms
of the step's all-gathers, reduce-scatters and all-reduces by axis
(``data``, ``model``, ``world``); :func:`state_bytes` the rank's
persistent bytes, :func:`block_bytes` their closed form from the specs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.dataparallel.grad_sync import replica_grad_norm
from ..models import layers, transformer as tfm
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw
from ..training.train_step import TrainState, abstract_train_state, train_state_from
from ..tree import flatten, tree_leaves
from . import rules

PyTree = Any

# what the port lacks to run each family at model > 1
MISSING_AT_MODEL = {
    "moe": "expert parallelism (the experts over the model axis)",
    "ssm": "SSM head sharding (the mamba2 heads over the model axis)",
    "hybrid": "SSM head sharding (the mamba2 heads over the model axis)",
    "audio": "encoder-decoder head sharding (whisper's cross-attention)",
}


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

    def units(self, entry) -> Tuple[str, ...]:
        """An entry's axes as the groups that hold them, major to minor:
        ``"model"`` or ``"data"`` (every data axis, in order)."""
        axes, out, i = rules.entry_axes(entry), [], 0
        while i < len(axes):
            if axes[i] == self.model_axis:
                out.append("model")
                i += 1
                continue
            run = tuple(axes[i:i + len(self.data_axes)])
            if run != self.data_axes:
                raise NotImplementedError(
                    f"spec entry {entry!r}: the grid holds the data axes "
                    f"{self.data_axes} as one group; {run} alone has none")
            out.append("data")
            i += len(run)
        return tuple(out)

    def comm(self, unit):
        return self.grid.tp if unit == "model" else self.grid.dp

    def size(self, unit) -> int:
        return self.model if unit == "model" else self.data

    def index(self, unit) -> int:
        return self.grid.k if unit == "model" else self.grid.d

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
        return {"data": self.grid.dp, "model": self.grid.tp, "world": self.grid.world}

    def reset_counts(self) -> None:
        for comm in self.groups().values():
            if comm is not None:
                comm.reset_counts()

    def counts(self) -> Dict[str, float]:
        """The collectives since :meth:`reset_counts`, by axis: bytes
        (all-gathers: what arrives; reduce-scatters and all-reduces: the
        tensors given) and wall ms."""
        out = {}
        for axis, comm in self.groups().items():
            for kind, b, s in (("gather", "gather_bytes", "gather_seconds"),
                               ("scatter", "scatter_bytes", "scatter_seconds"),
                               ("reduce", "reduce_bytes", "reduce_seconds")):
                out[f"{axis}_{kind}_bytes"] = getattr(comm, b) if comm else 0
                out[f"{axis}_{kind}_ms"] = getattr(comm, s) * 1e3 if comm else 0.0
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


class Gather:
    """The model's access to one rank's blocks (``models.model.loss_fn(...,
    gather=)``): ``gather(tree, where)`` gathers a (sub)tree whose path in
    the params is ``where`` (a layer of a stack, or a whole non-stacked
    entry), and ``block`` runs one layer on what it returns.  At model > 1
    a dense layer's leaves come back as this member's Megatron shards and
    ``block`` is the Megatron block; where the rules put the model axis
    on a leaf's Megatron dim, the member's block is its shard already,
    and only the data axes are gathered (and reduced).  ``data`` False
    leaves the data axes out of the backward (ZeRO-1); ``routing`` is the
    moe blocks' ``routing_sum`` (:meth:`Layout.routing_sum`)."""

    def __init__(self, cfg: ModelConfig, layout: Layout, specs: Dict[str, Any],
                 shapes: Dict[str, Tuple[int, ...]], *, data: bool = True, routing=None):
        from ..core import heteropp as HP
        self.cfg, self.layout, self.specs, self.shapes = cfg, layout, specs, shapes
        self.data, self.routing = data, routing
        self.tp = layout.model > 1
        self.lcfg = HP._tp_local_cfg(cfg, layout.model)
        self._tp_block = HP._tp_block_forward

    def __call__(self, tree, where: str):
        def one(path, leaf):
            full = self.shapes[path]
            spec = self.specs[path][len(full) - leaf.ndim:]
            d = rules.tp_body_dim(path, leaf.ndim) \
                if self.tp and where == "blocks" else None
            if d is not None and rules.entry_axes(spec[d]) == (self.layout.model_axis,):
                own = spec[:d] + (None,) + spec[d + 1:]
                return _Gathered.apply(leaf, self.layout, own, "local", self.data)
            x = _Gathered.apply(leaf, self.layout, spec, "equal" if d is None else "sum",
                                self.data)
            if d is not None:
                w = x.shape[d] // self.layout.model
                x = x.narrow(d, self.layout.grid.k * w, w)
            return x

        return rules.map_with_path(one, tree, where + "/")

    def block(self, p, cfg, x, kind, *, backend="auto", **kw):
        if not self.tp:
            return tfm.block_forward(p, cfg, x, kind, backend=backend,
                                     routing_sum=self.routing, **kw)
        return self._tp_block(p, cfg, self.lcfg, x, self.layout.grid.tp,
                              backend=backend, **kw), {}


def check_grid(cfg: ModelConfig, model: int) -> None:
    """Refuse a model a grid of model axis ``model`` cannot run: at model
    > 1 the Megatron blocks cover dense and vlm models whose heads, kv
    heads and d_ff divide the model axis."""
    if model == 1:
        return
    from ..core.heteropp import validate_tensor_parallel
    if cfg.family in MISSING_AT_MODEL:
        raise NotImplementedError(
            f"--model-parallel {model}: {cfg.name} is a {cfg.family} model, and "
            f"the port lacks {MISSING_AT_MODEL[cfg.family]}; it runs dense and vlm "
            f"models at model > 1 (Megatron blocks) and every family at model 1")
    validate_tensor_parallel(cfg, model)


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

def local_rows(batch_size: int, layout: Layout, accum_steps: int = 1) -> torch.Tensor:
    """The global batch rows this rank takes, microbatch-major: of each of
    the ``accum_steps`` microbatches (consecutive row blocks, as the
    single device splits them), the block ``rules.batch_shardings`` gives
    this rank's data index."""
    if batch_size % accum_steps:
        raise ValueError(f"batch {batch_size} does not split into {accum_steps} "
                         f"microbatches")
    mb = batch_size // accum_steps
    spec = rules.batch_shardings(torch.empty((mb,), device="meta"), layout.mesh)
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
                      scale):
    """Each microbatch's loss (``M.loss_fn`` through ``gather``) and the
    gradient of ``scale`` x it w.r.t. the rank's blocks, accumulated in
    fp32 and averaged over ``accum_steps`` as the single device's step
    does.  Returns (block gradients in leaf order, the rank's mean loss
    and metrics as one fp32 vector, the metric names)."""
    leaves = tree_leaves(state.params)
    mbs = [{k: v.chunk(accum_steps, dim=0)[i] for k, v in batch.items()}
           for i in range(accum_steps)]
    grads, sums, names = None, None, None
    for mb in mbs:
        loss, metrics = M.loss_fn(state.params, cfg, mb, remat=remat,
                                  backend=backend, gather=gather)
        g = torch.autograd.grad(loss * scale, leaves)
        if accum_steps > 1:
            g = [t.float() for t in g]
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        names = ["loss"] + sorted(metrics)
        vec = torch.stack([loss.detach().float()] +
                          [metrics[k].detach().float() for k in names[1:]])
        sums = vec if sums is None else sums + vec
    if accum_steps > 1:
        grads = [g / accum_steps for g in grads]
        sums = sums / accum_steps
    return grads, sums, names


def make_train_step(cfg: ModelConfig, layout: Layout,
                    opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                    accum_steps: int = 1, remat: bool = True, backend: str = "auto"):
    """``train_step(state, batch) -> (state, metrics)`` on this rank's
    blocks (:func:`init_state`) and rows (:func:`local_rows`); the
    metrics are the single device's (the loss and each model metric the
    mean over the data ranks) as floats; ``train_step.stats`` holds the
    last step's collectives (:meth:`Layout.counts`) and ``train_step.specs``
    the state's specs."""
    check_grid(cfg, layout.model)
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
            backend=backend, scale=1.0 / D)
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
        train_step.stats = layout.counts()
        out = dict(zip(names, vec.tolist()))
        out.update(grad_norm=float(opt_m["grad_norm"]), lr=opt_m["lr"])
        return state, out

    train_step.stats = {}
    train_step.specs = specs
    return train_step
