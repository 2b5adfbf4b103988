"""HeteroPP on ``torch.distributed``: heterogeneous pipeline parallelism
over the pipe axis (the counterpart of ``repro/core/heteropp.py``).

Two execution paths, as in the JAX package:

* :func:`simulate_pipeline_forward` runs the global stages one after
  another on one device (following a chunked schedule's placement): the
  numerics oracle, equal to the monolithic ``models.model.forward``.
* :func:`make_pipeline_loss` / :func:`make_pipeline_train_step` run the
  schedule's static tick program (``core/tickprogram.py``) with one
  process (rank) a physical stage.  Each rank holds its stage's layers
  (``local_stage_params``: ``(Lmax, ...)`` leaves, or ``(v, Lcmax,
  ...)`` for chunked schedules) and a copy of ``embed`` and
  ``final_norm``.  On every tick every rank takes its input from the
  route the tables name (a fresh embedding, the previous or the next
  stage, or its own last output), runs its chunk, adds the CE of a
  microbatch that leaves the last global stage, and shifts its output
  one hop each way with :class:`~repro_torch.comm.p2p.P2P` (zeros on a
  tick it is idle, so every rank issues every exchange of every tick).

The backward is explicit, in reverse tick order, not autograd across
ranks: each tick's input is a detached leaf, the tick's gradient comes
back from the rank that consumed its output, the tick's graph is
differentiated with ``torch.autograd.grad``, and the input's gradient
goes back along the route it came by.  It computes what ``jax.grad``
through the JAX package's scan and ``ppermute`` computes (GPipe memory:
every tick's graph lives until the backward; ``recompute[s]`` keeps only
each layer's input, as ``torch.utils.checkpoint``).  The replicated
leaves' gradients are summed over the pipe, which is what ``shard_map``'s
transpose of a replicated input does.

Only the pipe axis is ported: a spec that asks for tensor parallelism,
data parallelism, a batch domain or grouped tp raises
``NotImplementedError`` (ROADMAP A8(d)-(g)).  Only the dense and ssm
block kinds run (the JAX package's ``block_kind`` maps hybrid to dense,
so its pipeline has no hybrid path; moe waits for ROADMAP A11).  A
padded layer slot is skipped, not computed and masked: with tp 1 no
collective sits inside a layer, and the result is the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models import layers, model as M, transformer as tfm
from ..models.config import ModelConfig
from ..optim import adamw
from ..tree import tree_leaves, tree_map
from .tickprogram import (SRC_INJECT, SRC_LOCAL, SRC_NEXT, SRC_PREV, TickTables,
                          chunk_layer_counts, spmd_tick_tables)

PyTree = Any
UNPORTED = ("tensor parallelism, data parallelism, batch domains and grouped "
            "tp are not ported yet (ROADMAP A8(d)-(g)); the port runs the "
            "pipe axis only")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Runtime pipeline layout: the JAX package's fields and checks.

    ``num_stages`` is the PHYSICAL stage count S (one rank each).
    ``layers_per_stage`` is indexed by GLOBAL chunk-stage g in ascending
    model-layer order (length S·n_chunks); the schedule's chunk placement
    decides which physical stage hosts which global chunk-stage.
    ``recompute`` stays per physical stage.  The tp, dp, batch-domain
    and grouped-tp fields keep the JAX package's validation, and a spec
    that asks for any of them raises ``NotImplementedError``
    (``bucket_bytes`` only shapes a dp sync, so it is inert here)."""
    num_stages: int
    layers_per_stage: Tuple[int, ...]     # per global chunk-stage
    microbatches: int
    recompute: Tuple[bool, ...] = ()      # per physical stage
    pipe_axis: str = "pipe"
    schedule: str = "1f1b"                # repro_torch.core.schedules name
    n_chunks: int = 1                     # virtual stages per device (v)
    tensor_parallel: int = 1
    tp_axis: str = "tp"
    data_parallel: int = 1
    dp_axis: str = "dp"
    batch_domain: Tuple[int, ...] = ()
    bucket_bytes: int = 0
    stage_tp: Tuple[int, ...] = ()
    reshard: Tuple[str, ...] = ()

    def __post_init__(self):
        assert len(self.layers_per_stage) == self.num_stages * self.n_chunks
        assert self.tensor_parallel >= 1, self.tensor_parallel
        assert self.data_parallel >= 1, self.data_parallel
        assert self.bucket_bytes >= 0, self.bucket_bytes
        if not self.recompute:
            object.__setattr__(self, "recompute",
                               (True,) * self.num_stages)
        assert len(self.recompute) == self.num_stages
        if self.batch_domain:
            object.__setattr__(self, "batch_domain",
                               tuple(int(a) for a in self.batch_domain))
            if len(self.batch_domain) != self.data_parallel:
                raise ValueError(
                    f"batch_domain has {len(self.batch_domain)} "
                    f"allocations but data_parallel="
                    f"{self.data_parallel}")
            if any(a < 1 for a in self.batch_domain):
                raise ValueError(f"batch_domain allocations must be "
                                 f">= 1: {self.batch_domain}")
            if max(self.batch_domain) != self.microbatches:
                raise ValueError(
                    f"batch_domain pacing allocation "
                    f"{max(self.batch_domain)} must equal microbatches="
                    f"{self.microbatches} — ``microbatches`` is the "
                    f"pacing replica's tick-table length (DESIGN.md §13)")
            if len(set(self.batch_domain)) == 1:
                object.__setattr__(self, "batch_domain", ())
        if self.stage_tp:
            object.__setattr__(self, "stage_tp",
                               tuple(int(t) for t in self.stage_tp))
            if len(self.stage_tp) != self.num_stages:
                raise ValueError(
                    f"stage_tp has {len(self.stage_tp)} entries but the "
                    f"spec has {self.num_stages} physical stages")
            if any(t < 1 for t in self.stage_tp):
                raise ValueError(f"stage_tp degrees must be >= 1: "
                                 f"{self.stage_tp}")
            if self.tensor_parallel != 1:
                raise ValueError(
                    f"non-uniform per-stage tp (stage_tp={self.stage_tp}) "
                    f"replaces the uniform tensor_parallel="
                    f"{self.tensor_parallel}; set tensor_parallel=1")
            if self.n_chunks != 1:
                raise ValueError(
                    f"non-uniform per-stage tp (stage_tp={self.stage_tp}) "
                    f"executes single-chunk schedules only; n_chunks="
                    f"{self.n_chunks} chunked schedules keep asymmetric "
                    f"tp a cost-model dimension (DESIGN.md §12)")
            if self.data_parallel != 1:
                raise ValueError(
                    f"non-uniform per-stage tp (stage_tp={self.stage_tp}) "
                    f"does not compose with data_parallel="
                    f"{self.data_parallel} yet; dp replicas of grouped "
                    f"pipelines stay a cost-model dimension "
                    f"(DESIGN.md §12)")
            if not self.reshard:
                object.__setattr__(self, "reshard", tuple(
                    "none" if a == b else "sr_ag"
                    for a, b in zip(self.stage_tp, self.stage_tp[1:])))
            if len(self.reshard) != self.num_stages - 1:
                raise ValueError(
                    f"reshard names {len(self.reshard)} boundary "
                    f"strategies but the spec has "
                    f"{self.num_stages - 1} stage boundaries")
            bad = [r for r in self.reshard
                   if r not in ("none", "naive", "sr_ag")]
            if bad:
                raise ValueError(f"unknown reshard strategies {bad}; "
                                 f"pick from 'none' | 'naive' | 'sr_ag'")
        elif self.reshard:
            raise ValueError("reshard strategies need stage_tp (the "
                             "grouped runtime); uniform specs have no "
                             "per-boundary collective to choose")
        asks = [f"{name}={value}" for name, value, default in (
            ("tensor_parallel", self.tensor_parallel, 1),
            ("data_parallel", self.data_parallel, 1),
            ("batch_domain", self.batch_domain, ()),
            ("stage_tp", self.stage_tp, ())) if value != default]
        if asks:
            raise NotImplementedError(f"PipelineSpec({', '.join(asks)}): "
                                      + UNPORTED)

    @property
    def total_layers(self) -> int:
        return sum(self.layers_per_stage)

    @property
    def max_layers(self) -> int:
        return max(self.layers_per_stage)

    @property
    def grouped(self) -> bool:
        return bool(self.stage_tp)


def from_plan(plan, microbatches: Optional[int] = None, *,
              execute_tp: bool = False,
              execute_dp: bool = False,
              verify: bool = True) -> PipelineSpec:
    """Build a runtime PipelineSpec from a HeteroAuto ParallelPlan, as the
    JAX package's ``from_plan`` does: each plan stage's ``pp`` physical
    stages take ``layers_per_stage`` layers each (the last one the
    rest), and chunked schedules split each physical stage's layers over
    its v chunk slots (``chunk_layer_counts``).

    With the defaults tp and dp stay cost-model dimensions and the layer
    split alone executes.  ``execute_tp`` / ``execute_dp`` build the
    JAX package's tp, dp and batch-domain fields, which the port's spec
    refuses unless the plan is pipe-only (tp 1, dp 1).  ``verify=True``
    gates on the copied static verifier (``analysis.verify_plan``)."""
    from .schedules import get_schedule
    sched = get_schedule(plan.schedule)
    v = sched.n_chunks
    tp = 1
    stage_tp: Tuple[int, ...] = ()
    reshard: Tuple[str, ...] = ()
    if execute_tp:
        tps = sorted({s.tp for s in plan.stages})
        if len(tps) == 1:
            tp = tps[0]
        else:
            if v > 1:
                raise ValueError(
                    f"plan assigns non-uniform per-stage tp {tps} under "
                    f"the chunked {plan.schedule!r} schedule "
                    f"({plan.describe()}); the grouped stage runtime "
                    f"streams single-chunk schedules only, so this "
                    f"combination stays a cost-model artifact "
                    f"(DESIGN.md §12) — re-search with a single-chunk "
                    f"schedule or uniform tp")
            if execute_dp and plan.dp > 1:
                raise ValueError(
                    f"plan assigns non-uniform per-stage tp {tps} AND "
                    f"dp={plan.dp} ({plan.describe()}); dp replicas of "
                    f"grouped pipelines stay a cost-model dimension "
                    f"(DESIGN.md §12) — call from_plan with "
                    f"execute_dp=False or re-search with uniform tp")
            from . import resharding as RS
            per_tp, per_chip = [], []
            for s in plan.stages:
                per_tp.extend([s.tp] * s.pp)
                per_chip.extend([s.group.spec] * s.pp)
            stage_tp = tuple(per_tp)
            reshard = tuple(
                "none" if per_tp[i] == per_tp[i + 1] else
                RS.choose_strategy(per_tp[i], per_tp[i + 1],
                                   nic_bw=per_chip[i].nic_bw,
                                   intra_bw=per_chip[i + 1].intra_node_bw)
                for i in range(len(per_tp) - 1))
    dp = 1
    batch_domain: Tuple[int, ...] = ()
    if execute_dp:
        domain = getattr(plan, "batch_domain", None)
        if domain is not None and len(set(domain)) > 1:
            if microbatches is not None and microbatches != max(domain):
                raise ValueError(
                    f"microbatches={microbatches} override conflicts "
                    f"with the plan's non-uniform batch domain "
                    f"{list(domain)} ({plan.describe()}): the override "
                    f"cannot rescale a per-replica split — rebuild the "
                    f"plan's domain instead (DESIGN.md §13)")
            batch_domain = tuple(int(a) for a in domain)
        dp = plan.dp
    phys, rec = [], []
    for s in plan.stages:
        per = s.layers_per_stage
        left = s.layers
        for _ in range(s.pp):
            take = min(per, left)
            phys.append(take)
            rec.append(s.recompute)
            left -= take
    bucket = getattr(plan, "bucket_bytes", 0) \
        if dp > 1 and getattr(plan, "dp_sync", "") == "psum" else 0
    spec = PipelineSpec(len(phys), chunk_layer_counts(phys, sched),
                        microbatches or plan.microbatches,
                        tuple(rec), schedule=plan.schedule, n_chunks=v,
                        tensor_parallel=tp, data_parallel=dp,
                        bucket_bytes=bucket, batch_domain=batch_domain,
                        stage_tp=stage_tp, reshard=reshard)
    if verify:
        from ..analysis import verify_plan
        verify_plan(plan, microbatches=microbatches,
                    execute_tp=execute_tp, execute_dp=execute_dp)
    return spec


# ---------------------------------------------------------------------------
# stage parameters
# ---------------------------------------------------------------------------

def _spec_schedule(spec: PipelineSpec):
    from .schedules import get_schedule
    sched = get_schedule(spec.schedule)
    assert sched.n_chunks == spec.n_chunks, \
        (sched.name, sched.n_chunks, spec.n_chunks)
    return sched


def pipeline_block_kind(cfg: ModelConfig) -> str:
    """The block kind a pipeline stage runs: dense or ssm; other
    families raise."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the pipeline runs dense and ssm blocks only.  The "
            f"JAX package's block_kind maps the hybrid family to 'dense' "
            f"(repro/models/config.py:94), so its pipeline has no hybrid "
            f"path to port (ROADMAP C)")
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: moe blocks are not ported yet (ROADMAP A11)")
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP A12)")
    return cfg.block_kind


def stage_slots(spec: PipelineSpec, stage: int) -> Tuple[int, ...]:
    """The global chunk-stage each chunk slot of physical ``stage``
    hosts (one slot for single-chunk schedules)."""
    if spec.n_chunks == 1:
        return (stage,)
    sched = _spec_schedule(spec)
    return tuple(sched.global_stage(stage, k, spec.num_stages)
                 for k in range(spec.n_chunks))


def local_stage_params(params: PyTree, cfg: ModelConfig, spec: PipelineSpec,
                       stage: int) -> PyTree:
    """Physical ``stage``'s share of the monolithic ``params``: block
    leaves ``(Lmax, ...)`` (single-chunk) or ``(v, Lcmax, ...)``
    (chunked: slot k holds global chunk-stage ``stage_slots[k]``), zero
    past each slot's layer count; ``embed`` and ``final_norm`` copied.
    New tensors: the result shares no storage with ``params``."""
    pipeline_block_kind(cfg)
    L = cfg.num_layers
    assert spec.total_layers == L, (spec.layers_per_stage, L)
    Lmax = spec.max_layers
    bounds = np.cumsum([0] + list(spec.layers_per_stage))
    slots = stage_slots(spec, stage)

    def pad_part(leaf, g):
        part = leaf[int(bounds[g]):int(bounds[g + 1])]
        pad = torch.zeros((Lmax - part.shape[0], *leaf.shape[1:]),
                          dtype=leaf.dtype, device=leaf.device)
        return torch.cat([part.detach(), pad])

    def split(leaf):
        if spec.n_chunks == 1:
            return pad_part(leaf, slots[0])
        return torch.stack([pad_part(leaf, g) for g in slots])

    return {"blocks": tree_map(split, params["blocks"]),
            "embed": tree_map(lambda t: t.detach().clone(), params["embed"]),
            "final_norm": tree_map(lambda t: t.detach().clone(),
                                   params["final_norm"])}


def stage_mask(spec: PipelineSpec, stage: int) -> torch.Tensor:
    """Validity mask of ``local_stage_params``' layer slots: ``(Lmax,)``
    or ``(v, Lcmax)`` bool."""
    counts = [spec.layers_per_stage[g] for g in stage_slots(spec, stage)]
    mask = torch.zeros((len(counts), spec.max_layers), dtype=torch.bool)
    for k, n in enumerate(counts):
        mask[k, :n] = True
    return mask[0] if spec.n_chunks == 1 else mask


def split_stage_params(params: PyTree, cfg: ModelConfig, spec: PipelineSpec
                       ) -> Tuple[PyTree, torch.Tensor]:
    """The JAX package's stage layout: block leaves ``(S, Lmax, ...)`` and
    mask ``(S, Lmax)`` for single-chunk specs, ``(S, v, Lcmax, ...)`` /
    ``(S, v, Lcmax)`` for chunked ones, zero-padded; ``embed`` and
    ``final_norm`` replicated (once)."""
    S = spec.num_stages
    per = [local_stage_params(params, cfg, spec, s) for s in range(S)]
    blocks = tree_map(lambda *leaves: torch.stack(leaves),
                      *[p["blocks"] for p in per])
    mask = torch.stack([stage_mask(spec, s) for s in range(S)])
    return ({"blocks": blocks, "embed": per[0]["embed"],
             "final_norm": per[0]["final_norm"]}, mask)


# ---------------------------------------------------------------------------
# stage compute
# ---------------------------------------------------------------------------

def _stage_forward(blocks, mask_row, cfg, x, kind: str, remat: bool, *,
                   backend: str = "auto"):
    """Run the valid layers of a stage's stacked ``blocks`` (``mask_row``
    True); a padded slot is skipped.  ``remat`` checkpoints each layer."""
    valid = [bool(v) for v in mask_row]
    if not any(valid):
        return x
    for p, ok in zip(tfm.unstack(blocks), valid):
        if not ok:
            continue
        fn = lambda x, p=p: tfm.block_forward(p, cfg, x, kind,
                                              backend=backend)[0]
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return x


def _chunk(tree, k):
    return tree_map(lambda t: t[k], tree)


def simulate_pipeline_forward(params: PyTree, cfg: ModelConfig,
                              spec: PipelineSpec, batch: Dict[str, torch.Tensor],
                              *, backend: str = "auto"):
    """Run the pipeline global stage by global stage on one device (in a
    chunked schedule's placement); equals the monolithic forward.
    Returns (logits, aux)."""
    kind = pipeline_block_kind(cfg)
    stage_params, mask = split_stage_params(params, cfg, spec)
    x = layers.embed_tokens(params["embed"], batch["tokens"])
    S, v = spec.num_stages, spec.n_chunks
    sched = _spec_schedule(spec) if v > 1 else None
    for g in range(S * v):
        if v == 1:
            s, blocks, mrow = g, _chunk(stage_params["blocks"], g), mask[g]
        else:
            s = sched.device_of(g, S)
            k = next(k for k in range(v)
                     if sched.global_stage(s, k, S) == g)
            blocks = _chunk(_chunk(stage_params["blocks"], s), k)
            mrow = mask[s, k]
        x = _stage_forward(blocks, mrow, cfg, x, kind, spec.recompute[s],
                           backend=backend)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = layers.unembed(params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# the tick program on torch.distributed (one rank a physical stage)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Routes:
    """Static facts of a tick program: which exchanges any tick uses."""
    perm_f: Tuple[Tuple[int, int], ...]   # y -> the next stage (x_prev)
    perm_b: Tuple[Tuple[int, int], ...]   # y -> the previous stage (x_next)
    local: bool                           # some tick reads its own output

    @staticmethod
    def of(tables: TickTables, S: int) -> "_Routes":
        used = set(np.unique(tables.src[tables.active])) \
            if tables.active.any() else set()
        wraps_prev = bool(np.any(tables.active[..., 0]
                                 & (tables.src[..., 0] == SRC_PREV)))
        wraps_next = bool(np.any(tables.active[..., -1]
                                 & (tables.src[..., -1] == SRC_NEXT)))
        perm_f = tuple((i, (i + 1) % S)
                       for i in range(S if wraps_prev else S - 1)) \
            if SRC_PREV in used else ()
        perm_b = tuple([(i, i - 1) for i in range(1, S)]
                       + ([(0, S - 1)] if wraps_next else [])) \
            if SRC_NEXT in used else ()
        return _Routes(perm_f, perm_b, SRC_LOCAL in used)

    @staticmethod
    def reverse(perm):
        return tuple((dst, src) for src, dst in perm)


def make_pipeline_loss(cfg: ModelConfig, spec: PipelineSpec, p2p, *,
                       backend: str = "auto"):
    """This rank's part of the pipeline loss.  Returns ``loss_fn(params,
    tokens) -> (loss, grads)``: ``params`` is the rank's
    ``local_stage_params`` tree (floating leaves ``requires_grad``),
    ``tokens`` (b, mb_size, S) int.  ``loss`` is the global mean CE (a
    detached 0-d fp32 tensor, the same on every rank); ``grads`` is an
    fp32 tree shaped like ``params``, the replicated leaves summed over
    the pipe.  ``loss_fn.stats`` holds the last call's tick count and
    exchanges."""
    kind = pipeline_block_kind(cfg)
    S = spec.num_stages
    if p2p.world_size != S:
        raise ValueError(f"the pipe group has {p2p.world_size} ranks but the "
                         f"PipelineSpec has {S} physical stages")
    s = p2p.rank
    tables = spmd_tick_tables(_spec_schedule(spec), S, spec.microbatches)
    routes = _Routes.of(tables, S)
    mask = stage_mask(spec, s)
    mask = mask[None] if spec.n_chunks == 1 else mask
    remat = spec.recompute[s]
    dtype = layers.dtype_of(cfg)
    rows = [(bool(tables.active[t, s]), int(tables.mb[t, s]),
             int(tables.chunk[t, s]), int(tables.src[t, s]),
             bool(tables.emit[t, s])) for t in range(tables.ticks)]

    def loss_fn(params, tokens):
        b, mb_size, seq = tokens.shape
        if b != spec.microbatches:
            raise ValueError(f"tokens carry {b} microbatches but the "
                             f"PipelineSpec has {spec.microbatches}")
        dev = tokens.device
        like = torch.empty((mb_size, seq, cfg.d_model), dtype=dtype, device=dev)
        blocks = params["blocks"] if spec.n_chunks > 1 \
            else tree_map(lambda t: t[None], params["blocks"])
        targets = torch.cat([tokens[:, :, 1:], torch.zeros_like(tokens[:, :, :1])],
                            dim=2)
        lmask = torch.ones((mb_size, seq), dtype=torch.float32, device=dev)
        lmask[:, -1] = 0.0
        p2p0 = (p2p.bytes_sent, p2p.seconds, p2p.copy_seconds, p2p.reduce_seconds)
        # denom is a token count: the emitting ticks' masks, summed over
        # the pipe once
        denom = torch.tensor(float(sum(e for a, _, _, _, e in rows if a))
                             * float(lmask.sum()), dtype=torch.float32, device=dev)
        p2p.all_reduce_(denom)
        inv_denom = 1.0 / max(float(denom), 1.0)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)

        # ---- forward: tick by tick ----
        records: List[Optional[tuple]] = []
        x_prev = x_next = y_loc = None
        for t, (active, mb, ck, src, emit) in enumerate(rows):
            y = None
            if active:
                toks = tokens[mb]
                if src == SRC_INJECT:
                    x, leaf = layers.embed_tokens(params["embed"], toks).to(dtype), None
                else:
                    x = {SRC_PREV: x_prev, SRC_NEXT: x_next, SRC_LOCAL: y_loc}[src]
                    leaf = x = x.detach().requires_grad_()
                y = _stage_forward(_chunk(blocks, ck), mask[ck], cfg, x, kind, remat,
                                   backend=backend)
                ce = None
                if emit:
                    h = layers.apply_norm(params["final_norm"], y, cfg.norm)
                    ce = M.chunked_ce(params["embed"], h, targets[mb], lmask)
                    loss_acc = loss_acc + ce.detach()
                records.append((leaf, y, ce, src))
            else:
                records.append(None)
            if t < tables.ticks - 1:
                x_prev, x_next = _exchange(p2p, routes.perm_f, routes.perm_b, y, like)
                y_loc = y.detach() if routes.local and y is not None else None
        loss = p2p.all_reduce_(loss_acc) * inv_denom

        # ---- backward: reverse tick order, gradients along the routes ----
        leaves = tree_leaves(params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        dy_f = dy_b = dy_loc = None          # gradients of this tick's y
        for t in range(tables.ticks - 1, -1, -1):
            rec, records[t] = records[t], None
            gx, src = None, None
            if rec is not None:
                leaf, y, ce, src = rec
                outs, gouts = [], []
                dy = _sum([dy_f, dy_b, dy_loc])
                if dy is not None:
                    outs.append(y)
                    gouts.append(dy.to(y.dtype))
                if ce is not None:
                    outs.append(ce * inv_denom)
                    gouts.append(None)
                if outs:
                    inputs = ([leaf] if leaf is not None else []) + leaves
                    gs = torch.autograd.grad(outs, inputs, gouts,
                                             allow_unused=True)
                    if leaf is not None:
                        gx, gs = gs[0], gs[1:]
                    for a, g in zip(acc, gs):
                        if g is not None:
                            a.add_(g.float())
                del rec, leaf, y, ce, outs
            if t > 0:
                # the input's gradient goes back to the rank that sent it
                # (the reverse of the forward's perms); what arrives is
                # the gradient of this rank's output of tick t - 1
                dy_f, dy_b = _exchange(
                    p2p, _Routes.reverse(routes.perm_f), _Routes.reverse(routes.perm_b),
                    None, like, sends=(gx if src == SRC_PREV else None,
                                       gx if src == SRC_NEXT else None))
                dy_loc = gx if src == SRC_LOCAL else None
        grads = _unflatten(params, acc)
        for name in ("embed", "final_norm"):
            for g in tree_leaves(grads[name]):
                p2p.all_reduce_(g)
        loss_fn.stats = _stats(tables, p2p, p2p0)
        return loss, grads

    loss_fn.tables = tables
    loss_fn.stats = {}
    return loss_fn


def _sum(ts):
    ts = [t for t in ts if t is not None]
    if not ts:
        return None
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def _exchange(p2p, perm_f, perm_b, y, like, sends=None):
    """One tick's exchange: ``y`` (or ``sends``, one tensor a perm) along
    ``perm_f`` and ``perm_b``; returns what arrived on each (None on a
    perm no tick uses)."""
    sends = sends or (y, y)
    items = [(x, perm) for x, perm in zip(sends, (perm_f, perm_b)) if perm]
    got = iter(p2p.ppermute(items, like)) if items else iter(())
    return (next(got) if perm_f else None, next(got) if perm_b else None)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _stats(tables, p2p, start):
    """A call's tick count and exchanges: bytes sent, wall seconds (waits
    for the peer included) and the staging copies' seconds in them; and
    the wall seconds of its all-reduces (the token count, the loss, the
    replicated leaves' gradients)."""
    return {"ticks": int(tables.ticks),
            "p2p_bytes": int(p2p.bytes_sent - start[0]),
            "p2p_s": float(p2p.seconds - start[1]),
            "p2p_copy_s": float(p2p.copy_seconds - start[2]),
            "reduce_s": float(p2p.reduce_seconds - start[3])}


def pipeline_grad_norm(grads: PyTree, p2p) -> torch.Tensor:
    """The global gradient norm of the whole model: the block leaves'
    squares summed over the pipe, the replicated leaves (already summed
    over the pipe, the same on every rank) counted once."""
    blocks = sum(torch.sum(torch.square(g.float()))
                 for g in tree_leaves(grads["blocks"]))
    blocks = p2p.all_reduce_(torch.as_tensor(blocks, dtype=torch.float32).clone())
    rep = sum(torch.sum(torch.square(g.float()))
              for name in ("embed", "final_norm") for g in tree_leaves(grads[name]))
    return torch.sqrt(blocks + rep)


def make_pipeline_train_step(cfg: ModelConfig, spec: PipelineSpec, p2p,
                             opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                             backend: str = "auto"):
    """This rank's train step: the pipeline loss and gradients, the global
    gradient norm for the clip, and AdamW on the rank's stage tree (the
    replicated leaves get the same update on every rank).  Returns
    ``train_step(state, tokens) -> (state, metrics)`` over a
    ``training.train_step.TrainState`` of ``local_stage_params``;
    ``train_step.stats`` holds the last step's tick count and exchanges."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    loss_fn = make_pipeline_loss(cfg, spec, p2p, backend=backend)

    def train_step(state, tokens):
        loss, grads = loss_fn(state.params, tokens)
        gnorm = pipeline_grad_norm(grads, p2p)
        _, _, om = adamw.apply_update(opt_cfg, state.opt_state, grads, state.step,
                                      state.params, grad_norm=gnorm)
        state.step += 1
        train_step.stats = loss_fn.stats
        return state, {"loss": loss, **om}

    train_step.tables = loss_fn.tables
    train_step.stats = {}
    return train_step
