"""HeteroPP on ``torch.distributed``: heterogeneous pipeline parallelism
over a (dp, pipe, tp) rank grid (the counterpart of
``repro/core/heteropp.py``).

Two execution paths, as in the JAX package:

* :func:`simulate_pipeline_forward` runs the global stages one after
  another on one device (following a chunked schedule's placement): the
  numerics oracle, equal to the monolithic ``models.model.forward``.
* :func:`make_pipeline_loss` / :func:`make_pipeline_train_step` run the
  schedule's static tick program (``core/tickprogram.py``) with one
  process (rank) a physical stage, tp member and dp replica
  (:class:`~repro_torch.comm.p2p.Grid`, ``rank = (d·S + s)·T + k``).
  Each rank holds its stage's layers (``local_stage_params``: ``(Lmax,
  ...)`` leaves, or ``(v, Lcmax, ...)`` for chunked schedules), sliced to
  its Megatron tp shard, and a copy of ``embed`` and ``final_norm``.  On
  every tick every rank takes its input from the route the tables name
  (a fresh embedding, the previous or the next stage, or its own last
  output), runs its chunk, adds the CE of a microbatch that leaves the
  last global stage, and shifts its output one hop each way along its
  pipe group with :class:`~repro_torch.comm.p2p.P2P` (zeros on a tick it
  is idle, so every rank issues every exchange of every tick).

The backward is explicit, in reverse tick order, not autograd across
ranks: each tick's input is a detached leaf, the tick's gradient comes
back from the rank that consumed its output, the tick's graph is
differentiated with ``torch.autograd.grad``, and the input's gradient
goes back along the route it came by.  It computes what ``jax.grad``
through the JAX package's scan and ``ppermute`` computes (GPipe memory:
every tick's graph lives until the backward; ``recompute[s]`` keeps only
each layer's input, as ``torch.utils.checkpoint``).  The replicated
leaves' gradients are summed over pipe and dp in one all-reduce, which
is what ``shard_map``'s transpose of a replicated input does.

Tensor parallelism (dense blocks) is Megatron's conjugate pair inside
each layer (:class:`_TPCopy` on the normed input of each sub-block,
:class:`_TPReduce` on its row-parallel output), so activations, norm
scales, ``embed`` and ``final_norm`` get their whole gradient on every
tp member and need no sum over tp.  Data parallelism takes each
replica's own microbatches, makes the loss the global batch mean, and
closes the gradients with a per-leaf or bucketed all-reduce over dp, or
ZeRO-1 (reduce-scatter, AdamW on dp-sharded state, all-gather).

Uneven batch domains (``PipelineSpec.batch_domain``, DESIGN.md §13):
replica d runs the schedule's tick program for its own allocation
(``spmd_tick_tables(sched, S, batch_domain[d])``, the prefix of its row
of ``domain_tick_tables``) and stops there: the JAX program's padded
tail ticks, which compute nothing it keeps, are skipped.  The loss is
the global token mean, so the dp sync that follows the tick loop is the
uniform one.

Grouped non-uniform tp (``PipelineSpec.stage_tp``, DESIGN.md §12): a flat
layout of Σ tp_s ranks (:meth:`~repro_torch.comm.p2p.Grid.grouped`), each
stage's Megatron blocks on its own tp group and its own tp_s shard (the
JAX package pads every shard to the tp_min width with zeros; the port
holds the true shard), and at each stage boundary the spec's reshard
strategy (``core/resharding.py``: ``sr_ag`` or ``naive``) moves the
activation forward and its gradient back.  Single-chunk schedules and dp
1 only, as in the JAX package.

The dense, moe and ssm block kinds run (the JAX package's ``block_kind``
maps hybrid to dense, so its pipeline has no hybrid path), and tp only
the dense one.  A padded layer slot is skipped, not computed and masked:
a stage's tp group shares its mask, so every member skips the same slots
and issues the same collectives.

A moe stage returns its layers' summed auxiliary loss beside x; each
tick's backward differentiates ``(y, aux)`` against ``(g_y, 1 / n)``
with n the global microbatch count, and the loss is Σ CE / Σ tokens +
Σ aux / n over every stage, microbatch and replica: the mean over the
microbatches of ``models.model.loss_fn``.  The JAX package divides the
summed aux by the stage count besides (``repro/core/heteropp.py:741,
947``), which halves it at two stages; the port does not (ROADMAP C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..comm.p2p import Grid
from . import resharding as RS
from ..models import attention, layers, model as M, transformer as tfm
from ..models.config import ModelConfig
from ..optim import adamw
from ..tree import flatten, tree_leaves, tree_map
from .dataparallel.grad_sync import (GRAD_SYNC_MODES, bucketize, replica_grad_norm,
                                     zero1_scatter_dim)
from .tp_rules import TP_COLUMN_PARAMS, TP_ROW_PARAMS, tp_body_dim, tp_local_slice
from .tickprogram import (SRC_INJECT, SRC_LOCAL, SRC_NEXT, SRC_PREV, TickTables,
                          chunk_layer_counts, spmd_tick_tables)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Runtime pipeline layout: the JAX package's fields and checks.

    ``num_stages`` is the PHYSICAL stage count S (one rank each).
    ``layers_per_stage`` is indexed by GLOBAL chunk-stage g in ascending
    model-layer order (length S·n_chunks); the schedule's chunk placement
    decides which physical stage hosts which global chunk-stage.
    ``recompute`` stays per physical stage.  ``microbatches`` is per dp
    replica (the pacing one's under a non-uniform ``batch_domain``, whose
    replica r takes ``batch_domain[r]``).  ``stage_tp`` gives each
    physical stage its own tp degree (the grouped runtime, with
    ``reshard`` naming each boundary's strategy).  Every field keeps the
    JAX package's validation."""
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

    @property
    def total_layers(self) -> int:
        return sum(self.layers_per_stage)

    @property
    def max_layers(self) -> int:
        return max(self.layers_per_stage)

    @property
    def grouped(self) -> bool:
        """True when the spec uses the grouped (non-uniform per-stage tp)
        runtime: a flat layout of :attr:`pipe_width` ranks."""
        return bool(self.stage_tp)

    @property
    def stage_tps(self) -> Tuple[int, ...]:
        """Effective per-physical-stage tp degrees (uniform or grouped)."""
        return self.stage_tp if self.stage_tp \
            else (self.tensor_parallel,) * self.num_stages

    @property
    def pipe_width(self) -> int:
        """Ranks of the grouped runtime's flat layout."""
        return sum(self.stage_tp) if self.stage_tp else self.num_stages

    @property
    def batch_allocations(self) -> Tuple[int, ...]:
        """Effective per-dp-replica microbatch allocations (uniform or
        non-uniform, DESIGN.md §13)."""
        return self.batch_domain if self.batch_domain \
            else (self.microbatches,) * self.data_parallel

    @property
    def total_microbatches(self) -> int:
        """Global-batch microbatch count Σ_r allocations[r]."""
        return sum(self.batch_allocations)


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
    JAX package's tp, dp and batch-domain fields: stages that disagree
    on tp give a grouped spec whose tp-changing boundaries take
    ``resharding.choose_strategy``'s pick, and a non-uniform
    ``batch_domain`` gives each replica its own allocation; non-uniform
    tp under a chunked schedule or with dp > 1 is refused with the JAX
    package's words.  ``verify=True`` gates on the copied static
    verifier (``analysis.verify_plan``)."""
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
    """The block kind a pipeline stage runs: dense, moe or ssm; other
    families raise."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the pipeline runs dense, moe and ssm blocks only.  The "
            f"JAX package's block_kind maps the hybrid family to 'dense' "
            f"(repro/models/config.py:94), so its pipeline has no hybrid "
            f"path to port (ROADMAP C)")
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the pipeline runs dense, moe and ssm blocks only.  The "
            f"JAX package's block_kind maps the audio family to 'dense' "
            f"(repro/models/config.py:89-95), and its pipeline slices "
            f"params['blocks'], which an encoder-decoder does not have "
            f"(KeyError: 'blocks'), so it has no audio path to port (ROADMAP C)")
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the pipeline runs dense, moe and ssm blocks only.  The "
            f"JAX package's block_kind maps the vlm family to 'dense' "
            f"(repro/models/config.py:94-95), and its pipeline embeds the tokens "
            f"alone (repro/core/heteropp.py:708, :885, :1378), so it drops the "
            f"image prefix silently and has no vlm path to port (ROADMAP C)")
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
                       stage: int, tp_rank: int = 0) -> PyTree:
    """Physical ``stage``'s share of the monolithic ``params``: block
    leaves ``(Lmax, ...)`` (single-chunk) or ``(v, Lcmax, ...)``
    (chunked: slot k holds global chunk-stage ``stage_slots[k]``), zero
    past each slot's layer count, and with the stage's tp degree
    (``spec.stage_tps[stage]``) above 1 sliced to tp member ``tp_rank``'s
    Megatron shard of that degree (``tp_rules.tp_local_slice``);
    ``embed`` and ``final_norm`` copied.  New tensors: the result shares
    no storage with ``params``."""
    pipeline_block_kind(cfg)
    validate_spec_tp(cfg, spec)
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

    blocks = tree_map(split, params["blocks"])
    tp = spec.stage_tps[stage]
    if tp > 1:
        stacked = 1 if spec.n_chunks == 1 else 2
        blocks = _unflatten(blocks, [
            tp_local_slice(path, leaf, tp_rank, tp, stacked=stacked)
            for path, leaf in flatten(blocks).items()])
    return {"blocks": blocks,
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
    ``final_norm`` replicated (once); every leaf at full width, whatever
    the spec's tp (the tp shards are ``local_stage_params``'; the JAX
    package lays a grouped spec out a rank at a time instead)."""
    S = spec.num_stages
    full = dataclasses.replace(spec, tensor_parallel=1, stage_tp=(), reshard=())
    per = [local_stage_params(params, cfg, full, s) for s in range(S)]
    blocks = tree_map(lambda *leaves: torch.stack(leaves),
                      *[p["blocks"] for p in per])
    mask = torch.stack([stage_mask(spec, s) for s in range(S)])
    return ({"blocks": blocks, "embed": per[0]["embed"],
             "final_norm": per[0]["final_norm"]}, mask)


def abstract_stage_params(cfg: ModelConfig, spec: PipelineSpec) -> PyTree:
    """``split_stage_params``' stage layout of the parameters on the meta
    device, nothing allocated (the JAX package's ``jax.eval_shape`` of
    it, ``repro/core/heteropp.py:499``)."""
    return split_stage_params(M.abstract_params(cfg), cfg, spec)[0]


# ---------------------------------------------------------------------------
# stage compute
# ---------------------------------------------------------------------------

def validate_tensor_parallel(cfg: ModelConfig, tp: int) -> None:
    """Check that the runtime can realize tp-degree ``tp`` for ``cfg``.

    The manual tp path shards attention heads and MLP ff Megatron-style
    (DESIGN.md §8), so it is limited to dense decoder blocks whose head /
    kv-head / ff counts divide tp; MoE / SSM / hybrid blocks keep tp as a
    cost-model dimension until their expert/state sharding is realized."""
    if tp == 1:
        return
    kind = cfg.block_kind
    if kind != "dense" or cfg.hybrid_attn_every or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"tensor_parallel={tp}: the 2-D (pipe, tp) runtime shards "
            f"dense decoder blocks only; {cfg.name} has block kind "
            f"{kind!r} (family {cfg.family!r}) — tp stays a cost-model "
            f"dimension for it (DESIGN.md §8)")
    refuse_undivided(cfg, tp, (("num_heads", cfg.num_heads),
                               ("num_kv_heads", cfg.num_kv_heads),
                               ("d_ff", cfg.d_ff)),
                     "tensor_parallel", "pick a tp that divides heads, kv heads and d_ff")


def refuse_undivided(cfg: ModelConfig, tp: int, counts, flag: str, why: str) -> None:
    """Raise ``ValueError`` naming the first of ``counts`` ((name, n)
    pairs: the counts tp members split) that ``tp`` (given as ``flag``)
    does not divide."""
    for what, n in counts:
        if n % tp:
            raise ValueError(
                f"{flag}={tp} does not divide {cfg.name}.{what}"
                f"={n}; {why}")


def validate_spec_tp(cfg: ModelConfig, spec: PipelineSpec) -> None:
    """Validate every tp degree a spec realizes — the uniform
    ``tensor_parallel`` or each distinct grouped ``stage_tp`` entry:
    the model's head / kv-head / ff counts must divide every degree."""
    for t in sorted(set(spec.stage_tps)):
        validate_tensor_parallel(cfg, t)


def _tp_local_cfg(cfg: ModelConfig, tp: int, whole=()) -> ModelConfig:
    """The per-member view of the model: each tp member owns 1/tp of the
    heads, kv heads and ff width; everything else (d_model, head_dim,
    rope, norms) is unchanged.  Where the kv heads are fewer than the
    members, a member's query heads share one kv head (the sharded train
    step's grid; the pipeline refuses such a tp).  A part the grid
    computes whole (``whole``: ``"attention"``, ``"mlp"``) keeps the whole
    model's heads or ff width."""
    if tp == 1:
        return cfg
    kw = {}
    if "attention" not in whole:
        kw.update(num_heads=cfg.num_heads // tp, num_kv_heads=max(1, cfg.num_kv_heads // tp))
    if "mlp" not in whole:
        kw.update(d_ff=cfg.d_ff // tp)
    return dataclasses.replace(cfg, **kw)


class _TPCopy(torch.autograd.Function):
    """Megatron's ``f``: identity forward; backward, the all-reduce of
    the gradient over the tp group (each member's heads or ff slice give
    a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_(g.contiguous().clone()), None


class _TPReduce(torch.autograd.Function):
    """Megatron's ``g``: forward, the all-reduce over the tp group of a
    row-parallel output (each member's part of the sum); identity
    backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_block_forward(p, cfg: ModelConfig, lcfg: ModelConfig, x, tp, *,
                      backend: str = "auto", enc_kv=None, ffn=None, whole=(), **attn_kw):
    """One block with manual Megatron tensor parallelism: ``p`` holds
    this member's shards (column-parallel wq/wk/wv/bq/bk/bv/wi/wg,
    row-parallel wo), so attention runs on its ``lcfg`` heads and the MLP
    on its ff slice; each sub-block's row-parallel output is summed over
    the tp group (``tp``, a :class:`~repro_torch.comm.p2p.P2P`) before
    the residual add, so activations stay replicated across tp.  A
    replicated attention leaf (the per-head qk-norm scales) sees only
    this member's heads, so it passes :class:`_TPCopy` too.  ``attn_kw``
    (positions, a vlm model's ``prefix_len``, an encoder's ``causal``)
    goes to the attention.  ``enc_kv`` (this member's cross K/V heads)
    adds a ``dec_cross`` block's cross-attention, sharded the same way;
    ``ffn(h)``, where given, takes the MLP's place and returns the
    members' summed output and metrics (a moe block's experts).  A
    sub-block named in ``whole`` (``"attention"``, the self and cross
    attention; ``"ffn"``, the MLP or ``ffn``) is the whole model's on
    every member (the sharded step's grid, ``sharding.spmd.whole_parts``):
    ``p`` holds its whole leaves, and it takes no :class:`_TPCopy` in and
    no :class:`_TPReduce` out.  Returns (x, metrics) as
    ``transformer.block_forward``."""
    copy = lambda t: _TPCopy.apply(t, tp)
    total = lambda t: _TPReduce.apply(t, tp)
    same = lambda t: t
    acopy, atotal = (same, same) if "attention" in whole else (copy, total)
    fcopy, ftotal = (same, same) if "ffn" in whole else (copy, total)
    h = acopy(layers.apply_norm(p["ln1"], x, cfg.norm))
    attn = {k: v if k in TP_COLUMN_PARAMS | TP_ROW_PARAMS else tree_map(acopy, v)
            for k, v in p["attn"].items()}
    x = x + atotal(attention.self_attention(attn, lcfg, h, backend=backend,
                                            rope=cfg.family != "audio", **attn_kw))
    if enc_kv is not None:
        h = acopy(layers.apply_norm(p["ln3"], x, cfg.norm))
        x = x + atotal(attention.cross_attention(p["xattn"], lcfg, h, enc_kv, backend))
    h = fcopy(layers.apply_norm(p["ln2"], x, cfg.norm))
    if ffn is not None:
        y, metrics = ffn(h)
        return x + y, metrics
    return x + ftotal(layers.apply_mlp(p["mlp"], h, cfg.mlp)), {}


def _stage_forward(blocks, mask_row, cfg, x, kind: str, remat: bool, *,
                   backend: str = "auto", tp=None, lcfg=None):
    """Run the valid layers of a stage's stacked ``blocks`` (``mask_row``
    True); a padded slot is skipped.  Returns (x, aux): aux is the fp32
    sum of the valid moe layers' ``moe_aux_loss + moe_z_loss`` (None
    without a valid moe layer).  ``remat`` checkpoints each layer, which
    returns its metrics beside x (its recompute issues the layer's tp
    all-reduces again).  With ``tp`` (the tp group) each layer is the
    Megatron block on ``lcfg``'s heads."""
    aux = None
    valid = [bool(v) for v in mask_row]
    if not any(valid):
        return x, aux
    for p, ok in zip(tfm.unstack(blocks), valid):
        if not ok:
            continue
        if tp is None:
            fn = lambda x, p=p: tfm.block_forward(p, cfg, x, kind, backend=backend)
        else:
            fn = lambda x, p=p: _tp_block_forward(p, cfg, lcfg, x, tp, backend=backend)
        x, m = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        if m:
            a = m["moe_aux_loss"] + m["moe_z_loss"]
            aux = a if aux is None else aux + a
    return x, aux


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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(S * v):
        if v == 1:
            s, blocks, mrow = g, _chunk(stage_params["blocks"], g), mask[g]
        else:
            s = sched.device_of(g, S)
            k = next(k for k in range(v)
                     if sched.global_stage(s, k, S) == g)
            blocks = _chunk(_chunk(stage_params["blocks"], s), k)
            mrow = mask[s, k]
        x, a = _stage_forward(blocks, mrow, cfg, x, kind, spec.recompute[s],
                              backend=backend)
        if a is not None:
            aux = aux + a
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = layers.unembed(params["embed"], x)
    return logits, aux


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


class _BoundaryHops:
    """The grouped runtime's tick exchange: this stage's output to the
    next stage and its input from the previous one, each across a
    :class:`~repro_torch.core.resharding.Boundary` with the spec's
    strategy, in one batch (single-chunk schedules only hop forward);
    the gradients go back by the reversed boundaries."""

    def __init__(self, spec: PipelineSpec, grid: Grid):
        S, s = spec.num_stages, grid.s
        cross = [RS.Boundary(grid.stage_ranks(i), grid.stage_ranks(i + 1), spec.reshard[i])
                 for i in range(S - 1)]
        self.p2p, self.gather = grid.boundary, grid.tp
        self.out = cross[s] if s < S - 1 else None     # y -> stage s + 1
        self.inp = cross[s - 1] if s > 0 else None     # x <- stage s - 1

    def forward(self, y, like):
        return RS.hop(self.p2p, like, send=(y, self.out) if self.out else None,
                      recv=self.inp, gather=self.gather)

    def backward(self, gx, like):
        return RS.hop(self.p2p, like,
                      send=(gx, self.inp.reversed()) if self.inp else None,
                      recv=self.out.reversed() if self.out else None, gather=self.gather)


def _check_grid(spec: PipelineSpec, grid: Grid) -> None:
    if spec.grouped:
        if grid.stage_tp != spec.stage_tp:
            raise ValueError(f"the rank layout has stage_tp {grid.stage_tp} but the "
                             f"PipelineSpec asks for {spec.stage_tp}")
        return
    want = (spec.data_parallel, spec.num_stages, spec.tensor_parallel)
    if grid.stage_tp or (grid.D, grid.S, grid.T) != want:
        raise ValueError(f"the rank grid is (dp {grid.D}, pipe {grid.S}, tp "
                         f"{grid.T}) but the PipelineSpec asks for (dp {want[0]}, "
                         f"pipe {want[1]}, tp {want[2]})")


def prepare_domain_tokens(spec: PipelineSpec, tokens: torch.Tensor) -> torch.Tensor:
    """The microbatches of ``tokens`` laid out a replica after another,
    ``spec.microbatches`` slots each (the JAX package's
    ``_prepare_domain_tokens``).  A uniform domain takes exactly ``dp ·
    b``.  A non-uniform one takes either the TIGHT replica-major layout
    (Σ allocations, replica r's ``allocations[r]`` consecutive), packed
    through ``dataparallel.pad_index_map`` (a pad slot repeats the
    replica's last microbatch and is never read), or the PADDED one (dp
    · max allocations), as it is."""
    dp, b = spec.data_parallel, spec.microbatches
    n = tokens.shape[0]
    if not spec.batch_domain:
        if n != dp * b:
            raise ValueError(
                f"tokens carry {n} microbatches but data_parallel={dp} "
                f"× microbatches={b} needs {dp * b} (uniform batch "
                f"domain — DESIGN.md §9)")
        return tokens
    from .dataparallel import pad_index_map
    total = spec.total_microbatches
    if n == total:
        return tokens[torch.tensor(pad_index_map(spec.batch_domain), device=tokens.device)]
    if n == dp * b:
        return tokens
    raise ValueError(
        f"tokens carry {n} microbatches but the batch domain "
        f"{list(spec.batch_domain)} needs {total} (tight replica-major) "
        f"or {dp * b} (padded per-replica — DESIGN.md §13)")


def make_pipeline_loss(cfg: ModelConfig, spec: PipelineSpec, grid: Grid, *,
                       backend: str = "auto",
                       clock: Optional[Callable[[], float]] = None):
    """This rank's part of the pipeline loss.  Returns ``loss_fn(params,
    tokens) -> (loss, grads)``: ``params`` is the rank's
    ``local_stage_params`` tree (floating leaves ``requires_grad``),
    ``tokens`` int, (D·b, mb_size, S), of which dp replica d takes
    microbatches ``d·b`` to ``d·b + b - 1``, or under a non-uniform
    batch domain either layout :func:`prepare_domain_tokens` takes
    (replica d runs its own ``batch_domain[d]``).  ``loss`` is the global
    mean CE over every replica, plus for moe the auxiliary losses summed
    over every stage, microbatch and replica and divided by the global
    microbatch count (a detached 0-d fp32 tensor, the same on every
    rank); ``grads`` is an fp32 tree shaped like ``params``, this
    rank's part of the global gradient: :func:`make_grad_sync` sums it
    over the grid (at dp 1 the block leaves are whole already, and the
    replicated leaves need their sum over the stages).  On a grouped spec
    ``grid`` is :meth:`Grid.grouped`'s layout: each stage runs its own tp
    degree and the boundary hops reshard.  ``loss_fn.stats`` holds the
    last call's tick count and collectives (``Grid.counts``).

    ``clock`` (``obs.runtime.trace_pipeline``'s fenced timer) stamps the
    tick loop itself, so a traced call runs the very program an untraced
    one runs: ``stats["tick_stamps"]`` holds ``"forward"``, one
    ``(tick, active, mb, chunk, emit, start, computed, exchanged)`` a
    tick (the compute is the stage forward and an emitting tick's CE;
    then the exchange), and ``"backward"``, one ``(tick, active, start,
    computed, exchanged)`` a tick in the order run (the compute is the
    tick's ``autograd.grad``); a tick's exchange ends where the next
    tick starts.  A clocked call also counts the masked target tokens
    that its emitting ticks' CE consumed (``stats["ce_tokens"]``, this
    rank's) and keeps the denominator the loss divided by
    (``stats["denom"]``), for the tracer's cross-check.  Without a clock
    the loop calls nothing more: two ``is None`` tests a tick, a third on
    an emitting tick."""
    kind = pipeline_block_kind(cfg)
    validate_spec_tp(cfg, spec)
    _check_grid(spec, grid)
    p2p, tp = grid.pipe, grid.tp
    S, s = spec.num_stages, grid.s
    b, bmax = spec.batch_allocations[grid.d], spec.microbatches
    lcfg = _tp_local_cfg(cfg, grid.T)
    tables = spmd_tick_tables(_spec_schedule(spec), S, b)
    if spec.grouped:
        hops, routes = _BoundaryHops(spec, grid), None
    else:
        hops, routes = None, _Routes.of(tables, S)
    mask = stage_mask(spec, s)
    mask = mask[None] if spec.n_chunks == 1 else mask
    remat = spec.recompute[s]
    dtype = layers.dtype_of(cfg)
    # the aux is a mean over the global batch's microbatches
    inv_mb = 1.0 / spec.total_microbatches
    rows = [(bool(tables.active[t, s]), int(tables.mb[t, s]),
             int(tables.chunk[t, s]), int(tables.src[t, s]),
             bool(tables.emit[t, s])) for t in range(tables.ticks)]

    def loss_fn(params, tokens):
        tokens = prepare_domain_tokens(spec, tokens)[grid.d * bmax:grid.d * bmax + b]
        _, mb_size, seq = tokens.shape
        dev = tokens.device
        like = torch.empty((mb_size, seq, cfg.d_model), dtype=dtype, device=dev)
        blocks = params["blocks"] if spec.n_chunks > 1 \
            else tree_map(lambda t: t[None], params["blocks"])
        targets = torch.cat([tokens[:, :, 1:], torch.zeros_like(tokens[:, :, :1])],
                            dim=2)
        lmask = torch.ones((mb_size, seq), dtype=torch.float32, device=dev)
        lmask[:, -1] = 0.0
        c0 = grid.counts()
        # denom is a token count: the emitting ticks' masks, summed over
        # the stages and replicas once (every tp member holds the same count)
        denom = torch.tensor(float(sum(e for a, _, _, _, e in rows if a))
                             * float(lmask.sum()), dtype=torch.float32, device=dev)
        grid.stage_sum_(denom)
        inv_denom = 1.0 / max(float(denom), 1.0)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
        ce_tokens = 0.0

        # ---- forward: tick by tick ----
        records: List[Optional[tuple]] = []
        x_prev = x_next = y_loc = None
        fwd_stamps, bwd_stamps = [], []
        for t, (active, mb, ck, src, emit) in enumerate(rows):
            if clock is not None:
                fwd_stamps.append((t, active, mb, ck, emit, clock()))
            y = None
            if active:
                toks = tokens[mb]
                if src == SRC_INJECT:
                    x, leaf = layers.embed_tokens(params["embed"], toks).to(dtype), None
                else:
                    x = {SRC_PREV: x_prev, SRC_NEXT: x_next, SRC_LOCAL: y_loc}[src]
                    leaf = x = x.detach().requires_grad_()
                y, aux = _stage_forward(_chunk(blocks, ck), mask[ck], cfg, x, kind,
                                        remat, backend=backend, tp=tp, lcfg=lcfg)
                if aux is not None:
                    aux_acc = aux_acc + aux.detach()
                ce = None
                if emit:
                    h = layers.apply_norm(params["final_norm"], y, cfg.norm)
                    ce = M.chunked_ce(params["embed"], h, targets[mb], lmask)
                    loss_acc = loss_acc + ce.detach()
                    if clock is not None:
                        ce_tokens = ce_tokens + lmask.sum()
                records.append((leaf, y, ce, aux, src))
            else:
                records.append(None)
            if clock is not None:
                fwd_stamps[-1] += (clock(),)
            if t < tables.ticks - 1 and hops is not None:
                x_prev = hops.forward(y, like)
            elif t < tables.ticks - 1:
                x_prev, x_next = _exchange(p2p, routes.perm_f, routes.perm_b, y, like)
                y_loc = y.detach() if routes.local and y is not None else None
        if clock is not None:
            fwd_end = clock()
        loss = grid.stage_sum_(loss_acc) * inv_denom
        if kind == "moe":
            loss = loss + grid.stage_sum_(aux_acc) * inv_mb

        # ---- backward: reverse tick order, gradients along the routes ----
        leaves = tree_leaves(params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        dy_f = dy_b = dy_loc = None          # gradients of this tick's y
        for t in range(tables.ticks - 1, -1, -1):
            if clock is not None:
                bwd_stamps.append((t, records[t] is not None, clock()))
            rec, records[t] = records[t], None
            gx, src = None, None
            if rec is not None:
                leaf, y, ce, aux, src = rec
                outs, gouts = [], []
                dy = _sum([dy_f, dy_b, dy_loc])
                if dy is not None:
                    outs.append(y)
                    gouts.append(dy.to(y.dtype))
                if ce is not None:
                    outs.append(ce * inv_denom)
                    gouts.append(None)
                if aux is not None:
                    outs.append(aux * inv_mb)
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
                del rec, leaf, y, ce, aux, outs
            if clock is not None:
                bwd_stamps[-1] += (clock(),)
            if t > 0 and hops is not None:
                dy_f = hops.backward(gx if src == SRC_PREV else None, like)
            elif t > 0:
                # the input's gradient goes back to the rank that sent it
                # (the reverse of the forward's perms); what arrives is
                # the gradient of this rank's output of tick t - 1
                dy_f, dy_b = _exchange(
                    p2p, _Routes.reverse(routes.perm_f), _Routes.reverse(routes.perm_b),
                    None, like, sends=(gx if src == SRC_PREV else None,
                                       gx if src == SRC_NEXT else None))
                dy_loc = gx if src == SRC_LOCAL else None
        if clock is not None:
            stamps = {"forward": _close_stamps(fwd_stamps, fwd_end),
                      "backward": _close_stamps(bwd_stamps, clock())}
        grads = _unflatten(params, acc)
        loss_fn.stats = _stats(tables, grid, c0)
        if clock is not None:
            loss_fn.stats.update(tick_stamps=stamps, ce_tokens=float(ce_tokens),
                                 denom=float(denom))
        return loss, grads

    loss_fn.tables = tables
    loss_fn.stats = {}
    return loss_fn


def _close_stamps(stamps, end):
    """Each tick's stamps with its exchange's end appended: the next
    tick's start, ``end`` for the last tick."""
    ends = [row[-2] for row in stamps[1:]] + [end]
    return [row + (e,) for row, e in zip(stamps, ends)]


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


def _stats(tables, grid: Grid, start: Dict[str, float]) -> Dict[str, Any]:
    """A call's tick count and, since ``start`` (``grid.counts()``), its
    collectives: the hops' bytes sent, wall seconds (waits for the peer
    included) and the staging copies' seconds in them; the wall seconds
    of the loss, token-count and replicated-gradient all-reduces
    (``reduce_s``), the tp all-reduces, the dp sync (all-reduce,
    reduce-scatter, all-gather) and the clip norm's all-reduce."""
    now = grid.counts()
    out: Dict[str, Any] = {"ticks": int(tables.ticks)}
    for key, v in now.items():
        out[key] = type(v)(v - start[key])
    return out


# ---------------------------------------------------------------------------
# the train step: dp gradient sync, the clip norm over the grid, AdamW
# ---------------------------------------------------------------------------

def zero1_dims(params: PyTree, spec: PipelineSpec, grad_sync: str) -> PyTree:
    """The dim of each leaf of a rank's stage tree on which ZeRO-1 shards
    its gradient and optimizer state over dp
    (``grad_sync.zero1_scatter_dim`` of the rank-local shape, the tp dim
    taken), or None for a leaf synced whole (every leaf outside ZeRO-1:
    ``grad_sync`` ``psum``, or dp 1)."""
    D, T = spec.data_parallel, spec.tensor_parallel
    stacked = 1 if spec.n_chunks == 1 else 2
    flat = flatten(params)
    if D == 1 or grad_sync != "reduce_scatter":
        return _unflatten(params, [None] * len(flat))

    def dim(path, leaf):
        taken = []
        if path.startswith("blocks/") and T > 1:
            d = tp_body_dim(path, leaf.ndim - stacked)
            if d is not None:
                taken.append(stacked + d)
        return zero1_scatter_dim(tuple(leaf.shape), D, taken)

    return _unflatten(params, [dim(p, leaf) for p, leaf in flat.items()])


def stage_opt_state(params: PyTree, spec: PipelineSpec, grid: Grid,
                    grad_sync: str = "reduce_scatter") -> PyTree:
    """AdamW state (fp32 master, m, v) for a rank's stage tree: whole, or
    under ZeRO-1 (dp > 1, ``reduce_scatter``) each leaf's dp slice
    ``grid.d`` on its :func:`zero1_dims` dim (1/D of the bytes)."""
    D = spec.data_parallel
    part = lambda p, d: p if d is None else p.detach().chunk(D, d)[grid.d]
    return adamw.init_opt_state(tree_map(part, params, zero1_dims(params, spec, grad_sync)))


def leaf_axes(params: PyTree, spec: PipelineSpec, dims: PyTree,
              stage: int = 0) -> List[tuple]:
    """Each leaf's grid axes (``grad_sync.spec_axes`` input) on a rank of
    physical ``stage``: block leaves are sharded over pipe, over tp on
    their Megatron dim (where the stage's tp degree is above 1), and over
    dp on their ZeRO-1 dim; the replicated leaves over dp on theirs."""
    stacked = 1 if spec.n_chunks == 1 else 2
    out = []
    for (path, leaf), d in zip(flatten(params).items(), tree_leaves(dims)):
        axes = ["dp"] if d is not None else []
        if path.startswith("blocks/"):
            axes.append("pipe")
            if spec.stage_tps[stage] > 1 and \
                    tp_body_dim(path, leaf.ndim - stacked) is not None:
                axes.append("tp")
        out.append(tuple(axes))
    return out


def _bucketed_dp_psum(grads: PyTree, grid: Grid, n_chunks: int,
                      bucket_bytes: int) -> None:
    """Fused per-bucket all-reduces in wgrad-completion order, in place:
    the JAX package's ``_bucketed_dp_psum``.

    The gradient stream is ordered the way backward finalizes it: later
    chunk slots first, block leaves in reverse flatten order within a
    slot, and the replicated ``embed`` / ``final_norm`` last.  The
    coalescing is ``grad_sync.bucketize``, applied per run of one dtype:
    block leaves sum over dp.  The replicated leaves sum over pipe ∪ dp
    (``grid.rep``; the reference has summed them over the pipe already
    and sums them over dp here), one all-reduce a leaf: gloo's and
    NCCL's rings sum an element of a group of more than two ranks in an
    order set by its place in the buffer, so a fused buffer would round
    differently.  A dp group of two sums each element as a + b wherever
    it lies, so at dp 2 the result is bit-identical to the per-leaf
    all-reduces (beyond two, equal to rounding)."""
    flat = list(flatten(grads).items())
    nleaves = len(flat)
    entries = []        # (completion-order key, tensor: a view of a block leaf)
    for i, (path, leaf) in enumerate(flat):
        if path.startswith("blocks/") and n_chunks > 1:
            for k in range(n_chunks):
                entries.append(((n_chunks - 1 - k, nleaves - i), leaf[k]))
        elif path.startswith("blocks/"):
            entries.append(((0, nleaves - i), leaf))
    entries.sort(key=lambda e: e[0])

    run: List[torch.Tensor] = []          # maximal run of one dtype

    def flush_run():
        if not run:
            return
        gb = bucketize([(str(j), t.numel() * t.element_size())
                        for j, t in enumerate(run)], bucket_bytes)
        for bucket in gb.buckets:
            parts = [run[int(name)] for name, _ in bucket]
            if len(parts) == 1:
                grid.dp.all_reduce_(parts[0])
                continue
            fused = grid.dp.all_reduce_(torch.cat([t.reshape(-1) for t in parts]))
            for t, piece in zip(parts, fused.split([t.numel() for t in parts])):
                t.copy_(piece.view(t.shape))
        run.clear()

    for _, t in entries:
        if run and t.dtype != run[0].dtype:
            flush_run()
        run.append(t)
    flush_run()
    for i in reversed(range(nleaves)):
        path, leaf = flat[i]
        if not path.startswith("blocks/"):
            grid.stage_sum_(leaf)


def make_grad_sync(spec: PipelineSpec, grid: Grid, grad_sync: str = "reduce_scatter"):
    """The gradient sync of the train step (the JAX package's
    ``_make_dp_train_step``), for gradients from
    :func:`make_pipeline_loss`.  Returns ``sync(grads, dims) -> grads`` with
    ``dims`` :func:`zero1_dims`: the replicated leaves are summed over
    the stages and replicas, one all-reduce a leaf (``Grid.stage_sum_``:
    pipe ∪ dp, or one member a stage on a grouped layout); the block
    leaves over dp by
    ``grad_sync``: ``psum``, one all-reduce a leaf, or with
    ``spec.bucket_bytes`` > 0 fused buckets in wgrad-completion order
    (:func:`_bucketed_dp_psum`); or ``reduce_scatter`` (ZeRO-1): a
    reduce-scatter a leaf on its ``dims`` dim, where the replicated
    leaves keep their slice of the sum.  ``grad_sync`` means nothing at
    dp 1.  In place where the result is whole."""
    if grad_sync not in GRAD_SYNC_MODES:
        raise ValueError(f"grad_sync {grad_sync!r} not in {GRAD_SYNC_MODES}")
    D = spec.data_parallel

    def sync(grads, dims):
        if D > 1 and grad_sync == "psum" and spec.bucket_bytes > 0:
            _bucketed_dp_psum(grads, grid, spec.n_chunks, spec.bucket_bytes)
            return grads
        out = []
        for (path, g), d in zip(flatten(grads).items(), tree_leaves(dims)):
            if not path.startswith("blocks/"):
                grid.stage_sum_(g)
                out.append(g if d is None else g.chunk(D, d)[grid.d].contiguous())
            elif D == 1:
                out.append(g)
            elif d is None:
                out.append(grid.dp.all_reduce_(g))
            else:
                out.append(grid.dp.reduce_scatter_(g, d))
        return _unflatten(grads, out)

    return sync


def make_pipeline_train_step(cfg: ModelConfig, spec: PipelineSpec, grid: Grid,
                             opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                             backend: str = "auto", grad_sync: str = "reduce_scatter"):
    """This rank's train step: the pipeline loss and gradients, the dp
    sync (:func:`make_grad_sync`), the global gradient norm for the clip
    over the whole grid (``grad_sync.replica_grad_norm``), and AdamW on
    the rank's stage tree (the replicated leaves get the same update on
    every rank).  Under ZeRO-1 AdamW updates this replica's slices of the
    dp-sharded (master, m, v), and one all-gather a leaf rebuilds the
    parameters.  Returns ``train_step(state, tokens) -> (state,
    metrics)`` over a ``training.train_step.TrainState`` of
    ``local_stage_params`` whose optimizer state is
    :func:`stage_opt_state`'s; ``train_step.stats`` holds the last step's
    tick count and collectives."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    sync = make_grad_sync(spec, grid, grad_sync)
    loss_fn = make_pipeline_loss(cfg, spec, grid, backend=backend)
    D = spec.data_parallel
    # a leaf replicated in a stage's tp group has that stage's tp_s copies
    sizes = {"pipe": spec.num_stages, "tp": grid.T, "dp": D}

    def train_step(state, tokens):
        c0 = grid.counts()
        loss, grads = loss_fn(state.params, tokens)
        dims = zero1_dims(state.params, spec, grad_sync)
        grads = sync(grads, dims)
        gnorm = replica_grad_norm(tree_leaves(grads),
                                  leaf_axes(state.params, spec, dims, grid.s),
                                  sizes, grid.world.all_reduce_)
        # ZeRO-1 updates this replica's slices into buffers of the
        # parameters' dtype and gathers them into the parameters
        parts = tree_map(lambda p, d: p if d is None else torch.empty_like(
            p.detach().chunk(D, d)[0]), state.params, dims)
        _, _, om = adamw.apply_update(opt_cfg, state.opt_state, grads, state.step,
                                      parts, grad_norm=gnorm)
        with torch.no_grad():
            for p, part, d in zip(tree_leaves(state.params), tree_leaves(parts),
                                  tree_leaves(dims)):
                if d is not None:
                    grid.dp.all_gather_(p, part, d)
        state.step += 1
        train_step.stats = _stats(loss_fn.tables, grid, c0)
        return state, {"loss": loss, **om}

    train_step.tables = loss_fn.tables
    train_step.stats = {}
    return train_step
