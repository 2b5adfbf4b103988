"""The meta-device dry-run: what one rank of a production mesh holds and
does in a train step, a prefill or a decode step, estimated without a
card (the counterpart of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch all --shape train_4k --both-meshes

The reference lowers and compiles each step under GSPMD on 512 host
placeholder devices and reads the compiled HLO.  The port has no HLO;
for each (arch, shape, mesh) this runs the port's own train step
(``sharding/spmd.py``, or ``training/manual_dp.py``'s ZeRO-1 under
``--dp-mode manual``) once on the meta device, as rank (d, k) of the
mesh (``--rank``, (0, 0) by default), over a grid of counting stand-ins
(``comm.p2p.Grid.standin``) that count each collective instead of moving
it, under :class:`~repro_torch.launch.meta_analysis.MetaAnalysis`.  The
kernels take the card's path without launching (``kernels.ops.
estimating``).  Each combination writes ``<arch>__<shape>__<mesh>.json``
to ``--out``:

* ``argument_bytes``: the rank's blocks of the state and its rows of
  the batch, what the step is given;
* ``state_bytes`` beside ``block_bytes``, ``spmd.block_bytes``' closed
  form of the same blocks (equal, or the combination fails); under
  ``--dp-mode manual`` also ``optimizer_bytes`` beside
  ``manual_dp.optimizer_bytes``;
* ``peak_bytes``, ``flops`` and ``bytes`` (the HBM proxy) of the step;
* ``collectives``: bytes and calls by axis (``data``, ``model``,
  ``world``) and kind (``gather``, ``scatter``, ``reduce``);
* ``n_devices``, ``wall_s`` and ``activations``, the activation layout
  the estimate reports: the port's, whole rows of the rank's batch
  replicated over the model axis, not GSPMD's sequence-parallel
  activations;
* ``whole``: the parts of a block each member computes whole, with the
  count the model axis does not split (``spmd.whole_parts``), and beside
  it ``whole_note``: such a part's FLOPs count on every member.

The serve shapes (``prefill_32k``, ``decode_32k``, ``long_500k``) run
the grid's serve steps (``spmd.make_prefill_step`` /
``make_decode_step``) once the same way (:func:`estimate_serve`): the
rank's blocks of the weights (FSDP, as the reference's
``tree_param_shardings``; of them a decode reads all but a whisper
model's encoder, ``spmd.decode_params``), its rows of the prompts or of the decode
tokens, and for decode its block of ``abstract_serve_cache`` under
``rules.cache_shardings`` at the shape's last position.  Their record
has ``argument_bytes`` (weights, cache, tokens and the reference's int32
position), ``cache_bytes`` beside ``cache_block_bytes``, the closed
form (equal, or the combination fails), the step's peak, FLOPs,
HBM-proxy bytes and collectives (a hybrid model's ssm cache moved
between the rule's blocks and the blocks its layers compute on among
them, ``spmd.Layout.reblock``; ``reblock`` has their bytes and calls by
axis), and ``copy_bytes``, the bytes of a whisper cross cache's blocks
copied into ``flash_decode``'s layout.

A combination is ``ok``, ``refused`` (with the reason: a batch the data
axes do not split; shapes the card's kernels would refuse, ``analysis.card_lint``, with their codes in ``codes``; a
decode the cache plan refuses, full attention at 500k, as the reference
skips it) or
``failed`` (with the traceback); the process exits non-zero only on ``failed``.  The
reference's environment knobs are flags: ``--cfg-set``, ``--accum``,
``--accum-dtype``, ``--dp-mode`` and ``--remat-policy``.  The numbers
are estimates made on the host; they state no time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from ..analysis import card_lint
from ..comm.p2p import Grid
from ..configs import ASSIGNED, canonical, get_config
from ..models.config import ModelConfig
from ..sharding import rules, spmd
from ..training import manual_dp
from ..models import model as M
from ..training.serve_step import abstract_serve_cache
from ..training.train_step import abstract_train_state, make_train_step, train_state_from
from ..tree import tree_leaves
from . import shapes as SH
from .mesh import Mesh, make_production_mesh
from .meta_analysis import MetaAnalysis

ACTIVATIONS = ("the port's: whole rows of the rank's batch, replicated over the model "
               "axis (not GSPMD's sequence-parallel activations)")
WHOLE_NOTE = ("each part in whole is computed whole on every member of the model axis, "
              "its FLOPs counted on each")
DP_MODES = ("gspmd", "manual")
REMAT = {"full": None, "dots": "dots"}
KINDS = ("gather", "scatter", "reduce")
AXES = ("data", "model", "world")
# the words of what a grid refuses: a batch the data axes do not split, a
# serve shape out of scope
REFUSED = ("does not divide", "does not split", "out of scope")
H100_BYTES = 80e9               # an NVIDIA H100 80GB HBM3's memory


def apply_overrides(cfg: ModelConfig, cfg_set: str) -> ModelConfig:
    """``cfg`` with the fields of ``cfg_set`` (``"a=1,b=2"``) replaced,
    each parsed as its current value's type."""
    if not cfg_set:
        return cfg
    kv = {}
    for part in cfg_set.split(","):
        k, v = part.split("=")
        kv[k] = type(getattr(cfg, k))(v)
    return dataclasses.replace(cfg, **kv)


def adaptive_accum(cfg: ModelConfig, shape: SH.InputShape, mesh: Mesh,
                   accum: Optional[int] = None) -> int:
    """The reference's adaptive accumulation (``repro/launch/dryrun.py:
    139-153``): the fewest microbatches whose activations fit, by the
    parameter count, unless ``accum`` is given, and never fewer rows a
    microbatch than the data axes."""
    data = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    n = cfg.param_count()
    if accum is not None:
        base = accum
    elif n > 1e11:
        base = 16
    elif n > 5e10:
        base = 8
    elif n > 2e10:
        base = 4
    elif n > 5e9:
        base = 2
    else:
        base = 1
    return max(1, min(base, shape.global_batch // data))


def mesh_name(mesh: Mesh) -> str:
    if dict(mesh.shape) == {"data": 16, "model": 16}:
        return "pod16x16"
    if dict(mesh.shape) == {"pod": 2, "data": 16, "model": 16}:
        return "pod2x16x16"
    return "mesh" + "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def collectives(stats: Dict[str, float]) -> Dict[str, Dict[str, Dict[str, int]]]:
    """A step's ``Layout.counts`` as {axis: {kind: {bytes, calls}}}."""
    return {a: {k: {"bytes": int(stats[f"{a}_{k}_bytes"]),
                    "calls": int(stats[f"{a}_{k}_calls"])} for k in KINDS} for a in AXES}


def standin_layout(mesh: Mesh, rank: Tuple[int, int] = (0, 0)) -> spmd.Layout:
    """Rank ``rank`` = (d, k) of ``mesh`` on a grid of counting stand-ins."""
    data = math.prod(mesh.shape[a] for a in rules.data_axes(mesh))
    model = mesh.shape[rules.model_axis(mesh)] if rules.model_axis(mesh) else 1
    return spmd.Layout(mesh, Grid.standin(dp=data, tp=model, d=rank[0], k=rank[1]))


def _steps(cfg, layout, mesh, kw, dp_mode):
    """(the step, its state's specs or None, the state on meta) as the
    launcher runs it on ``mesh``: one device's ``make_train_step`` on a
    mesh of one, else the grid's step (``dp_mode``)."""
    if mesh.size == 1:
        step = make_train_step(cfg, remat_policy=kw["remat_policy"],
                               accum_steps=kw["accum_steps"], accum_dtype=kw["accum_dtype"])
        whole = abstract_train_state(cfg)
        return step, None, train_state_from(whole.params, whole.opt_state, 0)
    if dp_mode == "manual":
        step, specs = manual_dp.make_manual_dp_train_step(cfg, layout, read_metrics=False,
                                                          **kw)
    elif dp_mode == "gspmd":
        step = spmd.make_train_step(cfg, layout, read_metrics=False, **kw)
        specs = step.specs
    else:
        raise ValueError(f"unknown dp mode {dp_mode!r}; expected one of {DP_MODES}")
    return step, specs, spmd.abstract_state(cfg, layout, specs)


def state_specs(cfg: ModelConfig, mesh: Mesh, dp_mode: str = "gspmd"):
    """The state's specs on ``mesh`` under ``dp_mode``."""
    if dp_mode == "manual":
        return manual_dp.state_specs(cfg, mesh)[0]
    return spmd.state_specs(cfg, mesh)


def rank_state_bytes(cfg: ModelConfig, mesh: Mesh, rank: Tuple[int, int],
                     dp_mode: str = "gspmd") -> Tuple[int, int]:
    """(persistent bytes, of them the optimizer's: fp32 master, m, v) of
    rank ``rank``'s blocks on ``mesh``, from its blocks on meta, without
    a step."""
    layout = standin_layout(mesh, rank)
    state = spmd.abstract_state(cfg, layout, state_specs(cfg, mesh, dp_mode))
    return spmd.state_bytes(state), sum(t.numel() * t.element_size()
                                        for t in tree_leaves(state.opt_state))


def estimate(cfg: ModelConfig, mesh: Mesh, shape: SH.InputShape, *,
             rank: Tuple[int, int] = (0, 0), accum: int = 1,
             accum_dtype: str = "float32", dp_mode: str = "gspmd",
             remat_policy: Optional[str] = None) -> Dict[str, object]:
    """One train step of ``cfg`` at ``shape`` (global batch and sequence)
    as rank ``rank`` = (d, k) of ``mesh``, on the meta device: the
    record's numbers (see the module's docstring).  A mesh of one device
    runs the single device's step, as the launcher does.  Raises what the
    step raises (a batch the data axes do not split) and
    ``card_lint.CardRefusal`` where the card's kernels would refuse a
    member's shapes."""
    layout = standin_layout(mesh, rank)
    card_lint.require(cfg, seq_len=shape.seq_len, heads_per_member=layout.model)
    kw = dict(accum_steps=accum, accum_dtype=accum_dtype, remat_policy=remat_policy)
    step, specs, state = _steps(cfg, layout, mesh, kw, dp_mode)
    rows = len(spmd.local_rows(shape.global_batch, layout, accum))
    batch = {k: v.new_empty((rows, *v.shape[1:]))
             for k, v in SH.input_specs(cfg, shape).items()}
    leaves = tree_leaves(state.params) + tree_leaves(state.opt_state)
    state_bytes = spmd.state_bytes(state)
    batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
    mode = MetaAnalysis()
    t0 = time.perf_counter()
    with mode:
        mode.track(leaves + list(batch.values()))
        step(state, batch)
    wall = time.perf_counter() - t0
    stats = getattr(step, "stats", None) or layout.counts()
    rec = {"rank": list(rank), "n_devices": mesh.size, "accum": accum,
           "accum_dtype": accum_dtype, "dp_mode": dp_mode if mesh.size > 1 else "single",
           "argument_bytes": state_bytes + batch_bytes, "batch_bytes": batch_bytes,
           "state_bytes": state_bytes,
           "block_bytes": state_bytes if specs is None else
           sum(spmd.block_bytes(cfg, layout, specs).values()),
           **mode.report(), "collectives": collectives(stats),
           "collective_total": sum(stats[f"{a}_{k}_bytes"] for a in AXES for k in KINDS),
           "step_s": wall, "activations": ACTIVATIONS,
           "whole": spmd.whole_parts(cfg, layout.model), "whole_note": WHOLE_NOTE}
    if dp_mode == "manual" and mesh.size > 1:
        rec["optimizer_bytes"] = sum(t.numel() * t.element_size()
                                     for t in tree_leaves(state.opt_state))
        rec["optimizer_closed"] = manual_dp.optimizer_bytes(cfg, layout)
    return rec


def estimate_serve(cfg: ModelConfig, mesh: Mesh, shape: SH.InputShape, *,
                   rank: Tuple[int, int] = (0, 0), backend: str = "auto",
                   cache_len: Optional[int] = None) -> Dict[str, object]:
    """One prefill (``shape.kind`` ``"prefill"``: the prompts of
    ``shape.seq_len`` into a cache of as many slots, or of ``cache_len``
    where given, a vlm model's prefix besides) or decode step (the token at the shape's last position
    against ``abstract_serve_cache``) of ``cfg`` as rank ``rank`` of
    ``mesh`` on the meta device: the record's numbers (see the module's
    docstring).  Raises what the steps raise (the cache plan's refusals)
    and ``card_lint.CardRefusal`` as :func:`estimate` does."""
    layout = standin_layout(mesh, rank)
    # a decode step runs no scan over the sequence
    card_lint.require(cfg, seq_len=shape.seq_len if shape.kind == "prefill" else None,
                      heads_per_member=layout.model)
    B = shape.global_batch
    params = spmd.tree_blocks(M.abstract_params(cfg), layout, spmd.param_specs(cfg, mesh))
    rows = len(spmd.local_rows(B, layout, serving=True))
    if shape.kind == "prefill":
        cache_len = shape.seq_len if cache_len is None else cache_len
        step = spmd.make_prefill_step(cfg, layout, cache_len, batch=B, backend=backend)
        inputs = {k: v.new_empty((rows, *v.shape[1:]))
                  for k, v in SH.input_specs(cfg, shape).items()}
        args, cache = (params, inputs), None
        closed = spmd.cache_block_bytes(cfg, layout, B, cache_len + cfg.num_prefix_tokens)
    else:
        step = spmd.make_decode_step(cfg, layout, shape.seq_len, batch=B, backend=backend)
        specs = spmd.cache_specs(cfg, mesh, B, shape.seq_len)
        cache = spmd.tree_blocks(abstract_serve_cache(cfg, B, shape.seq_len), layout, specs)
        tokens = SH.decode_specs(cfg, shape)["tokens"]
        inputs = {"tokens": tokens.new_empty((rows, 1))}
        args = (params, cache, inputs["tokens"], shape.seq_len - 1)
        closed = spmd.cache_block_bytes(cfg, layout, B, max(step.plan["cache_len"], 1))
    read = params if shape.kind == "prefill" else spmd.decode_params(cfg, params)
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(read))
    batch_bytes = sum(t.numel() * t.element_size() for t in inputs.values())
    mode = MetaAnalysis()
    t0 = time.perf_counter()
    with mode:
        mode.track(tree_leaves(params) + list(inputs.values())
                   + (list(spmd.cache_leaves(cache).values()) if cache is not None else []))
        _, _, out = step(*args)
    wall = time.perf_counter() - t0
    cache_bytes = spmd.cache_bytes(out)
    # the reference's decode also takes the position, an int32 scalar, which
    # its compiled step keeps where it reads it (an ssm model's does not)
    pos_bytes = 4 if shape.kind == "decode" and cfg.family != "ssm" else 0
    return {"rank": list(rank), "n_devices": mesh.size, "accum": 1, "kind": shape.kind,
            "argument_bytes": param_bytes + batch_bytes + pos_bytes
            + (cache_bytes if cache is not None else 0),
            "param_bytes": param_bytes, "batch_bytes": batch_bytes,
            "cache_bytes": cache_bytes, "cache_block_bytes": closed,
            **mode.report(), "collectives": collectives(step.stats),
            "collective_total": sum(step.stats[f"{a}_{k}_bytes"] for a in AXES for k in KINDS),
            "reblock": {a: {w: step.stats[f"reblock_{a}_{w}"] for w in ("bytes", "calls")}
                        for a in ("data", "model")},
            "copy_bytes": step.stats["copy_bytes"], "step_s": wall, "activations": ACTIVATIONS,
            "whole": step.stats["whole"], "whole_note": WHOLE_NOTE}


def _card_refusal(e: card_lint.CardRefusal) -> Dict[str, object]:
    return {"status": "refused", "reason": "; ".join(d.format() for d in e.diagnostics),
            "codes": sorted({d.code for d in e.diagnostics})}


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               out_dir: Optional[str] = None, *, mesh: Optional[Mesh] = None,
               cfg: Optional[ModelConfig] = None, shape: Optional[SH.InputShape] = None,
               rank: Tuple[int, int] = (0, 0), cfg_set: str = "",
               accum: Optional[int] = None, accum_dtype: str = "float32",
               dp_mode: str = "gspmd", remat_policy: str = "full",
               tag: str = "") -> Dict[str, object]:
    """One combination's record (``status`` ``ok``, ``refused`` or
    ``failed``), written to ``out_dir`` when given.  ``mesh``, ``cfg``
    and ``shape`` replace the production mesh, ``arch``'s config and
    ``shape_name``'s shape where given."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(mesh) + (f"__{tag}" if tag else "")
    if tuple(rank) != (0, 0):
        name += f"__rank{rank[0]}_{rank[1]}"
    rec = {"arch": arch, "shape": shape_name, "mesh": name, "tag": tag,
           "overrides": cfg_set, "remat_policy": remat_policy, "status": "failed"}
    t0 = time.perf_counter()
    try:
        cfg = apply_overrides(cfg or get_config(arch), cfg_set)
        shape = shape or SH.SHAPES[shape_name]
        if shape.kind != "train":
            try:
                rec.update(estimate_serve(cfg, mesh, shape, rank=rank))
            except card_lint.CardRefusal as e:
                rec.update(_card_refusal(e))
            except (ValueError, NotImplementedError) as e:
                if not any(w in str(e) for w in REFUSED):
                    raise
                rec.update(status="refused", reason=str(e))
            else:
                rec["status"] = "ok"
                if rec["cache_bytes"] != rec["cache_block_bytes"]:
                    raise AssertionError(f"cache bytes {rec['cache_bytes']} are not the "
                                         f"rules' blocks {rec['cache_block_bytes']}")
        else:
            n = adaptive_accum(cfg, shape, mesh, accum)
            try:
                rec.update(estimate(cfg, mesh, shape, rank=rank, accum=n,
                                    accum_dtype=accum_dtype, dp_mode=dp_mode,
                                    remat_policy=REMAT[remat_policy]))
            except card_lint.CardRefusal as e:
                rec.update(_card_refusal(e))
            except (ValueError, NotImplementedError) as e:
                if not any(w in str(e) for w in REFUSED):
                    raise
                rec.update(status="refused", reason=str(e))
            else:
                rec["status"] = "ok"
                if rec["state_bytes"] != rec["block_bytes"]:
                    raise AssertionError(f"state bytes {rec['state_bytes']} are not the "
                                         f"rules' blocks {rec['block_bytes']}")
    except Exception:
        rec.update(status="failed", error=traceback.format_exc())
    rec["wall_s"] = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape_name}__{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _gib(x) -> str:
    return f"{x / 2**30:.2f}"


def table_row(rec) -> str:
    """A record as a markdown row: per-rank argument and peak GiB, FLOPs
    and HBM-proxy bytes a step, collective GiB by axis, and whether the
    peak fits the card."""
    if rec["status"] != "ok":
        why = rec.get("reason") or rec.get("error", "").strip().splitlines()[-1:]
        return (f"| {rec['arch']} | {rec['mesh']} | {rec['remat_policy']} | "
                f"{rec['status']}: {why} |" + " |" * 8 + f" {rec['shape']} |")
    coll = rec["collectives"]
    by_axis = " / ".join(_gib(sum(coll[a][k]["bytes"] for k in KINDS)) for a in AXES)
    fits = "yes" if rec["peak_bytes"] <= H100_BYTES else "no"
    whole = ", ".join(f"{k} ({v})" for k, v in rec["whole"].items()) or "-"
    return (f"| {rec['arch']} | {rec['mesh']} | {rec['remat_policy']} | ok | "
            f"{rec['accum']} | {_gib(rec['argument_bytes'])} | {_gib(rec['peak_bytes'])} | "
            f"{rec['flops'] / 1e12:.4g} | {rec['bytes'] / 1e12:.4g} | {by_axis} | {fits} | "
            f"{whole} | {rec['shape']} |")


TABLE_HEAD = ("| arch | mesh | remat | status | accum | argument GiB | peak GiB | TFLOP | "
              "HBM-proxy TB | collective GiB data / model / world | fits 80 GB | whole | shape |\n"
              "|---|---|---|---|---|---|---|---|---|---|---|---|---|")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all' (the assigned archs)")
    ap.add_argument("--shape", default="all",
                    help="input shape name, a comma list of them, or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    ap.add_argument("--cfg-set", default="",
                    help="comma list of config field overrides, e.g. ssm_chunk=128")
    ap.add_argument("--accum", type=int, default=None,
                    help="microbatches a step (default: the adaptive rule)")
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--dp-mode", choices=DP_MODES, default="gspmd")
    ap.add_argument("--remat-policy", choices=tuple(REMAT), default="full")
    ap.add_argument("--rank", default="0,0", help="the rank's (data, model) coordinate")
    ap.add_argument("--table", action="store_true",
                    help="end with the records as a markdown table")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(torch.get_num_threads(), 4))

    archs = ASSIGNED if args.arch == "all" else [canonical(args.arch)]
    shape_names = list(SH.SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    rank = tuple(int(x) for x in args.rank.split(","))
    counts = {"ok": 0, "refused": 0, "failed": 0}
    rows = []
    for arch in archs:
        for sn in shape_names:
            for mp in meshes:
                rec = dryrun_one(arch, sn, mp, args.out, rank=rank, cfg_set=args.cfg_set,
                                 accum=args.accum, accum_dtype=args.accum_dtype,
                                 dp_mode=args.dp_mode, remat_policy=args.remat_policy,
                                 tag=args.tag)
                counts[rec["status"]] += 1
                rows.append(table_row(rec))
                if rec["status"] == "ok":
                    what = (f"flops/dev={rec['flops']:.3e} peak={_gib(rec['peak_bytes'])}GiB "
                            f"coll/dev={rec['collective_total'] / 2**30:.2f}GiB")
                    if rec["whole"]:
                        what += " whole=" + ",".join(f"{k}:{v}" for k, v in rec["whole"].items())
                else:
                    what = rec.get("reason") or rec["error"].strip().splitlines()[-1]
                print(f"[{rec['status']:7s}] {arch:24s} {sn:12s} "
                      f"{'2x16x16' if mp else '16x16':8s} t={rec['wall_s']:6.1f}s {what}",
                      flush=True)
    print(f"\n{counts['ok']} ok, {counts['refused']} refused, {counts['failed']} failed")
    if args.table:
        print(TABLE_HEAD)
        print("\n".join(rows))
    return 1 if counts["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
