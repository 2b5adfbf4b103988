"""The port's HeteroPP on the grouped layout, where the stages disagree on
tp (DESIGN.md §12), held against the JAX package on the CPU.

One spawn of three gloo CPU ranks (``repro_torch.launch.ranks``; the
rank function is ``tests/helpers/torch_pipeline_ranks.py::grouped_cases``)
builds the layouts ``stage_tp`` (2, 1) and (1, 2) and runs each under
the ``sr_ag`` and the ``naive`` reshard, for qwen1.5-0.5b and granite-8b
with qk-norm (fp32 ``conftest.exact_cfg`` smoke configs, weights from
``repro.models.model.init_params``): the loss equals the mean of the JAX
package's ``M.loss_fn`` to 1e-5 rel, and the gradient, each stage's tp_s
shards put back together, equals ``jax.grad`` laid out as stages to 1e-4
of each leaf's largest entry (``tests/test_torch_heteropp.py``'s
limits).  One AdamW step with the clip norm active leaves the port's
single-device step's first moment, clip norm and update.  And
``resharding.reshard`` alone: the values each strategy delivers, and the
bytes its counters show crossing, beside the copied closed forms.
"""
import dataclasses
import math
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.core import heteropp as JHP
from repro_torch import bridge
from repro_torch.comm.p2p import Grid
from repro_torch.core import heteropp as THP, resharding as TRS
from repro_torch.core.tp_rules import tp_body_dim
from repro_torch.launch import ranks
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten
from test_torch_heteropp import GRAD_TOL, LOSS_RTOL, OPT, _jax_reference, _np
from test_torch_heteropp_grid import B, PHYS, SEQ, _case

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "helpers"))
import torch_pipeline_ranks as W  # noqa: E402

CPU = torch.device("cpu")
LAYOUTS = ((2, 1), (1, 2))
STRATEGIES = ("sr_ag", "naive")
# a clip far below the smoke configs' gradient norms, so the clip acts
OPT_CLIP = dict(OPT, grad_clip=0.1)
NORM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """Keep the parent's torch to two threads beside the other workers
    (ROADMAP: wall-clock tests share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    """Both layouts, both strategies, both configs, one train step each,
    and the reshard alone: one spawn of three ranks."""
    cases = [_case("qwen1p5_0p5b", 1, []),
             _case("granite_8b", 1, [], seed=5, qk_norm=True)]
    for _, case in cases:
        case["strategies"] = STRATEGIES
    res = ranks.spawn(W.grouped_cases, 3, (LAYOUTS, [c for _, c in cases], OPT_CLIP),
                      workdir=str(tmp_path_factory.mktemp("grouped")), threads=1,
                      timeout=300)
    return cases, res


def _assemble(res, layout, pick):
    """The tree ``pick`` takes from each rank's result on ``layout``, put
    together as the stage layout at full width: each stage's tp shards concatenated on
    their Megatron dim, block leaves stacked over stages, the replicated
    leaves once.  Copies that must agree (the replicated leaves on every
    rank, a tp-replicated block leaf on a stage's members) are held
    equal bit for bit."""
    li = LAYOUTS.index(layout)
    by = {tuple(r[li]["grid"]): flatten(pick(r[li])) for r in res}
    out = {}
    for path, first in by[(0, 0)].items():
        if not path.startswith("blocks/"):
            for tree in by.values():
                torch.testing.assert_close(tree[path], first, rtol=0, atol=0, msg=path)
            out[path] = first
            continue
        per_stage = []
        for s, t in enumerate(layout):
            shards = [by[(s, k)][path] for k in range(t)]
            dim = tp_body_dim(path, shards[0].ndim - 1) if t > 1 else None
            if dim is None:
                for shard in shards[1:]:
                    torch.testing.assert_close(shard, shards[0], rtol=0, atol=0, msg=path)
                per_stage.append(shards[0])
            else:
                per_stage.append(torch.cat(shards, 1 + dim))
        out[path] = torch.stack(per_stage)
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_grouped_tp_matches_jax(layout, strategy, three_ranks):
    """Each layout under each reshard: the same loss on every rank, the
    JAX package's loss and gradient (for qwen, and granite with qk-norm,
    whose per-head scales see one member's heads)."""
    cases, res = three_ranks
    for i, (jcfg, case) in enumerate(cases):
        key = f"{i} {strategy}"
        want_loss, jgrads = _jax_reference(jcfg, case["tree"],
                                           case["tokens"].astype(np.int32))
        losses = {r[LAYOUTS.index(layout)][key]["loss"] for r in res}
        assert len(losses) == 1, losses
        assert abs(losses.pop() - want_loss) / abs(want_loss) < LOSS_RTOL
        want, _ = JHP.split_stage_params(jgrads, jcfg, JHP.PipelineSpec(2, PHYS, B))
        fw = flatten(jax.tree.map(np.asarray, want))
        fg = _assemble(res, layout, lambda r: r[key]["grads"])
        assert fw.keys() == fg.keys()
        for k in fw:
            np.testing.assert_allclose(_np(fg[k]), fw[k], rtol=0,
                                       atol=GRAD_TOL * max(np.abs(fw[k]).max(), 1e-6),
                                       err_msg=f"{layout} {strategy} {k}")
    assert "blocks/attn/q_norm/scale" in flatten(res[0][0][f"1 {strategy}"]["grads"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_grouped_train_step_matches_single_device(layout, three_ranks):
    """One AdamW step with the clip active (``grad_clip`` 0.1): the clip
    norm on every rank equals the single device's (each stage's tp_s
    copies of a replicated leaf counted once), and so do the first moment
    and, where the gradient fixes the update's sign, the update."""
    cases, res = three_ranks
    li = LAYOUTS.index(layout)
    for i, (_, case) in enumerate(cases):
        tcfg = TConfig(**case["cfg"])
        state = TTS.train_state_from(bridge.params_from_numpy(case["tree"], CPU), None, 0)
        state.opt_state = tadamw.init_opt_state(state.params)
        step = TTS.make_train_step(tcfg, tadamw.AdamWConfig(**OPT_CLIP))
        tokens = torch.from_numpy(case["tokens"].reshape(-1, SEQ))
        state, m = step(state, {"tokens": tokens})
        assert float(m["grad_norm"]) > 10 * OPT_CLIP["grad_clip"]
        spec = THP.PipelineSpec(2, PHYS, B)
        staged = lambda tree: flatten(THP.split_stage_params(tree, tcfg, spec)[0])
        p0 = staged(bridge.params_from_numpy(case["tree"], CPU))
        want_m, want = staged(state.opt_state["m"]), staged(state.params)
        for strategy in STRATEGIES:
            key = f"{i} {strategy}"
            train = [r[li][key]["train"] for r in res]
            assert len({t["grad_norm"] for t in train}) == 1
            assert math.isclose(train[0]["grad_norm"], float(m["grad_norm"]),
                                rel_tol=NORM_RTOL)
            assert abs(train[0]["loss"] - float(m["loss"])) / float(m["loss"]) < LOSS_RTOL
            got_m = _assemble(res, layout, lambda r: r[key]["train"]["m"])
            got = _assemble(res, layout, lambda r: r[key]["train"]["params"])
            for k, mk in want_m.items():
                torch.testing.assert_close(got_m[k], mk, rtol=0,
                                           atol=GRAD_TOL * max(float(mk.abs().max()), 1e-12),
                                           msg=k)
                sure = mk.abs() > 1e-3 * float(mk.abs().max())
                assert sure.any(), k
                torch.testing.assert_close((got[k] - p0[k])[sure], (want[k] - p0[k])[sure],
                                           rtol=1e-3, atol=0, msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reshard_moves_the_activation_and_counts_its_bytes(layout, three_ranks):
    """``reshard`` from stage 0 to stage 1 and back, each source member
    holding 100·rank + column: ``sr_ag`` delivers each column from the
    source member whose slice holds it, ``naive`` destination member r
    the whole of source member r mod tp_src's; one copy crosses under
    ``sr_ag`` each way (``sr_ag_cost.cross_bytes``), tp_dst copies
    forward and tp_src back under ``naive`` (``naive_cost`` counts one:
    ROADMAP C), and an ``sr_ag`` destination of t members gathers
    ``sr_ag_cost.intra_bytes`` a member."""
    _, res = three_ranks
    li = LAYOUTS.index(layout)
    t_src, t_dst = layout
    src, dst = range(t_src), range(t_src, t_src + t_dst)
    width = 6
    act = 2 * 3 * width * 4
    cols = torch.arange(width).float()
    for strategy in STRATEGIES:
        got = [r[li][f"reshard {strategy}"] for r in res]
        for k, rank in enumerate(dst):
            if strategy == "sr_ag":
                owner = torch.tensor([TRS._owner(c, width, t_src) for c in range(width)])
                want = 100.0 * owner + cols
            else:
                want = 100.0 * (k % t_src) + cols
            torch.testing.assert_close(got[rank]["there"], want.expand(2, 3, width))
        for rank in src:
            assert got[rank]["there"] is None
            # the hop back brings stage 1's value, whole, to every source member
            torch.testing.assert_close(got[rank]["back"], got[dst[0]]["there"])
        sent = lambda ranks: sum(got[r]["bytes"] for r in ranks)
        if strategy == "sr_ag":
            cost = TRS.sr_ag_cost(act, t_src, t_dst)
            assert sent(src) == sent(dst) == cost.cross_bytes
            for rank in dst:
                assert got[rank]["gathered"] == cost.intra_bytes
            for rank in src:
                assert got[rank]["gathered"] == TRS.sr_ag_cost(act, t_dst, t_src).intra_bytes
        else:
            cost = TRS.naive_cost(act, t_src, t_dst)
            assert sent(src) == t_dst * cost.cross_bytes
            assert sent(dst) == t_src * cost.cross_bytes
            assert all(g["gathered"] == 0 for g in got)


def test_grouped_specs_and_layout_refusals():
    """The spec keeps the JAX package's grouped checks and defaults, every
    stage's tp degree must divide the heads (the JAX package's words),
    and the runtime refuses a rank layout that does not match its spec."""
    for kw in (dict(stage_tp=(2, 1)), dict(stage_tp=(1, 2), reshard=("naive",)),
               dict(stage_tp=(2, 2), reshard=("none",))):
        assert dataclasses.asdict(THP.PipelineSpec(2, (1, 1), 4, **kw)) == \
            dataclasses.asdict(JHP.PipelineSpec(2, (1, 1), 4, **kw))
    for kw, match in ((dict(stage_tp=(2, 1), data_parallel=2), "does not compose"),
                      (dict(stage_tp=(2, 1), tensor_parallel=2), "replaces the uniform"),
                      (dict(stage_tp=(2, 1), reshard=("ring",)), "unknown reshard"),
                      (dict(reshard=("sr_ag",)), "need stage_tp")):
        for P in (THP.PipelineSpec, JHP.PipelineSpec):
            with pytest.raises(ValueError, match=match):
                P(2, (1, 1), 4, **kw)
    with pytest.raises(ValueError, match="unknown reshard strategy"):
        TRS.boundary_messages(2, 1, 8, "ring")
    jcfg = exact_cfg("qwen1p5_0p5b")
    bad = dict(stage_tp=(3, 1))
    with pytest.raises(ValueError) as terr:
        THP.validate_spec_tp(TConfig(**dataclasses.asdict(jcfg)),
                             THP.PipelineSpec(2, (1, 1), 4, **bad))
    with pytest.raises(ValueError) as jerr:
        JHP.validate_spec_tp(jcfg, JHP.PipelineSpec(2, (1, 1), 4, **bad))
    assert str(terr.value) == str(jerr.value)
    uniform = Grid(1, 2, 1, 0, 0, 0, None, None, None, None, None)
    grouped = dataclasses.replace(uniform, T=2, stage_tp=(2, 1))
    THP._check_grid(THP.PipelineSpec(2, (1, 1), 4, stage_tp=(2, 1)), grouped)
    with pytest.raises(ValueError, match="stage_tp"):
        THP._check_grid(THP.PipelineSpec(2, (1, 1), 4, stage_tp=(1, 2)), grouped)
    with pytest.raises(ValueError, match="rank grid"):
        THP._check_grid(THP.PipelineSpec(2, (1, 1), 4), grouped)
