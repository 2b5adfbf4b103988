"""The port's sharded serve steps on the (data, model) grid held against
the JAX package on the CPU: ``repro_torch.sharding.spmd``'s
``make_prefill_step`` / ``make_decode_step`` (the JAX dry-run's jitted
``make_prefill_step`` and ``make_decode_step`` under the copied sharding
rules, ``repro/launch/dryrun.py:171-191``, written with explicit
collectives), on gloo CPU ranks started by ``repro_torch.launch.ranks``
(rank functions in ``tests/helpers/torch_grid_serve_ranks.py``), one
spawn of four ranks for every case.

Reference: the JAX package's single-device ``make_prefill_step`` and
``make_decode_step`` on fp32 ``conftest.exact_cfg`` smoke configs from
the same weights (biases and scales perturbed) and prompts.  Each rank's
prefill logits and 4 decode steps' logits of its rows within 1e-5, its
greedy tokens equal, and its cache blocks after the last step equal to
the rules' blocks (``rules.cache_shardings``) of the JAX cache within
1e-5, their bytes the closed form; a hybrid model's logits and cache
within 2e-4, the tolerance ``tests/test_torch_hybrid.py`` holds the
port's single device to (its caches lie 2e-5 to 5e-5 from JAX's here).  Cases, at data 2 x model 2 unless
named: granite's smoke width (kv heads over the model axis); with one kv
head (the cache sharded over its sequence: each member's slots, the
partial softmaxes combined through ``flash_decode``'s slot offset and
log-sum-exp); the same under a sliding window whose ring wraps during
decode; an odd cache length the model axis divides in no dim (the
whole cache on every member); qwen3-moe (expert parallelism), mamba2
(head sharding, the conv cache whole) and paligemma (one kv head behind
its image prefix); a batch of one replicated over the data axis; mamba2
at data 4 x model 1; zamba2 in the three placements the rule gives its
stacked (G, per, B, ...) ssm cache (per 1: the conv cache's batch over
the model axis, the state whole; per 2: per over data and the batch
over model; per 2 at batch 1: the conv channels over model), each moved
to the blocks its layers compute on and back once a group; whisper (the
cross cache over its encoder sequence, decoded through ``flash_decode``'s
slot offset and log-sum-exp, the self cache over its kv heads).  The
plain ``flash_decode`` with ``slot0``, ``cache_len`` and ``return_lse``
is held, blocks combined, to ``repro.kernels.ref``'s decode over the
whole cache.  ``spmd.Layout.reblock`` is held on the same ranks to the
blocks of a whole leaf, both ways, at 2 x 2 for each spec pattern of the
rule's zamba2 and whisper placements, and on counting stand-ins at the
full configs' shapes and meshes (16 x 16 included) to the rule's specs,
the blocks' shapes and the closed form of the bytes it gathers.  Two
torch threads.
"""
import dataclasses
import pathlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from test_torch_hybrid import SERVE_TOL
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.training import serve_step as JSS
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, ranks
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.sharding import spmd
from repro_torch.training import serve_step as TSS

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "helpers"))
import torch_grid_serve_ranks as W  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
HYBRID_TOL = SERVE_TOL
STEPS = 4
PER2 = {"num_layers": 4, "hybrid_attn_every": 2}
# (name, arch, config overrides, data, model, batch, prompt, the cache's
# placement over the model axis: KVCut's mode, None for an ssm cache)
CASES = [
    ("granite-kv-heads", "granite_8b", {}, 2, 2, 8, 64, "heads"),
    ("granite-sequence", "granite_8b", {"num_kv_heads": 1}, 2, 2, 8, 64, "seq"),
    ("granite-ring", "granite_8b", {"num_kv_heads": 1, "sliding_window": 66}, 2, 2, 8, 64,
     "seq"),
    ("granite-whole", "granite_8b", {"num_kv_heads": 1}, 2, 2, 8, 63, "whole"),
    ("qwen3-moe", "qwen3_moe_30b_a3b", {}, 2, 2, 8, 64, "heads"),
    ("mamba2", "mamba2_780m", {}, 2, 2, 8, 64, None),
    ("paligemma", "paligemma_3b", {}, 2, 2, 8, 64, "seq"),
    ("granite-batch1", "granite_8b", {}, 2, 2, 1, 64, "heads"),
    ("mamba2-data4", "mamba2_780m", {}, 4, 1, 8, 64, None),
    ("zamba2", "zamba2_2p7b", {}, 2, 2, 8, 64, "heads"),
    ("zamba2-per2", "zamba2_2p7b", PER2, 2, 2, 4, 64, "heads"),
    ("zamba2-per2-batch1", "zamba2_2p7b", PER2, 2, 2, 1, 64, "heads"),
    ("whisper", "whisper_base", {}, 2, 2, 8, 64, "heads"),
]
# the self-attention cache's path by family (the others' "k")
KV_PATH = {"hybrid": "attn/k", "audio": "self/k"}
# (name, whole shape, the rule's spec, the block computed on, seed): the
# spec patterns of the rule's zamba2 and whisper placements at 2 x 2 that
# Layout.reblock moves between, on small shapes
D, MD = "data", "model"
REBLOCK = [
    ("conv per over data, batch over model", (2, 4, 3, 8), (D, MD, None, None),
     (None, D, None, None)),
    ("conv batch over model, per whole", (1, 4, 3, 8), (None, MD, None, None),
     (None, D, None, None)),
    ("conv channels over model, one row", (2, 1, 3, 8), (D, None, None, MD),
     (None, None, None, None)),
    ("state per over data", (2, 4, 4, 2, 3), (D, None, None, None, None),
     (None, D, MD, None, None)),
    ("state whole", (1, 4, 4, 2, 3), (None, None, None, None, None),
     (None, D, MD, None, None)),
    ("cross over its sequence", (2, 4, 6, 2, 3), (None, D, MD, None, None),
     (None, D, None, MD, None)),
]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(jcfg, seed=0):
    """The JAX params of ``jcfg`` with perturbed biases and scales, as numpy."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bias", "scale", "conv_b", "D", "dt_bias"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return tree


def _lengths(jcfg, prompt):
    """(the prefill's cache length, the decode's sequence length): a ring
    of the window where the window is shorter than the positions served,
    else every position, a vlm model's prefix included."""
    total = prompt + STEPS
    if jcfg.sliding_window and total > jcfg.sliding_window:
        return jcfg.sliding_window, total
    return total, total + jcfg.num_prefix_tokens


def _case(name, arch, over, data, model, B, prompt, seed):
    jcfg = dataclasses.replace(exact_cfg(arch), **over)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, prompt)).astype(np.int32)}
    if jcfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, jcfg.num_prefix_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "audio":
        batch["audio_embeds"] = rng.standard_normal(
            (B, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    cache_len, seq_len = _lengths(jcfg, prompt)
    return jcfg, _weights(jcfg, seed), batch, cache_len, seq_len


def _jax_serve(jcfg, tree, batch, cache_len, seq_len):
    """The JAX package's single-device prefill and ``STEPS`` decode steps,
    each fed the last step's tokens: every step's logits and tokens and
    the cache after the last, as numpy."""
    params = jax.tree.map(jnp.asarray, tree)
    cache, logits = jax.jit(JSS.make_prefill_step(jcfg, cache_len))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    step, _ = JSS.make_decode_step(jcfg, seq_len)
    step = jax.jit(step)
    out, toks = [np.asarray(logits)], [np.asarray(tok)]
    pos = batch["tokens"].shape[1] + jcfg.num_prefix_tokens
    for i in range(STEPS):
        logits, tok, cache = step(params, cache, tok, jnp.int32(pos + i))
        out.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return out, toks, jax.tree.map(np.asarray, cache)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One spawn of four ranks for every case, the JAX references computed
    while the ranks run."""
    jobs, cases = [], {}
    for seed, (name, arch, over, data, model, B, prompt, mode) in enumerate(CASES):
        jcfg, tree, batch, cache_len, seq_len = _case(name, arch, over, data, model, B,
                                                      prompt, seed)
        cases[name] = (jcfg, tree, batch, cache_len, seq_len)
        jobs.append((name, dataclasses.asdict(jcfg), tree, batch, model, data, cache_len,
                     seq_len, STEPS))
    result = {}

    def spawn():
        try:
            rjobs = [(name, shape, src, dst, seed) for seed, (name, shape, src, dst)
                     in enumerate(REBLOCK)]
            result["outs"] = ranks.spawn(W.run_all, 4, ([("cases", "serve_cases", (jobs,)),
                                                         ("reblock", "reblock_cases",
                                                          (rjobs,))],),
                                         workdir=str(tmp_path_factory.mktemp("serve")),
                                         timeout=300, threads=1)
        except BaseException as e:          # re-raised in the test's thread
            result["error"] = e

    t = threading.Thread(target=spawn)
    t.start()
    refs = {name: _jax_serve(*c) for name, c in cases.items()}
    t.join()
    if "error" in result:
        raise result["error"]
    return result["outs"], cases, refs


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_grid_serve_matches_jax_single_device(served, name):
    """A hybrid case is held at ``HYBRID_TOL``, the port's single device's
    own tolerance against the JAX package in serving
    (``tests/test_torch_hybrid.py``: its chunked SSD sums in another
    order; at these weights its caches lie 2e-5 to 5e-5 from JAX's), the
    others at 1e-5."""
    outs, cases, refs = served
    jcfg, _, batch, cache_len, seq_len = cases[name]
    want_logits, want_tokens, want_cache = refs[name]
    _, _, _, data, model, B, _, mode = next(c for c in CASES if c[0] == name)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    tol = HYBRID_TOL if tcfg.family == "hybrid" else TOL
    mesh = Mesh.of((data, model), ("data", "model"))
    specs = spmd.cache_specs(tcfg, mesh, B, seq_len)
    coords = set()
    for o in outs:
        got = o["cases"][name]
        rows = got["rows"].numpy()
        coords.add(tuple(got["coord"]))
        assert len(rows) == (B if B % data else B // data)
        for step, (a, b) in enumerate(zip(got["logits"], want_logits)):
            np.testing.assert_allclose(a.numpy(), b[rows], **tol, err_msg=f"{name} {step}")
        for step, (a, b) in enumerate(zip(got["tokens"], want_tokens)):
            np.testing.assert_array_equal(a.numpy(), b[rows], err_msg=f"{name} {step}")
        layout = dryrun.standin_layout(mesh, got["coord"])
        blocks = spmd.cache_leaves(bridge.cache_blocks_from_numpy(want_cache, layout, specs,
                                                                  CPU))
        assert set(blocks) == set(got["cache"])
        for path, t in blocks.items():
            np.testing.assert_allclose(got["cache"][path].numpy(), t.numpy(), **tol,
                                       err_msg=f"{name} {path}")
        assert got["cache_bytes"] == got["cache_block_bytes"] == \
            spmd.cache_bytes(blocks)
        if mode is not None:
            whole = (1, B, tcfg.num_kv_heads, seq_len if mode != "seq" or not
                     jcfg.sliding_window else cache_len, tcfg.head_dim)
            kv = KV_PATH.get(tcfg.family, "k")
            assert spmd.KVCut(layout, specs[kv], whole).mode == mode
        if tcfg.family == "audio":
            cross = (1, B, tcfg.encoder_seq_len, tcfg.num_kv_heads, tcfg.head_dim)
            cut = spmd.KVCut(layout, specs["cross/0"], cross, heads=3, seq=2)
            assert (cut.mode, cut.slots) == ("seq", tcfg.encoder_seq_len // model)
        model_calls = [s["model_gather_calls"] + s["model_reduce_calls"] for s in got["stats"]]
        assert all(n > 0 for n in model_calls) == (model > 1), model_calls
    assert len(coords) == 4


def test_decode_combines_the_members_partials(served):
    """The sequence-sharded decode (one kv head, which every member
    computes) gathers every head's query and the members' partial
    softmaxes: two model all-gathers a layer more than the
    kv-head-sharded decode."""
    outs = served[0]
    stats = lambda name: outs[0]["cases"][name]["stats"][1]
    seq, heads = stats("granite-sequence"), stats("granite-kv-heads")
    layers = exact_cfg("granite_8b").num_layers
    assert seq["model_gather_calls"] == 2 * layers + heads["model_gather_calls"]


class _Stacked:
    """A model group's all-gather standing in for its members, whose
    tensors it is handed in member order."""

    def __init__(self, parts):
        self.parts, self.world_size = parts, len(parts)

    def all_gather_(self, out, part, dim):
        return out.copy_(torch.cat(self.parts, dim))


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("pos,window,softcap,ring", [
    (90, 0, 0.0, False), (50, 0, 0.0, False), (70, 30, 0.0, False), (90, 0, 20.0, False),
    (150, 0, 0.0, True), (300, 40, 0.0, True), (60, 0, 0.0, True)])
def test_flash_decode_blocks_combine_to_the_whole_cache(blocks, pos, window, softcap, ring):
    """The plain ``flash_decode`` on each block of a cache (``slot0``,
    ``cache_len``, ``return_lse``), combined by ``spmd.combine_partials``,
    equals ``repro.kernels.ref``'s decode over the whole cache within
    1e-6; a block with no live slot gives 0 and -inf.  By default the
    call is the whole cache's, unchanged."""
    B, KV, G, S, hd = 2, 2, 3, 96, 64
    g = torch.Generator().manual_seed(blocks + pos)
    q = torch.randn(B, KV * G, hd, generator=g)
    k, v = torch.randn(B, KV, S, hd, generator=g), torch.randn(B, KV, S, hd, generator=g)
    kw = dict(window=window, softcap=softcap, ring=ring)
    want = np.asarray(jref.decode_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                                jnp.asarray(v.numpy()), jnp.int32(pos), **kw))
    n = S // blocks
    parts = [ops.flash_decode(q, k[:, :, i * n:(i + 1) * n].contiguous(),
                              v[:, :, i * n:(i + 1) * n].contiguous(), pos, slot0=i * n,
                              cache_len=S, return_lse=True, **kw) for i in range(blocks)]
    stacked = [torch.cat([o.float(), lse[..., None]], dim=-1)[None] for o, lse in parts]
    got = spmd.combine_partials(parts[0][0], parts[0][1], _Stacked(stacked))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    for o, lse in parts:
        dead = torch.isinf(lse)
        assert bool((o[dead] == 0).all()) and bool((lse[dead] < 0).all())
    assert torch.equal(ops.flash_decode(q, k, v, pos, **kw),
                       ops.flash_decode(q, k, v, pos, slot0=0, cache_len=S, **kw))


def test_hybrid_ssm_cache_moves_once_a_group(served):
    """Each of zamba2's groups moves its ssm cache (conv and state) from
    the rule's blocks to the blocks its layers compute on and back once a
    decode step, counted among the step's collectives: per 2 at 2 x 2
    (the conv cache's per over data and its batch over model, the
    state's per over data) gathers over data four times a group (each
    leaf each way) and over model twice (the conv cache in, the state's
    heads out), the bytes each move's whole group slice less the block
    it started from.  Whisper's decode copies each layer's cross cache
    blocks into ``flash_decode``'s layout, its prefill nothing."""
    outs, cases, _ = served
    jcfg = cases["zamba2-per2"][0]
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    mesh = Mesh.of((2, 2), ("data", "model"))
    groups = PER2["num_layers"] // PER2["hybrid_attn_every"]
    for o in outs:
        layout = dryrun.standin_layout(mesh, o["cases"]["zamba2-per2"]["coord"])
        gather = spmd.ServeGather(tcfg, layout, {}, {}, 68, 4)
        want = 0
        for rule, compute, shape in gather.ssm.values():
            whole = torch.empty(shape, device="meta").numel() * 4
            for spec in (rule, compute):
                want += whole - layout.block(torch.empty(shape, device="meta"), spec).numel() * 4
        for stats in o["cases"]["zamba2-per2"]["stats"][1:]:
            assert stats["reblock_data_calls"] == groups * 4, stats
            assert stats["reblock_model_calls"] == groups * 2, stats
            assert stats["reblock_data_bytes"] + stats["reblock_model_bytes"] == \
                groups * want
            assert stats["copy_bytes"] == 0
    whisper = outs[0]["cases"]["whisper"]["stats"]
    wcfg = exact_cfg("whisper_base")
    assert whisper[0]["copy_bytes"] == whisper[0]["reblock_data_calls"] == 0
    assert whisper[1]["copy_bytes"] == wcfg.num_layers * 2 * 4 * wcfg.num_kv_heads * \
        wcfg.encoder_seq_len // 2 * wcfg.head_dim * 4


@pytest.mark.parametrize("name", [c[0] for c in REBLOCK])
def test_reblock_moves_between_blocks(served, name):
    """``Layout.reblock`` on the four gloo ranks: the rank's ``to`` block
    of a whole leaf from its ``from`` block, and back, exactly; its
    gathers counted, their bytes the whole leaf's less the block it
    started from."""
    outs = served[0]
    _, shape, src, dst = next(c for c in REBLOCK if c[0] == name)
    seed = [c[0] for c in REBLOCK].index(name)
    whole = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    mesh = Mesh.of((2, 2), ("data", "model"))
    for o in outs:
        got = o["reblock"][name]
        layout = dryrun.standin_layout(mesh, got["coord"])
        assert torch.equal(got["there"], layout.block(whole, dst))
        assert torch.equal(got["back"], layout.block(whole, src))
        for stats, spec in zip(got["stats"], (src, dst)):
            gathered = sum(stats[f"{a}_gather_bytes"] for a in ("data", "model"))
            assert gathered == 4 * (whole.numel() - layout.block(whole, spec).numel())


# (arch, overrides, (data, model), batch, leaf, the rule's spec): the
# rule's zamba2 and whisper placements that the grid reblocks or reads
M16 = (16, 16)
TABLE = [
    ("zamba2_2p7b", {}, (2, 2), 4, "ssm/conv", (None, D, MD, None, None)),
    ("zamba2_2p7b", {}, (2, 2), 4, "ssm/state", (None, D, None, None, None, None)),
    ("zamba2_2p7b", {}, M16, 128, "ssm/conv", (None, None, MD, None, None)),
    ("zamba2_2p7b", {}, M16, 128, "ssm/state", (None,) * 6),
    ("zamba2_2p7b", {"num_layers": 4, "hybrid_attn_every": 2}, (2, 2), 1, "ssm/conv",
     (None, D, None, None, MD)),
    ("whisper_base", {}, (2, 2), 4, "cross/0", (None, D, MD, None, None)),
    ("whisper_base", {}, M16, 128, "cross/0", (None, D, None, None, None)),
]


@pytest.mark.parametrize("case", TABLE, ids=lambda c: f"{c[0]}-{c[2][0]}x{c[2][1]}-B{c[3]}-"
                         f"{c[4]}")
def test_reblock_takes_every_rule_placement(case):
    """At each full config's shapes on its mesh (counting stand-ins, meta
    tensors): the rule's spec of the leaf is the one the grid was built
    for, and ``reblock`` moves rank (0, 0)'s and the last rank's block of
    it to the compute placement (the batch over data, heads over model)
    and back, each result its block's shape, the bytes gathered the whole
    leaf's less the block it started from, in one call an axis named."""
    from repro_torch.configs import get_config
    arch, over, (data, model), B, path, want = case
    cfg = dataclasses.replace(get_config(arch), **over)
    mesh = Mesh.of((data, model), ("data", "model"))
    spec = spmd.cache_specs(cfg, mesh, B, 64)[path]
    assert spec == want
    leaf = spmd.cache_leaves(TSS.abstract_serve_cache(cfg, B, 64))[path]
    rows = D if B % data == 0 else None
    heads = MD if cfg.num_kv_heads % model == 0 else None
    compute = {"ssm/conv": (None, None, rows, None, None),
               "ssm/state": (None, None, rows, MD, None, None),
               "cross/0": (None, rows, None, heads, None)}[path]
    nbytes = lambda t: t.numel() * t.element_size()
    for coord in ((0, 0), (data - 1, model - 1)):
        layout = dryrun.standin_layout(mesh, coord)
        for src, dst in ((spec, compute), (compute, spec)):
            block = layout.block(leaf, src)
            layout.reset_counts()
            got = layout.reblock(block, src, dst, leaf.shape)
            stats = layout.counts()
            assert got.shape == layout.block(leaf, dst).shape
            gathered = sum(stats[f"{a}_gather_bytes"] for a in ("data", "model"))
            assert gathered == (0 if src == dst else nbytes(leaf) - nbytes(block))
            named = {u for e in src for u in layout.units(e) if layout.size(u) > 1}
            calls = sum(stats[f"{a}_gather_calls"] for a in ("data", "model"))
            assert calls == (0 if src == dst else len(named))
