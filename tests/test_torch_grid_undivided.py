"""The (data, model) grid at a model axis that does not divide a block's
count, held against the JAX package on the CPU: one spawn of three gloo
ranks, (data 1, model 3), through ``repro_torch.launch.ranks.spawn``
(rank functions in ``tests/helpers/torch_grid_undivided_ranks.py``), two
torch threads a rank.  Each part whose count 3 does not split
(``spmd.whole_parts``) is computed whole on every member; the other
parts of the same block keep their shards.

Cases: ``conftest.exact_cfg`` smoke configs of the six families (dense
granite, vlm paligemma, audio whisper, moe qwen3-moe with 4 experts, ssm
mamba2, hybrid zamba2; at smoke size 2 heads, ``d_ff`` 512, 4 experts
and 16 ssm heads, so every part is whole); mamba2 with a state of 48,
whose cache the rule shards over the state's 48 over the model axis
while the heads compute whole (the state moved to every head and back
each decode step); and starcoder2 changed on both sides to 12 heads over
4 kv heads and ``d_ff`` 768: the attention whole (``num_kv_heads=4``)
and the MLP sharded over the three members.

Training: one step each, held to the JAX package's single-device
``loss_fn`` on the same weights (biases and scales perturbed) and a
``SyntheticTokens`` batch: the loss within 1e-5, each gradient the step
applied, gathered from the ranks' blocks, within 1e-4 of its leaf's
largest entry (a whole part's gradient summed over the members where it
should be sliced shows there, three times too large).  Serving: a
prefill and 2 decode steps, held to the JAX package's ``prefill`` /
``decode_step`` logits at 1e-5 (hybrid 2e-4, as
``tests/test_torch_grid_serve.py``), greedy tokens equal and each
rank's cache blocks the rules' blocks of the JAX cache (an ssm model's
at 2e-4, the tolerance ``tests/test_torch_ssm.py`` holds the port's
single device's caches to: at a state of 48 its conv cache lies 3.0e-5
from JAX's on one device as on the grid); the dense and
mixed cases run one cache length 3 divides (the cache over its
sequence) and one it does not (the whole cache on every member).  The
dry-run's counting stand-ins count what each gloo rank counted, by axis
and kind, in training and in serving; each case's ``whole`` names are
asserted.
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
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.training import serve_step as JSS
from repro_torch import bridge
from repro_torch.launch import dryrun, ranks
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shapes import InputShape
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.sharding import spmd
from repro_torch.training.serve_step import abstract_serve_cache
from test_torch_gspmd import OPT
from test_torch_gspmd_families import _hold_grads
from test_torch_grid_serve import HYBRID_TOL, TOL, _weights
from test_torch_ssm import SERVE_TOL as SSM_SERVE_TOL

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "helpers"))
import torch_grid_undivided_ranks as W  # noqa: E402

CPU = torch.device("cpu")
MODEL, DATA = 3, 1
B, SEQ, STEPS = 2, 32, 2
LOSS_RTOL = 1e-5
MIXED = {"num_heads": 12, "num_kv_heads": 4, "d_ff": 768}
ALL = {"attention": "num_heads=2", "mlp": "d_ff=512"}
# (name, arch, config overrides, the parts computed whole)
CASES = [
    ("dense", "granite_8b", {}, ALL),
    ("vlm", "paligemma_3b", {}, ALL),
    ("audio", "whisper_base", {}, ALL),
    ("moe", "qwen3_moe_30b_a3b", {}, {"attention": "num_heads=2", "experts": "num_experts=4"}),
    ("ssm", "mamba2_780m", {}, {"ssm": "ssm_nheads=16"}),
    ("ssm-n48", "mamba2_780m", {"ssm_state": 48}, {"ssm": "ssm_nheads=16"}),
    ("hybrid", "zamba2_2p7b", {}, dict(ALL, ssm="ssm_nheads=16")),
    ("mixed", "starcoder2_7b", MIXED, {"attention": "num_kv_heads=4"}),
]
# (name, train case, batch, prompt, the self cache's placement over the
# model axis: KVCut's mode, None for an ssm model); the cache holds the
# prompt, a vlm model's prefix and the decode steps
SERVE = [
    ("dense-seq", "dense", 2, 64, "seq"),
    ("dense-whole", "dense", 2, 65, "whole"),
    ("vlm", "vlm", 2, 63, "whole"),
    ("audio", "audio", 2, 64, "seq"),
    ("moe", "moe", 2, 63, "whole"),
    ("ssm", "ssm", 2, 64, None),
    ("ssm-n48", "ssm-n48", 2, 64, None),
    ("hybrid", "hybrid", 3, 64, "seq"),
    ("mixed-seq", "mixed", 2, 64, "seq"),
    ("mixed-whole", "mixed", 2, 65, "whole"),
]
KV_PATH = {"hybrid": "attn/k", "audio": "self/k"}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    _, arch, over, _ = next(c for c in CASES if c[0] == name)
    return dataclasses.replace(exact_cfg(arch), **over)


def _train_batch(jcfg, seed):
    return jpipe.SyntheticTokens(jcfg, jpipe.DataConfig(batch_size=B, seq_len=SEQ,
                                                        seed=seed)).next_batch()


def _prompts(jcfg, batch, prompt, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (batch, prompt)).astype(np.int32)}
    if jcfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch, jcfg.num_prefix_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "audio":
        out["audio_embeds"] = rng.standard_normal(
            (batch, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    return out


def _jax_loss(jcfg, tree, batch):
    params = jax.tree.map(jnp.asarray, tree)
    return float(jax.jit(lambda p, b: JM.loss_fn(p, jcfg, b, backend="einsum")[0])(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))


def _jax_serve(jcfg, tree, prompts, cache_len):
    """The JAX package's single-device prefill and ``STEPS`` decode steps:
    every step's logits and tokens and the cache after the last."""
    params = jax.tree.map(jnp.asarray, tree)
    cache, logits = jax.jit(JSS.make_prefill_step(jcfg, cache_len))(
        params, {k: jnp.asarray(v) for k, v in prompts.items()})
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    step = jax.jit(JSS.make_decode_step(jcfg, cache_len + jcfg.num_prefix_tokens)[0])
    out, toks = [np.asarray(logits)], [np.asarray(tok)]
    pos = prompts["tokens"].shape[1] + jcfg.num_prefix_tokens
    for i in range(STEPS):
        logits, tok, cache = step(params, cache, tok, jnp.int32(pos + i))
        out.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return out, toks, jax.tree.map(np.asarray, cache)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """One spawn of three ranks for every train and serve case, the JAX
    references computed while the ranks run."""
    trains, serves, inputs = [], [], {"train": {}, "serve": {}}
    for seed, (name, _, _, _) in enumerate(CASES):
        jcfg = _cfg(name)
        tree = _weights(jcfg, seed)
        batch = _train_batch(jcfg, seed)
        inputs["train"][name] = (jcfg, tree, batch)
        trains.append((name, dataclasses.asdict(jcfg), tree, [batch], MODEL, DATA, 1,
                       "gspmd"))
    for seed, (name, case, batch, prompt, _) in enumerate(SERVE):
        jcfg, tree, _ = inputs["train"][case]
        prompts = _prompts(jcfg, batch, prompt, 100 + seed)
        cache_len = prompt + STEPS
        inputs["serve"][name] = (jcfg, tree, prompts, cache_len)
        serves.append((name, dataclasses.asdict(jcfg), tree, prompts, MODEL, DATA, cache_len,
                       cache_len + jcfg.num_prefix_tokens, STEPS))
    result = {}

    def spawn():
        try:
            result["outs"] = ranks.spawn(
                W.run_all, MODEL * DATA, ([("train", "train_cases", (trains, OPT)),
                                           ("serve", "serve_cases", (serves,))],),
                workdir=str(tmp_path_factory.mktemp("undivided")), timeout=300, threads=2)
        except BaseException as e:          # re-raised in the test's thread
            result["error"] = e

    t = threading.Thread(target=spawn)
    t.start()
    refs = {"train": {name: _jax_loss(*inputs["train"][name]) for name, *_ in CASES},
            "serve": {name: _jax_serve(*inputs["serve"][name]) for name, *_ in SERVE}}
    t.join()
    if "error" in result:
        raise result["error"]
    return result["outs"], inputs, refs


def test_whole_parts_name_the_counts_that_do_not_split():
    """``whole_parts`` at model 3 for each case, at 1 nothing, and at 2
    (every smoke count splits) nothing either."""
    for name, _, _, want in CASES:
        cfg = TConfig(**dataclasses.asdict(_cfg(name)))
        assert spmd.whole_parts(cfg, MODEL) == want, name
        assert spmd.whole_parts(cfg, 1) == {} == spmd.whole_parts(cfg, 2)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_undivided_grid_trains_as_the_single_device(grid, name):
    outs, inputs, refs = grid
    jcfg, tree, batch = inputs["train"][name]
    want = refs["train"][name]
    got = [o["train"][name] for o in outs]
    for g in got:
        assert abs(g["metrics"][0]["loss"] - want) <= LOSS_RTOL * abs(want), (g["metrics"], want)
        assert g["stats"]["whole"] == next(c[3] for c in CASES if c[0] == name)
        assert g["state_bytes"] == g["block_bytes"]
    assert sorted(tuple(g["coord"]) for g in got) == [(0, k) for k in range(MODEL)]
    _hold_grads(got[0]["grads1"], jcfg, tree, batch, 1)


@pytest.mark.parametrize("name", [c[0] for c in SERVE])
def test_undivided_grid_serves_as_the_single_device(grid, name):
    outs, inputs, refs = grid
    jcfg, _, prompts, cache_len = inputs["serve"][name]
    want_logits, want_tokens, want_cache = refs["serve"][name]
    _, case, batch, _, mode = next(c for c in SERVE if c[0] == name)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    tol = HYBRID_TOL if tcfg.family == "hybrid" else TOL
    cache_tol = SSM_SERVE_TOL if tcfg.family == "ssm" else tol
    mesh = Mesh.of((DATA, MODEL), ("data", "model"))
    seq_len = cache_len + jcfg.num_prefix_tokens
    specs = spmd.cache_specs(tcfg, mesh, batch, seq_len)
    whole = next(c[3] for c in CASES if c[0] == case)
    for o in outs:
        got = o["serve"][name]
        for step, (a, b) in enumerate(zip(got["logits"], want_logits)):
            np.testing.assert_allclose(a.numpy(), b, **tol, err_msg=f"{name} {step}")
        for step, (a, b) in enumerate(zip(got["tokens"], want_tokens)):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{name} {step}")
        layout = dryrun.standin_layout(mesh, got["coord"])
        blocks = spmd.cache_leaves(bridge.cache_blocks_from_numpy(want_cache, layout, specs,
                                                                  CPU))
        assert set(blocks) == set(got["cache"])
        for path, t in blocks.items():
            np.testing.assert_allclose(got["cache"][path].numpy(), t.numpy(), **cache_tol,
                                       err_msg=f"{name} {path}")
        assert got["cache_bytes"] == got["cache_block_bytes"] == spmd.cache_bytes(blocks)
        assert all(s["whole"] == whole for s in got["stats"])
        if mode is not None:
            kv = KV_PATH.get(tcfg.family, "k")
            shape = spmd.cache_leaves(abstract_serve_cache(tcfg, batch, seq_len))[kv].shape
            assert spmd.KVCut(layout, specs[kv], shape).mode == mode


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_standin_counts_the_undivided_ranks(grid, name):
    """The dry-run's estimate of each rank (counting stand-ins on the meta
    device) against what that gloo rank counted: the train step's and
    each serve case's prefill and last decode step's collectives, bytes
    and calls by axis and kind, exactly, with the same ``whole``."""
    outs, inputs, _ = grid
    jcfg = inputs["train"][name][0]
    cfg = TConfig(**dataclasses.asdict(jcfg))
    mesh = Mesh.of((DATA, MODEL), ("data", "model"))
    serves = [c for c in SERVE if c[1] == name]
    for o in outs:
        got = o["train"][name]
        rec = dryrun.estimate(cfg, mesh, InputShape(name, "train", SEQ, B), rank=got["coord"])
        assert rec["collectives"] == dryrun.collectives(got["stats"]), got["coord"]
        assert rec["state_bytes"] == got["state_bytes"] == rec["block_bytes"]
        assert rec["whole"] == got["stats"]["whole"]
        for sname, _, batch, prompt, _ in serves:
            sgot = o["serve"][sname]
            cache_len = inputs["serve"][sname][3]
            pre = dryrun.estimate_serve(cfg, mesh, InputShape(sname, "prefill", prompt, batch),
                                        rank=sgot["coord"], cache_len=cache_len)
            dec = dryrun.estimate_serve(
                cfg, mesh, InputShape(sname, "decode", cache_len + cfg.num_prefix_tokens,
                                      batch), rank=sgot["coord"])
            assert pre["collectives"] == dryrun.collectives(sgot["stats"][0]), sname
            assert dec["collectives"] == dryrun.collectives(sgot["stats"][-1]), sname
            assert pre["whole"] == dec["whole"] == sgot["stats"][0]["whole"]
