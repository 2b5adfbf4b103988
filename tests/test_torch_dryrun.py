"""The meta-device dry-run held against the JAX package on the CPU:
``repro_torch.launch.shapes`` (the reference's ``launch/shapes.py``),
``training.serve_step.abstract_serve_cache`` and
``core.heteropp.abstract_stage_params`` (names, shapes and dtypes of the
reference's ``jax.eval_shape``), the ``remat_policy`` argument
(``"dots"``: the same loss and gradients as full remat in fp32 within
1e-6, and the JAX step under ``dots_with_no_batch_dims_saveable`` at the
port's fp32 parity limits), ``launch/meta_analysis.py`` (a step's dot
FLOPs within 2% of ``repro.launch.hlo_analysis.analyze_hlo`` of the same
jitted step, for full remat and ``dots``), ``launch/dryrun.py`` (each
rank's argument bytes equal to ``memory_analysis()`` of the JAX step
compiled under GSPMD on a 2 x 2 mesh of virtual host devices, in a
subprocess, ``tests/helpers/jax_dryrun_memory.py``; ``ok``, ``refused``
and the CLI) and the kernels' meta path (``kernels.ops.estimating``:
the outputs and scratch allocated, no launch, the closed-form cost of
``kernels/cost.py``).  The counting stand-in's collectives are held to
the gloo ranks' in ``tests/test_torch_gspmd.py`` and
``tests/test_torch_gspmd_families.py``, beside the ranks they count.
Smoke configs, two torch threads.
"""
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.configs import ASSIGNED, get_smoke_config as jsmoke
from repro.core import heteropp as JHP
from repro.launch import shapes as JSH
from repro.launch.hlo_analysis import HloModule
from repro.optim import adamw as JA
from repro.training import serve_step as JSS, train_step as JTS
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import heteropp as THP
from repro_torch.kernels import cost, ops, ref
from repro_torch.launch import dryrun, shapes as TSH
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.meta_analysis import MetaAnalysis
from repro_torch.models import model as TM, transformer as tfm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.training import serve_step as TSS, train_step as TTS
from repro_torch.tree import tree_leaves
from test_torch_heteropp import _pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "helpers"))
import torch_pipeline_ranks as W  # noqa: E402

CPU = torch.device("cpu")
FAMILIES = ["granite_8b", "qwen3_moe_30b_a3b", "mamba2_780m", "zamba2_2p7b",
            "whisper_base", "paligemma_3b"]
B, SEQ = 8, 32
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
LOSS_RTOL, GNORM_RTOL, DOTS_RTOL, FLOPS_RTOL = 1e-5, 1e-4, 1e-6, 0.02
# (name, arch, data, model, accum, dp mode): the argument-bytes cases
MEMORY_CASES = [("granite", "granite_8b", 2, 2, 1, "gspmd"),
                ("granite-accum2", "granite_8b", 2, 2, 2, "gspmd"),
                ("granite-zero1", "granite_8b", 2, 2, 1, "manual"),
                ("qwen3-moe", "qwen3_moe_30b_a3b", 2, 2, 1, "gspmd"),
                ("mamba2", "mamba2_780m", 2, 2, 1, "gspmd"),
                ("mamba2-zero1", "mamba2_780m", 2, 2, 1, "manual"),
                ("whisper", "whisper_base", 2, 2, 1, "gspmd")]
# (name, arch, config overrides, kind, batch, seq): the serve steps'
# argument-bytes and FLOPs cases, each on the 2 x 2 mesh
SERVE_CASES = [("granite-prefill", "granite_8b", {}, "prefill", 8, 32),
               ("granite-decode", "granite_8b", {}, "decode", 8, 64),
               ("granite-sequence-decode", "granite_8b", {"num_kv_heads": 1}, "decode", 8,
                128),
               ("paligemma-prefill", "paligemma_3b", {}, "prefill", 8, 64),
               ("paligemma-decode", "paligemma_3b", {}, "decode", 8, 128),
               ("qwen3-moe-prefill", "qwen3_moe_30b_a3b", {}, "prefill", 8, 32),
               ("qwen3-moe-decode", "qwen3_moe_30b_a3b", {}, "decode", 8, 64),
               ("mamba2-prefill", "mamba2_780m", {}, "prefill", 8, 32),
               ("mamba2-decode", "mamba2_780m", {}, "decode", 8, 64),
               ("granite-batch1-decode", "granite_8b", {}, "decode", 1, 64),
               ("zamba2-prefill", "zamba2_2p7b", {"hybrid_attn_every": 2}, "prefill", 8, 32),
               ("zamba2-decode", "zamba2_2p7b", {"hybrid_attn_every": 2}, "decode", 8, 64),
               ("whisper-prefill", "whisper_base", {}, "prefill", 8, 32),
               ("whisper-decode", "whisper_base", {}, "decode", 8, 64)]

# (name, arch, config overrides, kind, batch, seq): the argument-bytes
# cases on the 2 x 3 mesh, whose model axis does not divide a block's
# count: starcoder2 at 12 heads over 4 kv heads and d_ff 768 (attention
# whole, the MLP over the members), whisper (every part whole), and
# paligemma's decode (attention and MLP whole, the cache over its sequence)
MIXED = {"num_heads": 12, "num_kv_heads": 4, "d_ff": 768}
UNDIVIDED_CASES = [("mixed-2x3", "starcoder2_7b", MIXED, "gspmd", 8, SEQ),
                   ("whisper-2x3", "whisper_base", {}, "gspmd", 8, SEQ),
                   ("paligemma-decode-2x3", "paligemma_3b", {}, "decode", 8, 120)]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _abstract(tree, path=""):
    """{path: (shape, dtype name)} of a tree of dicts, tuples and arrays or
    tensors (JAX ShapeDtypeStructs, meta tensors)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _abstract(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree) for k, v in _abstract(t, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), _dtype_name(tree.dtype))}


# ---------------------------------------------------------------------------
# shapes, the abstract cache and stage layout
# ---------------------------------------------------------------------------

def test_shapes_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in TSH.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSH.SHAPES.items()}
    for arch in ASSIGNED:
        jcfg, tcfg = jsmoke(arch), tsmoke(arch)
        for name, shape in JSH.SHAPES.items():
            tshape = TSH.SHAPES[name]
            got = _abstract(TSH.input_specs(tcfg, tshape))
            assert got == _abstract(JSH.input_specs(jcfg, shape)), (arch, name)
            assert _abstract(TSH.decode_specs(tcfg, tshape)) == \
                _abstract(JSH.decode_specs(jcfg, shape))
            assert all(t.device.type == "meta"
                       for t in TSH.input_specs(tcfg, tshape).values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_abstract_serve_cache_equal_jax(arch):
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    for batch, seq in ((2, 48), (1, 70000)):
        try:
            want = JSS.abstract_serve_cache(jcfg, batch, seq)
        except ValueError as e:           # full attention past the long threshold
            with pytest.raises(ValueError, match="sliding-window"):
                TSS.abstract_serve_cache(tcfg, batch, seq)
            assert "sliding-window" in str(e)
            continue
        got = TSS.abstract_serve_cache(tcfg, batch, seq)
        assert _abstract(got) == _abstract(want), (arch, batch, seq)
        assert {t.device.type for t in _tensors(got)} == {"meta"}


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


@pytest.mark.parametrize("arch,phys,schedule", [
    ("granite_8b", (1, 1), "1f1b"), ("granite_8b", (2, 0), "1f1b"),
    ("granite_8b", (1, 1), "zb_v"), ("qwen3_moe_30b_a3b", (1, 1), "1f1b"),
    ("mamba2_780m", (0, 2), "interleaved")])
def test_abstract_stage_params_equal_jax(arch, phys, schedule):
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    spec = W.schedule_spec(schedule, phys, 4)
    want = JHP.abstract_stage_params(jcfg, JHP.PipelineSpec(**dataclasses.asdict(spec)))
    got = THP.abstract_stage_params(tcfg, spec)
    assert _abstract(got) == _abstract(want)
    assert {t.device.type for t in _tensors(got)} == {"meta"}


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "whisper_base", "paligemma_3b"])
def test_abstract_stage_params_refuses_what_the_pipeline_refuses(arch):
    """The port's pipeline runs dense, moe and ssm blocks (ROADMAP C: the
    JAX pipeline drops a vlm prefix, has no audio path and stacks a hybrid
    model's groups as layers), and its abstract stage layout refuses the
    others as ``split_stage_params`` does."""
    with pytest.raises(NotImplementedError, match="dense, moe and ssm"):
        THP.abstract_stage_params(tsmoke(arch), W.schedule_spec("1f1b", (1, 1), 4))


# ---------------------------------------------------------------------------
# remat_policy="dots"
# ---------------------------------------------------------------------------

def _batch(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)}
    if jcfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (2, jcfg.num_prefix_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "audio":
        b["audio_embeds"] = rng.standard_normal(
            (2, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_policy_matches_full_remat_and_jax(arch):
    """``remat_policy="dots"``: the loss and every leaf's gradient those of
    full remat (fp32, 1e-6 relative to the leaf's largest entry), and one
    train step the JAX package's under ``dots_with_no_batch_dims_saveable``
    (loss 1e-5, gradient norm 1e-4 relative)."""
    jcfg, tcfg, tree = _pair(arch)
    batch = _batch(jcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for policy in (None, "dots"):
        params = TTS.train_state_from(bridge.params_from_numpy(tree, CPU), {}, 0).params
        loss, _ = TM.loss_fn(params, tcfg, tb, remat=True, remat_policy=policy)
        grads[policy] = (float(loss.detach()), torch.autograd.grad(loss, tree_leaves(params)))
    (l_full, g_full), (l_dots, g_dots) = grads[None], grads["dots"]
    assert abs(l_dots - l_full) <= DOTS_RTOL * abs(l_full)
    for a, b in zip(g_full, g_dots):
        assert float((a - b).abs().max()) <= DOTS_RTOL * max(float(a.abs().max()), 1e-12)

    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    params = jax.tree.map(jnp.asarray, tree)
    jstate = JTS.TrainState(params, JA.init_opt_state(params), jnp.zeros((), jnp.int32))
    jstep = jax.jit(JTS.make_train_step(jcfg, JA.AdamWConfig(**OPT), remat_policy=policy,
                                        backend="einsum"))
    _, want = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = bridge.params_from_numpy(tree, CPU)
    state = TTS.train_state_from(params, tadamw.init_opt_state(params), 0)
    _, got = TTS.make_train_step(tcfg, tadamw.AdamWConfig(**OPT), remat_policy="dots")(state, tb)
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))
    assert rel(got["loss"], want["loss"]) < LOSS_RTOL
    assert rel(got["grad_norm"], want["grad_norm"]) < GNORM_RTOL


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        tfm.rematted(torch.neg, torch.zeros(2, requires_grad=True), policy="all")


# ---------------------------------------------------------------------------
# the analysis: FLOPs against the HLO of the same step
# ---------------------------------------------------------------------------

def _hlo_dot_flops(hlo: str, batched: bool):
    """``analyze_hlo``'s dot FLOPs of a compiled step, and of them those
    of the dots with a result of rank > 2 (the batched einsums)."""
    mod = HloModule(hlo)
    total = mod.analyze()["flops"]
    part = sum(mod.multipliers.get(c, 0) * mod._dot_flops(comp, i)
               for c, comp in mod.computations.items() for i in comp.instructions
               if i.opcode == "dot" and len(i.result_dims[0]) > 2) if batched else 0
    return total, part


class _Batched(MetaAnalysis):
    """The analysis, also summing the FLOPs of the batched products."""

    def __init__(self):
        super().__init__()
        self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func._overloadpacket in (torch.ops.aten.bmm, torch.ops.aten.baddbmm):
            self.batched += self.flops - before
        return out


@pytest.mark.parametrize("policy", [None, "dots"])
@pytest.mark.parametrize("arch", ["granite_8b", "qwen3_moe_30b_a3b", "mamba2_780m"])
def test_dot_flops_match_hlo_analysis(arch, policy):
    """One single-device train step's FLOPs (b 2 x S 64, the einsum paths)
    within 2% of ``analyze_hlo`` of the JAX step jitted at the same
    shapes, under full remat and ``dots``.  Named structural term: the
    SSD scan's batched einsums, which JAX contracts per head
    (``bclhn,bcshn,bhcls,bcshp->bclhp``) and the port per group, are
    subtracted from both sides for mamba2 (the dots of rank > 2 there,
    ``aten.bmm`` here); its projections are held as the rest."""
    jcfg = exact_cfg(arch)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    shape = JSH.InputShape("flops", "train", 64, 2)
    jpol = None if policy is None else jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    jstep = JTS.make_train_step(jcfg, JA.AdamWConfig(), remat_policy=jpol, backend="einsum")
    hlo = jax.jit(jstep).lower(JTS.abstract_train_state(jcfg),
                               JSH.input_specs(jcfg, shape)).compile().as_text()
    ssd = jcfg.family == "ssm"
    want, want_ssd = _hlo_dot_flops(hlo, ssd)
    state = TTS.abstract_train_state(tcfg)
    state = TTS.train_state_from(state.params, state.opt_state, 0)
    mode = _Batched()
    with mode:
        TTS.make_train_step(tcfg, remat_policy=policy, backend="einsum")(
            state, TSH.input_specs(tcfg, TSH.InputShape("flops", "train", 64, 2)))
    got, got_ssd = mode.flops, mode.batched if ssd else 0
    assert abs((got - got_ssd) - (want - want_ssd)) <= FLOPS_RTOL * (want - want_ssd), \
        (got, got_ssd, want, want_ssd)
    if ssd:
        assert got_ssd > 0 and want_ssd > 0


def test_dots_saves_recompute_flops_and_holds_more_memory():
    """At granite's smoke width, b 2 x S 512: ``dots`` does fewer FLOPs
    than full remat (the projections are not recomputed) and its peak
    holds more (their outputs are kept)."""
    tcfg = TConfig(**dataclasses.asdict(exact_cfg("granite_8b")))
    out = {}
    for policy in (None, "dots"):
        state = TTS.abstract_train_state(tcfg)
        state = TTS.train_state_from(state.params, state.opt_state, 0)
        batch = {"tokens": torch.empty((2, 512), dtype=torch.int32, device="meta")}
        mode = MetaAnalysis()
        with mode:
            mode.track(tree_leaves(state.params) + tree_leaves(state.opt_state)
                       + list(batch.values()))
            TTS.make_train_step(tcfg, remat_policy=policy)(state, batch)
        out[policy] = mode.report()
    assert out["dots"]["flops"] < out[None]["flops"]
    assert out["dots"]["peak_bytes"] > out[None]["peak_bytes"]
    assert out["dots"]["kernels"]["flash_attention"]["calls"] == \
        out[None]["kernels"]["flash_attention"]["calls"] == 2 * tcfg.num_layers


# ---------------------------------------------------------------------------
# the analysis: peak bytes and the kernels' meta path
# ---------------------------------------------------------------------------

def test_peak_tracks_each_storage_until_released():
    mode = MetaAnalysis()
    x = torch.empty(1000, device="meta")                       # 4000 bytes
    with mode:
        mode.track([x])
        a = torch.empty(500, device="meta")                    # + 2000
        v = a.view(10, 50)                                     # a view: nothing new
        del a
        b = v * 2.0                                            # + 2000 -> 8000
        del v, b                                               # - 4000
        c = torch.empty(3000, dtype=torch.uint8, device="meta")  # + 3000 -> 7000
    assert mode.peak == 8000 and mode.live == 4000 + 3000
    assert mode.bytes == 2000 + 2000                           # mul: operand + result
    del c


@pytest.mark.parametrize("causal,window,q_offset,prefix,Sq,Sk", [
    (True, 0, 0, 0, 37, 37), (True, 0, 0, 11, 37, 37), (False, 0, 5, 0, 9, 40),
    (True, 7, 0, 0, 30, 30), (True, 5, 12, 3, 10, 25), (True, 0, 3, 20, 8, 14)])
def test_attention_pairs_count_the_mask(causal, window, q_offset, prefix, Sq, Sk):
    """``cost.attention_pairs`` is the number of True entries of
    ``ref.attention_ref``'s mask, written out here."""
    qp = torch.arange(Sq)[:, None] + q_offset
    kp = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask = (kp <= qp) | (kp < prefix) if prefix else kp <= qp
    if window:
        mask = mask & (kp > qp - window)
    assert cost.attention_pairs(2, 3, Sq, Sk, causal=causal, window=window,
                                q_offset=q_offset, prefix_len=prefix) == 6 * int(mask.sum())


def test_kernels_on_meta_allocate_count_and_launch_nothing(monkeypatch):
    """Inside ``ops.estimating`` each wrapper given meta tensors returns
    its kernel's outputs (ssd_scan's bf16 scratch allocated too, as the
    peak shows), launches nothing and counts no launch, and reports the
    closed form of ``kernels/cost.py``; ``backend="auto"`` resolves to the
    kernel for such tensors; outside it a meta tensor still reaches the
    kernel path and raises there."""
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("a kernel was launched"))
    meta = dict(device="meta", dtype=torch.bfloat16)
    seen = []
    before = {fn.__name__: fn.launches for fn in ops.KERNELS}
    mode = MetaAnalysis()
    with mode:
        q, kv = torch.empty(2, 128, 8, 128, **meta), torch.empty(2, 128, 2, 128, **meta)
        assert ops.resolve_backend("auto", q) == "kernel" == ops.preferred_backend(q)
        out = ops.flash_attention(q, kv, kv, causal=True, prefix_len=16)
        seen.append(("flash_attention", out.shape == q.shape, cost.flash_attention_cost(
            q.shape, kv.shape, 2, causal=True, prefix_len=16)))
        qd, cache = torch.empty(2, 8, 128, **meta), torch.empty(2, 2, 64, 128, **meta)
        out = ops.flash_decode(qd, cache, cache, 40, window=16)
        live = int(ref.decode_valid(40, 64, window=16).sum())
        seen.append(("flash_decode", out.shape == qd.shape,
                     cost.flash_decode_cost(2, 2, 4, 128, live, 2)))
        x = torch.empty(1, 256, 4, 64, **meta)
        f32 = dict(device="meta", dtype=torch.float32)
        BC = torch.empty(1, 256, 1, 128, **meta)
        live_before = mode.live
        y, fin = ops.ssd_scan(x, torch.empty(1, 256, 4, **f32), torch.empty(4, **f32), BC, BC,
                              chunk=128)
        scratch = 4 * (4 * 256 + 4 * 2 * 64 * 128) + 2 * 4 * 2 * 2 * 64 * 128
        assert mode.peak - live_before >= y.numel() * 4 + fin.numel() * 4 + scratch
        seen.append(("ssd_scan", y.shape == (1, 256, 4, 64) and fin.shape == (1, 4, 64, 128),
                     cost.ssd_scan_cost(1, 256, 4, 64, 1, 128, 128, 2)))
        xn = torch.empty(64, 512, **meta)
        out = ops.rmsnorm(xn, torch.empty(512, **f32))
        seen.append(("rmsnorm", out.shape == xn.shape, cost.rmsnorm_cost(64, 512, 2, 4)))
    assert {fn.__name__: fn.launches for fn in ops.KERNELS} == before
    for name, shaped, (flops, nbytes) in seen:
        assert shaped, name
        assert mode.kernels[name] == {"calls": 1, "flops": flops, "bytes": nbytes}, name
    assert ops.preferred_backend(q) == "einsum"
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.flash_decode(qd, cache, cache, 40)


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

def _serve_cfg(arch, over):
    return dataclasses.replace(exact_cfg(arch), **over)


@pytest.fixture(scope="module", autouse=True)
def _jax_memory_run(tmp_path_factory):
    """The helper's subprocess, started with the module's first test so
    that it compiles while the others run: the JAX steps' per-device
    argument bytes of ``MEMORY_CASES``."""
    tmp = tmp_path_factory.mktemp("dryrun_memory")
    cases = [(name, dataclasses.asdict(exact_cfg(arch)), data, model, B, SEQ, accum, mode)
             for name, arch, data, model, accum, mode in MEMORY_CASES]
    cases += [(name, dataclasses.asdict(_serve_cfg(arch, over)), 2, 2, batch, seq, 1, kind)
              for name, arch, over, kind, batch, seq in SERVE_CASES]
    cases += [(name, dataclasses.asdict(_serve_cfg(arch, over)), 2, 3, batch, seq, 1, kind)
              for name, arch, over, kind, batch, seq in UNDIVIDED_CASES]
    src, dst = tmp / "in.pkl", tmp / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "helpers" /
                                                 "jax_dryrun_memory.py"), str(src), str(dst)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, dst
    proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def jax_arguments(_jax_memory_run):
    proc, dst = _jax_memory_run
    log = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, log[-3000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", [c[0] for c in MEMORY_CASES])
def test_argument_bytes_equal_jax_memory_analysis(jax_arguments, name):
    """Rank (0, 0)'s argument bytes (its blocks of the state and its rows
    of the batch) equal JAX's per-device ``argument_size_in_bytes`` of
    the same step compiled on a 2 x 2 mesh, less JAX's int32 step counter
    (the port keeps the step as a Python int)."""
    _, arch, data, model, accum, mode = next(c for c in MEMORY_CASES if c[0] == name)
    cfg = TConfig(**dataclasses.asdict(exact_cfg(arch)))
    rec = dryrun.estimate(cfg, Mesh.of((data, model), ("data", "model")),
                          TSH.InputShape(name, "train", SEQ, B), accum=accum, dp_mode=mode)
    assert rec["argument_bytes"] == jax_arguments[name] - 4
    assert rec["state_bytes"] == rec["block_bytes"]
    if mode == "manual":
        assert rec["optimizer_bytes"] == rec["optimizer_closed"]


@pytest.mark.parametrize("name", [c[0] for c in UNDIVIDED_CASES])
def test_undivided_argument_bytes_equal_jax_memory_analysis(jax_arguments, name):
    """On the 2 x 3 mesh, where the model axis does not divide a count
    the members would split and each such part is computed whole, every
    rank's argument bytes equal JAX's per-device ``argument_size_in_bytes``
    of the same step (a train step less JAX's int32 step counter): the
    persistent blocks stay the rules' whatever the members compute."""
    _, arch, over, kind, batch, seq = next(c for c in UNDIVIDED_CASES if c[0] == name)
    cfg = TConfig(**dataclasses.asdict(_serve_cfg(arch, over)))
    mesh = Mesh.of((2, 3), ("data", "model"))
    for rank in ((0, 0), (1, 2)):
        if kind == "gspmd":
            rec = dryrun.estimate(cfg, mesh, TSH.InputShape(name, "train", seq, batch),
                                  rank=rank)
            assert rec["argument_bytes"] == jax_arguments[name] - 4
            assert rec["state_bytes"] == rec["block_bytes"]
        else:
            rec = dryrun.estimate_serve(cfg, mesh, TSH.InputShape(name, kind, seq, batch),
                                        rank=rank)
            assert rec["argument_bytes"] == jax_arguments[name]
            assert rec["cache_bytes"] == rec["cache_block_bytes"]
        assert rec["whole"] and rec["whole"] == dryrun.spmd.whole_parts(cfg, 3)


def _serve_estimate(name, backend="auto"):
    _, arch, over, kind, batch, seq = next(c for c in SERVE_CASES if c[0] == name)
    cfg = TConfig(**dataclasses.asdict(_serve_cfg(arch, over)))
    return cfg, dryrun.estimate_serve(cfg, Mesh.of((2, 2), ("data", "model")),
                                      TSH.InputShape(name, kind, seq, batch), backend=backend)


@pytest.mark.parametrize("name", [c[0] for c in SERVE_CASES])
def test_serve_argument_bytes_equal_jax_memory_analysis(jax_arguments, name):
    """Rank (0, 0)'s serve arguments (its blocks of the weights, of the
    decode cache under ``rules.cache_shardings``, its rows of the prompts
    or tokens, and the decode's int32 position where the step reads it)
    equal JAX's per-device ``argument_size_in_bytes`` of the JAX
    dry-run's prefill and donated decode step compiled on a 2 x 2 mesh;
    the cache's bytes are its closed form."""
    _, rec = _serve_estimate(name)
    assert rec["argument_bytes"] == jax_arguments[name]
    assert rec["cache_bytes"] == rec["cache_block_bytes"]


def _structural_flops(cfg, name):
    """The two products the port and the reference's GSPMD step do not
    share, by their closed forms on the 2 x 2 mesh (rank (0, 0)'s rows):
    (the port's extra unembedding: it gathers the embedding whole where
    GSPMD shards the vocabulary over the model axis; the reference's
    second K and V projection a layer for its cache, ``repro/models/
    model.py:334`` beside ``block_forward``'s, once an attention layer (a
    hybrid model's shared block once a group), which XLA keeps where the
    rules shard the cache over its kv heads and merges where one kv head
    is replicated, read from the compiled HLO's dots)."""
    _, _, _, kind, batch, seq = next(c for c in SERVE_CASES if c[0] == name)
    rows = batch // 2 if batch % 2 == 0 else batch     # a batch of one is replicated
    unembed = 2 * rows * cfg.d_model * cfg.vocab_size // 2
    twice = 0
    if kind == "prefill" and cfg.family != "ssm" and cfg.num_kv_heads >= 2:
        tokens = rows * (seq + cfg.num_prefix_tokens)
        attn_layers = cfg.num_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" \
            else cfg.num_layers
        twice = attn_layers * 2 * 2 * tokens * cfg.num_kv_heads * cfg.head_dim \
            * cfg.d_model // 2
    return unembed, twice


@pytest.mark.parametrize("name", [c[0] for c in SERVE_CASES])
def test_serve_flops_against_hlo_analysis(jax_arguments, name, capsys):
    """A prefill's FLOPs on rank (0, 0) (the einsum paths) within 2% of
    ``analyze_hlo`` of the JAX dry-run's step compiled on the 2 x 2 mesh,
    once the two named products the steps do not share are taken into
    account (:func:`_structural_flops`).  A decode step's are printed
    beside it (the gaps, PERF.md §6: the unembedding, and where one kv
    head or a row is replicated the products GSPMD splits over the
    members where the port repeats them)."""
    cfg, rec = _serve_estimate(name, backend="einsum")
    want = jax_arguments[name + "/flops"]
    unembed, twice = _structural_flops(cfg, name)
    with capsys.disabled():
        print(f"\n{name}: port {rec['flops']} FLOPs, analyze_hlo {want:.0f}, unembedding "
              f"{unembed}, K/V again {twice}")
    if rec["kind"] == "prefill":
        assert abs(rec["flops"] - unembed + twice - want) <= FLOPS_RTOL * want
    else:
        assert rec["flops"] - unembed >= want * (1 - FLOPS_RTOL)


def test_dryrun_one_records_ok_and_refusals(tmp_path):
    """``dryrun_one`` on a 2 x 2 mesh records ``ok`` with every field; an
    undivided head count is ``ok``, the attention named whole; a serve
    shape out of scope is ``refused`` with its reason; each record is
    written."""
    mesh = Mesh.of((2, 2), ("data", "model"))
    shape = TSH.InputShape("train_small", "train", 64, 4)
    rec = dryrun.dryrun_one("granite_8b", "train_small", out_dir=str(tmp_path), mesh=mesh,
                            cfg=tsmoke("granite_8b"), shape=shape, remat_policy="dots")
    assert rec["status"] == "ok", rec.get("error")
    for key in ("argument_bytes", "state_bytes", "block_bytes", "peak_bytes", "flops",
                "bytes", "collectives", "n_devices", "wall_s", "activations"):
        assert key in rec, key
    assert rec["n_devices"] == 4 and rec["peak_bytes"] >= rec["argument_bytes"]
    assert rec["collectives"]["model"]["reduce"]["calls"] > 0
    assert "replicated over the model axis" in rec["activations"]
    on_disk = json.loads((tmp_path / "granite_8b__train_small__mesh2x2.json").read_text())
    assert on_disk["status"] == "ok"
    odd = dataclasses.replace(tsmoke("granite_8b"), num_heads=3, num_kv_heads=1)
    rec = dryrun.dryrun_one("granite_8b", "train_small", mesh=mesh, cfg=odd, shape=shape)
    assert rec["status"] == "ok" and rec["whole"] == {"attention": "num_heads=3"}
    for kind, seq in (("prefill", 64), ("decode", 128)):
        rec = dryrun.dryrun_one("granite_8b", kind, mesh=mesh, cfg=tsmoke("granite_8b"),
                                shape=TSH.InputShape(kind, kind, seq, 4))
        assert rec["status"] == "ok", rec.get("error")
        assert rec["cache_bytes"] == rec["cache_block_bytes"] > 0
        assert rec["collectives"]["model"]["reduce"]["calls"] > 0
    full = dataclasses.replace(tsmoke("granite_8b"), long_context_window=0)
    rec = dryrun.dryrun_one("granite_8b", "long_500k", mesh=mesh, cfg=full)
    assert rec["status"] == "refused" and "out of scope" in rec["reason"]
    rec = dryrun.dryrun_one("zamba2_2p7b", "decode_32k", mesh=mesh,
                            cfg=tsmoke("zamba2_2p7b"))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cache_bytes"] == rec["cache_block_bytes"] > 0
    assert rec["reblock"]["data"]["calls"] > 0


def test_dryrun_cli_on_the_production_mesh(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun`` for qwen1.5-0.5b on the
    16 x 16 mesh: ``train_4k`` ok (the adaptive accumulation's 1
    microbatch of 16 rows a rank) and the three serve shapes ok, exit 0;
    the record's state bytes are the rules' blocks over 256 devices, a
    decode's cache bytes their closed form."""
    code = dryrun.main(["--arch", "qwen1p5_0p5b", "--shape", "all", "--out", str(tmp_path),
                        "--table"])
    text = capsys.readouterr().out
    assert code == 0 and "4 ok, 0 refused, 0 failed" in text
    rec = json.loads((tmp_path / "qwen1p5_0p5b__decode_32k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and rec["cache_bytes"] == rec["cache_block_bytes"]
    assert rec["batch_bytes"] == 8 * 4
    rec = json.loads((tmp_path / "qwen1p5_0p5b__train_4k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and rec["accum"] == 1 and rec["n_devices"] == 256
    assert rec["state_bytes"] == rec["block_bytes"]
    assert rec["batch_bytes"] == 16 * 4096 * 4
    assert "| qwen1p5_0p5b | pod16x16 | full | ok | 1 |" in text


def test_launcher_remat_policy(tmp_path):
    """``--remat-policy dots`` trains on one device (the smoke config, 2
    steps, the same losses as full remat's in fp32 to 1e-6) and the
    pipeline, whose stages checkpoint whole layers, refuses it."""
    from unittest import mock

    from repro_torch.launch import train
    cfg = TConfig(**dataclasses.asdict(exact_cfg("qwen1p5_0p5b")))
    losses = {}
    for policy in ("full", "dots"):
        argv = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "32", "--remat-policy", policy,
                "--run-dir", str(tmp_path / policy)]
        with mock.patch.object(train, "get_smoke_config", lambda name: cfg):
            losses[policy] = train.main(argv)["losses"]
    for a, b in zip(losses["dots"], losses["full"]):
        assert abs(a - b) <= DOTS_RTOL * abs(b)
    with pytest.raises(SystemExit, match="--remat-policy dots"):
        train.main(["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu",
                    "--pipeline-parallel", "2", "--remat-policy", "dots"])
