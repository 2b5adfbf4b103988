"""The port's precision-alignment harness (``repro_torch.precision``) held
against ``repro.precision`` on the CPU.

The regimes' table, the probes and the criterion are the reference's.
Each probe's body gets the reference's own inputs, drawn here exactly as
``repro/precision/backends.py`` draws them from ``jax.random``.
Tolerances: in the fp32 regime, and for the probes that only round their
inputs to the regime's dtype before fp32 math (softmax, layernorm, gelu,
cross_entropy), the two frameworks do the same fp32 arithmetic in
another order (1e-6 of the output's scale).  A product in bf16 or fp16
is rounded to that dtype once per accumulation chunk in both, from sums
taken in another order, so it may land one step of the dtype away per
chunk (``_ulps``); attention rounds two products, two steps at its
scale.  Loss curves: fp32 to 1e-4 relative, bf16 and fp16 within the
harness's own MRE criterion of the JAX curve in the same dtype.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.precision import align as JA
from repro.precision import backends as JB
from repro_torch import bridge
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.precision import align as TA
from repro_torch.precision import backends as TB

DEV = torch.device("cpu")
EPS = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
RNG = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)          # two cores, not all: tier-1 runs files in parallel
    yield
    torch.set_num_threads(threads)


def jax_draws(name, rng):
    """The inputs ``repro/precision/backends.py``'s probe ``name`` draws
    from ``rng``, as numpy."""
    normal = lambda k, s, scale=1: np.asarray(jax.random.normal(k, s) * scale)
    if name == "matmul":
        return normal(rng, (128, 256)), normal(jax.random.fold_in(rng, 1), (256, 128))
    if name == "attention":
        return tuple(normal(k, (2, 64, 4, 32)) for k in jax.random.split(rng, 3))
    return {"softmax": (normal(rng, (64, 512), 4),),
            "layernorm": (normal(rng, (64, 512)),),
            "gelu": (normal(rng, (4096,)),),
            "cross_entropy": (normal(rng, (32, 1000), 3),)}[name]


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _ulps(be, a, b):
    """One step of the regime's dtype per accumulation chunk: the sum
    over chunks of eps x |the chunk's product| (fp64, rounded inputs)."""
    dt = TB.DTYPES[be.compute_dtype]
    a, b = (torch.from_numpy(np.array(x)).to(dt).double().numpy() for x in (a, b))
    K, c = a.shape[-1], be.accum_chunks
    while K % c:
        c -= 1
    kc = K // c
    return sum(EPS[be.compute_dtype] * np.abs(a[..., i * kc:(i + 1) * kc] @
                                              b[..., i * kc:(i + 1) * kc, :])
               for i in range(c))


def test_tables_equal_reference():
    assert TA.MRE_CRITERION == JA.MRE_CRITERION == 0.015
    assert list(TB.BACKENDS) == list(JB.BACKENDS)
    for name, be in TB.BACKENDS.items():
        assert dataclasses.asdict(be) == dataclasses.asdict(JB.BACKENDS[name])
    assert list(TB.OPS) == list(JB.OPS)
    assert [f.name for f in dataclasses.fields(TA.OpReport)] == \
        [f.name for f in dataclasses.fields(JA.OpReport)]


@pytest.mark.parametrize("be", list(JB.BACKENDS))
def test_backend_matmul_matches_reference(be):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((256, 64)).astype(np.float32)
    want = np.asarray(JB.backend_matmul(JB.BACKENDS[be], jnp.asarray(a), jnp.asarray(b)))
    got = TB.backend_matmul(TB.BACKENDS[be], *_t((a, b)))
    assert got.dtype == torch.float32
    tol = 1e-6 * np.abs(want).max() if be == "a100_ref" else _ulps(TB.BACKENDS[be], a, b)
    assert (np.abs(got.numpy() - want) <= tol + 1e-6).all()


def test_accumulation_order_changes_bits_but_stays_aligned():
    """The reference test's claim, in the port: chip_b's chunked order
    gives other bits than chip_a's, within 5e-2 of the output's scale."""
    rng = np.random.default_rng(0)
    a, b = _t((rng.standard_normal((64, 256)).astype(np.float32),
               rng.standard_normal((256, 64)).astype(np.float32)))
    o1 = TB.backend_matmul(TB.BACKENDS["chip_a"], a, b).numpy()
    o2 = TB.backend_matmul(TB.BACKENDS["chip_b"], a, b).numpy()
    assert not np.array_equal(o1, o2)
    rms = np.sqrt(np.mean(o1 ** 2))
    assert np.max(np.abs(o1 - o2) / np.maximum(np.abs(o1), rms)) < 5e-2


@pytest.mark.parametrize("be", list(JB.BACKENDS))
@pytest.mark.parametrize("op", list(JB.OPS))
def test_op_body_matches_reference(op, be):
    """Each probe's body on the reference's own draws against the
    reference probe, under each regime."""
    want = np.asarray(JB.OPS[op](JB.BACKENDS[be], RNG), np.float64)
    ins = jax_draws(op, RNG)
    tbe = TB.BACKENDS[be]
    got = TB.OPS[op].body(tbe, *_t(ins))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    if be == "a100_ref" or op not in ("matmul", "attention"):
        tol = 1e-6 * scale
    elif op == "matmul":
        tol = _ulps(tbe, *ins) + 1e-6
    else:
        tol = 2 * EPS[tbe.compute_dtype] * scale
    assert (np.abs(got.double().numpy() - want) <= tol).all()


def test_probes_draw_the_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    for name, probe in TB.OPS.items():
        got = probe.draw(gen, DEV)
        assert [tuple(t.shape) for t in got] == [a.shape for a in jax_draws(name, RNG)]
        assert all(t.dtype == torch.float32 for t in got)
        assert tuple(probe(TB.BACKENDS["chip_a"], gen, DEV).shape) == \
            tuple(np.shape(JB.OPS[name](JB.BACKENDS["chip_a"], RNG)))


def test_operator_sweep_matches_reference(monkeypatch):
    """The port's sweep on its own draws: the reference's (op, backend)
    set, every regime passing where the reference's passes, every bf16
    regime inside the 0.1 tolerance and every error finite.  On the
    reference's draws, each error within two steps of the regime's dtype
    of the reference's (errors are relative to the output's scale)."""
    want = JA.operator_sweep()
    got = TA.operator_sweep(device="cpu")
    key = lambda r: (r.op, r.backend)
    assert sorted(map(key, got)) == sorted(map(key, want))
    assert {key(r) for r in got if r.passed} == {key(r) for r in want if r.passed}
    assert all(r.passed for r in got if r.backend in ("chip_a", "chip_b"))
    assert all(np.isfinite(r.max_rel_err) for r in got)

    for name, probe in TB.OPS.items():
        draws = jax_draws(name, RNG)
        monkeypatch.setitem(TB.OPS, name, dataclasses.replace(
            probe, draw=lambda g, d, draws=draws: tuple(_t(draws))))
    got = {key(r): r for r in TA.operator_sweep(device="cpu")}
    for r in want:
        eps = EPS[JB.BACKENDS[r.backend].compute_dtype]
        assert abs(got[key(r)].max_rel_err - r.max_rel_err) <= 2 * eps + 1e-6, r
        assert got[key(r)].passed == r.passed


def test_loss_mre():
    y = np.array([1.0, 2.0, 4.0])
    yh = np.array([1.01, 1.98, 4.04])
    assert abs(TA.loss_mre(yh, y) - 0.01) < 1e-12
    rng = np.random.default_rng(1)
    a, b = rng.random(50) + 5, rng.random(50) + 5
    assert TA.loss_mre(a, b) == JA.loss_mre(a, b)


def test_train_loss_curve_from_bridged_jax_weights():
    """The port's curve from the JAX package's weights in each regime's
    dtype (``init_params`` of the config in that dtype, seed 0, as the
    reference's own curve starts), on the same stream: fp32 to 1e-4
    relative; bf16 and fp16 within the MRE criterion of the JAX curve in
    the same dtype."""
    cfg = get_smoke_config("qwen1p5_0p5b")
    tcfg = TConfig(**dataclasses.asdict(cfg))
    iters = 4
    for dt in ("float32", "bfloat16", "float16"):
        want = JA.train_loss_curve(cfg, dtype=dt, iters=iters)
        jp = JM.init_params(dataclasses.replace(cfg, dtype=dt), jax.random.PRNGKey(0))
        params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), DEV)
        times = []
        got = TA.train_loss_curve(tcfg, dtype=dt, iters=iters, device="cpu",
                                  params=params, times=times)
        assert got.shape == (iters,) and np.isfinite(got).all() and len(times) == iters
        if dt == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4)
        else:
            assert TA.loss_mre(got, want) < TA.MRE_CRITERION, (dt, got, want)


def test_model_level_alignment_keys_and_defaults():
    """The reference's default regimes (bf16 and fp16) against fp32, each
    a finite MRE; its own init from the seed."""
    cfg = TConfig(**dataclasses.asdict(get_smoke_config("qwen1p5_0p5b")))
    out = TA.model_level_alignment(cfg, iters=2, device="cpu", seq=32)
    assert list(out) == ["bfloat16", "float16"]
    assert all(np.isfinite(v) and v < TA.MRE_CRITERION for v in out.values())
    assert list(TA.model_level_alignment(cfg, iters=1, dtypes=["float16"],
                                         device="cpu", seq=16)) == ["float16"]


def test_harness_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig(**dataclasses.asdict(get_smoke_config("qwen1p5_0p5b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.operator_sweep()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.train_loss_curve(cfg, dtype="float32", iters=1)


def test_ieee_fp32_turns_tf32_off_and_restores_it():
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        m.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with TA.ieee_fp32():
            assert not m.allow_tf32 and not torch.backends.cudnn.allow_tf32
            assert TA.regime_flags()["allow_tf32"] is False
        assert m.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    flags = TA.regime_flags()
    assert set(flags) == {"allow_tf32", "cudnn_allow_tf32",
                          "allow_fp16_reduced_precision_reduction",
                          "allow_bf16_reduced_precision_reduction"}
