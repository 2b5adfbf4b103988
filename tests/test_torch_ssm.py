"""The port's SSD functions, Mamba2 block, ``flash_attention`` gradient
and SSM serving path, held against the JAX package on the CPU.

Inputs are numpy-seeded; weights come from ``repro.models.model.
init_params`` (fp32 ``conftest.exact_cfg``, with biases and norm scales
perturbed) and cross with ``repro_torch.bridge``.  Where JAX reaches a
Pallas kernel it runs in interpret mode, as ``tests/test_kernels.py``
runs it.  The CUDA kernels run only on the card (``chip_smoke.py``); on
the CPU the wrappers compute their plain versions, and the autograd
Functions are driven with the plain version as their forward body.

Tolerances: the SSD functions and the block are the same fp32
arithmetic in another order, atol 2e-5 on O(1) values (the sequential
and chunked forms sum ~64 terms differently); gradients, which sum
over every position, rtol 1e-4 of each leaf's largest value; the
served logits and caches atol/rtol 2e-4 as ``tests/test_serve.py``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TTF
from repro_torch.models.config import ModelConfig as TConfig

ATOL = 2e-5
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
DEV = torch.device("cpu")


def _chip_smoke():
    """chip_smoke.py as a module (it imports only the standard library at
    its top), for its tolerances and limits."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _ssd_inputs(seed, b=2, S=64, h=4, p=16, g=1, n=8, state=False):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f(b, S, h, p)
    dt = (np.log1p(np.exp(f(b, S, h))) * 0.5).astype(np.float32)
    A = (-np.exp(f(h, scale=0.3))).astype(np.float32)
    out = [x, dt, A, f(b, S, g, n, scale=0.3), f(b, S, g, n, scale=0.3)]
    if state:
        out.append(f(b, h, p, n, scale=0.3))
    return out


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _grad_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("g,state", [(1, False), (2, False), (1, True), (2, True)])
def test_ssd_ref_and_chunked_match_jax(g, state):
    arrs = _ssd_inputs(g + 10 * state, g=g, state=state)
    *ins, s0 = arrs if state else (*arrs, None)
    jins = list(map(jnp.asarray, ins))
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    want_y, want_f = jref.ssd_ref(*jins, initial_state=js0)
    jc_y, jc_f = jssm.ssd_chunked(*jins, 16, js0)
    for got_y, got_f in (tref.ssd_ref(*_t(ins), initial_state=ts0),
                         tssm.ssd_chunked(*_t(ins), 16, ts0)):
        for want in ((want_y, want_f), (jc_y, jc_f)):
            _close(got_y, want[0])
            _close(got_f, want[1])


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_plain_matches_pallas_interpret(g):
    ins = _ssd_inputs(20 + g, S=64, h=4, p=32, g=g, n=16)
    want_y, want_f = pallas_ssd_scan(*map(jnp.asarray, ins), chunk=32,
                                     interpret=True)
    got_y, got_f = tops.ssd_scan(*_t(ins), chunk=32)    # CPU: plain version
    _close(got_y, want_y, atol=1e-4, rtol=1e-3)          # as tests/test_kernels.py
    _close(got_f, want_f, atol=1e-4, rtol=1e-3)
    assert got_y.dtype == got_f.dtype == torch.float32
    assert tops.ssd_scan.launches == 0


def _plain_ssd_body(x, dt, A, Bm, Cm, *, chunk):
    return tref.ssd_ref(x, dt, A, Bm, Cm)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_grad_matches_jax(g):
    """The autograd Function (forward: the kernel's plain version;
    backward: the chunked form) against ``jax.grad`` of the JAX wrapper
    (forward: the interpret-mode Pallas kernel; backward: ``ssd_ref``)."""
    ins = _ssd_inputs(30 + g, S=64, h=4, p=16, g=g, n=8)
    rng = np.random.default_rng(40 + g)
    gy = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    gf = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)

    def jloss(*a):
        y, fin = jops.ssd_scan(*a, chunk=16)
        return jnp.sum(y * gy) + jnp.sum(fin * gf)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
    tins = [t.requires_grad_() for t in _t(ins)]
    y, fin = tops.recompute_vjp("ssd_scan", _plain_ssd_body, tops._ssd_chunked,
                                tins, chunk=16)
    got = torch.autograd.grad([y, fin], tins, _t([gy, gf]))
    for a, b in zip(got, want):
        _grad_close(a, b)
    # an unused final state (the training path) brings no gradient
    y, _ = tops.recompute_vjp("ssd_scan", _plain_ssd_body, tops._ssd_chunked,
                                tins, chunk=16)
    gx, = torch.autograd.grad(y, tins[0], torch.from_numpy(gy))
    want_x = jax.grad(lambda x: jnp.sum(jops.ssd_scan(
        x, *map(jnp.asarray, ins[1:]), chunk=16)[0] * gy))(jnp.asarray(ins[0]))
    _grad_close(gx, want_x)


def _hi_lo(v):
    """``v`` as the bf16 kernels feed an fp32 intermediate to the tensor
    cores: hi = bf16(v), lo = bf16(v - hi), multiplied as hi + lo."""
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float()


def _bf16_once(v):
    """``v`` rounded to bf16 once (what a plain bf16 operand would hold)."""
    return v.bfloat16().float()


def ssd_tc_emulated(x, dt, A, Bm, Cm, chunk, *, rnd=_hi_lo):
    """The bf16 ``ssd_scan`` kernels' arithmetic in plain PyTorch (fp32
    from the inputs as given): pass 1 the chunk states (x o w)^T B with
    w = dt exp(cum_last - cum), pass 2 the state entering each chunk,
    pass 3 exp(cum_i) C prev^T + (S o L o dt_j) x with S = C B^T.  The
    three fp32 intermediates that the kernels hand to the tensor cores
    (x o w, prev, M) go through ``rnd`` exactly there (the kernels'
    ``_hi_lo``; None keeps them fp32); products of two inputs stay exact.
    Returns (y, final state)."""
    b, S, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    nc, r = S // chunk, h // g
    rnd = rnd or (lambda v: v)
    xc = x.float().reshape(b, nc, chunk, h, p)
    Bc = Bm.float().repeat_interleave(r, 2).reshape(b, nc, chunk, h, n)
    Cc = Cm.float().repeat_interleave(r, 2).reshape(b, nc, chunk, h, n)
    dtc = dt.float().reshape(b, nc, chunk, h)
    cum = torch.cumsum(A.float() * dtc, dim=2)                     # (b,nc,l,h)
    # pass 1
    w = dtc * torch.exp(cum[:, :, -1:] - cum)
    states = torch.einsum("bclhp,bclhn->bchpn", rnd(xc * w[..., None]), Bc)
    # pass 2
    prev, run = torch.empty_like(states), torch.zeros_like(states[:, 0])
    for c in range(nc):
        prev[:, c] = run
        run = run * torch.exp(cum[:, c, -1])[..., None, None] + states[:, c]
    # pass 3: the exponent of L only where j <= i
    y = torch.einsum("bclhn,bchpn->bclhp", Cc, rnd(prev)) * torch.exp(cum)[..., None]
    Sm = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    ci = cum.permute(0, 1, 3, 2)                                    # (b,nc,h,l)
    low = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    L = torch.where(low, torch.exp(torch.where(low, ci[..., :, None] - ci[..., None, :], 0.0)),
                    0.0)
    M = rnd(Sm * L * dtc.permute(0, 1, 3, 2)[..., None, :])
    y = y + torch.einsum("bchij,bcjhp->bcihp", M, xc)
    return y.reshape(b, S, h, p), run


def _bf16_ssd_inputs(seed, **kw):
    """``_ssd_inputs`` with x, B and C rounded to bf16 (the kernels'
    inputs), as torch tensors and as the fp32 numpy arrays the JAX side
    reads."""
    x, dt, A, Bm, Cm = _t(_ssd_inputs(seed, **kw))
    x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    return (x, dt, A, Bm, Cm), [t.float().numpy() for t in (x, dt, A, Bm, Cm)]


# (b, S, h, p, g, n, chunk): several chunks with g 1 and g 2, S = one chunk,
# chunks that are no multiple of the kernels' 64-row tiles, and zamba2's
# (p 64, n 64): a state half the kernels' 128 columns
SSD_TC_CASES = [
    (2, 128, 4, 16, 1, 16, 32),
    (2, 128, 4, 16, 2, 16, 32),
    (1, 64, 4, 32, 1, 32, 64),
    (1, 192, 6, 8, 3, 24, 96),
    (1, 128, 8, 64, 1, 64, 64),
]


@pytest.mark.parametrize("b,S,h,p,g,n,chunk", SSD_TC_CASES)
def test_ssd_tensor_core_numerics_match_jax(b, S, h, p, g, n, chunk):
    """The bf16 kernels' arithmetic (hi + lo splits) against the JAX
    ``ssd_ref`` and the interpret-mode Pallas kernel on the same
    bf16-rounded inputs, under chip_smoke's unchanged SSD_TOL (the bound
    the kernels meet against ``ref.ssd_ref`` on the card)."""
    tins, jins = _bf16_ssd_inputs(50 + S + g, b=b, S=S, h=h, p=p, g=g, n=n)
    atol, rtol = CS.SSD_TOL
    got_y, got_f = ssd_tc_emulated(*tins, chunk)
    jins = list(map(jnp.asarray, jins))
    for want_y, want_f in (jref.ssd_ref(*jins),
                           pallas_ssd_scan(*jins, chunk=chunk, interpret=True)):
        _close(got_y, want_y, atol=atol, rtol=rtol)
        _close(got_f, want_f, atol=atol, rtol=rtol)


@pytest.mark.parametrize("b,S,h,p,g,n,chunk", SSD_TC_CASES)
def test_ssd_tensor_core_emulation_without_rounding_is_exact(b, S, h, p, g, n,
                                                             chunk):
    """Without the hi + lo splits the three passes are the reference's
    fp32 arithmetic in another order (1e-5 against the JAX ``ssd_ref``):
    the splits are the design's only departure."""
    ins = _ssd_inputs(60 + S + g, b=b, S=S, h=h, p=p, g=g, n=n)
    want_y, want_f = jref.ssd_ref(*map(jnp.asarray, ins))
    got_y, got_f = ssd_tc_emulated(*_t(ins), chunk, rnd=None)
    _close(got_y, want_y, atol=1e-5)
    _close(got_f, want_f, atol=1e-5)


@pytest.mark.parametrize("b,S,h,p,g,n,chunk", SSD_TC_CASES)
def test_ssd_one_bf16_rounding_misses_the_tolerance(b, S, h, p, g, n, chunk):
    """Why the kernels split: with each fp32 intermediate rounded to bf16
    once instead of hi + lo, the same inputs miss SSD_TOL against the
    JAX ``ssd_ref`` (the splits stay far inside it, as the test above
    holds)."""
    tins, jins = _bf16_ssd_inputs(50 + S + g, b=b, S=S, h=h, p=p, g=g, n=n)
    atol, rtol = CS.SSD_TOL
    want_y, _ = jref.ssd_ref(*map(jnp.asarray, jins))
    got_y, _ = ssd_tc_emulated(*tins, chunk, rnd=_bf16_once)
    want_y = np.asarray(want_y)
    assert (np.abs(got_y.numpy() - want_y) > atol + rtol * np.abs(want_y)).any()


def _capture_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(tops, "_stream", lambda: 0)
    monkeypatch.setattr(tops, "_launch", lambda *a: calls.append(a))
    return calls


def _meta_ssd(b, S, h, p, g, n, dtype, bc_width=None, c_at=None):
    """Meta tensors of the kernel's inputs, B and C column slices of one
    (b, S, bc_width) tensor as the model lays them out (C at column c_at)."""
    meta = dict(device="meta")
    bc_width = bc_width or 2 * g * n
    c_at = g * n if c_at is None else c_at
    BC = torch.empty(b, S, bc_width, dtype=dtype, **meta)
    return (torch.empty(b, S, h, p, dtype=dtype, **meta),
            torch.empty(b, S, h, dtype=torch.float32, **meta),
            torch.empty(h, dtype=torch.float32, **meta),
            BC[..., :g * n].view(b, S, g, n), BC[..., c_at:c_at + g * n].view(b, S, g, n))


def test_ssd_scan_kernel_path_passes_its_scratch(monkeypatch):
    """The wrapper's kernel path on meta tensors, the launch captured: in
    bf16 one C call with its scratch (cum (b, h, S) and the chunk states
    (b, h, S / chunk, p, n) in fp32, the carried states as bf16 hi / lo
    tiles (b, h, S / chunk, 2, 64, 128)), B and C read in place as column
    slices (C 2·g·n bytes into the row, row stride 2·g·n); in fp32 no
    scratch.  One launch counted a call."""
    b, S, h, p, g, n, chunk = 4, 2048, 48, 64, 1, 128, 256
    calls = _capture_launches(monkeypatch)
    shapes = []
    scratch = tops._ssd_scratch
    monkeypatch.setattr(tops, "_ssd_scratch",
                        lambda *a: shapes.append(a) or scratch(*a))
    before = tops.ssd_scan.launches
    y, fin = tops.ssd_scan(*_meta_ssd(b, S, h, p, g, n, torch.bfloat16), chunk=chunk)
    assert y.shape == (b, S, h, p) and fin.shape == (b, h, p, n)
    assert y.dtype == fin.dtype == torch.float32
    assert tops.ssd_scan.launches == before + 1
    (name, *args), = calls
    assert name == "ssd_scan" and len(args) == len(tops.build.ENTRY_POINTS[name][1])
    assert shapes == [(b, S, h, p, n, chunk, torch.device("meta"))]
    assert [(t.shape, t.dtype) for t in scratch(*shapes[0])] == [
        ((b, h, S), torch.float32), ((b, h, S // chunk, p, n), torch.float32),
        ((b, h, S // chunk, 2, 64, 128), torch.bfloat16)]
    assert args[3:5] == [0, 2 * g * n]                  # B, C: byte offsets in place
    assert args[10:] == [b, S, h, g, p, n, chunk, h * p, 2 * g * n, 2 * g * n,
                         tops.DTYPE_CODES[torch.bfloat16], 0]
    calls.clear()
    tops.ssd_scan(*_meta_ssd(2, 96, 4, 32, 1, 16, torch.float32), chunk=32)
    (name, *args), = calls
    assert args[7:10] == [0, 0, 0] and len(shapes) == 1     # fp32: no scratch


@pytest.mark.parametrize("what,shape,kw", [
    ("C at 8 bytes past a 16-byte boundary", (1, 64, 4, 64, 1, 128),
     dict(bc_width=264, c_at=132)),
    ("B/C row stride of 260 elements", (1, 64, 4, 64, 1, 128), dict(bc_width=260)),
    ("head_dim 12", (1, 64, 4, 12, 1, 16), {}),
    ("state 20", (1, 64, 4, 16, 1, 20), {}),
])
def test_ssd_scan_bf16_refuses_what_it_cannot_copy(monkeypatch, what, shape, kw):
    """The bf16 kernels copy 16-byte pieces: a misaligned operand or
    row stride, or p / n not a multiple of 8, raises before any launch
    (there is no other bf16 path on the card).  fp32 takes them."""
    calls = _capture_launches(monkeypatch)
    with pytest.raises(ValueError, match="ssd_scan"):
        tops.ssd_scan(*_meta_ssd(*shape, torch.bfloat16, **kw), chunk=32)
    assert calls == []
    tops.ssd_scan(*_meta_ssd(*shape, torch.float32, **kw), chunk=32)
    assert len(calls) == 1


def _train_kernel_vs_chunked(monkeypatch, cfg, batch, seq, steps):
    """chip_smoke phase 9 (bf16) on the CPU: from the same weights and
    batches, three AdamW steps through the chunked path and through the
    kernel path (the bf16 kernels' arithmetic, ``ssd_tc_emulated``, in the
    kernel's place inside the autograd Function, backward through the
    chunked form as on the card), the same through a control that rounds
    the fp32 intermediates to bf16 once (``_bf16_once``), and the step-1
    gradients of the chunked path at the yardstick chunks (the same fp32
    SSD summed in another order: how far a small change of the SSD output
    moves each leaf).  Returns, for the kernel path and the control, the
    worst relative loss difference and chip_smoke's per-leaf rows."""
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import make_train_state, make_train_step
    from repro_torch.tree import flatten

    def run(cfg, backend, steps):
        opt = AdamWConfig(lr=3e-4, total_steps=3, warmup_steps=5)
        state = make_train_state(cfg, torch.Generator().manual_seed(0), device=DEV)
        loader = make_loader(cfg, DataConfig(batch_size=batch, seq_len=seq, seed=1234),
                             device=DEV)
        first = next(loader)
        flat = flatten(state.params)
        loss, _ = TM.loss_fn(state.params, cfg, first, backend=backend)
        norms = [float(g.float().norm())
                 for g in torch.autograd.grad(loss, list(flat.values()))]
        step = make_train_step(cfg, opt, backend=backend)
        losses = []
        for i in range(steps):
            state, m = step(state, first if i == 0 else next(loader))
            losses.append(float(m["loss"]))
        return list(flat), norms, losses

    rnd = {}

    def kernel(x, dt, A, Bm, Cm, *, chunk, initial_state=None):
        body = lambda *ins, chunk: ssd_tc_emulated(*ins, chunk, rnd=rnd["now"])
        return tops.recompute_vjp("ssd_scan", body, tops._ssd_chunked,
                                  (x, dt, A, Bm, Cm), chunk=chunk)

    monkeypatch.setattr(tops, "ssd_scan", kernel)
    monkeypatch.setattr(tssm, "_ssd_backend", lambda backend, state, x:
                        "kernel" if backend == "kernel" else "chunked")
    names, ne, le = run(cfg, "einsum", steps)
    yardsticks = [run(dataclasses.replace(cfg, ssm_chunk=cfg.ssm_chunk // k),
                      "einsum", 0)[1] for k in CS.TRAIN_BF16_CHUNK_DIVISORS]
    out = {}
    for label, r in (("kernel", _hi_lo), ("control", _bf16_once)):
        rnd["now"] = r
        _, nk, lk = run(cfg, "kernel", steps)
        out[label] = (max(abs(a - b) / b for a, b in zip(lk, le)),
                      CS.bf16_gnorm_rows(names, nk, ne, yardsticks))
    return out


def test_bf16_kernel_path_training_rehearsal(monkeypatch):
    """The rehearsal of chip_smoke's bf16 phase-9 check: mamba2-780m at
    full width, 4 layers, bf16, batch 1 x seq 512 (two chunks), the
    kernel path against the chunked path.  The block rounds the SSD
    output to bf16, so a ~1e-5 change of it flips some roundings; the
    gradient norms move by the flips.  The kernels' arithmetic keeps every
    leaf within chip_smoke's multiple of the leaf's own spread, and its
    losses within the loss limit; one bf16 rounding of the intermediates
    in its place (the control) takes some leaf over its limit."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mamba2_780m"), num_layers=4)
    assert cfg.dtype == "bfloat16" and cfg.d_model == 1536
    threads = torch.get_num_threads()
    torch.set_num_threads(2)         # two cores, not all: tier-1 runs files in parallel
    try:
        out = _train_kernel_vs_chunked(monkeypatch, cfg, 1, 512, 3)
    finally:
        torch.set_num_threads(threads)
    for label, (loss_rel, rows) in out.items():      # shown by pytest -rP
        print(f"{label}: losses {loss_rel:.2e}; per leaf (difference, spread, "
              f"limit): " + "; ".join(f"{n} {d:.2e} {sp:.2e} {lim:.2e}"
                                      for n, d, sp, lim in rows))
    loss_rel, rows = out["kernel"]
    assert 0 < loss_rel < CS.TRAIN_BF16_LOSS_RTOL, loss_rel
    assert all(0 < d <= limit for _, d, _, limit in rows), rows
    loss_rel, rows = out["control"]
    assert any(d > limit for _, d, _, limit in rows), rows


def test_ssd_routing_refuses_what_the_kernel_cannot_do():
    cfg = TConfig(**dataclasses.asdict(exact_cfg("mamba2_780m")))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device=DEV)
    p = TTF.layer(params["blocks"]["ssm"], 0)
    u = torch.randn(1, 32, cfg.d_model)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tssm.mamba2_forward(p, cfg, u, backend="kernel")
    state = torch.zeros(1, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)
    with pytest.raises(ValueError, match="initial_state"):
        tssm.mamba2_forward(p, cfg, u, backend="kernel", initial_state=state)
    x, dt, A, Bm, Cm = _t(_ssd_inputs(0, S=48))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        tops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError):
        tops.ssd_scan(x, dt[:, :5], A, Bm, Cm, chunk=16)


def _weights(jcfg, seed=0):
    """JAX init as numpy, with biases, norm scales, D and dt_bias
    perturbed so they are not the trivial zeros/ones."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bias", "scale", "conv_b", "D", "dt_bias"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, DEV)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _np(x):
    return x.detach().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_jax(with_state):
    jcfg = exact_cfg("mamba2_780m")
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jparams, tparams = _weights(jcfg, seed=1)
    jp = _layer0(jparams["blocks"]["ssm"])
    tp = TTF.layer(tparams["blocks"]["ssm"], 0)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    s0 = (rng.standard_normal((2, jcfg.ssm_nheads, jcfg.ssm_headdim,
                               jcfg.ssm_state)) * 0.3).astype(np.float32) \
        if with_state else None
    jy, jf = jssm.mamba2_forward(jp, jcfg, jnp.asarray(u), backend="einsum",
                                 initial_state=None if s0 is None else jnp.asarray(s0))
    ty, tf, _ = tssm.mamba2_forward(tp, tcfg, torch.from_numpy(u), backend="einsum",
                                 initial_state=None if s0 is None else torch.from_numpy(s0))
    _close(ty, jy, atol=1e-4, rtol=1e-4)
    _close(tf, jf, atol=1e-4, rtol=1e-4)
    # auto on the CPU is the same chunked path
    ty2, _, _ = tssm.mamba2_forward(tp, tcfg, torch.from_numpy(u))
    if s0 is None:
        torch.testing.assert_close(ty2, ty, rtol=0, atol=0)

    cache = tssm.init_ssm_cache(tcfg, 2, torch.float32, device=DEV)
    jcache = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    ut = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    for _ in range(3):
        jo, jcache = jssm.mamba2_decode_step(jp, jcfg, jnp.asarray(ut), jcache)
        to, cache = tssm.mamba2_decode_step(tp, tcfg, torch.from_numpy(ut), cache)
        _close(to, jo, atol=1e-4, rtol=1e-4)
    for key in ("conv", "state"):
        _close(cache[key], jcache[key], atol=1e-5, rtol=1e-4)


FA_GRAD_CASES = [
    (2, 16, 16, 4, 2, 64, True, 0, 0),        # causal, GQA
    (1, 24, 24, 2, 2, 64, True, 6, 0),        # causal + window
    (1, 8, 24, 2, 1, 128, True, 0, 16),       # q_offset, hd 128
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,q_offset", FA_GRAD_CASES)
def test_flash_attention_grad_matches_jax(B, Sq, Sk, H, KV, hd, causal, window,
                                          q_offset):
    rng = np.random.default_rng(Sq + 7 * Sk)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    go = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jax.grad(lambda q, k, v: jnp.sum(jops.flash_attention(q, k, v, **kw) * go),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [t.requires_grad_() for t in _t((q, k, v))]
    out = tops.recompute_vjp("flash_attention", tref.flash_attention_ref,
                             tref.flash_attention_ref, (tq, tk, tv), **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(go))
    for a, b in zip(got, want):
        _grad_close(a, b)
    # the CPU branch of the wrapper is the plain version, differentiable
    out2 = tops.flash_attention(tq, tk, tv, **kw)
    assert out2.grad_fn is not None
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


def test_ssm_prefill_and_decode_match_jax():
    jcfg = exact_cfg("mamba2_780m")
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jparams, tparams = _weights(jcfg, seed=5)
    B, S, steps = 2, 64, 4
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache, jlog, _ = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                 cache_len=0)
    with torch.inference_mode():
        tcache, tlog, plen = TM.prefill(tparams, tcfg,
                                        {"tokens": torch.from_numpy(tokens)}, 0)
    assert plen == S
    np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)
    for key in ("conv", "state"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **SERVE_TOL)
    tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    for i in range(steps):
        jlog, jcache = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(S + i))
        with torch.inference_mode():
            tlog, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                          tcache, S + i)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)
        tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(np.argmax(_np(tlog), -1)[:, None], tok)
    for key in ("conv", "state"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **SERVE_TOL)


def test_ssm_init_names_shapes_and_counts_match_jax():
    from repro.configs import get_smoke_config
    jcfg = get_smoke_config("mamba2_780m")
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    want = jax.tree_util.tree_flatten_with_path(JM.abstract_params(jcfg))[0]
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype)) for p, x in want}
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
    got = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                got[path + f"['{k}']"] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    walk(tparams, "")
    assert got == want
    assert TM.param_count(tparams) == tcfg.param_count()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))["blocks"]["ssm"]
    tp = tparams["blocks"]["ssm"]
    for k in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6)


def test_row_strided_reads_column_slices_in_place():
    """B and C reach the kernel as column slices of one (b, S, 2·g·n)
    tensor; the wrapper passes them with their row stride, uncopied, and
    copies only a layout the kernel cannot read."""
    BC = torch.randn(2, 16, 2 * 3 * 8)
    Bm = BC[..., :24].view(2, 16, 3, 8)
    t, rs = tops._row_strided(Bm)
    assert t.data_ptr() == Bm.data_ptr() and rs == 48
    x = torch.randn(2, 16, 4, 8)
    t, rs = tops._row_strided(x)
    assert t is x and rs == 32
    xt = torch.randn(2, 4, 16, 8).transpose(1, 2)          # (b, S, h, p) view
    t, rs = tops._row_strided(xt)
    assert t.is_contiguous() and rs == 32 and torch.equal(t, xt)
