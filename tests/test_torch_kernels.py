"""The port's plain kernel versions and attention dispatch, held against
the JAX package on the CPU.

The same numpy-seeded inputs go through ``repro.kernels.ref`` (the JAX
oracles), ``repro.kernels.ops`` (the Pallas kernels, which run their
kernel bodies in interpret mode off-TPU) and the port's
``repro_torch.kernels`` / ``repro_torch.models.attention``.  Attention
in fp32, atol 1e-5: the same fp32 arithmetic in two frameworks; rmsnorm
in fp32 and bf16 within the JAX package's own kernel tolerances.  In
fp16 (which the JAX package's Pallas kernels take, casting to fp32 and
writing back in fp16) both sides compute in fp32 and round the output to
fp16 once, so they may land one fp16 step apart: rtol 2^-10 (with the
fp32 atol for the sums' order near zero).  The CUDA
kernels themselves run only on the card (``chip_smoke.py``; the
``cuda``-marked tests skip without one); their arithmetic is rehearsed
here in plain PyTorch: the tensor-core ``flash_attention`` (P rounded to
the input's bf16 or fp16 before P V) under chip_smoke's unchanged bf16
tolerance and its fp16 one, and the split-K ``flash_decode`` (pass 1 and
the combine) in fp32.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

ATOL = 1e-5
FP16_STEP = 2.0 ** -10                # one fp16 step, relative to the value
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py as a module (it imports only the standard library at
    its top), for its case lists and tolerances."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# (B, Sq, Sk, H, KV, hd, causal, window, q_offset)
FA_CASES = [
    (2, 16, 16, 2, 2, 64, True, 0, 0),        # causal
    (1, 13, 13, 4, 2, 64, True, 0, 0),        # ragged S, GQA
    (2, 24, 24, 2, 1, 64, True, 6, 0),        # causal + window, GQA
    (1, 8, 24, 2, 2, 64, True, 0, 16),        # q_offset (decode-style tail)
    (1, 10, 14, 2, 2, 64, False, 0, 0),       # non-causal, ragged Sk
    (1, 20, 20, 2, 2, 128, True, 5, 0),       # hd 128 + window
    (2, 70, 70, 4, 4, 80, True, 0, 0),        # hd 80 (zamba2), ragged S
    (1, 24, 40, 4, 2, 80, True, 6, 16),       # hd 80, window, q_offset, GQA
    (1, 20, 20, 8, 1, 256, True, 0, 0),       # hd 256, MQA 8/1 (paligemma)
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,q_offset", FA_CASES)
def test_flash_attention_plain_matches_jax(B, Sq, Sk, H, KV, hd, causal,
                                           window, q_offset):
    rng = np.random.default_rng(Sq * 31 + Sk)
    q, k, v = (_randn(rng, B, Sq, H, hd), _randn(rng, B, Sk, KV, hd),
               _randn(rng, B, Sk, KV, hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rep = H // KV
    want_ref = jref.attention_ref(jnp.asarray(q), jnp.repeat(k, rep, 2),
                                  jnp.repeat(v, rep, 2), **kw)
    want_pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got_ref = tref.attention_ref(tq, tk.repeat_interleave(rep, 2),
                                 tv.repeat_interleave(rep, 2), **kw)
    got_wrapper = tops.flash_attention(tq, tk, tv, **kw)   # CPU: plain version
    for got in (got_ref, got_wrapper):
        _close(got, want_ref)
        _close(got, want_pallas)
    assert tops.flash_attention.launches == 0     # no kernel ran on the CPU


def _fp16(*arrs):
    return [a.astype(np.float16) for a in arrs]


def _close_fp16(got, want):
    """One fp16 step apart at most: both computed in fp32 and rounded
    once.  Near zero the fp32 sums' own order shows, hence the fp32
    cases' ATOL beside it."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g.astype(np.float32),
                               np.asarray(want).astype(np.float32),
                               rtol=FP16_STEP, atol=ATOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,q_offset", FA_CASES)
def test_flash_attention_plain_matches_jax_fp16(B, Sq, Sk, H, KV, hd, causal,
                                                window, q_offset):
    """fp16 inputs: the plain version (and the wrapper on CPU tensors)
    against the JAX oracle and its Pallas kernel in interpret mode, each
    returning fp16."""
    rng = np.random.default_rng(Sq * 31 + Sk + 1)
    q, k, v = _fp16(_randn(rng, B, Sq, H, hd), _randn(rng, B, Sk, KV, hd),
                    _randn(rng, B, Sk, KV, hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rep = H // KV
    want_ref = jref.attention_ref(jnp.asarray(q), jnp.repeat(k, rep, 2),
                                  jnp.repeat(v, rep, 2), **kw)
    want_pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw)
    assert want_ref.dtype == want_pallas.dtype == jnp.float16
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (tref.flash_attention_ref(tq, tk, tv, **kw),
                tops.flash_attention(tq, tk, tv, **kw)):
        assert got.dtype == torch.float16
        _close_fp16(got, want_ref)
        _close_fp16(got, want_pallas)
    assert tops.flash_attention.launches == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_vjp_returns_gradients_in_the_input_dtype(dtype):
    """The autograd Function (its plain body in the kernel's place, as on
    the card's backward) returns each gradient in its input's 2-byte
    dtype, equal to autograd through the plain version."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(_randn(rng, *s)).to(dtype).requires_grad_()
               for s in ((1, 70, 4, 64), (1, 70, 2, 64), (1, 70, 2, 64)))
    go = torch.from_numpy(_randn(rng, 1, 70, 4, 64)).to(dtype)
    kw = dict(causal=True, window=0, q_offset=0, prefix_len=0)
    out = tops.recompute_vjp("flash_attention", tref.flash_attention_ref,
                             tref.flash_attention_ref, (q, k, v), **kw)
    got = torch.autograd.grad(out, (q, k, v), go)
    want = torch.autograd.grad(tref.flash_attention_ref(q, k, v, **kw), (q, k, v), go)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _k_tile_range(q0, Sk, causal, window, q_offset, prefix_len=0, bq=64, bk=64):
    """``k_tile_range`` of ``flash_attention.cu``: the 64-key tiles that
    hold an unmasked key for some row of the q tile at q0 (under causal,
    the prefix's tiles for every row)."""
    end = -(-Sk // bk)
    q_hi = q0 + bq - 1 + q_offset
    if causal:
        end = min(end, max(0 if q_hi < 0 else q_hi // bk + 1, -(-prefix_len // bk)))
    lo = q0 + q_offset - window + 1
    begin = lo // bk if window > 0 and lo > 0 else 0
    return begin, end


def tc_attention_emulated(q, k, v, *, causal, window, q_offset, prefix_len=0,
                          round_p=True, bq=64, bk=64, panel=64):
    """The tensor-core ``flash_attention``'s arithmetic (bf16 or fp16
    inputs) in plain PyTorch: per 64-row q tile, its visited 64-key tiles
    in order; S = Q K^T summed in fp32 (products of 2-byte inputs are
    exact); scores scaled into the log2 domain and masked to -1e30; online
    softmax with fp32 (m, l) and exp2; P rounded to the inputs' dtype
    (``round_p``) before P V, summed in fp32;
    output / max(l, 1e-20) in the input dtype.  As in shared memory, Q, K
    and V are whole 64-column panels, zero past hd (hd 80: two panels, 48
    zero columns; hd 256: four), and P V computes every panel column; the
    first hd are the output.  Under causal the first ``prefix_len`` keys
    are visible to every row."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    on = -(-hd // panel) * panel
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, on - hd))
    q = pad(q).to(q.dtype)
    kf = pad(k.repeat_interleave(H // KV, 2))
    vf = pad(v.repeat_interleave(H // KV, 2))
    scale = math.log2(math.e) / math.sqrt(hd)
    out = torch.zeros(B, Sq, H, on)
    for q0 in range(0, Sq, bq):
        rows = slice(q0, min(q0 + bq, Sq))
        qp = torch.arange(rows.start, rows.stop)[:, None] + q_offset
        m = torch.full((B, H, rows.stop - q0, 1), tref.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, rows.stop - q0, on)
        for kt in range(*_k_tile_range(q0, Sk, causal, window, q_offset, prefix_len,
                                       bq, bk)):
            keys = slice(kt * bk, min(kt * bk + bk, Sk))
            kp = torch.arange(keys.start, keys.stop)[None, :]
            ok = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool)
            if causal:
                ok = (kp <= qp) | (kp < prefix_len)
            if window:
                ok = ok & (kp > qp - window)
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows].float(), kf[:, keys])
            x = torch.where(ok, s * scale, tref.NEG_INF)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha, p = torch.exp2(m - m_new), torch.exp2(x - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            if round_p:
                p = p.to(q.dtype).float()
            acc = alpha * acc + p @ vf[:, keys].permute(0, 2, 1, 3)
            m = m_new
        out[:, rows] = (acc / l.clamp_min(1e-20)).permute(0, 2, 1, 3)
    assert not out[..., hd:].any()            # V's zero columns stay zero
    return out[..., :hd].to(q.dtype)


def jax_prefix_attention(q, k, v, *, causal, window, q_offset, prefix_len):
    """The JAX package's prefix-LM attention in fp32: ``_attend_einsum``
    with ``_mask_bias`` (``repro/models/attention.py``), on numpy or JAX
    inputs, K/V (B, Sk, KV, hd) expanded to the query heads."""
    q, k, v = (jnp.asarray(t, dtype=jnp.float32) for t in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    q_pos = jnp.arange(q.shape[1], dtype=jnp.int32) + q_offset
    k_pos = jnp.arange(k.shape[1], dtype=jnp.int32)
    bias = jattn._mask_bias(q_pos, k_pos, causal, window, prefix_len)
    return jattn._attend_einsum(q, jnp.repeat(k, rep, 2), jnp.repeat(v, rep, 2), bias,
                                1.0 / math.sqrt(q.shape[-1]))


@pytest.mark.parametrize("case", CS.FA_CASES, ids=[c[0] for c in CS.FA_CASES])
def test_flash_attention_tensor_core_numerics_match_jax(case):
    """bf16 inputs at chip_smoke's FA_CASES shapes: the tensor-core
    arithmetic (bf16 P) against the JAX ``attention_ref`` (with a prefix,
    the JAX package's ``_attend_einsum`` + ``_mask_bias`` in fp32 on the
    same bf16 values) under chip_smoke's unchanged bf16 tolerance
    (TOL["bfloat16"], the bound the kernel meets against its plain version
    on the card)."""
    _, B, Sq, Sk, H, KV, hd, causal, window, q_offset, prefix = case
    rng = np.random.default_rng(Sq * 7 + Sk + H)
    q, k, v = (torch.from_numpy(_randn(rng, *shape)).bfloat16()
               for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rep = H // KV
    if prefix:
        want = np.asarray(jax_prefix_attention(*(t.float().numpy() for t in (q, k, v)),
                                               prefix_len=prefix, **kw))
    else:
        jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (q, k, v))
        want = np.asarray(jref.attention_ref(jq, jnp.repeat(jk, rep, 2),
                                             jnp.repeat(jv, rep, 2), **kw)
                          .astype(jnp.float32))
    got = tc_attention_emulated(q, k, v, prefix_len=prefix, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Sq, H, hd)
    atol, rtol = CS.TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", CS.FA_CASES, ids=[c[0] for c in CS.FA_CASES])
def test_flash_attention_tensor_core_numerics_match_jax_fp16(case):
    """fp16 inputs at chip_smoke's FA_CASES shapes: the tensor-core
    arithmetic with P rounded to fp16 (11 significant bits, where bf16
    keeps 8) against the JAX ``attention_ref`` in fp16 (with a prefix,
    ``_attend_einsum`` + ``_mask_bias`` in fp32 on the same fp16 values)
    under chip_smoke's fp16 tolerance (TOL["float16"])."""
    _, B, Sq, Sk, H, KV, hd, causal, window, q_offset, prefix = case
    rng = np.random.default_rng(Sq * 7 + Sk + H)
    q, k, v = (torch.from_numpy(_randn(rng, *shape)).half()
               for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if prefix:
        want = np.asarray(jax_prefix_attention(*(t.float().numpy() for t in (q, k, v)),
                                               prefix_len=prefix, **kw))
    else:
        rep = H // KV
        jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
        want = np.asarray(jref.attention_ref(jq, jnp.repeat(jk, rep, 2),
                                             jnp.repeat(jv, rep, 2), **kw)
                          .astype(jnp.float32))
    got = tc_attention_emulated(q, k, v, prefix_len=prefix, **kw)
    assert got.dtype == torch.float16 and got.shape == (B, Sq, H, hd)
    atol, rtol = CS.TOL["float16"]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,q_offset", FA_CASES)
def test_flash_attention_emulation_without_rounding_is_exact(
        B, Sq, Sk, H, KV, hd, causal, window, q_offset):
    """With P kept in fp32 the emulation is the reference's arithmetic in
    another order (fp32, atol 1e-5 against the JAX oracle): the bf16
    rounding of P is the tensor-core design's only departure."""
    rng = np.random.default_rng(Sq * 31 + Sk)
    q, k, v = (_randn(rng, B, Sq, H, hd), _randn(rng, B, Sk, KV, hd),
               _randn(rng, B, Sk, KV, hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rep = H // KV
    want = jref.attention_ref(jnp.asarray(q), jnp.repeat(k, rep, 2),
                              jnp.repeat(v, rep, 2), **kw)
    got = tc_attention_emulated(*map(torch.from_numpy, (q, k, v)),
                                round_p=False, **kw)
    _close(got, want)


@pytest.mark.parametrize("pos,S,ring", [(5, 8, False), (5, 8, True),
                                        (13, 8, True), (0, 4, True),
                                        (100, 37, True), (36, 37, False)])
def test_decode_slot_positions_match_jax(pos, S, ring):
    want = jref.decode_slot_positions(jnp.int32(pos), S, ring=ring)
    got = tref.decode_slot_positions(pos, S, ring=ring)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (B, KV, G, S, hd, pos, kwargs, q_scale)
FD_CASES = [
    (2, 2, 2, 40, 64, 30, {}, 1.0),                               # linear
    (2, 2, 2, 40, 64, 100, dict(ring=True, window=40), 1.0),      # ring, full
    (1, 2, 3, 40, 64, 25, dict(ring=True), 1.0),                  # ring, unwritten
    (1, 2, 2, 300, 64, 290, dict(window=50), 1.0),                # pages before window
    (1, 1, 4, 300, 64, 20, {}, 1.0),                              # pages past pos
    (2, 2, 2, 40, 128, 39, dict(softcap=50.0), 30.0),             # softcap
    (2, 4, 1, 150, 80, 140, {}, 1.0),                             # hd 80, G 1 (zamba2)
    (1, 2, 4, 200, 80, 190, dict(ring=True, window=70), 1.0),     # hd 80, G 4, ring
    (2, 1, 8, 100, 256, 90, {}, 1.0),                             # hd 256, G 8 (paligemma)
]


@pytest.mark.parametrize("B,KV,G,S,hd,pos,kw,q_scale", FD_CASES)
def test_flash_decode_plain_matches_jax(B, KV, G, S, hd, pos, kw, q_scale):
    rng = np.random.default_rng(S * 7 + pos)
    q = _randn(rng, B, KV * G, hd, scale=q_scale)
    k, v = _randn(rng, B, KV, S, hd), _randn(rng, B, KV, S, hd)
    want_ref = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.int32(pos), **kw)
    want_pallas = jops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(pos), **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got_ref = tref.decode_attention_ref(tq, tk, tv, pos, **kw)
    got_wrapper = tops.flash_decode(tq[:, None], tk, tv, pos, **kw)
    for got in (got_ref, got_wrapper):
        _close(got, want_ref)
        _close(got, want_pallas)
    assert tops.flash_decode.launches == 0


@pytest.mark.parametrize("B,KV,G,S,hd,pos,kw,q_scale", FD_CASES)
def test_flash_decode_plain_matches_jax_fp16(B, KV, G, S, hd, pos, kw, q_scale):
    rng = np.random.default_rng(S * 7 + pos + 1)
    q = _randn(rng, B, KV * G, hd, scale=q_scale).astype(np.float16)
    k, v = _fp16(_randn(rng, B, KV, S, hd), _randn(rng, B, KV, S, hd))
    want_ref = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.int32(pos), **kw)
    want_pallas = jops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(pos), **kw)
    assert want_ref.dtype == want_pallas.dtype == jnp.float16
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (tref.decode_attention_ref(tq, tk, tv, pos, **kw),
                tops.flash_decode(tq[:, None], tk, tv, pos, **kw)):
        assert got.dtype == torch.float16
        _close_fp16(got, want_ref)
        _close_fp16(got, want_pallas)
    assert tops.flash_decode.launches == 0


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_plain_matches_pallas_interpret_fp16(g):
    """fp16 x, B and C: the plain version (the wrapper on CPU tensors)
    against the Pallas kernel in interpret mode on the same fp16 values;
    both compute in fp32 and return fp32, within the JAX package's own
    ssd tolerance (tests/test_kernels.py: 1e-4 + 1e-3 rel)."""
    rng = np.random.default_rng(50 + g)
    b, S, h, p, n = 2, 64, 4, 32, 16
    f = lambda *sh, scale=1.0: (rng.standard_normal(sh) * scale).astype(np.float32)
    x = f(b, S, h, p).astype(np.float16)
    dt = (np.log1p(np.exp(f(b, S, h))) * 0.5).astype(np.float32)
    A = (-np.exp(f(h, scale=0.3))).astype(np.float32)
    Bm, Cm = _fp16(f(b, S, g, n, scale=0.3), f(b, S, g, n, scale=0.3))
    from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
    want_y, want_f = pallas_ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=32,
                                     interpret=True)
    got_y, got_f = tops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=32)
    assert got_y.dtype == got_f.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-4, rtol=1e-3)
    assert tops.ssd_scan.launches == 0


def pv_partition(hd, vec, threads=128, page=64):
    """``Split<T, HD>`` of ``flash_decode.cu``: P V gives each thread vec
    columns of the rows of one slot subset.  Returns the rows of a page
    that each of the SUBS = threads // (hd / vec) subsets sums: t, t +
    SUBS, ..., JV = ceil(page / SUBS) of them, bounded by the page.  The
    threads past SUBS · hd / vec take no part."""
    nv = hd // vec
    subs = threads // nv
    jv = -(-page // subs)
    return [[t + u * subs for u in range(jv) if t + u * subs < page]
            for t in range(subs)]


@pytest.mark.parametrize("vec", [4, 8], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_flash_decode_pv_partition_covers_every_row(hd, vec):
    """Every row of a page is summed by exactly one subset, with no more
    threads than the block has.  At hd 80 the vectors of a row (10 in
    bf16, 20 in fp32) do not divide 128 threads; a row count of
    floor(page / SUBS) a subset would leave 4 rows of every page out."""
    subsets = pv_partition(hd, vec)
    assert sorted(r for rows in subsets for r in rows) == list(range(64))
    assert len(subsets) * (hd // vec) <= 128
    if hd == 80:
        assert len(subsets) * (64 // len(subsets)) == 60


def split_decode_emulated(q, k, v, pos, n_split, *, window=0, softcap=0.0,
                          ring=False, page=64, vec=8):
    """``flash_decode.cu`` in plain PyTorch, fp32: pass 1 per split over
    its contiguous range of 64-slot pages (a page with no live slot
    skipped before it is read), the mask from (pos, S, window, ring) as
    the kernel computes it (C's truncating remainder, then + S), an online
    softmax per page, P V summed per slot subset of ``pv_partition`` (the
    kernel's partition for ``vec`` elements in 16 bytes: 8 in bf16, 4 in
    fp32) into the subset's own accumulator and the subsets summed at the
    end, and a partial (acc, m, l) per split; then the combine, in which
    a split with no live page (m = -inf) adds nothing."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    subsets = pv_partition(hd, vec, page=page)
    qg = q.float().view(B, KV, G, hd)
    slots = torch.arange(S, dtype=torch.int64)
    k_pos = slots
    if ring:
        r = torch.fmod(pos - slots, S)
        k_pos = pos - torch.where(r < 0, r + S, r)
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window > 0:
        valid = valid & (k_pos > pos - window)
    n_pages = -(-S // page)
    parts = []
    for split in range(n_split):
        m = torch.full((B, KV, G, 1), -math.inf)
        l = torch.zeros(B, KV, G, 1)
        accs = torch.zeros(len(subsets), B, KV, G, hd)
        for pg in range(split * n_pages // n_split, (split + 1) * n_pages // n_split):
            sl = slice(pg * page, min(pg * page + page, S))
            if not bool(valid[sl].any()):
                continue
            s = torch.einsum("bkgd,bksd->bkgs", qg, k[:, :, sl].float()) / math.sqrt(hd)
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(valid[sl], s, tref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            vp = v[:, :, sl].float()
            for t, rows in enumerate(subsets):
                rows = [r for r in rows if r < vp.shape[2]]       # the ragged last page
                accs[t] = alpha * accs[t] + torch.einsum(
                    "bkgs,bksd->bkgd", p[..., rows], vp[:, :, rows])
            m = m_new
        parts.append((accs.sum(0), m, l))
    M = torch.stack([m for _, m, _ in parts]).amax(0)
    num, den = torch.zeros(B, KV, G, hd), torch.zeros(B, KV, G, 1)
    for acc, m, l in parts:
        w = torch.where(m > -math.inf, torch.exp(m - M), torch.zeros_like(m))
        num, den = num + w * acc, den + w * l
    return (num / den.clamp_min(1e-20)).view(B, H, hd).to(q.dtype)


# FD_CASES above plus splits whose every page is masked: pages before the
# window, pages past pos, and a ring whose older half is unwritten
FD_SPLIT_CASES = FD_CASES + [
    (1, 2, 2, 600, 64, 580, dict(window=60), 1.0),
    (2, 1, 3, 700, 128, 100, {}, 1.0),
    (1, 2, 2, 640, 64, 200, dict(ring=True), 1.0),
]


@pytest.mark.parametrize("n_split", [1, 2, 3, 9])
@pytest.mark.parametrize("B,KV,G,S,hd,pos,kw,q_scale", FD_SPLIT_CASES)
def test_flash_decode_split_k_emulation_matches_jax(B, KV, G, S, hd, pos, kw,
                                                    q_scale, n_split):
    """The split-K decode, pass 1 and the combine, against the JAX
    ``decode_attention_ref`` in fp32 at 1e-5, for every split count; at
    1, 2 and 3 pages a run of 9 splits holds splits with no page at all."""
    rng = np.random.default_rng(S * 7 + pos)
    q = _randn(rng, B, KV * G, hd, scale=q_scale)
    k, v = _randn(rng, B, KV, S, hd), _randn(rng, B, KV, S, hd)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.int32(pos), **kw)
    got = split_decode_emulated(*map(torch.from_numpy, (q, k, v)), pos, n_split, **kw)
    _close(got, want)


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("B,KV,G,S,hd,pos,kw,q_scale",
                         [c for c in FD_SPLIT_CASES if c[4] == 80])
def test_flash_decode_split_k_fp32_partition_at_hd80(B, KV, G, S, hd, pos, kw,
                                                     q_scale, n_split):
    """The hd-80 cases with the fp32 kernel's P V partition (6 subsets of
    10 or 11 rows; the bf16 one, 12 of 5 or 6, runs above)."""
    rng = np.random.default_rng(S * 7 + pos)
    q = _randn(rng, B, KV * G, hd, scale=q_scale)
    k, v = _randn(rng, B, KV, S, hd), _randn(rng, B, KV, S, hd)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.int32(pos), **kw)
    got = split_decode_emulated(*map(torch.from_numpy, (q, k, v)), pos, n_split,
                                vec=4, **kw)
    _close(got, want)


@pytest.mark.parametrize("batch_kv,S,sms,want", [
    (32, 544, 132, 9),        # serving: B 4 x KV 8, 544 slots -> 288 blocks
    (8, 1024, 132, 16),       # the profiler's decode: every page its own split
    (4, 40, 132, 1),          # one page
    (512, 4096, 132, 1),      # the batch alone fills the card
    (64, 4096, 132, 5),       # ceil(264 / 64)
    (32, 544, 80, 5),         # a card with fewer SMs
])
def test_decode_splits(batch_kv, S, sms, want):
    n = tops.decode_splits(batch_kv, S, sms)
    assert n == want
    assert 1 <= n <= -(-S // tops.DECODE_PAGE)
    if n < -(-S // tops.DECODE_PAGE):         # pages to spare: the card is covered
        assert batch_kv * n >= 2 * sms


def test_flash_decode_kernel_path_builds_no_bias(monkeypatch):
    """The wrapper's kernel path (driven here with meta tensors and the
    launch captured): one output and one fp32 scratch of (B*KV, n_split,
    G, hd + 2), the split count from ``decode_splits``, the mask
    arguments passed through, and no bias row or valid mask built."""
    B, KV, G, S, hd = 4, 8, 4, 544, 128

    def refuse(*a, **k):
        raise AssertionError("the kernel path built a mask on the host")

    calls = []
    monkeypatch.setattr(tops, "decode_bias", refuse)
    monkeypatch.setattr(tref, "decode_valid", refuse)
    monkeypatch.setattr(tops, "_check", lambda name, ts: None)
    monkeypatch.setattr(tops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(tops, "_stream", lambda: 0)
    monkeypatch.setattr(tops, "_launch", lambda *a: calls.append(a))
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(B, 1, KV * G, hd, **meta)
    k, v = torch.empty(B, KV, S, hd, **meta), torch.empty(B, KV, S, hd, **meta)
    before = tops.flash_decode.launches
    out = tops.flash_decode(q, k, v, 543, window=100, softcap=30.0, ring=True)
    assert out.shape == (B, KV * G, hd) and out.dtype == torch.bfloat16
    assert tops.flash_decode.launches == before + 1
    (name, *args), = calls
    assert name == "flash_decode"
    # no log-sum-exp pointer; the whole cache: slot 0 of S
    assert args[5] == 0 and args[6:20] == [B, KV, G, S, hd, 9, 543, 0, S, 100, 1, 30.0,
                                           tops.DTYPE_CODES[torch.bfloat16], 0]


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1),
                                        (torch.float16, 2)])
def test_attention_kernel_paths_pass_the_dtype_code(monkeypatch, dtype, code):
    """Both attention wrappers' kernel paths on meta tensors, the launch
    captured: fp16 reaches the kernels with its own code (2), as bf16 (1)
    and fp32 (0) do, and the output keeps the input's dtype."""
    calls = []
    monkeypatch.setattr(tops, "_check", lambda name, ts: None)
    monkeypatch.setattr(tops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(tops, "_stream", lambda: 0)
    monkeypatch.setattr(tops, "_launch", lambda *a: calls.append(a))
    meta = dict(device="meta", dtype=dtype)
    q = torch.empty(2, 128, 8, 128, **meta)
    kv = torch.empty(2, 128, 2, 128, **meta)
    out = tops._flash_attention_kernel(q, kv, kv, causal=True, window=0, q_offset=0,
                                       prefix_len=0)
    assert out.dtype == dtype
    out = tops.flash_decode(torch.empty(2, 8, 128, **meta), torch.empty(2, 2, 64, 128, **meta),
                            torch.empty(2, 2, 64, 128, **meta), 63)
    assert out.dtype == dtype
    (fa, *fa_args), (fd, *fd_args) = calls
    assert (fa, fd) == ("flash_attention", "flash_decode")
    assert fa_args[-2] == fd_args[-2] == tops.DTYPE_CODES[dtype] == code


@pytest.mark.parametrize("backend,Sq,window,softcap", [
    ("einsum", 16, 0, 0.0), ("einsum", 16, 5, 30.0),
    ("chunked", 1024, 0, 0.0), ("auto", 2304, 0, 0.0)])
def test_attend_paths_match_jax(backend, Sq, window, softcap):
    """The einsum and chunked attention paths (GQA expanded inside the
    port's ``attend``) against JAX's ``attend`` on the same inputs."""
    rng = np.random.default_rng(Sq)
    B, H, KV, hd = 1, 2, 1, 64
    q = _randn(rng, B, Sq, H, hd)
    k, v = _randn(rng, B, Sq, KV, hd), _randn(rng, B, Sq, KV, hd)
    pos = np.arange(Sq, dtype=np.int32)
    jb = "chunked" if backend == "chunked" else backend
    want = jattn.attend(jnp.asarray(q), jnp.repeat(k, H // KV, 2),
                        jnp.repeat(v, H // KV, 2), q_pos=jnp.asarray(pos),
                        k_pos=jnp.asarray(pos), window=window,
                        softcap=softcap, backend=jb)
    tb = "auto" if backend == "chunked" else backend
    if backend == "chunked":
        got = tattn._attend_chunked(
            torch.from_numpy(q), *(torch.from_numpy(x).repeat_interleave(H // KV, 2)
                                   for x in (k, v)),
            torch.from_numpy(pos), torch.from_numpy(pos), True, window, 0,
            1.0 / hd ** 0.5, softcap)
    else:
        got = tattn.attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), q_pos=torch.from_numpy(pos),
                           k_pos=torch.from_numpy(pos), window=window,
                           softcap=softcap, backend=tb)
    _close(got, want, atol=2e-5)


def test_kernel_backend_raises_on_cpu_tensors():
    x = torch.zeros(1, 4, 2, 64)
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.resolve_backend("kernel", x)
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.attend(x, x, x, q_pos=pos, k_pos=pos, backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        tops.resolve_backend("pallas", x)
    # auto stays on the plain paths for CPU tensors; kernel is the card's
    assert tops.preferred_backend(x) == "einsum"
    assert tops.resolve_backend("auto", x) == "auto"
    assert tops.preferred_backend(torch.empty(0, device="meta")) == "einsum"


@pytest.mark.parametrize("kw", [dict(softcap=30.0), dict(prefix_len=2)])
def test_kernel_backend_refuses_softcap_and_prefix(monkeypatch, kw):
    """Where ``attend`` takes the prefill kernel (CUDA tensors), nothing is
    rerouted to the plain paths: a logit softcap, which the kernel lacks,
    raises before the kernel is reached; a bidirectional prefix reaches
    ``flash_attention`` with its ``prefix_len``, which the kernel takes.
    The resolved backend is forced to ``kernel`` here, as on the card."""
    x = torch.zeros(1, 4, 2, 64)
    pos = torch.arange(4, dtype=torch.int32)
    monkeypatch.setattr(tops, "resolve_backend", lambda backend, t: "kernel")
    monkeypatch.setattr(tattn, "_attend_einsum", lambda *a, **k: pytest.fail("plain path"))
    calls = []

    def kernel(q, k, v, **static):
        calls.append(static)
        return q

    monkeypatch.setattr(tops, "flash_attention", kernel)
    if "softcap" in kw:
        with pytest.raises(NotImplementedError, match="flash_attention"):
            tattn.attend(x, x, x, q_pos=pos, k_pos=pos, backend="kernel", **kw)
        assert not calls
    else:
        tattn.attend(x, x, x, q_pos=pos, k_pos=pos, backend="kernel", **kw)
        assert calls == [dict(causal=True, window=0, q_offset=0, prefix_len=2)]


def test_cpu_wrappers_check_shapes():
    q = torch.zeros(1, 4, 3, 64)
    kv = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="kv heads"):
        tops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError):
        tops.flash_decode(torch.zeros(1, 4, 64), torch.zeros(1, 2, 8, 32),
                          torch.zeros(1, 2, 8, 32), 3)


# tests/test_kernels.py::TOL, the JAX package's own bound for its rmsnorm
# kernel against rmsnorm_ref
RN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@pytest.mark.parametrize("x_dtype,s_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32"),
                                             ("float16", "float16"),
                                             ("float16", "float32")])
@pytest.mark.parametrize("rows,d", [(64, 256), (128, 512), (37, 128)])
def test_rmsnorm_plain_matches_jax(rows, d, x_dtype, s_dtype):
    """``ref.rmsnorm_ref`` and the wrapper on CPU tensors against the JAX
    oracle and its Pallas kernel (interpret mode), x and scale rounded to
    their dtypes once, the same way, in both frameworks.  fp16 (the JAX
    package's tests hold no fp16 rmsnorm): one fp16 step of the output."""
    rng = np.random.default_rng(rows * 3 + d)
    x, s = _randn(rng, rows, d), _randn(rng, d)
    jx, js = jnp.asarray(x).astype(JDT[x_dtype]), jnp.asarray(s).astype(JDT[s_dtype])
    tx, ts = torch.from_numpy(x).to(TDT[x_dtype]), torch.from_numpy(s).to(TDT[s_dtype])
    wants = [jref.rmsnorm_ref(jx, js), jops.rmsnorm(jx, js)]
    gots = [tref.rmsnorm_ref(tx, ts), tops.rmsnorm(tx, ts)]
    for got in gots:
        assert got.dtype == TDT[x_dtype] and got.shape == (rows, d)
        for want in wants:
            if x_dtype == "float16":
                _close_fp16(got, want)
                continue
            err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32))).max()
            assert err < RN_TOL[x_dtype], err
    assert tops.rmsnorm.launches == 0         # no kernel ran on the CPU


@pytest.mark.parametrize("rows,d", [(32, 256), (37, 128)])
def test_rmsnorm_grad_matches_jax(rows, d):
    """The autograd Function with its plain body in the kernel's place
    (the kernel runs only on the card) against ``jax.grad`` of the JAX
    ``custom_vjp`` around the Pallas kernel: x and scale gradients."""
    rng = np.random.default_rng(rows + d)
    x, s, go = _randn(rng, rows, d), _randn(rng, d), _randn(rng, rows, d)
    want = jax.grad(lambda x, s: jnp.sum(jops.rmsnorm(x, s) * go),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx, ts = (torch.from_numpy(a).requires_grad_() for a in (x, s))
    out = tops.recompute_vjp("rmsnorm", tref.rmsnorm_ref, tref.rmsnorm_ref,
                             (tx, ts), eps=tops.RMSNORM_EPS)
    got = torch.autograd.grad(out, (tx, ts), torch.from_numpy(go))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    out2 = tops.rmsnorm(tx, ts)                # CPU: the plain version
    assert out2.grad_fn is not None
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


def test_rmsnorm_checks_shapes():
    with pytest.raises(ValueError, match="rmsnorm"):
        tops.rmsnorm(torch.zeros(4, 8), torch.ones(7))
    with pytest.raises(ValueError, match="rmsnorm"):
        tops.rmsnorm(torch.zeros(0, 8), torch.ones(8))


@pytest.mark.parametrize("x_dtype,s_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.float16, torch.float16),
                                             (torch.float16, torch.float32),
                                             (torch.bfloat16, torch.float16)])
def test_rmsnorm_kernel_path_launches_once(monkeypatch, x_dtype, s_dtype):
    """The wrapper's kernel path on meta tensors, the launch captured: one
    C call with rows, d, eps and both dtype codes (the kernel picks its
    warp or block form and its grid from them), one launch counted, an
    output like x."""
    calls = []
    monkeypatch.setattr(tops, "_check", lambda name, ts: None)
    monkeypatch.setattr(tops, "_stream", lambda: 0)
    monkeypatch.setattr(tops, "_launch", lambda *a: calls.append(a))
    x = torch.empty(2, 2048, 4096, dtype=x_dtype, device="meta")
    scale = torch.empty(4096, dtype=s_dtype, device="meta")
    before = tops.rmsnorm.launches
    out = tops.rmsnorm(x, scale)
    assert out.shape == x.shape and out.dtype == x_dtype
    assert tops.rmsnorm.launches == before + 1
    (name, *args), = calls
    assert name == "rmsnorm" and len(args) == len(tops.build.ENTRY_POINTS[name][1])
    assert args[3:] == [4096, 4096, tops.RMSNORM_EPS, tops.DTYPE_CODES[x_dtype],
                        tops.DTYPE_CODES[s_dtype], 0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the rmsnorm kernel runs only "
                    "there (chip_smoke.py phase 3 runs these checks on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype,atol,rtol", [
    (4096, 4096, torch.bfloat16, 4e-3, 1e-2),   # the profile's shape
    (37, 1000, torch.bfloat16, 4e-3, 1e-2),
    (37, 1001, torch.float32, 1e-4, 0.0),       # d not a multiple of a vector
])
def test_rmsnorm_kernel_on_card(cuda_device, rows, d, dtype, atol, rtol):
    """The CUDA kernel against its plain version on the card.  fp32: the
    same arithmetic summed in another order; bf16: both round one fp32
    result to bf16 once, so they may sit one bf16 step (< 1%) apart."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = torch.randn(rows, d, generator=gen, device=cuda_device).to(dtype)
    s = 1 + 0.1 * torch.randn(d, generator=gen, device=cuda_device)
    before = tops.rmsnorm.launches
    got = tops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert tops.rmsnorm.launches == before + 1
    torch.testing.assert_close(got.float(), tref.rmsnorm_ref(x, s).float(),
                               atol=atol, rtol=rtol)
