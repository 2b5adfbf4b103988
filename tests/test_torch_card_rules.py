"""The card's kernel rules (``repro_torch.kernels.card_rules``) as the
dispatch and the static lint apply them: one source of the thresholds
(the CUDA sources' own literals included), each refused shape named by
the lint's code and refused by the dispatch with the same message on
meta tensors, every catalog config clean at every member count, the
dry-run's and the launchers' refusals, and the ``card_lint`` CLI.

No card is needed: the dispatch's card path runs on meta tensors inside
``ops.estimating``, which launches nothing."""
import dataclasses
import pathlib
import re

import pytest
import torch

from repro_torch.analysis import card_lint
from repro_torch.configs import get_config, get_smoke_config, list_configs
from repro_torch.kernels import card_rules, ops
from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
MEMBERS = (1, 2, 4, 16)
META = torch.device("meta")


def test_dispatch_reads_the_rules():
    assert ops.HEAD_DIMS is card_rules.HEAD_DIMS
    assert (ops.SSD_MAX_HEAD_DIM, ops.SSD_MAX_STATE, ops.SSD_MAX_CHUNK) == (
        card_rules.SSD_MAX_HEAD_DIM, card_rules.SSD_MAX_STATE, card_rules.SSD_MAX_CHUNK)
    assert ops.SSD_COPY_BYTES == card_rules.SSD_COPY_BYTES
    assert [str(d).removeprefix("torch.") for d in ops.DTYPE_CODES] == list(card_rules.DTYPES)
    assert list(ops.DTYPE_CODES.values()) == [0, 1, 2]


def _cases(source, fn):
    """The ``case N:`` values of the ``switch (hd)`` in ``fn`` of ``source``."""
    body = source[source.index(f" {fn}("):]
    switch = body[body.index("switch (hd)"):]
    return tuple(int(n) for n in re.findall(r"case (\d+):", switch[:switch.index("default")]))


def test_the_sources_literals_are_the_rules():
    """The guards the CUDA sources keep as their last line of defence
    hold the numbers ``card_rules`` gives the dispatch and the lint."""
    decode = (CSRC / "flash_decode.cu").read_text()
    assert [int(n) for n in re.findall(r"G \* hd > (\d+)", decode)] == \
        [card_rules.DECODE_GROUP_WIDTH]
    assert _cases(decode, "launch_hd") == card_rules.HEAD_DIMS
    attention = (CSRC / "flash_attention.cu").read_text()
    assert _cases(attention, "launch_hd") == card_rules.HEAD_DIMS
    scan = (CSRC / "ssd_scan.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (MAX_P|MAX_N|MAX_CHUNK) = (\d+);",
                                            scan)}
    assert got == {"MAX_P": card_rules.SSD_MAX_HEAD_DIM, "MAX_N": card_rules.SSD_MAX_STATE,
                   "MAX_CHUNK": card_rules.SSD_MAX_CHUNK}


def _dense(**over):
    return dataclasses.replace(get_smoke_config("granite_8b"), **over)


def _ssm(**over):
    return dataclasses.replace(get_smoke_config("mamba2_780m"), **over)


def _attention_call(hd, H=2, KV=1):
    q = torch.empty(1, 8, H, hd, dtype=torch.bfloat16, device=META)
    kv = torch.empty(1, 8, KV, hd, dtype=torch.bfloat16, device=META)
    return lambda: ops.flash_attention(q, kv, kv, causal=True)


def _decode_call(hd, H=2, KV=1):
    q = torch.empty(1, H, hd, dtype=torch.bfloat16, device=META)
    cache = torch.empty(1, KV, 64, hd, dtype=torch.bfloat16, device=META)
    return lambda: ops.flash_decode(q, cache, cache, 63)


def _scan_call(S, p, n, chunk, dtype=torch.bfloat16, h=2):
    x = torch.empty(1, S, h, p, dtype=dtype, device=META)
    f32 = dict(dtype=torch.float32, device=META)
    BC = torch.empty(1, S, 1, n, dtype=dtype, device=META)
    return lambda: ops.ssd_scan(x, torch.empty(1, S, h, **f32), torch.empty(h, **f32),
                                BC, BC, chunk=chunk)


# chip_smoke phase 43 (d)'s planted shapes and the sequence rule: (config,
# sequence, the lint's code, the kernel calls on the same shapes)
PLANTED = {
    "hd96": (_dense(head_dim=96), None, "H2E511",
             {"flash_attention": _attention_call(96), "flash_decode": _decode_call(96)}),
    "hd32": (_dense(head_dim=32), None, "H2E511",
             {"flash_attention": _attention_call(32), "flash_decode": _decode_call(32)}),
    "decode-G16-hd256": (_dense(num_heads=16, num_kv_heads=1, head_dim=256), None,
                         "H2E512", {"flash_decode": _decode_call(256, H=16)}),
    "ssd-p128-n256-chunk512": (_ssm(ssm_headdim=128, ssm_state=256, ssm_chunk=512), 512,
                               "H2E513", {"ssd_scan": _scan_call(512, 128, 256, 512)}),
    "ssd-bf16-p60": (_ssm(ssm_headdim=60), 64, "H2E514",
                     {"ssd_scan": _scan_call(64, 60, 16, 32)}),
    "ssd-sequence-48-chunk-32": (_ssm(), 48, "H2E515",
                                 {"ssd_scan": _scan_call(48, 32, 16, 32)}),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_shape_refused_by_lint_and_dispatch(name, monkeypatch):
    """The lint names each planted shape by its code, and the wrapper on
    meta tensors of that shape (the card's path, nothing launched) raises
    the lint's message, before it records or counts anything."""
    cfg, seq, code, calls = PLANTED[name]
    diags = card_lint.check_card_kernels(cfg, seq_len=seq)
    assert {d.code for d in diags} == {code}, [d.format() for d in diags]
    messages = {d.message.split(":", 1)[0]: d.message for d in diags}
    assert sorted(messages) == sorted(calls)
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("a kernel was launched"))
    before = {fn.__name__: fn.launches for fn in ops.KERNELS}
    recorded = []
    with ops.estimating(lambda *a: recorded.append(a)):
        for kernel, call in calls.items():
            with pytest.raises(ValueError) as got:
                call()
            assert str(got.value) == messages[kernel]
    assert recorded == []
    assert {fn.__name__: fn.launches for fn in ops.KERNELS} == before
    with pytest.raises(card_lint.CardRefusal) as refusal:
        card_lint.require(cfg, seq_len=seq)
    assert code in str(refusal.value)


def test_decode_group_refused_on_a_member_and_message_names_it():
    """G x hd above 2048 is refused wherever a member's block or the whole
    model's (a sequence-sharded cache) reaches it, naming G, hd and 2048;
    paligemma-3b's G 8 x hd 256 sits on the limit and passes."""
    cfg = _dense(num_heads=32, num_kv_heads=2, head_dim=256)        # G 16
    for m in (1, 2, 4):
        diags = card_lint.check_card_kernels(cfg, heads_per_member=m)
        assert [d.code for d in diags] == ["H2E512"], m
        assert all(w in diags[0].message for w in ("G 16", "hd 256", "2048"))
    assert card_rules.check_decode_group(8, 256) == []
    assert card_lint.check_card_kernels(get_config("paligemma_3b")) == []


def test_dtype_and_initial_state_rules():
    diags = card_lint.check_card_kernels(_dense(), dtype="float64")
    assert [d.code for d in diags] == ["H2E516"]
    assert card_rules.check_dtype("float16") == []
    assert card_rules.check_ssd_initial_state(False) == []
    assert "zero state" in card_rules.check_ssd_initial_state(True)[0]


@pytest.mark.parametrize("arch", list_configs())
def test_catalog_is_clean_at_every_member_count(arch):
    """Every config of the catalog, full and smoke, at model 1, 2, 4 and
    16 (where the members divide its heads), at its train and serve
    sequences: nothing the card would refuse.  The ssm family has no
    attention layer (mamba2-780m's head_dim 1536 is never a head)."""
    for cfg in (get_config(arch), get_smoke_config(arch)):
        for m in MEMBERS:
            for seq in (None, 64, 4096, 32768):
                diags = card_lint.check_card_kernels(cfg, seq_len=seq, heads_per_member=m)
                assert diags == [], [d.format() for d in diags]


def test_member_heads_follow_the_grids_cut():
    granite = get_config("granite_8b")                    # 32 / 8
    assert card_lint.member_heads(granite, 1) == (32, 8)
    assert card_lint.member_heads(granite, 4) == (8, 2)
    assert card_lint.member_heads(granite, 16) == (2, 1)  # each member's kv head whole
    pali = get_config("paligemma_3b")                     # 8 / 1
    assert card_lint.member_heads(pali, 2) == (4, 1)
    assert card_lint.member_heads(pali, 16) == (8, 1)     # the grid computes it whole
    starcoder = get_config("starcoder2_7b")               # 36 / 4: kv 4 does not split
    assert card_lint.member_heads(starcoder, 3) == (36, 4)
    assert card_lint.member_heads(starcoder, 4) == (9, 1)


@pytest.mark.parametrize("arch,over,shape,code", [
    ("granite_8b", dict(head_dim=96), "train_4k", "H2E511"),
    ("granite_8b", dict(num_heads=64, num_kv_heads=4, head_dim=256), "decode_32k", "H2E512"),
    ("mamba2_780m", dict(ssm_headdim=12), "prefill_32k", "H2E514"),
])
def test_dryrun_refuses_a_planted_config_by_its_code(arch, over, shape, code, tmp_path):
    cfg = dataclasses.replace(get_config(arch), **over)
    rec = dryrun.dryrun_one(arch, shape, mesh=dryrun.Mesh.of((2, 2), ("data", "model")),
                            cfg=cfg, out_dir=str(tmp_path))
    assert rec["status"] == "refused" and rec["codes"] == [code], rec
    assert code in rec["reason"] and "error" not in rec


def test_launchers_gate_refuses_on_the_card_only():
    """``refuse_on_card`` exits naming the code for a card run, and lets
    a CPU run or the einsum path through (they run the plain versions)."""
    cfg = _dense(head_dim=96)
    with pytest.raises(SystemExit, match="H2E511"):
        card_lint.refuse_on_card(cfg, torch.device("cuda"), "auto", seq_len=64)
    with pytest.raises(SystemExit, match="H2E512"):
        card_lint.refuse_on_card(_dense(num_heads=32, num_kv_heads=2, head_dim=256),
                                 torch.device("cuda"), "kernel", members=(1, 2))
    card_lint.refuse_on_card(cfg, torch.device("cpu"), "auto", seq_len=64)
    card_lint.refuse_on_card(cfg, torch.device("cuda"), "einsum", seq_len=64)
    card_lint.refuse_on_card(get_config("zamba2_2p7b"), torch.device("cuda"), "auto",
                             seq_len=2048, members=(1, 2, 4))


def test_card_lint_cli(capsys):
    assert card_lint.main(["--arch", "zamba2_2p7b", "--model-parallel", "2",
                           "--seq", "4096"]) == 0
    assert "CARD_LINT_OK zamba2_2p7b" in capsys.readouterr().out
    assert card_lint.main(["--arch", "mamba2_780m", "--smoke", "--seq", "48"]) == 1
    out = capsys.readouterr()
    assert "H2E515" in out.err and "CARD_LINT_OK" not in out.out
