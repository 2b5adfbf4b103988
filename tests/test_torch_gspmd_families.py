"""The (data, model) grid's model axis for the moe, ssm, hybrid and audio
families, held against the JAX package on the CPU: qwen3-moe (expert
parallelism), mamba2 and zamba2 (mamba2 head sharding; zamba2's shared
block as Megatron) and whisper (encoder, decoder and cross-attention
heads) at data 2 x model 2 under ``repro_torch.sharding.spmd``, and
qwen3-moe and mamba2 under ZeRO-1 (``repro_torch.training.manual_dp``),
in one spawn of four gloo ranks (rank functions in
``tests/helpers/torch_gspmd_ranks.py``).

Reference: the JAX package's single-device ``make_train_step`` on fp32
``conftest.exact_cfg`` smoke configs, from the same weights and numpy
batches as ``tests/test_torch_gspmd.py``, at its limits (first loss
1e-5 relative, gradient norm 1e-4, every parameter after the step 5e-4,
second loss 1e-4, each rank's bytes its closed form).  The qwen3-moe
ZeRO-1 case is held instead to the JAX package's own manual step
(``repro.training.manual_dp``, on a 2 x 2 mesh of virtual host devices in
a subprocess, ``tests/helpers/jax_manual_dp_steps.py``), whose
load-balance loss is each data rank's own and so differs from the single
device's.  Besides, each leaf's first gradient is held to JAX's (for
ZeRO-1, the mean of each data rank's gradient on its rows) within 1e-4
of that leaf's largest entry: a gradient summed over the model members
where it should be counted once (the router's load-balance part) or the
reverse (B and C's columns, the cross-attention's encoder output) shows
there, where one AdamW step can hide it.  A key bias without RoPE has no
gradient but rounding noise (ROADMAP C), so it is held to its key
weight's largest entry.
"""
import dataclasses
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

from repro.models import model as JM
from test_torch_gspmd import OPT, _case_jobs, _hold, _hold_standin, _spawn

ROOT = pathlib.Path(__file__).resolve().parents[1]

GRAD_RTOL = 1e-4
CASES = [("qwen3-moe", "qwen3_moe_30b_a3b", 2, 2, 1, "gspmd"),
         ("mamba2", "mamba2_780m", 2, 2, 1, "gspmd"),
         ("zamba2", "zamba2_2p7b", 2, 2, 1, "gspmd"),
         ("whisper", "whisper_base", 2, 2, 1, "gspmd"),
         ("qwen3-moe-zero1", "qwen3_moe_30b_a3b", 2, 2, 1, "manual"),
         ("mamba2-zero1", "mamba2_780m", 2, 2, 1, "manual")]
# held to the JAX package's manual step, not its single-device one
JAX_MANUAL = ("qwen3-moe-zero1",)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """One spawn of four ranks: every case on the 2 x 2 grid; meanwhile
    the JAX manual step of each ``JAX_MANUAL`` case in a subprocess.
    Returns (the ranks' results, the cases' inputs, each ``JAX_MANUAL``
    case's reference)."""
    tmp = tmp_path_factory.mktemp("families")
    cases, refs = _case_jobs(CASES)
    data = {c[0]: c[3] for c in CASES}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for name in JAX_MANUAL:
        jcfg, tree, batches, _ = refs[name]
        src, dst = tmp / f"{name}.in", tmp / f"{name}.out"
        with open(src, "wb") as f:
            pickle.dump((dataclasses.asdict(jcfg), tree, batches, OPT, data[name],
                         next(c[2] for c in CASES if c[0] == name)), f)
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "helpers" / "jax_manual_dp_steps.py"),
             str(src), str(dst)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), dst)
    outs = _spawn(4, [("cases", "train_cases", (cases, OPT))], tmp / "ranks")
    manual = {}
    for name, (proc, dst) in procs.items():
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, log[-3000:]
        with open(dst, "rb") as f:
            manual[name] = pickle.load(f)
    return outs, refs, manual


def _jax_grads(jcfg, tree, batch):
    """The JAX package's gradient of the first batch's loss."""
    params = jax.tree.map(jnp.asarray, tree)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, jcfg, b, backend="einsum")[0]))(
        params, b)
    return jax.tree_util.tree_flatten_with_path(grads)[0]


def _hold_grads(got, jcfg, tree, batch, data):
    """Each leaf's first gradient held to JAX's: the mean over ``data``
    ranks of the gradient on each one's rows (the single device's where
    ``data`` is 1, or the loss has no per-rank term)."""
    rows = len(batch["tokens"]) // data
    per = [_jax_grads(jcfg, tree, {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()})
           for d in range(data)]
    want = {"/".join(k.key for k in path): sum(np.asarray(g[i][1], np.float32)
                                               for g in per) / data
            for i, (path, _) in enumerate(per[0])}
    assert set(got) == set(want)
    for path, w in want.items():
        scale_of = path[:-2] + "wk" if path.endswith("/bk") else path
        scale = float(np.max(np.abs(want[scale_of])))
        err = float(np.max(np.abs(got[path].float().numpy() - w)))
        assert err <= GRAD_RTOL * scale, (path, err, scale)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_family_grid_2x2_matches_jax(families, name):
    outs, refs, manual = families
    _hold(outs, refs, name, manual.get(name))
    jcfg, tree, batches, _ = refs[name]
    data = next(c[3] for c in CASES if c[0] == name) if name in manual else 1
    _hold_grads(outs[0]["cases"][name]["grads1"], jcfg, tree, batches[0], data)
    stats = outs[0]["cases"][name]["stats"]
    assert stats["model_reduce_bytes"] > 0        # the members' parts summed


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_standin_counts_the_family_ranks_collectives(families, name):
    """The dry-run's counting stand-in against each gloo rank of the
    model axis (expert parallelism's routing sums, the ssm heads' norm
    sums, the Megatron and ZeRO-1 collectives): bytes and calls exact."""
    outs, refs, _ = families
    _hold_standin(outs, refs, next(c for c in CASES if c[0] == name))
