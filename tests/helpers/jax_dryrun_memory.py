"""Subprocess helper: the per-device argument bytes of the JAX package's
train step compiled under GSPMD on a (data, model) mesh of virtual host
devices, as its dry-run compiles it (``repro/launch/dryrun.py:125-160``).

    python tests/helpers/jax_dryrun_memory.py IN OUT

``IN`` is a pickle of a list of ``(name, config fields, data, model,
batch, seq, accum, mode)`` cases, ``mode`` ``"gspmd"`` (the jitted
``make_train_step`` under ``rules.train_state_shardings``),
``"manual"`` (``manual_dp.make_manual_dp_train_step``'s ZeRO-1),
``"prefill"`` (the jitted ``make_prefill_step`` with the params and the
prompts sharded, ``repro/launch/dryrun.py:176-181``) or ``"decode"``
(the jitted ``make_decode_step`` with the cache in and out under
``rules.cache_shardings``, donated, ``:183-191``); ``OUT`` gets a pickle
of ``memory_analysis().argument_size_in_bytes`` by name, and of the
serve steps' per-device ``analyze_hlo`` FLOPs by ``<name>/flops``.
``tests/test_torch_dryrun.py`` holds the port's estimate to it.
"""
import pickle
import sys

from repro.launch.hostdevices import force_host_device_count


def main(src, dst):
    with open(src, "rb") as f:
        cases = pickle.load(f)
    force_host_device_count(max(c[2] * c[3] for c in cases))
    import jax

    from repro.launch import shapes as SH
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import model as M
    from repro.models.config import ModelConfig
    from repro.sharding import ctx, rules
    from repro.training import serve_step as SS
    from repro.training.manual_dp import make_manual_dp_train_step
    from repro.training.train_step import abstract_train_state, make_train_step

    out = {}
    for name, fields, data, model, batch, seq, accum, mode in cases:
        cfg = ModelConfig(**fields)
        mesh = jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:data * model])
        if mode in ("prefill", "decode"):
            with ctx.use_mesh(mesh):
                compiled = _serve(cfg, mesh, mode, SH.InputShape(name, mode, seq, batch),
                                  SH, M, SS, rules)
            out[name] = int(compiled.memory_analysis().argument_size_in_bytes)
            out[name + "/flops"] = float(analyze_hlo(compiled.as_text())["flops"])
            continue
        shape = SH.InputShape(name, "train", seq, batch)
        with ctx.use_mesh(mesh):
            state = abstract_train_state(cfg)
            batch_spec = SH.input_specs(cfg, shape)
            batch_sh = rules.batch_shardings(batch_spec, mesh)
            if mode == "manual":
                step, state_sh = make_manual_dp_train_step(cfg, mesh, accum_steps=accum)
            else:
                state_sh = rules.train_state_shardings(state, mesh,
                                                       hybrid=cfg.family == "hybrid")
                step = make_train_step(cfg, accum_steps=accum)
            jitted = jax.jit(step, in_shardings=(state_sh, batch_sh),
                             out_shardings=(state_sh, None), donate_argnums=(0,))
            compiled = jitted.lower(state, batch_spec).compile()
        out[name] = int(compiled.memory_analysis().argument_size_in_bytes)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


def _serve(cfg, mesh, mode, shape, SH, M, SS, rules):
    """The JAX dry-run's serve step of ``shape``, compiled."""
    import jax
    params = M.abstract_params(cfg)
    params_sh = rules.tree_param_shardings(params, mesh, hybrid=cfg.family == "hybrid")
    if mode == "prefill":
        batch = SH.input_specs(cfg, shape)
        fn = SS.make_prefill_step(cfg, cache_len=shape.seq_len)
        jitted = jax.jit(fn, in_shardings=(params_sh, rules.batch_shardings(batch, mesh)))
        return jitted.lower(params, batch).compile()
    fn, _ = SS.make_decode_step(cfg, shape.seq_len)
    cache = SS.abstract_serve_cache(cfg, shape.global_batch, shape.seq_len)
    cache_sh = rules.cache_shardings(cache, mesh)
    dspec = SH.decode_specs(cfg, shape)
    tok_sh = rules.batch_shardings({"tokens": dspec["tokens"]}, mesh)["tokens"]
    pos_sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    jitted = jax.jit(fn, in_shardings=(params_sh, cache_sh, tok_sh, pos_sh),
                     out_shardings=(None, None, cache_sh), donate_argnums=(1,))
    return jitted.lower(params, cache, dspec["tokens"], dspec["pos"]).compile()


if __name__ == "__main__":
    main(*sys.argv[1:])
