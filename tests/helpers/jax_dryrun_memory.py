"""Subprocess helper: the per-device argument bytes of the JAX package's
train step compiled under GSPMD on a (data, model) mesh of virtual host
devices, as its dry-run compiles it (``repro/launch/dryrun.py:125-160``).

    python tests/helpers/jax_dryrun_memory.py IN OUT

``IN`` is a pickle of a list of ``(name, config fields, data, model,
batch, seq, accum, mode)`` cases, ``mode`` ``"gspmd"`` (the jitted
``make_train_step`` under ``rules.train_state_shardings``) or
``"manual"`` (``manual_dp.make_manual_dp_train_step``'s ZeRO-1);
``OUT`` gets a pickle of ``memory_analysis().argument_size_in_bytes``
by name.  ``tests/test_torch_dryrun.py`` holds the port's estimate to
it.
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
    from repro.models.config import ModelConfig
    from repro.sharding import ctx, rules
    from repro.training.manual_dp import make_manual_dp_train_step
    from repro.training.train_step import abstract_train_state, make_train_step

    out = {}
    for name, fields, data, model, batch, seq, accum, mode in cases:
        cfg = ModelConfig(**fields)
        mesh = jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:data * model])
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


if __name__ == "__main__":
    main(*sys.argv[1:])
