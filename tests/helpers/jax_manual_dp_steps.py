"""Subprocess helper: the JAX package's manual-collective ZeRO-1 step
(``repro.training.manual_dp.make_manual_dp_train_step``) on a (data,
model) mesh of virtual host devices, one step a batch.

    python tests/helpers/jax_manual_dp_steps.py IN OUT

``IN`` is a pickle of ``(config fields, params tree, batches, AdamW
fields, data, model)`` (numpy leaves); ``OUT`` gets a pickle of each
step's metrics and the parameters after the first step, flattened by
path.  ``tests/test_torch_gspmd_families.py`` holds the port's ZeRO-1
step to it.
"""
import pickle
import sys

from repro.launch.hostdevices import force_host_device_count


def main(src, dst):
    with open(src, "rb") as f:
        fields, tree, batches, opt, data, model = pickle.load(f)
    force_host_device_count(data * model)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models.config import ModelConfig
    from repro.optim import adamw
    from repro.sharding import rules
    from repro.training import manual_dp
    from repro.training.train_step import TrainState

    cfg = ModelConfig(**fields)
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    step, shardings = manual_dp.make_manual_dp_train_step(
        cfg, mesh, adamw.AdamWConfig(**opt), backend="einsum")
    params = jax.tree.map(jnp.asarray, tree)
    state = jax.device_put(TrainState(params, adamw.init_opt_state(params),
                                      jnp.zeros((), jnp.int32)), shardings)
    metrics, params1 = [], None
    for i, b in enumerate(batches):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        state, m = step(state, jax.device_put(b, rules.batch_shardings(b, mesh)))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
            params1 = {"/".join(k.key for k in path): np.asarray(v, np.float32)
                       for path, v in flat}
    with open(dst, "wb") as f:
        pickle.dump((metrics, params1), f)


if __name__ == "__main__":
    main(*sys.argv[1:])
