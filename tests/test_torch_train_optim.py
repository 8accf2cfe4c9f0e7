"""LR schedules and optimizers, port vs optax (heal_tpu/parallel/schedulers).

The schedule is stepped per iteration with optax's count (update k uses
schedule(k), the count before the increment). The optimizers get the
SAME gradients on both sides, so only their update rules are compared.
Stated tolerances: 1e-6 relative for the learning rates (optax evaluates
them in f32, the port in Python floats); 1e-6 absolute on the parameters
after three updates (f32 moment arithmetic in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heal_tpu.parallel.schedulers import build_lr_schedule as jax_schedule
from heal_tpu.parallel.schedulers import build_optimizer as jax_optimizer
from heal_tpu_torch.parallel import build_lr_schedule, build_optimizer

torch.set_num_threads(1)
OPT = {"core_method": "Adam", "lr": 0.002,
       "args": {"eps": 1e-10, "weight_decay": 1e-4}}
SCHEDULES = {
    "step": {"core_method": "step", "step_size": 1, "gamma": 0.5},
    "multistep": {"core_method": "multistep", "step_size": [1, 2],
                  "gamma": 0.1},
    "exponential": {"core_method": "exponential", "gamma": 0.9},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_at_every_step_of_three_epochs_matches_optax(name):
    steps_per_epoch = 5
    want = jax_schedule(OPT, SCHEDULES[name], steps_per_epoch)
    got = build_lr_schedule(OPT, SCHEDULES[name], steps_per_epoch)
    counts = range(3 * steps_per_epoch)
    lrs = [got(k) for k in counts]
    np.testing.assert_allclose(
        lrs, [float(want(jnp.asarray(k))) for k in counts], rtol=1e-6)
    assert lrs[0] == OPT["lr"] and lrs[-1] < lrs[0]


@pytest.mark.parametrize("opt", [
    OPT,
    {"core_method": "AdamW", "lr": 0.002,
     "args": {"eps": 1e-8, "weight_decay": 1e-2}},
    {"core_method": "SGD", "lr": 0.01,
     "args": {"momentum": 0.9, "weight_decay": 1e-4}},
])
def test_three_updates_from_the_same_gradients_match_optax(opt):
    """Multistep boundaries at updates 1 and 2 (one step per epoch), so
    every update runs at another learning rate."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10.0 ** -i
              for k, v in params.items()} for i in range(3)]
    sched = SCHEDULES["multistep"]

    tx = jax_optimizer(opt, sched, 1)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    optimizer, schedule = build_optimizer(tp.values(), opt, sched, 1)
    for k, g in enumerate(grads):
        for name, p in tp.items():
            p.grad = torch.from_numpy(g[name])
        for group in optimizer.param_groups:
            group["lr"] = schedule(k)
        optimizer.step()
    for name, p in tp.items():
        assert not np.allclose(p.detach().numpy(), params[name])
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[name]),
                                   rtol=0, atol=1e-6)
