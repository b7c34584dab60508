"""The port's slice as a whole on the CPU: ``repro_torch.deploy.deploy_model``
against the JAX package's ``deploy_model`` at a tiny size.

The PPO run injects the reference's initial weights and per-iteration
Gaussian draws, replaying the reference's key sequence (``run_ppo``: the
init key, then one split per iteration). The plan's profile, partition,
graph and schedule must be equal; the PPO history agrees within rtol=1e-4
(float32 autograd against ``jax.grad``, summed in another order) and the
best placement is equal.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

from repro.core import topology as r_topology  # noqa: E402
from repro.core.placement import actor_critic as r_ac  # noqa: E402
from repro.deploy import deploy_model as r_deploy  # noqa: E402
from repro.snn import spike_vgg16 as r_vgg16  # noqa: E402

from repro_torch.core import topology as p_topology  # noqa: E402
from repro_torch.core.placement import PPOConfig, optimize_placement  # noqa: E402
from repro_torch.deploy import deploy_model as p_deploy  # noqa: E402
from repro_torch.snn import spike_vgg16 as p_vgg16  # noqa: E402

BATCH, ITERS, EPOCHS = 8, 3, 2


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _report(plan):
    rep = plan.report()
    rep.pop("stage_times_s")
    rep["placement"].pop("wall_time_s")
    return rep


def test_ppo_plan_matches_reference():
    kw = dict(method="ppo", objective="latency")
    ref = r_deploy(r_vgg16(width_mult=0.125), r_topology.parse_topology(
        "mesh:4x4"), budget=ITERS, batch_size=BATCH, ppo_epochs=EPOCHS, **kw)
    n = ref.graph.n
    key = jax.random.PRNGKey(0)                       # deploy_model's seed
    actor, critic = r_ac.init_actor_critic(key, 5, 32, 64)
    eps = []
    for _ in range(ITERS):
        key, k_s = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(k_s, (BATCH, n, 2))))
    cfg = PPOConfig(batch_size=BATCH, ppo_epochs=EPOCHS, iterations=ITERS,
                    objective="latency",
                    init_params=(_np_tree(actor), _np_tree(critic)),
                    eps=np.stack(eps))
    port = p_deploy(p_vgg16(width_mult=0.125),
                    p_topology.parse_topology("mesh:4x4"), cfg=cfg,
                    device="cpu", **kw)

    assert [vars(p) for p in port.profiles] == [vars(p) for p in ref.profiles]
    assert port.partition.strategy == ref.partition.strategy == "balanced"
    assert [vars(s) for s in port.partition.slices] == \
        [vars(s) for s in ref.partition.slices]
    for attr in ("adj", "compute", "memory"):
        np.testing.assert_array_equal(getattr(port.graph, attr),
                                      getattr(ref.graph, attr))
    assert port.schedule.events == ref.schedule.events
    assert port.schedule.makespan == ref.schedule.makespan
    hist_r, hist_p = ref.placement.history, port.placement.history
    assert len(hist_p) == len(hist_r) == ITERS
    for h_r, h_p in zip(hist_r, hist_p):
        for k in ("mean_cost", "min_cost", "best_cost", "actor_loss",
                  "critic_loss"):
            np.testing.assert_allclose(h_p[k], h_r[k], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(port.placement.placement,
                                  ref.placement.placement)
    assert _report(port) == _report(ref)


@pytest.mark.parametrize("spec,method,extra", [
    ("mesh:4x4", "zigzag", {}),
    ("hier:2x2:2x2", "sigmate", {"copartition_iters": 2,
                                 "contention_feedback": True}),
])
def test_constructor_plan_matches_reference(spec, method, extra):
    kw = dict(method=method, objective="latency", **extra)
    ref = r_deploy(r_vgg16(width_mult=0.125),
                   r_topology.parse_topology(spec), **kw)
    port = p_deploy(p_vgg16(width_mult=0.125),
                    p_topology.parse_topology(spec), device="cpu", **kw)
    assert _report(port) == _report(ref)
    np.testing.assert_array_equal(port.placement.placement,
                                  ref.placement.placement)


def test_unported_methods_and_kwargs_raise():
    topo = p_topology.parse_topology("mesh:3x3")
    from repro_torch.core import random_dag
    g = random_dag(6, seed=0)
    for method in ("sa", "genetic", "policy", "multilevel", "greedy"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            optimize_placement(g, topo, method=method, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimize_placement(g, topo, method="ppo", backend="device",
                           device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        optimize_placement(g, topo, method="annealing", device="cpu")
    with pytest.raises(TypeError, match="unknown method kwarg"):
        optimize_placement(g, topo, method="ppo", batchsize=4, device="cpu")
    with pytest.raises(TypeError, match="loose"):
        optimize_placement(g, topo, method="ppo", cfg=PPOConfig(),
                           batch_size=4, device="cpu")
    res = optimize_placement(g, topo, method="ppo", budget=1, batch_size=4,
                             ppo_epochs=1, device="cpu", objective="max_link")
    assert res.objective == "max_link" and len(res.history) == 1
