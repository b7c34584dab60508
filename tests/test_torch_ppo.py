"""Port parity, injected-randomness grade: the actor-critic, AdamW and the PPO
update of ``repro_torch`` against the JAX package, fed the reference's
weights and Gaussian draws (``jax.random`` and ``torch.Generator`` give
different numbers from one seed)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import NoC as RNoC  # noqa: E402
from repro.core import graph as r_graph  # noqa: E402
from repro.core.placement import actor_critic as r_ac  # noqa: E402
from repro.core.placement import ppo as r_ppo  # noqa: E402
from repro.train import optim as r_optim  # noqa: E402

from repro_torch.core import NoC as PNoC  # noqa: E402
from repro_torch.core import graph as p_graph  # noqa: E402
from repro_torch.core.placement import actor_critic as p_ac  # noqa: E402
from repro_torch.core.placement import ppo as p_ppo  # noqa: E402
from repro_torch.train import optim as p_optim  # noqa: E402

D_GCN, D_FC = 16, 32


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _setup(n=10, seed=0):
    g = r_graph.random_dag(n, seed=seed)
    lap = np.asarray(g.laplacian(), np.float32)
    feats = np.asarray(g.node_features(), np.float32)
    actor, critic = r_ac.init_actor_critic(jax.random.PRNGKey(seed),
                                           feats.shape[1], D_GCN, D_FC)
    return g, lap, feats, actor, critic


def test_actor_critic_forward_and_logp_match():
    _, lap, feats, actor, critic = _setup()
    pa, pc = p_ac.from_reference_params(_np_tree(actor), _np_tree(critic),
                                        device="cpu")
    mu_r, ls_r = r_ac.actor_apply(actor, jnp.asarray(lap), jnp.asarray(feats))
    tl, tf = torch.as_tensor(lap), torch.as_tensor(feats)
    with torch.no_grad():
        mu_p, ls_p = pa(tl, tf)
        v_p = pc(tl, tf)
    np.testing.assert_allclose(mu_p.numpy(), mu_r, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ls_p.numpy(), ls_r, rtol=1e-5)
    np.testing.assert_allclose(
        float(v_p), float(r_ac.critic_apply(critic, jnp.asarray(lap),
                                            jnp.asarray(feats))),
        rtol=1e-5, atol=1e-7)
    key = jax.random.PRNGKey(3)
    acts_r, logp_r = r_ac.sample_actions(key, mu_r, ls_r, 8)
    eps = np.asarray(jax.random.normal(key, (8,) + mu_r.shape))
    acts_p, logp_p = p_ac.sample_actions(mu_p, ls_p, 8,
                                         eps=torch.tensor(eps))
    np.testing.assert_allclose(acts_p.numpy(), acts_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logp_p.numpy(), logp_r, rtol=1e-5)
    np.testing.assert_allclose(
        p_ac.gaussian_logp(torch.tensor(np.asarray(acts_r)), mu_p,
                           ls_p).numpy(),
        r_ac.gaussian_logp(acts_r, mu_r, ls_r), rtol=1e-5)
    np.testing.assert_allclose(float(p_ac.entropy(ls_p)),
                               float(r_ac.entropy(ls_r)), rtol=1e-5)


def test_init_matches_reference_layout_and_distribution():
    ref_a, ref_c = r_ac.init_actor_critic(jax.random.PRNGKey(0), 5, 32, 64)
    pa, pc = p_ac.init_actor_critic(torch.Generator().manual_seed(0), 5, 32,
                                    64)
    for ref, port in ((ref_a, pa), (ref_c, pc)):
        ref_flat = _flat(ref)
        state = port.state_dict()
        assert set(state) == set(ref_flat)
        for name, value in state.items():
            assert tuple(value.shape) == ref_flat[name].shape, name
            if "_b" in name or name.split(".")[-1].startswith("b"):
                assert torch.count_nonzero(value) == 0, name
    assert abs(float(pa.fc2_w.detach().std()) - 0.01) < 0.003
    assert abs(float(pa.fc1_w.detach().std()) - 1 / np.sqrt(64)) < 0.02


@pytest.mark.parametrize("weight_decay,grad_clip", [(0.0, 0.0), (0.1, 0.5)])
def test_adamw_matches_reference(weight_decay, grad_clip):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    cfg_r = r_optim.AdamWConfig(lr=5e-3, weight_decay=weight_decay,
                                grad_clip=grad_clip)
    cfg_p = p_optim.AdamWConfig(lr=5e-3, weight_decay=weight_decay,
                                grad_clip=grad_clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = r_optim.adamw_init(jp, cfg_r)
    tp = [torch.tensor(params["b"]), torch.tensor(params["w"])]  # sorted keys
    opt = p_optim.AdamW(tp, cfg_p)
    for step in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, state = r_optim.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, jp, cfg_r)
        opt.update([torch.tensor(grads["b"]), torch.tensor(grads["w"])])
        np.testing.assert_allclose(tp[0].numpy(), jp["b"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(tp[1].numpy(), jp["w"], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("freeze_gcn", [True, False])
def test_teacher_forced_update_matches_reference(freeze_gcn):
    """One rollout batch (the reference's acts, logp_old, rewards) through
    both updates: losses and every updated parameter agree."""
    _, lap, feats, actor, critic = _setup()
    jl, jf = jnp.asarray(lap), jnp.asarray(feats)
    mu, ls = r_ac.actor_apply(actor, jl, jf)
    acts, logp_old = r_ac.sample_actions(jax.random.PRNGKey(9), mu, ls, 16)
    rewards = jnp.asarray(np.random.default_rng(1).uniform(-3, 3, 16),
                          jnp.float32)
    adam = r_optim.AdamWConfig(lr=5e-3)
    pa, pc = p_ac.from_reference_params(_np_tree(actor), _np_tree(critic),
                                        device="cpu")
    opt_a, opt_c = p_ppo.make_optimizers(
        pa, pc, p_ppo.PPOConfig(lr=5e-3, freeze_gcn=freeze_gcn))
    ra, rc, _, _, la_r, lc_r = r_ppo._ppo_update_scan(
        actor, critic, r_optim.adamw_init(actor, adam),
        r_optim.adamw_init(critic, adam), jl, jf, acts, logp_old, rewards,
        3, 0.2, 1e-3, freeze_gcn, adam, adam)
    la_p, lc_p = p_ppo.ppo_update(
        pa, pc, opt_a, opt_c, torch.as_tensor(lap), torch.as_tensor(feats),
        torch.tensor(np.asarray(acts)), torch.tensor(np.asarray(logp_old)),
        torch.tensor(np.asarray(rewards)), 3, 0.2, 1e-3)
    np.testing.assert_allclose(float(la_p), float(la_r), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(lc_p), float(lc_r), rtol=1e-4, atol=1e-6)
    for ref, port in ((ra, pa), (rc, pc)):
        ref_flat = _flat(ref)
        for name, value in port.state_dict().items():
            np.testing.assert_allclose(value.numpy(), ref_flat[name],
                                       rtol=1e-4, atol=1e-6, err_msg=name)
    if freeze_gcn:
        np.testing.assert_array_equal(pa.gcn.w0.detach().numpy(),
                                      np.asarray(actor["gcn"]["w0"]))


def _reference_draws(seed, iterations, batch, n):
    """The reference run_ppo's key sequence (ppo.py: init, then one split
    per iteration) replayed: initial params and per-iteration draws."""
    key = jax.random.PRNGKey(seed)
    actor, critic = r_ac.init_actor_critic(key, 5, D_GCN, D_FC)
    eps = []
    for _ in range(iterations):
        key, k_s = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(k_s, (batch, n, 2))))
    return (_np_tree(actor), _np_tree(critic)), np.stack(eps)


def test_run_ppo_matches_reference_under_injected_noise():
    g = r_graph.random_dag(10, seed=2)
    rg = r_graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    pg = p_graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    kw = dict(batch_size=8, ppo_epochs=2, iterations=3, d_gcn=D_GCN,
              d_fc=D_FC, seed=1)
    ref = r_ppo.run_ppo(rg, RNoC(4, 4), r_ppo.PPOConfig(**kw))
    params, eps = _reference_draws(1, 3, 8, g.n)
    port = p_ppo.run_ppo(pg, PNoC(4, 4),
                         p_ppo.PPOConfig(**kw, init_params=params, eps=eps),
                         device="cpu")
    for h_r, h_p in zip(ref.history, port.history, strict=True):
        for k in ("mean_cost", "min_cost", "best_cost", "actor_loss",
                  "critic_loss"):
            np.testing.assert_allclose(h_p[k], h_r[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_array_equal(port.best_placement, ref.best_placement)


def test_run_ppo_own_generator_is_seeded():
    g = p_graph.random_dag(8, seed=0)
    cfg = p_ppo.PPOConfig(batch_size=4, ppo_epochs=1, iterations=2,
                          d_gcn=8, d_fc=8, seed=5)
    a = p_ppo.run_ppo(g, PNoC(3, 3), cfg, device="cpu")
    b = p_ppo.run_ppo(g, PNoC(3, 3), cfg, device="cpu")
    assert a.history == b.history
    np.testing.assert_array_equal(a.best_placement, b.best_placement)
    # the device resolver is an exact drop-in for the host one
    # (tests/test_deploy.py::test_ppo_device_discretize_matches_host_path)
    c = p_ppo.run_ppo(g, PNoC(3, 3),
                      dataclasses.replace(cfg, device_discretize=True),
                      device="cpu")
    assert c.history == a.history
    np.testing.assert_array_equal(c.best_placement, a.best_placement)


def test_run_ppo_device_discretize_matches_reference():
    """``device_discretize=True`` on both sides under the reference's draws:
    the same trajectory as the reference's jitted resolver path."""
    g = r_graph.random_dag(10, seed=2)
    rg = r_graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    pg = p_graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    kw = dict(batch_size=8, ppo_epochs=2, iterations=3, d_gcn=D_GCN,
              d_fc=D_FC, seed=1, device_discretize=True)
    ref = r_ppo.run_ppo(rg, RNoC(4, 4), r_ppo.PPOConfig(**kw))
    params, eps = _reference_draws(1, 3, 8, g.n)
    port = p_ppo.run_ppo(pg, PNoC(4, 4),
                         p_ppo.PPOConfig(**kw, init_params=params, eps=eps),
                         device="cpu")
    for h_r, h_p in zip(ref.history, port.history, strict=True):
        for k in ("mean_cost", "min_cost", "best_cost"):
            np.testing.assert_allclose(h_p[k], h_r[k], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(port.best_placement, ref.best_placement)


def test_ppo_backend_default_resolves_by_device(monkeypatch):
    """``PPOConfig().backend`` is ``None``: ``run_ppo`` resolves it by device
    (``"batch"`` on the CPU, ``"cuda"`` on a card), and a ``cfg`` handed to
    ``optimize_placement`` keeps an explicit backend of its own."""
    assert p_ppo.PPOConfig().backend is None
    g = p_graph.random_dag(8, seed=0)
    cfg = p_ppo.PPOConfig(batch_size=4, ppo_epochs=1, iterations=2,
                          d_gcn=8, d_fc=8, seed=5)
    default = p_ppo.run_ppo(g, PNoC(3, 3), cfg, device="cpu")
    batch = p_ppo.run_ppo(g, PNoC(3, 3),
                          dataclasses.replace(cfg, backend="batch"),
                          device="cpu")
    assert default.history == batch.history
    np.testing.assert_array_equal(default.best_placement, batch.best_placement)

    from repro_torch.core.placement import optimizer as p_opt
    asked = []
    real = p_ppo.make_scorer

    def spy(noc, graph, backend, objective, recorder=None, device=None):
        asked.append(backend)
        return real(noc, graph, backend, objective, recorder=recorder,
                    device=device)

    monkeypatch.setattr(p_ppo, "make_scorer", spy)
    for backend in (None, "torch"):
        p_opt.optimize_placement(
            g, PNoC(3, 3), method="ppo", device="cpu",
            cfg=dataclasses.replace(cfg, backend=backend))
    assert asked == ["batch", "torch"]
