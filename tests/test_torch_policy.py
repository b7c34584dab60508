"""Port parity of the policy baseline (``core/placement/policy_baseline.py``),
injected-randomness grade: the reference's initial weights and its Gumbel
draws (replayed from its own split keys) go into the port, and the sampled
placements of every iteration, the history and the best placement are held
against a live reference run. A port run on its own ``torch.Generator`` is
held to the reference test's quality band over five seeds, and so is PPO."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import NoC as RNoC  # noqa: E402
from repro.core import graph as r_graph  # noqa: E402
from repro.core.placement import policy_baseline as r_pol  # noqa: E402
from repro.models.specs import materialize as r_materialize  # noqa: E402

from repro_torch.core import NoC as PNoC  # noqa: E402
from repro_torch.core import graph as p_graph  # noqa: E402
from repro_torch.core.placement import policy_baseline as p_pol  # noqa: E402
from repro_torch.core.placement import ppo as p_ppo  # noqa: E402

D_HIDDEN = 16


def _gumbel_rows(key, B, n, n_cores):
    """The ``[B, n, n_cores]`` Gumbel draws the reference's
    ``sample_placements(key, ...)`` makes: one key per sample, split once a
    node, ``jax.random.categorical`` adding ``gumbel(k, (n_cores,))``."""
    def one(kb):
        def body(kb, _):
            kb, k = jax.random.split(kb)
            return kb, jax.random.gumbel(k, (n_cores,), jnp.float32)
        return jax.lax.scan(body, kb, None, length=n)[1]
    return np.asarray(jax.vmap(one)(jax.random.split(key, B)))


def _reference_draws(seed, iterations, B, n, n_cores, d_feat):
    """The reference run_policy_baseline's key sequence replayed: the
    initial params from the seed key, then one split per iteration."""
    key = jax.random.PRNGKey(seed)
    params = r_materialize(key, r_pol.policy_specs(d_feat, n_cores,
                                                   D_HIDDEN))
    gumbel = []
    for _ in range(iterations):
        key, k = jax.random.split(key)
        gumbel.append(_gumbel_rows(k, B, n, n_cores))
    return {k: np.asarray(v) for k, v in params.items()}, np.stack(gumbel)


def _params(seed=0, d_feat=5, n_cores=12):
    ref = r_materialize(jax.random.PRNGKey(seed),
                        r_pol.policy_specs(d_feat, n_cores, D_HIDDEN))
    port = {k: torch.tensor(np.asarray(v)) for k, v in ref.items()}
    return ref, port


def test_sampling_matches_reference_draws_without_replacement():
    ref_params, port_params = _params()
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 5)))
    logits_r = r_pol.policy_logits(ref_params, jnp.asarray(feats))
    logits_p = p_pol.policy_logits(port_params, torch.tensor(feats))
    np.testing.assert_allclose(logits_p.numpy(), logits_r, rtol=1e-5,
                               atol=1e-7)
    key = jax.random.PRNGKey(2)
    pl_r, lp_r = r_pol.sample_placements(key, logits_r, 16)
    pl_p, lp_p = p_pol.sample_placements(
        logits_p, 16, gumbel=torch.tensor(_gumbel_rows(key, 16, 8, 12)))
    np.testing.assert_array_equal(pl_p.numpy(), np.asarray(pl_r))
    np.testing.assert_allclose(lp_p.numpy(), lp_r, rtol=1e-5)
    own, lp_own = p_pol.sample_placements(
        logits_p, 32, generator=torch.Generator().manual_seed(0))
    for placements in (pl_p.numpy(), own.numpy()):
        for row in placements:
            assert len(set(row.tolist())) == 8          # injective
            assert row.min() >= 0 and row.max() < 12
    assert bool(torch.isfinite(lp_own).all())


def test_placement_logp_matches_reference():
    ref_params, port_params = _params()
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 5)))
    rng = np.random.default_rng(0)
    placements = np.stack([rng.permutation(12)[:8] for _ in range(10)])
    want = r_pol.placement_logp(ref_params, jnp.asarray(feats),
                                jnp.asarray(placements))
    got = p_pol.placement_logp(port_params, torch.tensor(feats),
                               torch.tensor(placements))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def _recording(monkeypatch, module, sink):
    real = module.make_scorer

    def spy(*args, **kw):
        score = real(*args, **kw)

        def recorded(placements):
            sink.append(np.asarray(placements).copy())
            return score(placements)
        return recorded
    monkeypatch.setattr(module, "make_scorer", spy)


@pytest.mark.parametrize("objective", ["comm_cost", "latency"])
def test_run_policy_baseline_matches_live_reference(monkeypatch, objective):
    g = r_graph.random_dag(10, seed=4)
    rg = r_graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    pg = p_graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    kw = dict(batch_size=12, iterations=8, d_hidden=D_HIDDEN, seed=3,
              objective=objective)
    seen_r, seen_p = [], []
    _recording(monkeypatch, r_pol, seen_r)
    _recording(monkeypatch, p_pol, seen_p)
    ref = r_pol.run_policy_baseline(rg, RNoC(4, 4), r_pol.PolicyConfig(**kw))
    params, gumbel = _reference_draws(3, 8, 12, g.n, 16,
                                      g.node_features().shape[1])
    port = p_pol.run_policy_baseline(
        pg, PNoC(4, 4),
        p_pol.PolicyConfig(**kw, init_params=params, gumbel=gumbel),
        device="cpu")
    assert len(seen_p) == len(seen_r) == 8
    for it, (a, b) in enumerate(zip(seen_p, seen_r)):
        np.testing.assert_array_equal(a, b, err_msg=f"iteration {it}")
    # the loss is the advantage-weighted mean of per-sample log-prob sums of
    # magnitude about n * log(n_cores) that mostly cancel: it is held within
    # rtol 1e-5 plus 1e-6 of that magnitude (float32 log-softmax rounds
    # differently in XLA and PyTorch)
    loss_atol = 1e-6 * g.n * np.log(16)
    for h_r, h_p in zip(ref["history"], port["history"], strict=True):
        for k in ("mean_cost", "best_cost"):
            np.testing.assert_allclose(h_p[k], h_r[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(h_p["loss"], h_r["loss"], rtol=1e-5,
                                   atol=loss_atol, err_msg="loss")
    np.testing.assert_array_equal(port["best_placement"],
                                  ref["best_placement"])
    assert port["best_cost"] == ref["best_cost"]


@pytest.mark.parametrize("seed", range(5))
def test_policy_own_generator_improves(seed):
    g = p_graph.random_dag(10, seed=4)
    out = p_pol.run_policy_baseline(
        g, PNoC(4, 4), p_pol.PolicyConfig(batch_size=12, iterations=8,
                                          seed=seed), device="cpu")
    assert out["best_cost"] < out["history"][0]["mean_cost"]
    assert len(set(out["best_placement"].tolist())) == g.n
    again = p_pol.run_policy_baseline(
        g, PNoC(4, 4), p_pol.PolicyConfig(batch_size=12, iterations=8,
                                          seed=seed), device="cpu")
    assert again["history"] == out["history"]


@pytest.mark.parametrize("seed", range(5))
def test_ppo_own_generator_improves(seed):
    g = p_graph.random_dag(10, seed=4)
    st = p_ppo.run_ppo(g, PNoC(4, 4),
                       p_ppo.PPOConfig(batch_size=16, ppo_epochs=2,
                                       iterations=6, d_gcn=8, d_fc=16,
                                       seed=seed), device="cpu")
    assert st.best_cost < st.history[0]["mean_cost"]
    assert len(set(np.asarray(st.best_placement).tolist())) == g.n
