"""Port parity of the request layer and the plan cache
(``deploy/request.py``, ``deploy/plancache.py`` and ``execute_request`` /
``instantiate_plan`` in ``deploy/engine.py``) against the JAX package's
(``tests/test_service.py``): the canonical JSON, the cache keys and the warm
keys are the reference's byte for byte for the same call, requests cross
between the packages as JSON, and a plan cache written by either package
loads in the other under the same keys."""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro import deploy as r_deploy  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core.placement.policy_baseline import \
    PolicyConfig as RPolicyConfig  # noqa: E402
from repro.core.placement.ppo import PPOConfig as RPPOConfig  # noqa: E402
from repro.snn import profile_model as r_profile  # noqa: E402
from repro.snn import spike_resnet18 as r_resnet18  # noqa: E402

from repro_torch import deploy as p_deploy  # noqa: E402
from repro_torch.core import topology as p_topology  # noqa: E402
from repro_torch.core.placement import PolicyConfig, PPOConfig  # noqa: E402
from repro_torch.snn import profile_model as p_profile  # noqa: E402
from repro_torch.snn import spike_resnet18 as p_resnet18  # noqa: E402

R, P = "ref", "port"
PKG = {R: (r_deploy, r_topology, r_resnet18, r_profile, RPPOConfig,
           RPolicyConfig),
       P: (p_deploy, p_topology, p_resnet18, p_profile, PPOConfig,
           PolicyConfig)}


def _call(side, case):
    """One deploy_model call, spelled with each package's own objects."""
    dep, topo, resnet18, profile, ppo_cfg, policy_cfg = PKG[side]
    model = resnet18(n_classes=10, in_res=32, T=4)
    noc = topo.parse_topology("mesh:4x4")
    kw = dict(method="simulated_annealing", schedule="none", budget=120,
              seed=3)
    if case == "sa":
        pass
    elif case == "sa_kw":
        kw.update(method="sa", objective="max_link",
                  method_kw={"t0": 0.1, "init": np.arange(16)})
    elif case == "hier":
        noc = topo.parse_topology("hier:2x2:2x2,ibw=1e9")
        kw.update(objective={"latency": 1.0, "energy": 2e9},
                  copartition_iters=1)
    elif case == "degraded":
        noc = topo.degrade(noc, links=(3,), nodes=(5,))
        kw.update(method="random_search", partition_strategy="balanced")
    elif case == "profiles":
        model = profile(model, batch=4, training=False)
        kw.update(batch=4, training=False, spike_density=0.2)
    elif case == "ppo_cfg":
        kw.update(method="ppo", method_kw={
            "cfg": ppo_cfg(batch_size=8, iterations=2, backend="batch")})
    elif case == "policy_cfg":
        kw.update(method="policy", method_kw={
            "cfg": policy_cfg(batch_size=8, iterations=2, backend="batch")})
    elif case == "device_sa":
        kw.update(backend="device", method_kw={"restarts": 4})
    return dep.DeployRequest.from_call(model, noc, **kw)


CASES = ("sa", "sa_kw", "hier", "degraded", "profiles", "ppo_cfg",
         "policy_cfg", "device_sa")


@pytest.mark.parametrize("case", CASES)
def test_keys_match_reference(case):
    ref, port = _call(R, case), _call(P, case)
    assert port.canonical_json() == ref.canonical_json()
    assert port.cache_key() == ref.cache_key()
    assert port.warm_key() == ref.warm_key()
    assert port.describe() == ref.describe()
    # JSON crosses both ways and round-trips to the same request
    blob = json.loads(json.dumps(port.to_json()))
    assert p_deploy.DeployRequest.from_json(blob) == port
    assert r_deploy.DeployRequest.from_json(blob).cache_key() == \
        ref.cache_key()
    back = p_deploy.DeployRequest.from_json(json.loads(json.dumps(
        ref.to_json())))
    assert back == port and back.cache_key() == ref.cache_key()


def test_search_config_backend_default_is_pinned():
    """The port's PPOConfig/PolicyConfig default ``backend`` is ``None``
    (resolved by device), the reference's ``"batch"``; it is encoded as
    given. So the default keys like the reference's ``backend=None`` and
    unlike the reference's default, and ``backend="batch"`` keys like the
    reference's default."""
    def key(side, method, cfg):
        dep, topo, resnet18 = PKG[side][:3]
        return dep.DeployRequest.from_call(
            resnet18(n_classes=10, in_res=32, T=4),
            topo.parse_topology("mesh:4x4"), method=method, schedule="none",
            method_kw={"cfg": cfg}).cache_key()
    for method, port_cls, ref_cls in (("ppo", PPOConfig, RPPOConfig),
                                      ("policy", PolicyConfig,
                                       RPolicyConfig)):
        assert port_cls().backend is None and ref_cls().backend == "batch"
        assert key(P, method, port_cls()) != key(R, method, ref_cls())
        assert key(P, method, port_cls()) == \
            key(R, method, ref_cls(backend=None))
        assert key(P, method, port_cls(backend="batch")) == \
            key(R, method, ref_cls())
    # a reference-written config thaws into the port's class with the
    # injection fields at their defaults
    req = p_deploy.DeployRequest.from_json(_call(R, "ppo_cfg").to_json())
    cfg = req.materialize_method_kw()["cfg"]
    assert cfg == PPOConfig(batch_size=8, iterations=2, backend="batch")


def test_unencodable_requests_raise():
    dep, topo = p_deploy, p_topology
    model = p_resnet18(n_classes=10, in_res=32, T=4)
    noc = topo.parse_topology("mesh:4x4")
    bad = [
        dict(method="ppo", method_kw={"cfg": PPOConfig(
            init_params=({}, {}))}),
        dict(method="ppo", method_kw={"cfg": PPOConfig(eps=np.zeros(3))}),
        dict(method="policy", method_kw={"cfg": PolicyConfig(
            gumbel=np.zeros(3))}),
        dict(method="random_search", method_kw={"init": lambda: 0}),
        dict(method="simulated_annealing", method_kw={"t0": float("inf")}),
        dict(objective=p_deploy.with_migration(
            "comm_cost", p_deploy.MigrationSpec((0,), (1.0,)), 0.5),
            method="simulated_annealing"),
    ]
    for kw in bad:
        with pytest.raises(p_deploy.RequestEncodeError):
            dep.DeployRequest.from_call(model, noc, schedule="none", **kw)

    class Custom(topo.GridTopology):
        pass
    with pytest.raises(p_deploy.RequestEncodeError, match="Custom"):
        dep.DeployRequest.from_call(model, Custom(4, 4), schedule="none")
    # typo'd kwargs are the engine's TypeError, not an encode error
    with pytest.raises(TypeError, match="bogus"):
        dep.DeployRequest.from_call(model, noc, method="sa",
                                    method_kw={"bogus": 1})


def test_deploy_model_through_request_layer_matches_reference():
    ref_req, port_req = _call(R, "sa"), _call(P, "sa")
    ref = r_deploy.execute_request(ref_req)
    port = p_deploy.execute_request(port_req, device="cpu")
    direct = p_deploy.deploy_model(
        p_resnet18(n_classes=10, in_res=32, T=4),
        p_topology.parse_topology("mesh:4x4"), method="simulated_annealing",
        schedule="none", budget=120, seed=3, device="cpu")
    for plan in (port, direct):
        np.testing.assert_array_equal(plan.placement.placement,
                                      ref.placement.placement)
        assert plan.placement.objective_cost == ref.placement.objective_cost
    # injected draws skip the request layer and still deploy
    cfg = PPOConfig(batch_size=4, iterations=1, ppo_epochs=1,
                    eps=np.zeros((1, 4, 16, 2)))
    plan = p_deploy.deploy_model(p_resnet18(n_classes=10, in_res=32, T=4),
                                 p_topology.parse_topology("mesh:4x4"),
                                 method="ppo", schedule="none", cfg=cfg,
                                 device="cpu")
    assert len(plan.placement.history) == 1


def test_instantiate_plan_reproduces_cached_plan():
    req = _call(P, "sa")
    plan = p_deploy.execute_request(req, device="cpu")
    again = p_deploy.instantiate_plan(req, plan.placement.placement,
                                      device="cpu")
    np.testing.assert_array_equal(again.placement.placement,
                                  plan.placement.placement)
    assert again.placement.objective_cost == plan.placement.objective_cost
    assert again.report()["placement"]["comm_cost"] == \
        plan.report()["placement"]["comm_cost"]
    with pytest.raises(ValueError, match="placement"):
        p_deploy.instantiate_plan(req, [0, 1, 2], device="cpu")
    # a placement the reference cached re-materializes to its plan
    ref = r_deploy.execute_request(_call(R, "hier"))
    port = p_deploy.instantiate_plan(_call(P, "hier"),
                                     ref.placement.placement, device="cpu")
    assert port.placement.objective_cost == ref.placement.objective_cost


def _strip(entry):
    e = dict(entry)
    for k in ("report", "device", "resolved_backend", "last_seq", "hits"):
        e.pop(k, None)
    return e


def test_plan_caches_cross_load(tmp_path):
    ref_reqs = [_call(R, c) for c in ("sa", "degraded")]
    port_reqs = [_call(P, c) for c in ("sa", "degraded")]
    ref_cache, port_cache = r_deploy.PlanCache(), p_deploy.PlanCache()
    for rq, pq in zip(ref_reqs, port_reqs):
        ref_cache.put(rq, r_deploy.execute_request(rq))
        port_cache.put(pq, p_deploy.execute_request(pq, device="cpu"),
                       device="cpu")
    for e in port_cache.entries():
        assert e["device"] == "cpu" and e["resolved_backend"] == "batch"
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_cache.save(str(ref_path))
    port_cache.save(str(port_path))
    assert json.loads(port_path.read_text())["version"] == 1

    from_ref = p_deploy.PlanCache.load(str(ref_path))
    from_port = r_deploy.PlanCache.load(str(port_path))
    for rq, pq in zip(ref_reqs, port_reqs):
        ck = pq.cache_key()
        assert ck == rq.cache_key()
        assert ck in from_ref and ck in from_port
        assert _strip(from_ref.get(ck)) == _strip(ref_cache.get(ck))
        # the reference keeps the port's device fields, outside the key
        got = from_port.get(ck)
        assert got["device"] == "cpu" and got["resolved_backend"] == "batch"
        assert _strip(got) == _strip(port_cache.get(ck))
        assert got["placement"] == ref_cache.get(ck)["placement"]
        # a warm near miss finds the cross-loaded donor
        near = dataclasses.replace(pq, seed=pq.seed + 1)
        assert from_ref.find_warm(near)["cache_key"] == ck
    # and back again: a port cache re-saved by the reference reloads here
    from_port.save(str(port_path))
    again = p_deploy.PlanCache.load(str(port_path))
    assert [e["cache_key"] for e in again.entries()] == \
        [e["cache_key"] for e in port_cache.entries()]
