"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages; the reference runs its plain JAX functions (no Pallas on this
path). Routing ids, capacity, the dispatch order, ``keep``, slots and the
gathered buffer are exact; gates within 1e-6 (float32 softmax over the same
logits); outputs and aux within ``ATOL`` 2e-5 (float32, the combine summed
in another order). The reference's own ``tests/test_moe.py`` cases are held
on the port alone.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_reg  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.models import moe as p_moe  # noqa: E402
from repro_torch.models import specs as p_specs  # noqa: E402

ATOL = 2e-5
SMOKE_ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v3-671b"]


def _weights(d, cfg, seed):
    """numpy weights for ``moe_specs(d, cfg)`` at each leaf's init std."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) * p_specs.init_std(s))
            .astype(np.float32)
            for k, s in p_moe.moe_specs(d, cfg, torch.float32).items()}


def _pair(arch, cf=None, seed=0):
    """(reference MoEConfig, port MoEConfig, numpy weights, d_model) of the
    smoke config's MoE layer, optionally at capacity factor ``cf``."""
    rcfg = r_reg.get_smoke_config(arch)
    pcfg = p_reg.get_smoke_config(arch)
    rm, pm = rcfg.moe, pcfg.moe
    if cf is not None:
        rm = dataclasses.replace(rm, capacity_factor=cf)
        pm = dataclasses.replace(pm, capacity_factor=cf)
    return rm, pm, _weights(pcfg.d_model, pm, seed), pcfg.d_model


def _x(d, seed, b=2, s=24):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _torch(w):
    return {k: torch.tensor(v) for k, v in w.items()}


def _jax(w):
    return {k: jnp.asarray(v) for k, v in w.items()}


@pytest.mark.parametrize("cf", [None, 1.25])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_routing_and_dispatch_metadata_exact(arch, cf):
    """Router, capacity and dispatch on the same inputs: ids, order, keep,
    slots and the buffer exact, with drops at cf 1.25 and none at the smoke
    config's dropless 4.0."""
    rm, pm, w, d = _pair(arch, cf)
    x = _x(d, 1, s=40) + 1.0    # a shared offset skews the loads
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    r_top_p, r_ids, r_dens, r_mean = r_moe._route(_jax(w), jnp.asarray(xf),
                                                  rm)
    p_top_p, p_ids, p_dens, p_mean = p_moe._route(_torch(w), torch.tensor(xf),
                                                  pm)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(p_top_p.numpy(), np.asarray(r_top_p),
                               atol=1e-6)
    np.testing.assert_array_equal(p_dens.numpy(), np.asarray(r_dens))
    np.testing.assert_allclose(p_mean.numpy(), np.asarray(r_mean), atol=1e-7)
    cap = p_moe._capacity(t, pm)
    assert cap == r_moe._capacity(t, rm)
    # the same ids and gates into both dispatches
    ids, gates = np.asarray(r_ids), np.asarray(r_top_p)
    r_buf, (st, r_slot, r_keep, r_sg) = r_moe._dispatch(
        jnp.asarray(xf), jnp.asarray(ids), jnp.asarray(gates), rm.n_experts,
        cap)
    p_buf, (order, p_slot, p_keep, p_sg) = p_moe._dispatch(
        torch.tensor(xf), torch.tensor(ids).long(), torch.tensor(gates),
        pm.n_experts, cap)
    np.testing.assert_array_equal((order // pm.top_k).numpy(), np.asarray(st))
    np.testing.assert_array_equal(p_slot.numpy(), np.asarray(r_slot))
    np.testing.assert_array_equal(p_keep.numpy(), np.asarray(r_keep))
    np.testing.assert_array_equal(p_sg.numpy(), np.asarray(r_sg))
    np.testing.assert_array_equal(p_buf.numpy(), np.asarray(r_buf))
    dropped = int((~p_keep).sum())
    if cf is None:
        assert dropped == 0
    else:
        assert dropped > 0, "cf 1.25 at this shape should drop assignments"


@pytest.mark.parametrize("cf", [None, 1.25, 0.25])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    rm, pm, w, d = _pair(arch, cf, seed=2)
    x = _x(d, 3) + 0.5
    r_out, r_aux = r_moe.moe_apply(_jax(w), jnp.asarray(x), rm)
    p_out, p_aux = p_moe.moe_apply(_torch(w), torch.tensor(x), pm)
    assert p_out.shape == x.shape and p_out.dtype == torch.float32
    assert p_aux.dtype == torch.float32 and p_aux.dim() == 0
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), atol=ATOL)
    np.testing.assert_allclose(float(p_aux), float(r_aux), atol=ATOL)


def test_combine_repeats_under_deterministic_algorithms():
    _, pm, w, d = _pair("deepseek-v3-671b", 1.25, seed=4)
    x = torch.tensor(_x(d, 5))
    first, aux = p_moe.moe_apply(_torch(w), x, pm)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        again, aux2 = p_moe.moe_apply(_torch(w), x, pm)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(first, again) and torch.equal(aux, aux2)


def test_router_stays_float32_in_a_bf16_layer():
    specs = p_moe.moe_specs(16, p_moe.MoEConfig(8, 2, 32), torch.bfloat16)
    assert specs["router"].dtype == torch.float32
    assert specs["w_gate"].dtype == torch.bfloat16
    params = p_specs.materialize(specs, torch.Generator().manual_seed(0),
                                 device="cpu")
    x = torch.randn(1, 5, 16, generator=torch.Generator().manual_seed(1))
    out, aux = p_moe.moe_apply(params, x.bfloat16(), p_moe.MoEConfig(8, 2,
                                                                     32))
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all())


# ---- the reference's tests/test_moe.py cases, on the port ---------------------

def _setup(e=8, k=2, d=16, f=32, cf=4.0, n_shared=0, seed=0):
    cfg = p_moe.MoEConfig(n_experts=e, top_k=k, d_ff=f, n_shared=n_shared,
                          capacity_factor=cf)
    return cfg, _torch(_weights(d, cfg, seed))


def _dense_moe(params, x, cfg):
    """Dense (all-experts) oracle: gates times every expert's output, no
    capacity."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf @ params["router"], dim=-1)
    top_p, top_ids = torch.topk(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    g = torch.einsum("td,edf->tef", xf, params["w_gate"])
    u = torch.einsum("td,edf->tef", xf, params["w_up"])
    y_all = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u,
                         params["w_down"])
    wts = torch.zeros(xf.shape[0], cfg.n_experts).scatter(1, top_ids, top_p)
    return torch.einsum("te,ted->td", wts, y_all).reshape(b, s, d)


def _randn(seed, *shape):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape)
                        .astype(np.float32))


def test_dropless_matches_dense_reference():
    cfg, params = _setup(cf=4.0)       # cf >= E/k: no drops possible
    x = _randn(1, 2, 10, 16)
    out, _ = p_moe.moe_apply(params, x, cfg)
    np.testing.assert_allclose(out.numpy(), _dense_moe(params, x, cfg)
                               .numpy(), atol=1e-5)


def test_shared_expert_added():
    cfg, params = _setup(n_shared=1)
    x = _randn(2, 1, 6, 16)
    out, _ = p_moe.moe_apply(params, x, cfg)
    cfg0, _ = _setup(n_shared=0)
    out0, _ = p_moe.moe_apply({k: v for k, v in params.items()
                               if not k.startswith("shared")}, x, cfg0)
    assert float((out - out0).abs().max()) > 1e-6


def test_capacity_drops_bounded():
    cfg, params = _setup(cf=0.25)
    x = _randn(3, 2, 32, 16)
    out, _ = p_moe.moe_apply(params, x, cfg)
    assert bool(torch.isfinite(out).all())
    out_full, _ = p_moe.moe_apply(params, x, _setup(cf=4.0)[0])
    assert float(out.abs().mean()) <= float(out_full.abs().mean()) + 1e-6


def test_aux_loss_uniform_vs_skewed():
    cfg, params = _setup(e=4, k=1, d=8, f=16)
    x = _randn(4, 4, 64, 8).abs() + 0.1
    _, aux_uniform = p_moe.moe_apply(params, x, cfg)
    skew = dict(params)
    skew["router"] = torch.zeros_like(params["router"])
    skew["router"][:, 0] = 100.0
    _, aux_skew = p_moe.moe_apply(skew, x, cfg)
    assert float(aux_skew) > float(aux_uniform)
    assert float(aux_skew) == pytest.approx(
        cfg.aux_loss_coef * cfg.n_experts, rel=0.05)


@pytest.mark.parametrize("n_tokens", [1, 64, 8192])
def test_capacity_rounding(n_tokens):
    cfg = p_moe.MoEConfig(n_experts=8, top_k=2, d_ff=8, capacity_factor=1.25)
    c = p_moe._capacity(n_tokens, cfg)
    assert c % 8 == 0 and c >= max(8, n_tokens * 2 * 1.25 / 8)
    assert c == r_moe._capacity(n_tokens, r_moe.MoEConfig(8, 2, 8))
    qwen = p_reg.get_config("qwen3-moe-30b-a3b").moe
    assert p_moe._capacity(4 * 2048, qwen) == 640
    assert p_moe._capacity(4, qwen) == 8


def test_moe_grads_flow_to_router_and_experts():
    cfg, params = _setup()
    for v in params.values():
        v.requires_grad_(True)
    out, aux = p_moe.moe_apply(params, _randn(5, 1, 8, 16), cfg)
    ((out ** 2).sum() + aux).backward()
    for k in ("router", "w_gate", "w_down"):
        assert float(params[k].grad.abs().max()) > 0, k
