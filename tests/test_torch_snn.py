"""The port's SNN compute stack (``repro_torch.snn``) against the reference's
(``repro.snn``): surrogate spikes, the LIF step and its VJP, the layers, the
parameter layout and initialisation, and the model forward.

Inputs are made with numpy from a seed and handed to both packages; weights
are the reference's ``materialize`` draws carried across with
``from_reference_params``. The port computes in NCHW, so its activations and
states are permuted to the reference's NHWC before they are compared.

Spike parity needs margin: a spike flips wherever ``u'`` lands within float
error of the threshold. Each model test therefore first asserts, on the
reference's own run, that every LIF state of every timestep keeps
``|u' - θ| > 1e-4`` and (for the rect surrogate) ``||u' - θ| - α/2| > 1e-4``;
its inputs were chosen so that this holds. Then it compares spikes exactly.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.specs import materialize  # noqa: E402
from repro.snn import layers as r_layers, models as r_models  # noqa: E402
from repro.snn import neurons as r_neurons  # noqa: E402
from repro_torch.snn import layers as p_layers, models as p_models  # noqa: E402
from repro_torch.snn import neurons as p_neurons  # noqa: E402
from repro_torch.snn.bptt import make_optimizer, train_step  # noqa: E402

MARGIN = 1e-4


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(x):
    return _np(x).transpose(0, 2, 3, 1)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def reference_params(cfg, seed: int = 0):
    """``materialize(PRNGKey(seed), model_specs(cfg))`` as numpy, compiled as
    one program (eagerly each leaf's draw compiles on its own)."""
    specs = r_models.model_specs(cfg)
    return _np_tree(jax.jit(lambda key: materialize(key, specs))(
        jax.random.PRNGKey(seed)))


# ---- neurons ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rect", "sigmoid", "atan"])
def test_spike_and_its_surrogate_gradient_match_reference(kind):
    x = np.random.default_rng(0).standard_normal(257).astype(np.float32) * 2
    x[:3] = [0.0, 1.0, -1.0]          # the spike edge and the rect window's
    t = torch.tensor(x, requires_grad=True)
    out = p_neurons.spike(t, kind, 2.0)
    ref = r_neurons.spike(jnp.asarray(x), kind, 2.0)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    g = np.random.default_rng(1).standard_normal(257).astype(np.float32)
    (gt,) = torch.autograd.grad(out, t, torch.as_tensor(g))
    gr = jax.grad(lambda a: jnp.sum(r_neurons.spike(a, kind, 2.0) * g))(
        jnp.asarray(x))
    np.testing.assert_allclose(_np(gt), np.asarray(gr), rtol=1e-6, atol=0)


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("surrogate", ["rect", "sigmoid", "atan"])
def test_lif_step_and_its_vjp_match_reference(reset, surrogate):
    cfg_kw = dict(reset=reset, surrogate=surrogate, decay=0.7)
    rng = np.random.default_rng(2)
    shape = (3, 5, 7)
    u = rng.standard_normal(shape).astype(np.float32)
    s = (rng.random(shape) < 0.4).astype(np.float32)
    c = rng.standard_normal(shape).astype(np.float32)
    gu, gs = (rng.standard_normal(shape).astype(np.float32) for _ in "us")
    (ur, sr), vjp = jax.vjp(
        lambda a, b, d: r_neurons.lif_step(a, b, d,
                                           r_neurons.LIFConfig(**cfg_kw)),
        jnp.asarray(u), jnp.asarray(s), jnp.asarray(c))
    ref_grads = vjp((jnp.asarray(gu), jnp.asarray(gs)))
    tu, ts, tc = (torch.tensor(a, requires_grad=True) for a in (u, s, c))
    un, sn = p_neurons.lif_step(tu, ts, tc, p_neurons.LIFConfig(**cfg_kw))
    np.testing.assert_array_equal(_np(sn), np.asarray(sr))
    np.testing.assert_allclose(_np(un), np.asarray(ur), rtol=1e-6, atol=1e-7)
    grads = torch.autograd.grad((un, sn), (tu, ts, tc),
                                (torch.as_tensor(gu), torch.as_tensor(gs)))
    for name, got, want in zip("usI", grads, ref_grads):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_lif_step_vjp_with_one_cotangent():
    """Only the spike or only the membrane used downstream (the last
    timestep, the rate term): the missing cotangent counts as zero."""
    cfg = p_neurons.LIFConfig()
    u, s, c = (torch.rand(16, requires_grad=True) for _ in range(3))
    un, sn = p_neurons.lif_step(u, s, c, cfg)
    (g_from_s,) = torch.autograd.grad(sn.sum(), c, retain_graph=True)
    (g_from_u,) = torch.autograd.grad(un.sum(), c)
    assert torch.equal(g_from_u, torch.ones(16))
    window = ((un.detach() - 1.0).abs() < 1.0).float() / 2.0
    assert torch.equal(g_from_s, window)


def test_lif_rollout_matches_reference():
    rng = np.random.default_rng(5)
    cur = (rng.random((6, 4, 10)) * 1.4).astype(np.float32)
    cfg = dict(decay=0.6)
    got = p_neurons.lif_rollout(torch.as_tensor(cur),
                                p_neurons.LIFConfig(**cfg))
    want = r_neurons.lif_rollout(jnp.asarray(cur), r_neurons.LIFConfig(**cfg))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---- layers -----------------------------------------------------------------

@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (7, 2), (1, 2)])
@pytest.mark.parametrize("hw", [9, 16])
def test_conv2d_matches_reference(k, stride, hw):
    rng = np.random.default_rng(k * 100 + stride * 10 + hw)
    x = rng.standard_normal((2, hw, hw, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    ref = r_layers.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x), stride)
    out = p_layers.conv2d(
        {"w": torch.as_tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))},
        _nchw(x), stride)
    assert _nhwc(out).shape == ref.shape
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_batch_norm_avg_pool_and_linear_match_reference():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 4, 6)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(6).astype(np.float32) for _ in "sb")
    ref = r_layers.batch_norm({"scale": scale, "bias": bias}, jnp.asarray(x))
    out = p_layers.batch_norm({"scale": torch.as_tensor(scale),
                               "bias": torch.as_tensor(bias)}, _nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(p_layers.avg_pool_global(_nchw(x))),
                               np.asarray(r_layers.avg_pool_global(x)),
                               rtol=1e-5, atol=1e-6)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    h = x.reshape(-1, 6)
    np.testing.assert_allclose(
        _np(p_layers.linear({"w": torch.as_tensor(w), "b": torch.as_tensor(b)},
                            torch.as_tensor(h))),
        np.asarray(r_layers.linear({"w": w, "b": b}, jnp.asarray(h))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw,k,stride", [(1, 2, 2), (3, 2, 2), (3, 3, 2),
                                         (8, 3, 2), (8, 2, 2)])
def test_max_pool_matches_reference(hw, k, stride):
    """Binary spikes, as the model pools them: many ties in a window."""
    rng = np.random.default_rng(hw + k)
    x = (rng.random((2, hw, hw, 3)) < 0.5).astype(np.float32)
    ref = r_layers.max_pool(jnp.asarray(x), k, stride)
    out = p_layers.max_pool(_nchw(x), k, stride)
    np.testing.assert_array_equal(_nhwc(out), np.asarray(ref))


# ---- parameters -------------------------------------------------------------

def _cfg(arch, **kw):
    return getattr(r_models, arch)(**kw), getattr(p_models, arch)(**kw)


@pytest.mark.parametrize("arch", ["spike_vgg16", "spike_resnet18"])
def test_init_matches_reference_specs_and_distributions(arch):
    """Full width: every leaf's shape, ones and zeros exactly, and the std
    of every normal leaf of at least 4096 entries within 5% of the
    reference's draw (smaller leaves' sample stds scatter more than that)."""
    rcfg, pcfg = _cfg(arch)
    ref = reference_params(rcfg)
    net = p_models.init_model(pcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    port = p_models.to_reference_params(net)
    r_leaves = jax.tree_util.tree_leaves_with_path(ref)
    p_leaves = jax.tree_util.tree_leaves_with_path(port)
    assert [p for p, _ in r_leaves] == [p for p, _ in p_leaves]
    n_checked = 0
    for (path, a), (_, b) in zip(r_leaves, p_leaves):
        assert a.shape == b.shape, path
        if np.all(a == a.flat[0]):              # ones / zeros
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        elif a.size >= 4096:
            assert abs(b.std() / a.std() - 1) < 0.05, path
            n_checked += 1
    assert n_checked >= 10


def test_parameter_names_are_the_reference_paths():
    _, pcfg = _cfg("spike_resnet18", width_mult=0.125, in_res=8)
    net = p_models.init_model(pcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    names = [n for n, _ in net.named_parameters()]
    assert names == sorted(names)
    assert {"fc.b", "fc.w", "stem.conv.w", "s1b0.s1b0c1.bn.scale",
            "s1b0.s1b0down.conv.w"} <= set(names)
    w = dict(net.named_parameters())["s1b0.s1b0c1.conv.w"]
    assert tuple(w.shape) == (16, 8, 3, 3)       # OIHW of HWIO (3, 3, 8, 16)


def test_reference_params_round_trip_and_bad_trees_raise():
    rcfg, pcfg = _cfg("spike_vgg16", width_mult=0.125, in_res=8)
    ref = reference_params(rcfg, 3)
    net = p_models.from_reference_params(ref, pcfg, device="cpu")
    back = p_models.to_reference_params(net)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref),
                                 jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    missing = {k: v for k, v in ref.items() if k != "conv4"}
    with pytest.raises(ValueError, match="missing leaves.*conv4"):
        p_models.from_reference_params(missing, pcfg, device="cpu")
    surplus = dict(ref, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="surplus leaves.*extra"):
        p_models.from_reference_params(surplus, pcfg, device="cpu")
    inner = dict(ref, fc=dict(ref["fc"], bias=np.zeros(4, np.float32)))
    with pytest.raises(ValueError, match="fc: .*surplus leaves.*bias"):
        p_models.from_reference_params(inner, pcfg, device="cpu")
    bad = dict(ref, conv2=dict(ref["conv2"], conv={
        "w": np.zeros((3, 3, 8, 9), np.float32)}))
    with pytest.raises(ValueError, match=r"conv2\.conv\.w: shape"):
        p_models.from_reference_params(bad, pcfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        p_models.from_reference_params({}, pcfg, device="cpu")


# ---- model forward ----------------------------------------------------------

def reference_states(params, cfg, x):
    """The reference's per-timestep LIF states, stepping its ``model_step``
    (jitted) for ``cfg.T`` steps: a list of ``{name: (u, s)}``."""
    step = jax.jit(r_models.model_step, static_argnums=1)
    state = r_models.init_state(cfg, x.shape[0])
    out = []
    for _ in range(cfg.T):
        state, _ = step(params, cfg, state, x)
        out.append(_np_tree(state))
    return out


def assert_margins(states, lif):
    """The spike-parity precondition on the reference's run."""
    d = np.concatenate([np.abs(u - lif.threshold).ravel()
                        for st in states for u, _ in st.values()])
    assert d.min() > MARGIN, f"a membrane lands {d.min()} from threshold"
    if lif.surrogate == "rect":
        edge = np.abs(d - lif.surrogate_scale / 2).min()
        assert edge > MARGIN, f"a membrane lands {edge} from the rect edge"


# (arch, in_res, input seed): seeds chosen so that the margin holds
MODEL_CASES = [("spike_vgg16", 8, 9), ("spike_resnet18", 16, 5),
               ("spike_resnet50", 8, 5)]


@pytest.mark.parametrize("arch,in_res,seed", MODEL_CASES)
def test_model_step_and_rollout_match_reference(arch, in_res, seed):
    rcfg, pcfg = _cfg(arch, n_classes=10, in_res=in_res, T=2,
                      width_mult=0.125)
    params = reference_params(rcfg)
    x = np.random.default_rng(seed).random((4, in_res, in_res, 3),
                                           np.float32)
    states = reference_states(params, rcfg, jnp.asarray(x))
    assert_margins(states, rcfg.lif)
    net = p_models.from_reference_params(params, pcfg, device="cpu")
    assert p_models._shapes(pcfg, 4) == r_models._shapes(rcfg, 4)
    with torch.no_grad():
        state = p_models.init_state(pcfg, 4, device="cpu")
        for t, ref_state in enumerate(states):
            state, logits = p_models.model_step(net, pcfg, state,
                                                torch.as_tensor(x))
            assert sorted(state) == sorted(ref_state)
            for name, (u_r, s_r) in ref_state.items():
                u_p, s_p = state[name]
                np.testing.assert_array_equal(_nhwc(s_p), s_r,
                                              err_msg=f"t={t} {name}")
                np.testing.assert_allclose(_nhwc(u_p), u_r, rtol=1e-4,
                                           atol=1e-5, err_msg=f"t={t} {name}")
        logits, rate = net(torch.as_tensor(x))
    r_logits, r_rate = jax.jit(r_models.model_rollout, static_argnums=1)(
        params, rcfg, jnp.asarray(x))
    assert logits.shape == (4, 10)
    np.testing.assert_allclose(_np(logits), np.asarray(r_logits), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(rate), float(r_rate), rtol=1e-4,
                               atol=1e-5)


def test_own_rng_training_reduces_loss():
    """The reference's ``test_bptt_reduces_loss`` on the port's own draws."""
    cfg = p_models.spike_vgg16(n_classes=4, in_res=8, T=2, width_mult=0.125)
    net = p_models.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    opt = make_optimizer(net)
    x = torch.as_tensor(np.random.default_rng(1).random((8, 8, 8, 3),
                                                        np.float32))
    y = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3])
    losses = []
    for _ in range(8):
        net, opt, m = train_step(net, opt, x, y, cfg)
        losses.append(float(m["loss"]))
        assert 0.0 <= float(m["spike_rate"]) <= 1.0
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]


def test_entry_points_default_to_the_card():
    cfg = p_models.spike_vgg16(width_mult=0.125, in_res=8)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_models.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_models.init_state(cfg, 2)
