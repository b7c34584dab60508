"""The port's BPTT training step (``repro_torch.snn.bptt``) against the
reference's (``repro.snn.bptt``), on small Spike-VGG16 and Spike-ResNet18
with the reference's weights carried across.

The first step's loss, cross-entropy, spike rate and every parameter
gradient are held within rtol 1e-4 / atol 1e-6, then the losses of three
``train_step`` calls within rtol 1e-3: Adam's first step turns a tiny
gradient into a full-size step, so later losses carry float noise of that
size. As in ``tests/test_torch_snn.py``, the test first asserts the margin
precondition on the reference's first forward (no membrane within 1e-4 of
the threshold or of the rect window's edge); the input seeds were chosen so
that it holds.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.specs import materialize  # noqa: E402
from repro.snn import bptt as r_bptt, models as r_models  # noqa: E402
from repro_torch.snn import bptt as p_bptt, models as p_models  # noqa: E402

MARGIN = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _margins(params, cfg, x):
    """min |u' - θ| and min ||u' - θ| - α/2| over every LIF state of every
    timestep of the reference's forward."""
    step = jax.jit(r_models.model_step, static_argnums=1)
    state = r_models.init_state(cfg, x.shape[0])
    d = []
    for _ in range(cfg.T):
        state, _ = step(params, cfg, state, x)
        d += [np.abs(np.asarray(u) - cfg.lif.threshold).ravel()
              for u, _ in state.values()]
    d = np.concatenate(d)
    return d.min(), np.abs(d - cfg.lif.surrogate_scale / 2).min()


# (arch, in_res, input seed): seeds chosen so that the margin holds
CASES = [("spike_vgg16", 8, 33), ("spike_resnet18", 8, 1)]


@pytest.mark.parametrize("arch,in_res,seed", CASES)
def test_train_step_matches_reference(arch, in_res, seed):
    kw = dict(n_classes=4, in_res=in_res, T=2, width_mult=0.125)
    rcfg = getattr(r_models, arch)(**kw)
    pcfg = getattr(p_models, arch)(**kw)
    specs = r_models.model_specs(rcfg)
    params = _np_tree(jax.jit(lambda k: materialize(k, specs))(
        jax.random.PRNGKey(0)))
    x = np.random.default_rng(seed).random((8, in_res, in_res, 3),
                                           np.float32)
    y = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    d_th, d_edge = _margins(params, rcfg, jx)
    assert d_th > MARGIN and d_edge > MARGIN, (d_th, d_edge)

    (r_loss, (r_ce, r_rate)), r_grads = jax.jit(
        jax.value_and_grad(r_bptt.loss_fn, has_aux=True),
        static_argnums=1)(params, rcfg, jx, jy, 0.0)
    net = p_models.from_reference_params(params, pcfg, device="cpu")
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    loss, ce, rate, grads = p_bptt.loss_and_grads(net, pcfg, tx, ty)
    for name, got, want in (("loss", loss, r_loss), ("ce", ce, r_ce),
                            ("rate", rate, r_rate)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    port_grads = p_models.to_reference_params(net, grads)
    r_leaves = jax.tree_util.tree_leaves_with_path(_np_tree(r_grads))
    p_leaves = jax.tree_util.tree_leaves_with_path(port_grads)
    assert [p for p, _ in r_leaves] == [p for p, _ in p_leaves]
    for (path, want), (_, got) in zip(r_leaves, p_leaves):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))

    r_params, r_opt = params, r_bptt.make_optimizer(params)
    opt = p_bptt.make_optimizer(net)
    for step in range(3):
        r_params, r_opt, r_m = r_bptt.train_step(r_params, r_opt, jx, jy,
                                                 rcfg)
        net, opt, m = p_bptt.train_step(net, opt, tx, ty, pcfg)
        np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]),
                                   rtol=1e-3, err_msg=f"step {step}")
    assert opt.step == 3
