"""The port's checkpoint store against the JAX package's, on the CPU.

The reference's own cases (roundtrip, restart continuation bit for bit,
retention, async save, atomic commit, missing directory) are held on the
port; checkpoints the reference writes (float32, bfloat16 as raw 2-byte
bits, int8 moments, the int32 step) restore into the port exactly, under
the reference's ``/``-joined keys.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as r_store  # noqa: E402
from repro.train import optim as r_optim  # noqa: E402
from repro_torch.checkpoint import store as p_store  # noqa: E402
from repro_torch.models.specs import materialize, param  # noqa: E402
from repro_torch.train import optim as p_optim  # noqa: E402


def _tree(seed, dtype=torch.float32):
    specs = {"layer": {"w": param((4, 8), ("embed", "mlp"), dtype=dtype),
                       "b": param((8,), ("mlp",), init="zeros")},
             "head": param((8, 3), ("mlp", "vocab"), dtype=dtype)}
    return materialize(specs, torch.Generator().manual_seed(seed),
                       device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          path + (k,))]
    return [(path, tree)]


def _same(a, b):
    for (pa, x), (pb, y) in zip(_leaves(a), _leaves(b)):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roundtrip(tmp_path, dtype):
    t = _tree(0, dtype)
    p_store.save(str(tmp_path), 7, {"params": t}, extra={"data_step": 7})
    restored, step, extra = p_store.restore(str(tmp_path), {"params": t})
    assert step == 7 and extra["data_step"] == 7
    _same(t, restored["params"])


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_restart_continuation_bitwise(tmp_path, state_dtype):
    """Train 6 steps straight == train 3, checkpoint, restore, train 3
    more, with every moment storage."""
    cfg = p_optim.AdamWConfig(lr=1e-2, state_dtype=state_dtype)

    def run(params, opt, steps, start=0):
        for i in range(start, steps):
            g = {k: {kk: torch.ones_like(p) * (i + 1) * 0.1
                     for kk, p in v.items()} if isinstance(v, dict)
                 else torch.ones_like(v) * (i + 1) * 0.1
                 for k, v in params.items()}
            params, opt = p_optim.adamw_update(g, opt, params, cfg)
        return params, opt

    p_straight, o_straight = run(*_fresh(cfg), 6)
    p_half, o_half = run(*_fresh(cfg), 3)
    p_store.save(str(tmp_path), 3, {"p": p_half, "o": o_half})
    template = dict(zip(("p", "o"), _fresh(cfg)))
    restored, step, _ = p_store.restore(str(tmp_path), template)
    p_resumed, o_resumed = run(restored["p"], restored["o"], 6, start=step)
    _same(p_straight, p_resumed)
    _same(o_straight, o_resumed)


def _fresh(cfg):
    params = _tree(1)
    return params, p_optim.adamw_init(params, cfg)


def test_retention(tmp_path):
    t = {"x": torch.zeros(2)}
    for s in range(6):
        p_store.save(str(tmp_path), s, t, keep=3)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4, 5]
    assert p_store.latest_step(str(tmp_path)) == 5


def test_async_save_copies_before_returning(tmp_path):
    """The host copy is taken on the caller's thread: the training loop may
    update the tensors in place right after ``save_async``."""
    t = _tree(2)
    before = t["head"].clone()
    p_store.save_async(str(tmp_path), 11, {"params": t})
    t["head"].add_(1.0)
    p_store.wait()
    restored, step, _ = p_store.restore(str(tmp_path), {"params": t})
    assert step == 11
    assert torch.equal(restored["params"]["head"], before)


def test_atomicity_and_missing(tmp_path):
    p_store.save(str(tmp_path), 1, {"x": torch.arange(4.0)})
    assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))
    with pytest.raises(FileNotFoundError):
        p_store.restore(str(tmp_path / "nope"), {"x": torch.zeros(1)})
    # a leaf whose sharding is None restores as a plain tensor
    restored, _, _ = p_store.restore(str(tmp_path), {"x": torch.zeros(4)},
                                     shardings={"x": None})
    assert torch.equal(restored["x"], torch.arange(4.0))


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_reference_written_checkpoint_restores_exactly(tmp_path,
                                                       state_dtype):
    """The reference saves float32 and bfloat16 parameters and its AdamW
    state after one update; the port restores every leaf bit for bit."""
    key = jax.random.PRNGKey(0)
    params = {"w": jax.random.normal(key, (4, 8)).astype(jnp.bfloat16),
              "b": jax.random.normal(jax.random.PRNGKey(1), (8,)),
              "stack": {"k": jax.random.normal(jax.random.PRNGKey(2),
                                               (2, 3, 4))}}
    cfg = r_optim.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    opt = r_optim.adamw_init(params, cfg)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.3, params)
    params, opt = r_optim.adamw_update(grads, opt, params, cfg)
    r_store.save(str(tmp_path), 4, {"params": params, "opt": opt},
                 extra={"data_step": 4})

    like = {"w": torch.zeros(4, 8, dtype=torch.bfloat16),
            "b": torch.zeros(8), "stack": {"k": torch.zeros(2, 3, 4)}}
    template = {"params": like,
                "opt": p_optim.adamw_init(
                    like, p_optim.AdamWConfig(state_dtype=state_dtype))}
    got, step, extra = p_store.restore(str(tmp_path), template)
    assert step == 4 and extra == {"data_step": 4}
    want = {"params": params, "opt": opt}
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, leaf in _leaves(got):
        ref = next(v for p, v in flat_want.items()
                   if tuple(str(getattr(k, "key", k)) for k in p) == path)
        assert leaf.dtype == _dtype_at(template, path)
        if leaf.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                leaf.view(torch.int16).numpy(),
                np.asarray(ref).view(np.int16))
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))


def _dtype_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree.dtype


def test_port_writes_bfloat16_as_two_byte_bits(tmp_path):
    t = {"w": torch.randn(3, 5).to(torch.bfloat16)}
    final = p_store.save(str(tmp_path), 2, t)
    with np.load(os.path.join(final, "arrays.npz")) as data:
        arr = data["w"]
    assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2
    np.testing.assert_array_equal(arr.view(np.int16),
                                  t["w"].view(torch.int16).numpy())
