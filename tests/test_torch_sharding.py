"""The port's sharding layer (``repro_torch.sharding.rules``,
``launch.mesh``) and what runs on a mesh, against the JAX package's, on the
CPU.

Exact: ``spec_partition`` equals the reference's ``PartitionSpec`` (as
tuples) for the reference's property strategy and on every leaf of every
registry config's full-size specs, on the production mesh shapes under
both rule tables; ``batch_partition`` likewise; each rank's rows of a
sharded batch equal the reference's shard for the same device; checkpoints
restore onto another mesh bit for bit.

Tolerance: one gloo world of 8 CPU ranks (``tests/torch_mesh_worker.py``,
a subprocess; every collective has a 60 s timeout, the subprocess 240 s)
runs the sharded train step (internlm2's smoke config, a 2 x 4 mesh,
batch 8 x 16) within the reference test's bounds of the single-device
steps, parameters 2e-3 and loss 1e-3; MoE expert parallelism within 1e-5
of the single-device path, forward and gradients (relative to the largest
entry where that passes 1), and of the reference's ``moe_apply``; and ``launch.train --mesh 2x4``'s losses within
the launcher bound of ``test_torch_train.py`` (1e-4) of the reference's
launcher on 8 host devices. The reference's shards and launcher run in a
subprocess with ``--xla_force_host_platform_device_count=8``, as
``tests/test_sharding.py`` does.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as r_store  # noqa: E402
from repro.configs import registry as r_reg  # noqa: E402
from repro.models import encdec as r_encdec  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models.specs import ParamSpec, materialize, param  # noqa: E402
from repro.sharding import rules as r_rules  # noqa: E402
from repro.train import optim as r_optim  # noqa: E402
from repro.train import step as r_step  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.models import encdec as p_encdec  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models import moe as p_moe  # noqa: E402
from repro_torch.models import specs as p_specs  # noqa: E402
from repro_torch.sharding import rules as p_rules  # noqa: E402
from repro_torch.train import optim as p_optim  # noqa: E402
from repro_torch.train import step as p_step  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYP = True
except ImportError:
    HAS_HYP = False

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"base": "BASE_RULES", "fsdp": "FSDP_RULES"}


def _as_tuple(spec):
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in spec)


def _port_spec(s: ParamSpec):
    return p_specs.ParamSpec(tuple(s.shape), torch.float32, tuple(s.axes))


# ---- the rules, exact ---------------------------------------------------------

def _spec_leaves(tree, path=()):
    if isinstance(tree, ParamSpec):
        return [(path, tree)]
    return [x for k in sorted(tree) for x in _spec_leaves(tree[k],
                                                          path + (k,))]


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(r_reg.ARCHS))
def test_spec_partition_equals_reference_on_every_config(arch, mesh, rules):
    """Every leaf of the config's full-size specs."""
    cfg = r_reg.get_config(arch)
    specs = (r_encdec.encdec_specs(cfg)
             if isinstance(cfg, r_encdec.EncDecConfig) else r_lm.lm_specs(cfg))
    fm = FakeMesh(MESHES[mesh])
    rr, pr = getattr(r_rules, RULES[rules]), getattr(p_rules, RULES[rules])
    leaves = _spec_leaves(specs)
    assert leaves
    for path, s in leaves:
        want = _as_tuple(r_rules.spec_partition(fm, s, rr))
        assert p_rules.spec_partition(fm, _port_spec(s), pr) == want, path


if HAS_HYP:
    AXES = st.sampled_from(["embed", "mlp", "heads", "kv_heads", "vocab",
                            "expert", "layers", "head_dim", "batch",
                            "cache_seq"])

    @given(st.lists(st.tuples(st.integers(1, 64), AXES), min_size=1,
                    max_size=4))
    @settings(max_examples=60, deadline=None)
    def test_spec_partition_equals_reference_on_the_property_strategy(
            dims_axes):
        """The reference's strategy; its properties (no reuse, divisible)
        follow from equality."""
        fm = FakeMesh({"data": 4, "model": 2, "pod": 2})
        shape = tuple(d for d, _ in dims_axes)
        axes = tuple(a for _, a in dims_axes)
        want = r_rules.spec_partition(
            fm, ParamSpec(shape, jnp.float32, axes), r_rules.BASE_RULES)
        got = p_rules.spec_partition(
            fm, p_specs.ParamSpec(shape, torch.float32, axes),
            p_rules.BASE_RULES)
        assert got == _as_tuple(want)


def test_kv_heads_fall_back_to_replication():
    fm = FakeMesh({"data": 16, "model": 16})
    s = p_specs.ParamSpec((2048, 4, 128), torch.float32,
                          ("embed", "kv_heads", "head_dim"))
    got = p_rules.spec_partition(fm, s, p_rules.BASE_RULES)
    assert got == (None, None, None)
    assert got == _as_tuple(r_rules.spec_partition(
        fm, ParamSpec(s.shape, jnp.float32, s.axes), r_rules.BASE_RULES))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("ndim,seq_axis,batch_size,axes", [
    (2, None, None, ("pod", "data")), (3, None, 32, ("pod", "data")),
    (3, None, 16, ("pod", "data")), (3, None, 1, ("pod", "data")),
    (3, None, 6, ("pod", "data")), (4, 1, 64, ("pod", "data")),
    (3, 1, 3, ("pod", "data")), (3, None, 512, ("pod", "data", "model")),
    (3, None, 48, ("pod", "data", "model"))])
def test_batch_partition_equals_reference(mesh, ndim, seq_axis, batch_size,
                                          axes):
    """Divisible and non-divisible batch sizes (the fall-back to fewer
    axes), with and without a sequence axis."""
    fm = FakeMesh(MESHES[mesh])
    want = r_rules.batch_partition(fm, ndim, seq_axis,
                                   batch_size=batch_size, axes=axes)
    assert p_rules.batch_partition(fm, ndim, seq_axis, batch_size=batch_size,
                                   axes=axes) == _as_tuple(want)


def test_placements_shard_pod_major_and_refuse_other_orders():
    from torch.distributed.tensor import Replicate, Shard

    class Names:
        mesh_dim_names = ("pod", "data", "model")
    assert p_rules.placements(Names(), (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert p_rules.placements(Names(), (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        p_rules.placements(Names(), (("data", "pod"), None))


def test_hooks_are_identities_without_a_mesh_or_on_plain_tensors():
    x = torch.randn(4, 8, 16)
    assert p_rules.activation_constraint(x) is x
    assert p_rules.kv_replicated_constraint(x) is x
    assert p_rules.dim_constraint(x, 1) is x
    with p_rules.set_context(FakeMesh({"data": 2, "model": 4}),
                             seq_shard=True):
        assert p_rules.activation_constraint(x) is x
        assert p_rules.kv_replicated_constraint(x) is x
        assert p_rules.dim_constraint(x, 1) is x
    assert p_rules.context_mesh() is None


def test_set_context_turns_on_the_librarys_implicit_replication():
    """The switch ``set_context`` reads is the one DTensor's own
    ``implicit_replication`` sets (a private attribute: this fails loudly if
    a torch release drops it); a context inside another leaves the outer
    one's switch on, and the outermost turns it off on exit."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def on():
        return DTensor._op_dispatcher._allow_implicit_replication

    assert on() is False
    with implicit_replication():
        assert on() is True
    assert on() is False
    fake = FakeMesh({"data": 2, "model": 4})
    with p_rules.set_context(fake):
        assert on() is True
        with p_rules.set_context(fake, seq_shard=True):
            assert on() is True
        assert on() is True
    assert on() is False


def test_production_meshes_over_a_fake_world():
    """``make_production_mesh`` on a 512-rank world of the fake backend
    (no process runs the others): ``(16, 16)`` over ``("data", "model")``
    and ``(2, 16, 16)`` over ``("pod", "data", "model")``, the reference's;
    with a placement, logical position ``i`` is served by rank
    ``placement[i]``; too few ranks raise."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=512)
    try:
        single, multi = make_production_mesh(), make_production_mesh(
            multi_pod=True)
        assert tuple(single.mesh.shape) == (16, 16)
        assert single.mesh_dim_names == ("data", "model")
        assert tuple(multi.mesh.shape) == (2, 16, 16)
        assert multi.mesh_dim_names == ("pod", "data", "model")
        perm = np.random.default_rng(0).permutation(256)
        placed = make_production_mesh(placement=perm)
        np.testing.assert_array_equal(placed.mesh.flatten().numpy(), perm)
        assert list(placed.get_coordinate()) == [
            int(i) for i in np.argwhere(perm.reshape(16, 16) == 3)[0]]
        with pytest.raises(ValueError, match="need 256 devices"):
            make_production_mesh(devices=range(100))
    finally:
        dist.destroy_process_group()


# ---- the gloo world ----------------------------------------------------------------

REF_CODE = """
import sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, SRC)
import repro.launch.train as launch
from repro.data.pipeline import DataConfig, batch_for_step
from repro.launch.mesh import make_test_mesh
from jax.sharding import Mesh

out = {}
cfg = DataConfig(vocab=97, batch=8, seq_len=12, seed=3)
meshes = {"2x4": make_test_mesh((2, 4), ("data", "model")),
          "2x2x2": Mesh(np.asarray(jax.devices()[:8], dtype=object)
                        .reshape(2, 2, 2), ("pod", "data", "model"))}
for name, mesh in meshes.items():
    for step in (0, 5):
        tokens, labels = batch_for_step(cfg, step, mesh)
        for kind, arr in (("tokens", tokens), ("labels", labels)):
            for sh in arr.addressable_shards:
                out[f"batch/{name}/{step}/{kind}/{sh.device.id}"] = \\
                    np.asarray(sh.data)

losses = []
class Jax:  # the launcher's jax, whose jit records each step's loss
    def __getattr__(self, name):
        return getattr(jax, name)
    @staticmethod
    def jit(fn, **kw):
        step = jax.jit(fn, **kw)
        def recorded(*args):
            res = step(*args)
            losses.append(float(res[2]["loss"]))
            return res
        return recorded
launch.jax = Jax()
launch.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "6",
             "--batch", "8", "--seq", "32", "--mesh", "2x4"])
out["launch/losses"] = np.array(losses)
np.savez(OUT, **out)
"""


def _np(tree, prefix, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)


FSDP_CLIP = 0.5      # the FSDP step's global-norm clip; the norm exceeds it
# the xLSTM (1, 8) step's gradients against one device's, each over its
# own largest entry: read 1.56e-6 to 1.07e-5 (torch 2.13, CPU)
XLSTM_GRAD_TOL = 3e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs from the reference, the 8-rank gloo world's results (one
    ``dict`` a rank) and the reference's sharded results."""
    d = str(tmp_path_factory.mktemp("mesh"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"SRC, OUT = {SRC!r}, {os.path.join(d, 'ref.npz')!r}\n" + REF_CODE
    ref_proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    inp = {}
    cfg = r_reg.get_smoke_config("internlm2-1.8b")
    _np(materialize(jax.random.PRNGKey(0), r_lm.lm_specs(cfg)), "params",
        inp)
    inp["step/tokens"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab))
    inp["step/labels"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (8, 16), 0, cfg.vocab))
    inp["fsdp/clip"] = np.array(FSDP_CLIP)
    mcfg = r_moe.MoEConfig(n_experts=8, top_k=2, d_ff=32,
                           capacity_factor=4.0)
    _np(materialize(jax.random.PRNGKey(0),
                    r_moe.moe_specs(16, mcfg, jnp.float32)), "moe/params",
        inp)
    inp["moe/x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                (4, 8, 16)))
    inp["moe/ct"] = np.random.default_rng(0).standard_normal(
        (4, 8, 16)).astype(np.float32)
    tree = materialize(jax.random.PRNGKey(0),
                       {"w": param((16, 8), ("embed", "mlp")),
                        "e": param((32, 16), ("vocab", "embed"))})
    _np(tree, "elastic", inp)
    r_store.save(os.path.join(d, "ref_ckpt"), 1, tree)
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    try:
        run = subprocess.run(
            [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"), d],
            env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
            text=True, timeout=240)
        ref_out, ref_err = ref_proc.communicate(timeout=240)
    finally:
        ref_proc.kill()
    assert run.returncode == 0, run.stderr[-4000:]
    assert ref_proc.returncode == 0, ref_err[-4000:]
    ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
             for r in range(8)]
    return {"inputs": inp, "ranks": ranks,
            "ref": dict(np.load(os.path.join(d, "ref.npz")))}


def _case(world, name):
    for r, res in enumerate(world["ranks"]):
        assert f"{name}/error" not in res, (r, str(res[f"{name}/error"]))
    return world["ranks"]


def _inp_tree(inp, prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix + "/"):
            node, parts = out, k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def _single_device_steps(inp, **adam):
    """One AdamW step (``AdamWConfig(lr=1e-3, **adam)``) of internlm2's
    smoke config on one device, the reference's and the port's: for each,
    ``(params, grads, loss, m, v)``, the trees flat by path under
    ``step/params``, ``step/grads``, ``m`` and ``v``."""
    rcfg = r_reg.get_smoke_config("internlm2-1.8b")
    pcfg = p_reg.get_smoke_config("internlm2-1.8b")
    rparams = _inp_tree(inp, "params")
    batch = {k: inp[f"step/{k}"] for k in ("tokens", "labels")}
    rt = r_step.TrainConfig(adam=r_optim.AdamWConfig(lr=1e-3, **adam))
    rstep = r_step.make_train_step(
        lambda p, bt: r_lm.lm_loss(p, rcfg, bt["tokens"], bt["labels"]), rt)
    rjp = jax.tree_util.tree_map(jnp.asarray, rparams)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    r1, ropt, rm = jax.jit(rstep)(rjp, r_optim.adamw_init(rjp, rt.adam),
                                  rbatch)
    rg = jax.jit(jax.grad(lambda p: r_lm.lm_loss(
        p, rcfg, rbatch["tokens"], rbatch["labels"])[0]))(rjp)
    pt = p_step.TrainConfig(adam=p_optim.AdamWConfig(lr=1e-3, **adam))
    pp = p_lm.from_reference_params(pcfg, rparams, device="cpu")
    pb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    leaves = [t.requires_grad_() for _, t in p_specs.tree_leaves(pp)]
    pg = torch.autograd.grad(
        p_lm.lm_loss(pp, pcfg, pb["tokens"], pb["labels"])[0], leaves)
    p1, popt, pm = p_step.make_train_step(
        lambda p, bt: p_lm.lm_loss(p, pcfg, bt["tokens"], bt["labels"]),
        pt)(pp, p_optim.adamw_init(pp, pt.adam), pb)

    def named(prefix, tree):
        return {"/".join((prefix,) + path): np.asarray(
            t.detach() if isinstance(t, torch.Tensor) else t)
            for path, t in p_specs.tree_leaves(tree)}
    return {
        "reference": (named("step/params", r1), named("step/grads", rg),
                      float(rm["loss"]), named("m", ropt["m"]),
                      named("v", ropt["v"])),
        "port": (named("step/params", p1),
                 {"/".join(("step/grads",) + path): g.numpy()
                  for (path, _), g in zip(p_specs.tree_leaves(pp), pg)},
                 float(pm["loss"]), named("m", popt["m"]),
                 named("v", popt["v"]))}


def test_sharded_train_step_matches_single_device(world):
    """2 x 4 mesh against the port's and the reference's single-device
    steps. The gradients the step took within 1e-5 of each gradient's
    largest entry, the mesh's own check (one AdamW step moves a parameter
    by less than lr = 1e-3 whatever the gradient, so the parameters'
    bound cannot tell gradients apart); then the reference test's bounds,
    parameters within 2e-3 and loss within 1e-3; the moments carry the
    parameters' placements."""
    ranks = _case(world, "step")
    single = _single_device_steps(world["inputs"])
    for r, res in enumerate(ranks):
        assert str(res["step/opt_placements"][0]) == \
            "(Replicate(), Replicate())"
        for who, (params, grads, loss, _, _) in single.items():
            assert len(grads) == len(params)
            ggap = max(float(np.abs(res[k] - g).max() / np.abs(g).max())
                       for k, g in grads.items())
            gap = max(float(np.abs(res[k] - v).max())
                      for k, v in params.items())
            lgap = abs(float(res["step/loss"]) - loss)
            print(f"rank {r} vs {who}: GRADDIFF {ggap:.3g} of the largest "
                  f"entry, MAXDIFF {gap:.3g} LOSSDIFF {lgap:.3g}")
            assert ggap < 1e-5
            assert gap < 2e-3 and lgap < 1e-3


def test_fsdp_layout_trains_as_the_replicated_step(world):
    """ZeRO-3 in the same world: the step of
    ``test_sharded_train_step_matches_single_device`` with the parameters
    laid out by ``FSDP_RULES`` (``embed`` over ``data``) and
    ``set_context(..., fsdp=True)``, each layer's parameters gathered
    where they are used. Its gradients within 1e-5 of each one's largest
    entry, and its loss within 1e-6, of the replicated step's; the
    gradients keep the parameters' shards. The update it made on the
    sharded leaves (AdamW, global-norm clip ``FSDP_CLIP``, which the
    gradients' norm exceeds twice over) against the same step on one device, the
    port's and the reference's: each first and second moment within 1e-5
    of its largest entry (they carry the clip's scale), the parameters
    within the reference test's 2e-3."""
    ranks = _case(world, "fsdp")
    clip = FSDP_CLIP
    single = _single_device_steps(world["inputs"], grad_clip=clip)
    for who, (_, grads, _, _, _) in single.items():
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in grads.values()))
        assert norm > 2 * clip, (who, norm)
    for r, res in enumerate(ranks):
        assert [str(x) for x in res["fsdp/placements"]] == [
            "(Shard(dim=1), Shard(dim=2))"] * 2
        grads = [k for k in res if k.startswith("fsdp/grads/")]
        assert len(grads) == len([k for k in res
                                  if k.startswith("step/grads/")])
        ggap = max(float(np.abs(res[k] - res[k.replace("fsdp/", "step/")])
                         .max() / np.abs(res[k.replace("fsdp/", "step/")])
                         .max()) for k in grads)
        lgap = abs(float(res["fsdp/loss"]) - float(res["step/loss"]))
        print(f"rank {r}: fsdp vs replicated GRADDIFF {ggap:.3g} of the "
              f"largest entry, LOSSDIFF {lgap:.3g}")
        assert ggap < 1e-5 and lgap < 1e-6
        for who, (params, _, _, m, v) in single.items():
            assert len(params) == len(grads) == len(m) == len(v)
            mgap = max(float(np.abs(res["fsdp/" + k] - w).max()
                             / np.abs(w).max())
                       for k, w in list(m.items()) + list(v.items()))
            gap = max(float(np.abs(res[k.replace("step/", "fsdp/")] - w)
                            .max()) for k, w in params.items())
            print(f"rank {r} fsdp vs {who}: MOMENTDIFF {mgap:.3g} of the "
                  f"largest entry, MAXDIFF {gap:.3g}")
            assert mgap < 1e-5 and gap < 2e-3


@pytest.mark.parametrize("arch,kv,path,cache_pl", [
    ("internlm2-1.8b", 2, "_sharded_decode", "(Shard(dim=1), Shard(dim=2))"),
    ("internlm2-1.8b", 4, "_sharded_decode", "(Shard(dim=1), Shard(dim=3))"),
    ("qwen3-moe-30b-a3b", None, "_moe_gathered_tokens", None),
    ("minicpm3-4b", None, "_sharded_absorbed_decode", None),
    ("zamba2-2.7b", None, "_sharded_decode", None)])
def test_serving_on_the_mesh_matches_one_device(world, arch, kv, path,
                                                cache_pl):
    """``prefill`` of 8 tokens and one ``decode_step`` on the 2 x 4 mesh,
    parameters and caches laid out by a serving cell's rules, against
    the same calls on one device: the prefill's and the decode's logits
    and every cache within 1e-5 of the largest entry. internlm2's caches
    (stacked over layers) split over the sequence (2 kv heads) and over
    heads (4); the decode went through the sharded path each family
    has, and where the caches split over their sequence (2 kv heads on a
    model axis of 4: every smoke config but internlm2's with 4) each rank
    attended over its own rows and the ranks' softmaxes merged
    (``layers._merge_decode``)."""
    ranks = _case(world, "decode")
    key = f"decode/{arch}/{kv}"
    names = ["_merge_decode", "_moe_gathered_tokens",
             "_sharded_absorbed_decode", "_sharded_decode"]
    for r, res in enumerate(ranks):
        gaps = [float(res[f"{key}/{k}_gap"])
                for k in ("prefill", "decode", "cache")]
        ran = dict(zip(names, res[f"{key}/ran"].tolist()))
        print(f"rank {r} {arch} kv {kv}: prefill, decode, cache gaps "
              f"{gaps}, sharded paths {ran}")
        assert max(gaps) < 1e-5
        assert ran[path] > 0
        if cache_pl is not None:
            assert str(res[f"{key}/cache_placements"]) == cache_pl
        # the smoke configs' 2 kv heads (all but internlm2's with 4) split
        # the caches over their sequence: each rank attends over its own
        # rows, the softmaxes merged across the ranks
        assert (ran["_merge_decode"] > 0) == (
            kv != 4 and ran["_sharded_decode"] > 0)


@pytest.mark.parametrize("kv,wk", [(2, "(Replicate(), Replicate())"),
                                   (4, "(Replicate(), Shard(dim=2))")])
def test_tensor_parallel_parameters_train_as_on_one_device(world, kv, wk):
    """Parameters laid out by ``BASE_RULES`` (heads, mlp and vocab over
    ``model``), two steps with global-norm clipping, int8 moments and int8
    error feedback: the moments carry their parameters' placements; each
    int8 moment's per-channel scales (an absmax over the whole channel,
    all-reduced where the channel is sharded) within 1e-5 of the one-device
    ones; each loss within 1e-5 and every parameter within 1e-4 of the
    one-device steps (the sharded products sum in another order, which can
    move an int8 code by one at a rounding tie: 2.65e-5 read with 2 kv
    heads, 1.1e-6 with 4). With 2 kv heads (not divisible by ``model``)
    K/V stay replicated and attention gathers q's heads; with 4 every rank
    attends over its own heads."""
    ranks = _case(world, "tp")
    for res in ranks:
        (got, want), gap = res[f"tp/kv{kv}/losses"], float(
            res[f"tp/kv{kv}/param_gap"])
        scale_gap = float(res[f"tp/kv{kv}/scale_gap"])
        print(f"kv heads {kv}: losses {got} vs {want}, parameter gap "
              f"{gap:.3g}, int8 scale gap {scale_gap:.3g}")
        assert scale_gap < 1e-5
        assert str(res[f"tp/kv{kv}/wk"]) == wk
        assert str(res[f"tp/kv{kv}/moment_placements"]) == \
            "(Replicate(), Shard(dim=2))"
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert gap < 1e-4


def test_sequence_parallel_loss_matches_single_device(world):
    """``seq_shard``: activations shard the sequence over ``model``, K/V
    are gathered for attention and q keeps its shard: every attention call
    of a rank takes its own quarter of the 16 positions (shard ``r``, the
    rank's ``model`` coordinate) against all 16 keys. The loss within 1e-5
    of one device, every gradient within 1e-5 of its largest entry."""
    ranks = _case(world, "seq")
    pcfg = p_reg.get_smoke_config("internlm2-1.8b")
    inp = world["inputs"]
    pp = p_lm.from_reference_params(pcfg, _inp_tree(inp, "params"),
                                    device="cpu")
    leaves = [t.requires_grad_() for _, t in p_specs.tree_leaves(pp)]
    want, _ = p_lm.lm_loss(pp, pcfg, torch.from_numpy(inp["step/tokens"]),
                           torch.from_numpy(inp["step/labels"]))
    grads = torch.autograd.grad(want, leaves)
    for r, res in enumerate(ranks):
        assert str(res["seq/x_placements"][0]) == \
            "(Shard(dim=0), Shard(dim=1))"
        shards = {tuple(int(v) for v in row) for row in res["seq/shards"]}
        assert shards == {(r % 4, 4, 16)}, shards
        assert len(res["seq/shards"]) >= pcfg.n_layers
        assert abs(float(res["seq/loss"]) - float(want)) < 1e-5
        gap = max(float(np.abs(res["/".join(("seq/grads",) + path)]
                               - g.numpy()).max() / g.abs().max())
                  for (path, _), g in zip(p_specs.tree_leaves(pp), grads))
        print(f"rank {r}: gradient gap {gap:.3g} of the largest entry")
        assert gap < 1e-5


def _attention_inputs(seed, b=2, s=16, h=4, hkv=2, d=8):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, n, d, generator=g) for n in (h, hkv, hkv)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_sequence_shards_of_attention_equal_the_whole(causal, n):
    """Each of ``n`` sequence shards of q against the whole K/V
    (:class:`_SeqShardAttention`, one flash call a block of keys, merged by
    lse) gives its rows of the whole sequence's attention, and the shards'
    gradients sum to the whole one's: within 1e-5 (float32; the merge and
    the blocks' dq add in another order)."""
    from repro_torch.models import layers as p_layers
    q, k, v = _attention_inputs(n)
    ct = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    want = p_layers.blockwise_attention(*whole, causal=causal)
    want_g = torch.autograd.grad((want * ct).sum(), whole)
    s = q.shape[1] // n
    kv = [t.clone().requires_grad_() for t in (k, v)]
    outs, dq = [], []
    for r in range(n):
        qr = q[:, r * s:(r + 1) * s].clone().requires_grad_()
        out = p_layers._SeqShardAttention.apply(qr, *kv, r, causal)
        outs.append(out)
        dq.append(torch.autograd.grad((out * ct[:, r * s:(r + 1) * s]).sum(),
                                      [qr] + kv))
    torch.testing.assert_close(torch.cat(outs, 1), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.cat([g[0] for g in dq], 1), want_g[0],
                               rtol=0, atol=1e-5)
    for i in (1, 2):
        torch.testing.assert_close(sum(g[i] for g in dq), want_g[i], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-moe-30b-a3b"])
def test_families_on_the_mesh_match_one_device(world, arch):
    """zamba2's SSD with its heads pinned to ``model`` and qwen3-moe with
    every MoE layer expert-parallel, smoke configs on the 2 x 4 mesh: loss
    within 1e-5 relative and every gradient within 1e-4 of its largest
    entry (at least 1) of the one-device step."""
    ranks = _case(world, "families")
    for res in ranks:
        single, mesh = res[f"families/{arch}/loss"]
        gap = float(res[f"families/{arch}/grad_gap"])
        print(f"{arch}: loss {mesh!r} vs {single!r}, gradient gap {gap:.3g}")
        assert abs(mesh - single) <= 1e-5 * abs(single)
        assert gap < 1e-4


def test_xlstm_on_a_model_axis_wider_than_its_heads_matches_one_device(
        world):
    """xlstm-125m's mLSTM -> sLSTM cut laid out as its training cell lays
    it out on a (1, 8) mesh, 4 heads on a model axis of 8 (its backward's
    head split raised before the head norm's gradient was pinned): loss
    within 1e-5 relative and every gradient within ``XLSTM_GRAD_TOL`` of
    its own largest entry of the one-device step."""
    ranks = _case(world, "xlstm")
    for res in ranks:
        single, mesh = res["xlstm/loss"]
        gaps = res["xlstm/grad_gaps"]
        print(f"xlstm (1, 8): loss {mesh!r} vs {single!r}, gradient gaps "
              f"{[f'{g:.3g}' for g in gaps]}")
        assert abs(mesh - single) <= 1e-5 * abs(single)
        assert float(gaps.max()) <= XLSTM_GRAD_TOL


@pytest.mark.parametrize("rows", [2, 3])
def test_xlstm_pairs_on_a_model_axis_match_one_device(world, rows):
    """The cut of ``test_xlstm_on_a_model_axis_wider_than_its_heads_
    matches_one_device`` at 2 and 3 rows, where the model axis of 8
    divides neither the rows nor the 4 heads: the scans and the products
    into them run on each rank's (row, head) pairs (8 pairs, one a rank;
    12, two on ranks 0-5 and none on 6 and 7), the per-head weights'
    gradients partial sums over the ranks that hold each head. Loss within
    1e-5 relative and every gradient within ``XLSTM_GRAD_TOL`` of its own
    largest entry of the one-device step."""
    ranks = _case(world, "xlstm_pairs")
    for res in ranks:
        single, mesh = res[f"xlstm_pairs/{rows}/loss"]
        gaps = res[f"xlstm_pairs/{rows}/grad_gaps"]
        print(f"xlstm (1, 8), {rows} rows: loss {mesh!r} vs {single!r}, "
              f"gradient gaps {[f'{g:.3g}' for g in gaps]}")
        assert abs(mesh - single) <= 1e-5 * abs(single)
        assert float(gaps.max()) <= XLSTM_GRAD_TOL


def test_gqa_query_heads_stay_local_on_the_kernel_route(world):
    """internlm2's smoke config (4 query heads, 2 kv heads: the kv heads
    do not divide the model axis of 4) with tensor-parallel parameters,
    the kernels' route taken as on the card (K/V not repeated): every
    flash call takes one query head and the one kv head it reads, each
    rank projecting that head from its slice of ``wk``/``wv`` (whose
    gradients are partial sums over the two ranks that read each kv head,
    and over the batch). Loss within 1e-5 relative and every gradient
    within 1e-5 of its largest entry of the one-device step."""
    ranks = _case(world, "gqa")
    for r, res in enumerate(ranks):
        single, mesh = res["gqa/loss"]
        gap = float(res["gqa/grad_gap"])
        heads = res["gqa/heads"].tolist()
        print(f"rank {r} gqa: loss {mesh!r} vs {single!r}, gradient gap "
              f"{gap:.3g}, flash calls (query heads, kv heads) {heads}")
        assert str(res["gqa/wk"]) == "(Replicate(), Replicate())"
        assert heads == [[1, 1]] * 2
        assert abs(mesh - single) <= 1e-5 * abs(single)
        assert gap < 1e-5


def test_moe_expert_parallel_matches_single_device_and_reference(world):
    """Forward within 1e-5 of the port's single-device path and of the
    reference's ``moe_apply``; gradients (of ``sum(y * ct) + aux``, with
    respect to every weight and ``x``) within 1e-5 of the single-device
    path's, relative to each gradient's largest entry where that passes 1
    (the router's, 36.8, sums 32 tokens in another order: 1.1e-5 read);
    aux within 1e-6."""
    ranks = _case(world, "moe")
    inp = world["inputs"]
    w = _inp_tree(inp, "moe/params")
    rcfg = r_moe.MoEConfig(n_experts=8, top_k=2, d_ff=32,
                           capacity_factor=4.0)
    pcfg = p_moe.MoEConfig(n_experts=8, top_k=2, d_ff=32,
                           capacity_factor=4.0)
    rout, raux = r_moe.moe_apply({k: jnp.asarray(v) for k, v in w.items()},
                                 jnp.asarray(inp["moe/x"]), rcfg)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    x = torch.from_numpy(inp["moe/x"]).requires_grad_()
    y, aux = p_moe.moe_apply(p, x, pcfg)
    ((y * torch.from_numpy(inp["moe/ct"])).sum() + aux).backward()
    grads = {k: v.grad.numpy() for k, v in p.items()}
    grads["x"] = x.grad.numpy()
    for res in ranks:
        assert str(res["moe/out_placements"][0]) == \
            "(Shard(dim=0), Shard(dim=1))"
        err = float(np.abs(res["moe/out"] - np.asarray(rout)).max())
        print("ERR vs reference", err)
        assert err < 1e-5
        assert float(np.abs(res["moe/out"] - y.detach().numpy()).max()) < 1e-5
        assert abs(float(res["moe/aux"]) - float(raux)) < 1e-6
        assert abs(float(res["moe/aux"]) - float(aux)) < 1e-6
        for k, g in grads.items():
            gap = float(np.abs(res[f"moe/grad/{k}"] - g).max())
            scale = max(1.0, float(np.abs(g).max()))
            print(f"grad {k}: {gap:.3g} of {scale:.3g}")
            assert gap < 1e-5 * scale, (k, gap, scale)


def test_elastic_checkpoint_reshards_bit_for_bit(world):
    """Saved from the 2 x 4 mesh, restored onto a 2 x 2 mesh: each of its
    ranks holds exactly its slice; the reference's checkpoint restores
    onto the 2 x 4 mesh bit for bit."""
    ranks = _case(world, "elastic")
    inp = world["inputs"]
    for r, res in enumerate(ranks):
        if r < 4:
            assert bool(res["elastic/local_equal/w"])
            assert bool(res["elastic/local_equal/e"])
            # w (16, 8) embed/mlp: mlp over model; e (32, 16): vocab
            assert str(res["elastic/placements/w"]) == \
                "(Replicate(), Shard(dim=1))"
            assert str(res["elastic/placements/e"]) == \
                "(Replicate(), Shard(dim=0))"
        for k in ("w", "e"):
            np.testing.assert_array_equal(res[f"elastic/ref/{k}"],
                                          inp[f"elastic/{k}"])
        assert int(res["elastic/step"]) == 1


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
def test_sharded_batches_equal_the_reference_shards(world, mesh):
    """Rank ``r``'s rows equal the reference's shard on device ``r`` of
    the same mesh, exactly (pod-major over ``("pod", "data")``)."""
    ranks = _case(world, "batch")
    ref = world["ref"]
    for step in (0, 5):
        full = None
        for r, res in enumerate(ranks):
            for kind in ("tokens", "labels"):
                got = res[f"batch/{mesh}/{step}/{kind}"]
                want = ref[f"batch/{mesh}/{step}/{kind}/{r}"]
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
            full = res[f"batch/{mesh}/{step}/full"] if full is None else full
            np.testing.assert_array_equal(res[f"batch/{mesh}/{step}/full"],
                                          full)


# the layouts of ``case_rope`` in ``torch_mesh_worker.py``, and whether each
# rotates on its local shards
ROPE_LAYOUTS = {"batch_seq": True, "seq_heads": True, "heads": True,
                "seq_seq": True, "partial": True, "head_dim": False}


@pytest.mark.parametrize("layout", sorted(ROPE_LAYOUTS))
def test_rope_of_dtensors_equals_the_whole_tensors(world, layout):
    """``apply_rope`` of DTensors on the 2 x 4 mesh (uneven batch and
    sequence shards, a sequence split over both mesh dims, a partial sum),
    float32 and bf16, positions ``[S]`` and ``[B, S]``: on every rank the
    gathered output and the gradient equal ``rope_plain`` of the whole
    tensors bit for bit. Each layout but a split head dim calls the
    kernel's wrapper on the local shard once each way (the kernel on the
    card, the plain version here); a split head dim calls it not at all
    and takes the torch ops on the DTensor."""
    from repro_torch.kernels.rope import rope_plain
    ranks = _case(world, "rope")
    res0 = ranks[0]
    x32, d32 = (torch.from_numpy(res0[f"rope/{k}"]) for k in ("x", "d"))
    calls = [1, 1] if ROPE_LAYOUTS[layout] else [0, 0]
    for dt in (torch.float32, torch.bfloat16):
        for pname in ("seq", "rows"):
            positions = torch.from_numpy(res0[f"rope/positions/{pname}"])
            want = rope_plain(x32.to(dt), positions, 1e6).float().numpy()
            grad = rope_plain(d32.to(dt), positions, 1e6,
                              inverse=True).float().numpy()
            key = f"rope/{layout}/{str(dt).split('.')[1]}/{pname}"
            for r, res in enumerate(ranks):
                assert res[f"{key}/calls"].tolist() == calls, (r, key)
                for got, ref in ((res[f"{key}/y"], want),
                                 (res[f"{key}/grad"], grad)):
                    np.testing.assert_array_equal(got.view(np.int32),
                                                  ref.view(np.int32))


def test_launcher_on_a_mesh_matches_reference(world):
    """``launch.train --smoke --mesh 2x4``: each of 6 steps' loss within
    1e-4 of the reference's launcher."""
    ranks = _case(world, "launch")
    want = world["ref"]["launch/losses"]
    assert len(want) == 6
    for res in ranks:
        np.testing.assert_allclose(res["launch/losses"], want, rtol=0,
                                   atol=1e-4)


# ---- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_on_dtensors_launches_the_kernel(tmp_path, dtype):
    """Under a 1 x 1 NCCL mesh, attention of DTensor q/k/v (batch over
    ``data``) launches the flash kernel once forward and once backward and
    equals the plain tensors' call bit for bit, output and gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import datetime
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L

    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_test_mesh((1, 1))
        sh = p_rules.NamedSharding(mesh, p_rules.batch_partition(mesh, 4))
        g = torch.Generator(device=dev).manual_seed(0)
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt)
                       for shape in ((2, 512, 8, 64), (2, 512, 2, 64),
                                     (2, 512, 2, 64), (2, 512, 8, 64)))
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        want = L.blockwise_attention(*plain)
        want.backward(do)
        sharded = [p_rules.distribute(t, sh).requires_grad_()
                   for t in (q, k, v)]
        fwd, bwd = (fa.flash_attention_kernel.launches,
                    fa.flash_attention_backward_kernel.launches)
        got = L.blockwise_attention(*sharded)
        got.backward(p_rules.distribute(do, sh))
        torch.cuda.synchronize()
        assert fa.flash_attention_kernel.launches == fwd + 1
        assert fa.flash_attention_backward_kernel.launches == bwd + 1
        assert torch.equal(got.to_local(), want)
        for a, b in zip(sharded, plain):
            assert torch.equal(a.grad.to_local(), b.grad)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rope_on_dtensors_launches_the_kernel(tmp_path, dtype):
    """Under a 1 x 1 NCCL mesh, RoPE of a DTensor (batch over ``data``)
    launches the kernel once forward and once inverse on the local shard
    and equals the plain tensor's call bit for bit, output and
    gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import datetime
    import torch.distributed as dist
    from repro_torch.kernels.rope import rope_kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L

    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_test_mesh((1, 1))
        sh = p_rules.NamedSharding(mesh, p_rules.batch_partition(mesh, 4))
        g = torch.Generator(device=dev).manual_seed(0)
        dt = getattr(torch, dtype)
        x, dy = (torch.randn(2, 512, 8, 64, generator=g, device=dev).to(dt)
                 for _ in range(2))
        positions = torch.arange(512, device=dev)
        plain = x.clone().requires_grad_()
        want = L.apply_rope(plain, positions, 1e6)
        want.backward(dy)
        sharded = p_rules.distribute(x, sh).requires_grad_()
        before = (rope_kernel.launches, rope_kernel.backward_launches)
        got = L.apply_rope(sharded, positions, 1e6)
        got.backward(p_rules.distribute(dy, sh))
        torch.cuda.synchronize()
        assert (rope_kernel.launches - before[0],
                rope_kernel.backward_launches - before[1]) == (1, 1)
        assert torch.equal(got.to_local(), want)
        assert torch.equal(sharded.grad.to_local(), plain.grad)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sequence_shards_of_attention_launch_the_kernel(dtype):
    """On the card, shard ``r`` of 4 launches the flash kernel ``r + 1``
    times forward and backward, and the shards give the whole sequence's
    kernel call: within 1e-5 (float32) or relative L2 1e-2 (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L

    dev, n, dt = torch.device("cuda", 0), 4, getattr(torch, dtype)
    q, k, v = (t.to(dev, dt) for t in _attention_inputs(0, s=512, d=64))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)
                     ).to(dev, dt)
    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    want = L._FlashAttention.apply(*whole, None, True)
    want.backward(do)
    kv = [t.clone().requires_grad_() for t in (k, v)]
    c, outs, dq = q.shape[1] // n, [], []
    for r in range(n):
        qr = q[:, r * c:(r + 1) * c].clone().requires_grad_()
        fwd, bwd = (fa.flash_attention_kernel.launches,
                    fa.flash_attention_backward_kernel.launches)
        out = L._SeqShardAttention.apply(qr, *kv, r, True)
        out.backward(do[:, r * c:(r + 1) * c])
        torch.cuda.synchronize()
        assert fa.flash_attention_kernel.launches == fwd + r + 1
        assert fa.flash_attention_backward_kernel.launches == bwd + r + 1
        outs.append(out.detach())
        dq.append(qr.grad)
    pairs = [(torch.cat(outs, 1), want), (torch.cat(dq, 1), whole[0].grad),
             (kv[0].grad, whole[1].grad), (kv[1].grad, whole[2].grad)]
    for got, ref in pairs:
        if dt == torch.float32:
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
        else:
            rel = ((got.float() - ref.float()).norm() / ref.float().norm())
            assert rel.item() < 1e-2


@pytest.fixture
def one_rank(tmp_path):
    """A gloo world of this process alone."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b"])
def test_recomputation_on_another_thread_keeps_the_context(one_rank, arch):
    """Autograd recomputes checkpointed layers on its own thread on the
    card; here the backward runs on a new thread, where the thread-local
    sharding context is absent (implicit replication on, as the engine's
    threads see it): with ``remat="full"`` and chunked CE the gradients on
    a 1 x 1 mesh equal the one-device ones bit for bit (the MoE layers
    recompute on the expert-parallel path), and implicit replication stays
    on for the caller's context."""
    import dataclasses
    import threading
    from repro_torch.launch.mesh import make_test_mesh

    cfg = dataclasses.replace(p_reg.get_smoke_config(arch), remat="full",
                              logit_chunk=16)
    params = p_specs.materialize(p_lm.lm_specs(cfg),
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
    rng = np.random.default_rng(1)
    tok, lab = (torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
                for _ in range(2))
    leaves = [t.requires_grad_() for _, t in p_specs.tree_leaves(params)]
    want = torch.autograd.grad(p_lm.lm_loss(params, cfg, tok, lab)[0],
                               leaves)
    mesh = make_test_mesh((1, 1))
    rep = p_rules.NamedSharding(mesh, ())
    dp = p_specs.tree_map(lambda t: p_rules.distribute(t.detach(), rep),
                          params)
    dl = [t.requires_grad_() for _, t in p_specs.tree_leaves(dp)]
    bsh = p_rules.NamedSharding(mesh, p_rules.batch_partition(mesh, 2))
    box = []
    with p_rules.set_context(mesh):
        loss = p_lm.lm_loss(dp, cfg, p_rules.distribute(tok, bsh),
                            p_rules.distribute(lab, bsh))[0]
        def backward():
            with p_rules._implicit_replication():
                box.append(torch.autograd.grad(loss, dl))
        th = threading.Thread(target=backward)
        th.start()
        th.join()
        assert len(box) == 1
        # a plain tensor still meets a DTensor as a replicated one
        assert float((dl[0].sum() + torch.ones(())).full_tensor()) == \
            float(leaves[0].sum() + 1)
    for g, w in zip(box[0], want):
        assert torch.equal(g.to_local(), w)
