"""The port's LM training against the JAX package's, on the CPU.

Inputs are made with numpy and handed to both packages; the reference's
weights are carried across with ``lm.from_reference_params``. Tolerances
(float32): losses within rtol 1e-5, gradients within rtol 1e-4 / atol 1e-6
(the same sums in another order, through two layers); AdamW with float32
moments within 1e-6; bfloat16 moments within one bfloat16 step (the
float32 moments they round from differ in the last bits); int8 moments
with codes equal except at rounding ties (within one code) and dequantised
moments within one code step; train steps and the launcher's losses within
1e-4 over their steps.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as r_launch  # noqa: E402
import repro_torch.launch.train as p_launch  # noqa: E402
from repro.configs import registry as r_reg  # noqa: E402
from repro.models import encdec as r_encdec  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models import mamba2 as r_mamba2  # noqa: E402
from repro.models import specs as r_specs  # noqa: E402
from repro.train import optim as r_optim  # noqa: E402
from repro.train import step as r_step  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.models import encdec as p_encdec  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models import specs as p_specs  # noqa: E402
from repro_torch.train import optim as p_optim  # noqa: E402
from repro_torch.train import step as p_step  # noqa: E402


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          path + (k,))]
    return [(path, tree)]


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32)).to(
                torch.bfloat16 if v.dtype == jnp.bfloat16 else
                torch.float32)
            for k, v in tree.items()}


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---- optimizer -----------------------------------------------------------------

def _opt_inputs(seed):
    """A float32 matrix, a bfloat16 matrix, a stacked 3-axis leaf and a
    vector (no weight decay)."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 8)).astype(np.float32),
              "h": rng.standard_normal((4, 16)).astype(np.float32),
              "stack": {"k": rng.standard_normal((3, 4, 5))
                        .astype(np.float32)},
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(np.shape(v)) * 3).astype(np.float32)
              if not isinstance(v, dict) else
              {"k": (rng.standard_normal((3, 4, 5)) * 3).astype(np.float32)}
              for k, v in params.items()} for _ in range(3)]
    rp = {k: jnp.asarray(v) if not isinstance(v, dict) else
          {"k": jnp.asarray(v["k"])} for k, v in params.items()}
    rp["h"] = rp["h"].astype(jnp.bfloat16)
    return rp, grads


def _bf16_step(x):
    """One bfloat16 step (ulp) at each element of ``x``."""
    x = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.maximum(x, 1e-38)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_adamw_update_matches_reference(state_dtype):
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                  state_dtype=state_dtype)
    rcfg = r_optim.AdamWConfig(**cfg_kw)
    pcfg = p_optim.AdamWConfig(**cfg_kw)
    rp, grads = _opt_inputs(0)
    pp = _to_torch(rp)
    ro, po = r_optim.adamw_init(rp, rcfg), p_optim.adamw_init(pp, pcfg)
    for g in grads:
        rg = jax.tree_util.tree_map(jnp.asarray, g)
        rp, ro = r_optim.adamw_update(rg, ro, rp, rcfg)
        out = p_optim.adamw_update(_to_torch(g), po, pp, pcfg)
        assert out[0] is pp and out[1] is po            # in place
    assert int(po["step"]) == int(ro["step"]) == 3
    for (path, a), (_, b) in zip(_leaves(pp), _leaves(_np_tree(rp))):
        assert a.dtype == (torch.bfloat16 if path == ("h",) else
                           torch.float32)
        if state_dtype == "fp32" or path != ("h",):
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5,
                                       atol=1e-5 if state_dtype == "int8"
                                       else 1e-6, err_msg=str(path))
    for which in ("m", "v"):
        if state_dtype == "int8":
            for path, leaf in _leaves(po[which]):
                if path[-1] != "codes":
                    continue
                ref = ro[which]
                for k in path:
                    ref = ref[k]
                scale = _leaves(po[which])[[p for p, _ in
                                            _leaves(po[which])].index(
                    path[:-1] + ("scale",))][1]
                diff = np.abs(leaf.numpy().astype(int)
                              - np.asarray(ref).astype(int))
                assert diff.max() <= 1, path       # rounding ties only
                ref_s = ro[which]
                for k in path[:-1] + ("scale",):
                    ref_s = ref_s[k]
                deq_p = leaf.float() * scale
                deq_r = np.asarray(ref, np.float32) * np.asarray(ref_s)
                assert np.all(np.abs(deq_p.numpy() - deq_r)
                              <= 1.01 * np.asarray(ref_s)), path
        else:
            for (path, a), (_, b) in zip(_leaves(po[which]),
                                         _leaves(_np_tree(ro[which]))):
                if state_dtype == "fp32":
                    np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                               atol=1e-6, err_msg=str(path))
                else:
                    assert a.dtype == torch.bfloat16
                    assert np.all(np.abs(_f32(a) - _f32(b))
                                  <= _bf16_step(_f32(b))), path


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_adamw_update_in_row_slices_matches_whole(monkeypatch, state_dtype):
    """A leaf updated in slices of whole rows (``MAX_UPDATE`` 20 elements:
    3, 4 and 3 slices of the three matrices) gives the same bits as the
    leaf updated whole."""
    cfg = p_optim.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                              state_dtype=state_dtype)
    rp, grads = _opt_inputs(0)
    runs = []
    for max_update in (p_optim.MAX_UPDATE, 20):
        monkeypatch.setattr(p_optim, "MAX_UPDATE", max_update)
        params = _to_torch(rp)
        opt = p_optim.adamw_init(params, cfg)
        for g in grads:
            p_optim.adamw_update(_to_torch(g), opt, params, cfg)
        runs.append(_leaves(params) + _leaves(opt["m"]) + _leaves(opt["v"]))
    assert len(p_optim._row_slices(_to_torch(rp)["w"])) == 3
    for (path, a), (_, b) in zip(*runs):
        assert torch.equal(a, b), path


def test_adamw_first_step_is_lr_signed():
    """After bias correction, |first update| == lr for any grad scale (the
    reference's test)."""
    cfg = p_optim.AdamWConfig(lr=0.01, eps=1e-12)
    params = {"w": torch.ones(4)}
    opt = p_optim.adamw_init(params, cfg)
    g = torch.tensor([1.0, -3.0, 0.5, -0.1])
    p_optim.adamw_update({"w": g}, opt, params, cfg)
    np.testing.assert_allclose((1 - params["w"]).numpy(),
                               0.01 * np.sign(g.numpy()), rtol=1e-4)


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_opt_state_specs_mirror_init(state_dtype):
    cfg = p_optim.AdamWConfig(state_dtype=state_dtype)
    specs = {"a": p_specs.param((8, 16), ("embed", "mlp")),
             "b": p_specs.param((4,), ("embed",)),
             "c": {"d": p_specs.param((2, 3, 5), ("layers", "embed", "mlp"),
                                      dtype=torch.bfloat16)}}
    params = p_specs.materialize(specs, torch.Generator().manual_seed(0),
                                 device="cpu")
    live = [(p, (tuple(t.shape), t.dtype))
            for p, t in _leaves(p_optim.adamw_init(params, cfg))]
    spec = [(p, (tuple(s.shape), s.dtype))
            for p, s in _leaves(p_optim.opt_state_specs(specs, cfg))]
    assert live == spec
    r_specs_tree = {"a": r_specs.param((8, 16), ("embed", "mlp")),
                    "b": r_specs.param((4,), ("embed",)),
                    "c": {"d": r_specs.param((2, 3, 5),
                                             ("layers", "embed", "mlp"),
                                             dtype=jnp.bfloat16)}}
    r_spec = r_optim.opt_state_specs(
        r_specs_tree, r_optim.AdamWConfig(state_dtype=state_dtype))
    flat = jax.tree_util.tree_flatten_with_path(
        r_spec, is_leaf=lambda x: isinstance(x, r_specs.ParamSpec))[0]
    assert [(tuple(str(getattr(k, "key", k)) for k in path), s.shape,
             s.axes) for path, s in flat] == [
        (p, s.shape, s.axes)
        for p, s in _leaves(p_optim.opt_state_specs(specs, cfg))]


def test_global_norm_and_sgd_match_reference():
    rp, grads = _opt_inputs(1)
    g = grads[0]
    want = r_optim.global_norm(jax.tree_util.tree_map(jnp.asarray, g))
    got = p_optim.global_norm(_to_torch(g))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    pp = _to_torch(rp)
    out = p_optim.sgd_update(_to_torch(g), pp, 0.05)
    assert out is pp
    ref = r_optim.sgd_update(jax.tree_util.tree_map(jnp.asarray, g), rp,
                             0.05)
    for (path, a), (_, b) in zip(_leaves(pp), _leaves(_np_tree(ref))):
        assert a.dtype == (torch.bfloat16 if path == ("h",) else
                           torch.float32)
        np.testing.assert_array_equal(_f32(a), _f32(b))


# ---- train step ------------------------------------------------------------------

def _linear_loss(lib):
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        l = ((pred - batch["y"]) ** 2).mean()
        return l, {"ce": l, "scale": l * 2}
    return loss_fn


@pytest.mark.parametrize("accum,compression", [(1, "none"), (2, "none"),
                                               (1, "int8_ef"),
                                               (2, "int8_ef")])
def test_make_train_step_matches_reference(accum, compression):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    batches = [{"x": rng.standard_normal((16, 8)).astype(np.float32),
                "y": rng.standard_normal((16, 3)).astype(np.float32)}
               for _ in range(3)]
    kw = dict(adam=dict(lr=1e-2, grad_clip=1.0), accum_steps=accum,
              grad_compression=compression)
    rt = r_step.TrainConfig(adam=r_optim.AdamWConfig(**kw["adam"]),
                            accum_steps=accum, grad_compression=compression)
    pt = p_step.TrainConfig(adam=p_optim.AdamWConfig(**kw["adam"]),
                            accum_steps=accum, grad_compression=compression)
    r_fn = r_step.make_train_step(_linear_loss(jnp), rt)
    p_fn = p_step.make_train_step(_linear_loss(torch), pt)
    rp, pp = {"w": jnp.asarray(w)}, {"w": torch.tensor(w)}
    ro, po = r_step.init_optimizer(rp, rt), p_step.init_optimizer(pp, pt)
    re, pe = r_step.error_state_init(rp), p_step.error_state_init(pp)
    for bt in batches:
        rb = {k: jnp.asarray(v) for k, v in bt.items()}
        pb = {k: torch.tensor(v) for k, v in bt.items()}
        if compression == "int8_ef":
            rp, ro, rm, re = r_fn(rp, ro, rb, re)
            pp, po, pm, pe = p_fn(pp, po, pb, pe)
            np.testing.assert_allclose(pe["w"].numpy(), np.asarray(re["w"]),
                                       atol=1e-5)
        else:
            rp, ro, rm = r_fn(rp, ro, rb)
            pp, po, pm = p_fn(pp, po, pb)
        assert set(pm) == set(rm) == {"ce", "scale", "loss"}
        for k in rm:
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-5)
    np.testing.assert_allclose(pp["w"].detach().numpy(), np.asarray(rp["w"]),
                               atol=1e-4)


def test_compression_error_feedback_preserves_sum():
    g = {"w": torch.randn(32, 64, generator=torch.Generator().manual_seed(1))
         * 3.0}
    err = p_step.error_state_init(g)
    sent, resid = p_step.compress_grads(g, err)
    assert resid is err
    np.testing.assert_allclose((sent["w"] + resid["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-5, atol=1e-6)


# ---- lm_loss -----------------------------------------------------------------------

S = 32
# (arch, logit chunk, remat, tokens a row)
LOSS_CASES = ([("internlm2-1.8b", chunk, remat, S) for chunk in (0, 8)
               for remat in ("none", "full", "dots")]
              + [("h2o-danube-1.8b", 8, "none", S),
                 ("llava-next-34b", 8, "none", S)]
              + [("zamba2-2.7b", 8, remat, S)
                 for remat in ("none", "full", "dots")]
              + [("xlstm-125m", 8, "none", S)]
              # the MLA and MoE families; deepseek with its MTP head
              + [(arch, 8, "none", S) for arch in (
                  "minicpm3-4b", "qwen3-moe-30b-a3b", "deepseek-v3-671b")]
              # 16 tokens: zamba2's masked decays stay finite, so the
              # reference runs its own _segsum_mask (see _finite_segsum)
              + [("zamba2-2.7b", 8, "none", 16)])
# The recurrent families are deeper than two layers and their gradients
# sum through recurrences, so 1e-6 absolute is below their float32
# rounding. xlstm-125m's (stabilised mLSTM/sLSTM) are ill-conditioned: the
# port against itself with the mLSTM chunk 16 -> 8 (the same sums in
# another order) differs by up to 2.2e-5 of a leaf's largest magnitude, the
# reference by 4.9e-5. zamba2-2.7b (4 Mamba2 layers and 2 shared-block
# applications) differs from the reference by up to 1.6e-5 of a leaf's
# largest magnitude (A's log), and by 1.3e-6 absolute on embedding rows of
# 0.3. Their leaves are held within rtol 1e-4 plus this share of each
# leaf's largest magnitude.
GRAD_ATOL_OF_MAX = {"xlstm-125m": 1e-4, "zamba2-2.7b": 1e-5}


def _finite_segsum(a_cum):
    """The reference's ``_segsum_mask`` values with a finite gradient: the
    masked entries are exponentiated as exp(-inf) = 0. The reference takes
    ``where(mask, exp(diff), 0)``, whose gradient is 0 x inf = NaN wherever a
    masked ``diff`` overflows float32 (zamba2's smoke loss over 32 tokens
    does, over 16 it does not); the port's ``_segsum_mask`` is this form."""
    l = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    mask = jnp.tril(jnp.ones((l, l), bool))
    return jnp.exp(jnp.where(mask, diff, -jnp.inf))


def _loss_inputs(arch, chunk, remat, s=S):
    rcfg = dataclasses.replace(r_reg.get_smoke_config(arch),
                               logit_chunk=chunk, remat=remat)
    pcfg = dataclasses.replace(p_reg.get_smoke_config(arch),
                               logit_chunk=chunk, remat=remat)
    rng = np.random.default_rng(3)
    s = s - rcfg.prefix_len
    tokens = rng.integers(0, rcfg.vocab, (2, s)).astype(np.int32)
    labels = rng.integers(-1, rcfg.vocab, (2, s)).astype(np.int32)
    prefix = ((rng.standard_normal((2, rcfg.prefix_len, rcfg.d_model)) * 0.5)
              .astype(np.float32) if rcfg.prefix_len else None)
    params = r_specs.materialize(jax.random.PRNGKey(4), r_lm.lm_specs(rcfg))
    return rcfg, pcfg, tokens, labels, prefix, params


def _loss_case_id(case):
    arch, chunk, remat, s = case
    return f"{arch}-{chunk}-{remat}" + ("" if s == S else f"-s{s}")


@pytest.mark.parametrize("arch,chunk,remat,s", LOSS_CASES,
                         ids=[_loss_case_id(c) for c in LOSS_CASES])
def test_lm_loss_and_grads_match_reference(monkeypatch, arch, chunk, remat,
                                           s):
    rcfg, pcfg, tokens, labels, prefix, rp = _loss_inputs(arch, chunk, remat,
                                                          s)
    if rcfg.ssm is not None and s == S:
        monkeypatch.setattr(r_mamba2, "_segsum_mask", _finite_segsum)

    def r_loss(p):
        return r_lm.lm_loss(p, rcfg, jnp.asarray(tokens), jnp.asarray(labels),
                            None if prefix is None else jnp.asarray(prefix))

    (r_l, r_m), r_g = jax.jit(jax.value_and_grad(r_loss, has_aux=True))(rp)
    pp = p_lm.from_reference_params(pcfg, _np_tree(rp), device="cpu")
    leaves = [t.requires_grad_() for _, t in _leaves(pp)]
    p_l, p_m = p_lm.lm_loss(pp, pcfg, torch.tensor(tokens),
                            torch.tensor(labels),
                            None if prefix is None else torch.tensor(prefix))
    p_g = torch.autograd.grad(p_l, leaves)
    np.testing.assert_allclose(float(p_l.detach()), float(r_l), rtol=1e-5)
    for k in ("ce", "aux", "mtp"):
        np.testing.assert_allclose(float(p_m[k].detach()), float(r_m[k]),
                                   rtol=1e-5,
                                   atol=1e-7)
    for (path, want), got in zip(_leaves(_np_tree(r_g)), p_g):
        atol = max(1e-6, GRAD_ATOL_OF_MAX.get(arch, 0) * np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol,
                                   err_msg=str(path))


def test_lm_loss_refuses_what_is_not_ported():
    cfg = dataclasses.replace(p_reg.get_smoke_config("internlm2-1.8b"),
                              remat="bogus")
    params = p_specs.materialize(p_lm.lm_specs(cfg),
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="bogus"):
        p_lm.lm_loss(params, cfg, toks, toks)


# ---- the launcher -------------------------------------------------------------------

def _record_losses(monkeypatch, module, sink, traced, keys=("loss",)):
    """Wrap ``module.make_train_step`` so that every step's loss (or the
    tuple of its metrics ``keys``) lands in ``sink`` (through a debug
    callback where the step is traced by jit)."""
    real = module.make_train_step

    def put(*vals):
        vals = tuple(float(v) for v in vals)
        sink.append(vals[0] if len(keys) == 1 else vals)

    def wrapped(loss_fn, tcfg):
        step = real(loss_fn, tcfg)

        def recorded(*args):
            out = step(*args)
            vals = [out[2][k] for k in keys]
            if traced:
                jax.debug.callback(put, *vals, ordered=True)
            else:
                put(*vals)
            return out
        return recorded
    monkeypatch.setattr(module, "make_train_step", wrapped)


def _reference_init(monkeypatch):
    """The port's launcher starts from the reference's seeded weights (the
    enc-dec family's drawn from ``encdec_specs``)."""
    def init(cfg, seed, device):
        rcfg = r_reg.get_smoke_config(cfg.name[:-len("-smoke")])
        ed = isinstance(rcfg, r_encdec.EncDecConfig)
        specs = r_encdec.encdec_specs(rcfg) if ed else r_lm.lm_specs(rcfg)
        rp = _np_tree(r_specs.materialize(jax.random.PRNGKey(seed), specs))
        return (p_encdec if ed else p_lm).from_reference_params(
            cfg, rp, device=device)
    monkeypatch.setattr(p_launch, "init_params", init)


# the launcher's losses, port against reference, each step: float32 smoke
# configs within 1e-4; seamless-m4t-medium's smoke config is bfloat16 in
# both packages (class attributes), whose activations and AdamW updates
# round in other places: over its 6 steps the losses differ by 7.9e-5 to
# 5.3e-4; held at 2e-3
LAUNCHER_ATOL = {"seamless-m4t-medium": 2e-3}


@pytest.mark.parametrize("arch,extra,steps", [
    ("internlm2-1.8b", [], 6), ("llava-next-34b", [], 6),
    ("internlm2-1.8b", ["--grad-compression", "int8_ef"], 6),
    ("zamba2-2.7b", [], 6), ("xlstm-125m", [], 2),
    ("seamless-m4t-medium", [], 6), ("deepseek-v3-671b", [], 6)])
def test_launcher_losses_match_reference(monkeypatch, capsys, arch, extra,
                                         steps):
    """Each step's loss within 1e-4. xlstm-125m's smoke training is chaotic
    in float32 after two AdamW steps: each package against itself with the
    mLSTM chunk 16 -> 8 (the same sums in another order) moves step 2's
    loss by 5e-5 (port) / 6.3e-4 (reference) and step 3's by 3.2e-3 /
    3.4e-3, so its run is held over the two steps before that. The
    reference's SSD runs with ``_finite_segsum`` (its gradient is NaN where
    a masked decay overflows, which zamba2's smoke run reaches)."""
    ref, port = [], []
    _record_losses(monkeypatch, r_launch, ref, traced=True)
    _record_losses(monkeypatch, p_launch, port, traced=False)
    _reference_init(monkeypatch)
    if getattr(r_reg.get_smoke_config(arch), "ssm", None) is not None:
        monkeypatch.setattr(r_mamba2, "_segsum_mask", _finite_segsum)
    argv = ["--arch", arch, "--smoke", "--steps", str(steps), "--batch", "2",
            "--seq", "32"] + extra
    r_launch.main(argv)
    p_launch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    last = f"step {steps - 1:4d} loss="
    assert out.count("done") == 2 and out.count(last) == 2
    assert len(ref) == len(port) == steps
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=LAUNCHER_ATOL.get(arch, 1e-4))


def test_launcher_mtp_term_at_128_heads_matches_reference(monkeypatch,
                                                         capsys):
    """DeepSeek's MTP term at its published head count: a cut of
    deepseek-v3-671b keeping its 128 heads and MLA dims (d_model = d_ff =
    1024, vocab 8192, one dense MLA layer and the MTP layer, float32),
    4 steps of 2 x 64 tokens at the launcher's AdamW (lr 1e-3). Each
    step's loss, CE and MTP term within rtol 2e-5 of the reference's
    launcher (2.9e-6 read); and in both the MTP term grows while the CE
    falls (17.73 -> 31.31 and 9.291 -> 9.093): the MTP layer's output
    meets the head without a norm and MLA's ``wo`` is drawn with the
    fan-in of its head axis, so its logits start large and AdamW's first
    steps overshoot them. The published smoke config (4 heads) does not
    show it."""
    keys = ("loss", "ce", "mtp")
    ref, port = [], []
    _record_losses(monkeypatch, r_launch, ref, traced=True, keys=keys)
    _record_losses(monkeypatch, p_launch, port, traced=False, keys=keys)
    cut = dict(name="deepseek-v3-671b-smoke", d_model=1024, d_ff=1024,
               vocab=8192, remat="none", logit_chunk=0, q_chunk=64,
               k_chunk=64)
    rcfg = dataclasses.replace(
        r_reg.get_config("deepseek-v3-671b"),
        segments=(r_lm.Segment("mla", "dense", 1),), param_dtype=jnp.float32,
        dtype=jnp.float32, **cut)
    pcfg = dataclasses.replace(
        p_reg.get_config("deepseek-v3-671b"),
        segments=(p_lm.Segment("mla", "dense", 1),),
        param_dtype=torch.float32, dtype=torch.float32, **cut)
    monkeypatch.setattr(r_launch, "get_smoke_config", lambda arch: rcfg)
    monkeypatch.setattr(p_launch, "get_smoke_config", lambda arch: pcfg)

    def init(cfg, seed, device):
        rp = _np_tree(r_specs.materialize(jax.random.PRNGKey(seed),
                                          r_lm.lm_specs(rcfg)))
        return p_lm.from_reference_params(cfg, rp, device=device)
    monkeypatch.setattr(p_launch, "init_params", init)
    argv = ["--arch", "deepseek-v3-671b", "--smoke", "--steps", "4",
            "--batch", "2", "--seq", "64"]
    r_launch.main(argv)
    p_launch.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.count("done") == 2
    assert len(ref) == len(port) == 4
    np.testing.assert_allclose(port, ref, rtol=2e-5, atol=0)
    for run in (ref, port):
        ce, mtp = [r[1] for r in run], [r[2] for r in run]
        assert ce[-1] < ce[0] and mtp[-1] > 1.5 * mtp[0], run


def test_launcher_restarts_from_its_checkpoint(tmp_path, capsys):
    """3 steps, a checkpoint, a relaunch to 6: the parameters equal 6
    straight steps' bit for bit."""
    argv = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "2", "--seq",
            "32", "--device", "cpu"]
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    p_launch.main(argv + ["--steps", "3"] + ckpt)
    resumed = p_launch.main(argv + ["--steps", "6"] + ckpt)
    assert "restored checkpoint at step 3" in capsys.readouterr().out
    straight = p_launch.main(argv + ["--steps", "6"])
    for (path, a), (_, b) in zip(_leaves(resumed), _leaves(straight)):
        assert torch.equal(a, b), path
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_6"]


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


@pytest.mark.parametrize("restart", [False, True])
def test_launcher_on_a_one_rank_mesh_equals_the_unsharded(
        one_rank, tmp_path, monkeypatch, capsys, restart):
    """``--mesh 1x1`` (DTensor parameters, a sharded batch, the step in a
    mesh context) gives the unsharded launcher's losses and parameters bit
    for bit when both read the sharded batch's rows; a relaunch from its
    checkpoint (3 steps, then to 6) equals 6 straight steps."""
    from repro_torch.data import pipeline as p_pipe

    argv = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "2", "--seq",
            "32", "--device", "cpu", "--steps", "6"]
    mesh_losses, plain_losses = [], []
    _record_losses(monkeypatch, p_launch, mesh_losses, traced=False)
    if restart:
        ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "3"]
        p_launch.main(argv[:-1] + ["3", "--mesh", "1x1"] + ckpt)
        got = p_launch.main(argv + ["--mesh", "1x1"] + ckpt)
        assert "restored checkpoint at step 3" in capsys.readouterr().out
    else:
        got = p_launch.main(argv + ["--mesh", "1x1"])
    assert all(isinstance(t, torch.distributed.tensor.DTensor)
               for _, t in _leaves(got))
    mesh_losses = list(mesh_losses)

    def rows(cfg, step, mesh=None):
        buf = p_pipe.rows_for_step(cfg, step, range(cfg.batch))
        return buf[:, :-1], buf[:, 1:]
    monkeypatch.setattr(p_launch, "batch_for_step", rows)
    _record_losses(monkeypatch, p_launch, plain_losses, traced=False)
    want = p_launch.main(argv)
    assert mesh_losses[-6:] == plain_losses
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a.to_local(), b), path


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_optimizer_state_carries_across_packages(state_dtype):
    """The reference trains the smoke internlm2 two steps; its parameters and
    AdamW state (int8 codes and scales included) carry into the port
    exactly and back, and one more train step in each package from that
    same state agrees (loss within rtol 1e-5, parameters within 1e-5)."""
    rcfg = r_reg.get_smoke_config("internlm2-1.8b")
    pcfg = p_reg.get_smoke_config("internlm2-1.8b")
    kw = dict(lr=1e-2, grad_clip=1.0, state_dtype=state_dtype)
    rt = r_step.TrainConfig(adam=r_optim.AdamWConfig(**kw))
    pt = p_step.TrainConfig(adam=p_optim.AdamWConfig(**kw))
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, rcfg.vocab, (2, 16)),
                "labels": rng.integers(0, rcfg.vocab, (2, 16))}
               for _ in range(3)]

    def r_loss(p, bt):
        return r_lm.lm_loss(p, rcfg, bt["tokens"], bt["labels"])

    def p_loss(p, bt):
        return p_lm.lm_loss(p, pcfg, bt["tokens"], bt["labels"])

    r_fn = jax.jit(r_step.make_train_step(r_loss, rt))
    rp = r_specs.materialize(jax.random.PRNGKey(6), r_lm.lm_specs(rcfg))
    ro = r_step.init_optimizer(rp, rt)
    for bt in batches[:2]:
        rp, ro, _ = r_fn(rp, ro, {k: jnp.asarray(v, jnp.int32)
                                  for k, v in bt.items()})
    pp = p_lm.from_reference_params(pcfg, _np_tree(rp), device="cpu")
    po = p_optim.opt_state_from_reference(p_lm.lm_specs(pcfg), _np_tree(ro),
                                          pt.adam, device="cpu")
    assert int(po["step"]) == 2
    back = p_optim.opt_state_to_reference(po)
    for (path, a), (_, b) in zip(_leaves(back),
                                 _leaves(_np_tree(ro))):
        np.testing.assert_array_equal(a, np.asarray(b, a.dtype),
                                      err_msg=str(path))
    rp, ro, rm = r_fn(rp, ro, {k: jnp.asarray(v, jnp.int32)
                               for k, v in batches[2].items()})
    pp, po, pm = p_step.make_train_step(p_loss, pt)(
        pp, po, {k: torch.tensor(v) for k, v in batches[2].items()})
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    for (path, a), (_, b) in zip(_leaves(pp), _leaves(_np_tree(rp))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))
