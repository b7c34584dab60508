"""The multi-rank cases of ``tests/test_torch_sharding.py``: one gloo world
of 8 CPU ranks, a ``(2, 4)`` mesh over ``("data", "model")``.

    python tests/torch_mesh_worker.py DIR

reads ``DIR/inputs.npz`` (the reference's weights and inputs, written by
the test) and ``DIR/ref_ckpt`` (a checkpoint the reference wrote), runs
every case on every rank, and writes ``DIR/rank<r>.npz``: what each case
gave (full tensors, gathered), and the traceback of any case that raised.
Every collective has the process group's 60 s timeout, so a hang fails.
"""
import datetime
import os
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

WORLD = 8


def _tree(flat, prefix):
    """The nested dict under ``prefix/`` of a flat ``{path: array}``."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node, parts = out, k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flat(tree, prefix):
    from repro_torch.models.specs import tree_leaves
    return {"/".join((prefix,) + path): _full(t) for path, t in
            tree_leaves(tree)}


def _full(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def case_step(inp, out, mesh):
    """The sharded train step of the reference's test: internlm2's smoke
    config, batch 8 x 16 over ``data``, parameters replicated; the
    gradients the step took are kept."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.specs import tree_map
    from repro_torch.sharding import rules as R
    from repro_torch.train import step as S
    from repro_torch.train.optim import AdamWConfig, adamw_init

    cfg = get_smoke_config("internlm2-1.8b")
    params = lm.from_reference_params(cfg, _tree(inp, "params"),
                                      device="cpu")
    paths = [path for path, _ in S.tree_leaves(params)]
    params = tree_map(lambda p: R.distribute(p, R.NamedSharding(mesh, ())),
                      params)
    bsh = R.NamedSharding(mesh, R.batch_partition(mesh, 2))
    batch = {k: R.distribute(torch.from_numpy(inp[f"step/{k}"]).long(), bsh)
             for k in ("tokens", "labels")}
    tcfg = S.TrainConfig(adam=AdamWConfig(lr=1e-3))
    step = S.make_train_step(
        lambda p, bt: lm.lm_loss(p, cfg, bt["tokens"], bt["labels"]), tcfg)
    value_and_grad, taken = S._value_and_grad, []

    def recorded(*a):
        res = value_and_grad(*a)
        taken.append(res[2])
        return res
    S._value_and_grad = recorded
    try:
        with R.set_context(mesh):
            p2, opt, m = step(params, adamw_init(params, tcfg.adam), batch)
    finally:
        S._value_and_grad = value_and_grad
    out["step/loss"] = m["loss"].numpy()
    out.update(_flat(p2, "step/params"))
    out.update({"/".join(("step/grads",) + path): _full(g)
                for path, g in zip(paths, taken[0])})
    out["step/opt_placements"] = np.array(
        [str(opt["m"]["embed"]["table"].placements)])


def case_fsdp(inp, out, mesh):
    """``case_step``'s step with the parameters laid out by ``FSDP_RULES``
    (ZeRO-3: ``embed`` over ``data``) inside ``set_context(mesh,
    fsdp=True)``, AdamW with the global-norm clip ``fsdp/clip``; its
    loss, the gradients it took, the parameters and moments it left (full
    tensors) are kept."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.sharding import rules as R
    from repro_torch.train import step as S
    from repro_torch.train.optim import AdamWConfig, adamw_init

    cfg = get_smoke_config("internlm2-1.8b")
    params = lm.from_reference_params(cfg, _tree(inp, "params"),
                                      device="cpu")
    paths = [path for path, _ in S.tree_leaves(params)]
    shardings = R.tree_shardings(mesh, lm.lm_specs(cfg), R.FSDP_RULES)
    params = {path: R.distribute(t, _at(shardings, path))
              for path, t in S.tree_leaves(params)}
    params = _nest(params)
    bsh = R.NamedSharding(mesh, R.batch_partition(mesh, 2))
    batch = {k: R.distribute(torch.from_numpy(inp[f"step/{k}"]).long(), bsh)
             for k in ("tokens", "labels")}
    tcfg = S.TrainConfig(adam=AdamWConfig(
        lr=1e-3, grad_clip=float(inp["fsdp/clip"])))
    step = S.make_train_step(
        lambda p, bt: lm.lm_loss(p, cfg, bt["tokens"], bt["labels"]), tcfg)
    value_and_grad, taken = S._value_and_grad, []

    def recorded(*a):
        res = value_and_grad(*a)
        taken.append(res[2])
        return res
    S._value_and_grad = recorded
    try:
        with R.set_context(mesh, fsdp=True):
            p2, opt, m = step(params, adamw_init(params, tcfg.adam), batch)
    finally:
        S._value_and_grad = value_and_grad
    out["fsdp/loss"] = m["loss"].numpy()
    out.update({"/".join(("fsdp/grads",) + path): _full(g)
                for path, g in zip(paths, taken[0])})
    out.update(_flat(p2, "fsdp/params"))
    out.update(_flat(opt["m"], "fsdp/m"))
    out.update(_flat(opt["v"], "fsdp/v"))
    out["fsdp/placements"] = np.array(
        [str(params["seg0"]["attn"]["wq"].placements),
         str(taken[0][paths.index(("seg0", "attn", "wq"))].placements)])


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def case_sharded_params(inp, out, mesh):
    """Parameters laid out by ``BASE_RULES`` (tensor parallel over
    ``model``), two steps of AdamW with global-norm clipping, int8 moments
    and int8 error-feedback compression, against the same steps on one
    device; with 2 kv heads (attention gathers the heads of q) and with 4
    (q, k and v keep their head shards)."""
    import contextlib
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize, tree_leaves
    from repro_torch.sharding import rules as R
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import (TrainConfig, error_state_init,
                                        init_optimizer, make_train_step)

    tcfg = TrainConfig(adam=AdamWConfig(lr=1e-3, grad_clip=1.0,
                                        state_dtype="int8"),
                       grad_compression="int8_ef")
    batch = {k: torch.from_numpy(inp[f"step/{k}"]).long()
             for k in ("tokens", "labels")}
    bsh = R.NamedSharding(mesh, R.batch_partition(mesh, 2))
    dbatch = {k: R.distribute(v, bsh) for k, v in batch.items()}

    def place(t, h):
        return (R.distribute(t, h) if isinstance(h, R.NamedSharding)
                else {k: place(t[k], h[k]) for k in t})

    for kv in (2, 4):
        cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"),
                                  n_kv_heads=kv)
        step = make_train_step(
            lambda p, bt: lm.lm_loss(p, cfg, bt["tokens"], bt["labels"]),
            tcfg)

        def run(params, bt, ctx):
            opt, err = init_optimizer(params, tcfg), error_state_init(params)
            losses = []
            with ctx:
                for _ in range(2):
                    params, opt, m, err = step(params, opt, bt, err)
                    losses.append(float(m["loss"]))
            return params, opt, losses

        def draw():
            return materialize(lm.lm_specs(cfg),
                               torch.Generator().manual_seed(0),
                               device="cpu")
        want, want_opt, want_losses = run(draw(), batch,
                                          contextlib.nullcontext())
        sh = R.tree_shardings(mesh, lm.lm_specs(cfg), R.BASE_RULES)
        got, opt, losses = run(place(draw(), sh), dbatch,
                               R.set_context(mesh))
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
        key = f"tp/kv{kv}"
        out[f"{key}/param_gap"] = np.array(max(
            float(np.abs(_full(a) - b.detach().numpy()).max())
            for (_, a), (_, b) in pairs))
        out[f"{key}/losses"] = np.array([losses, want_losses])
        # the int8 moments' per-channel scales (each an absmax over the
        # whole channel), relative to the channel's
        scales = [(a, b) for (p, a), (_, b) in zip(
            tree_leaves({"m": opt["m"], "v": opt["v"]}),
            tree_leaves({"m": want_opt["m"], "v": want_opt["v"]}))
            if p[-1] == "scale"]
        out[f"{key}/scale_gap"] = np.array(max(
            float(np.abs(_full(a) - b.numpy()).max() / b.abs().max())
            for a, b in scales))
        out[f"{key}/wk"] = np.array(str(got["seg0"]["attn"]["wk"].placements))
        out[f"{key}/moment_placements"] = np.array(
            str(opt["m"]["seg0"]["mlp"]["w_gate"]["codes"].placements))


def case_seq_shard(inp, out, mesh):
    """Sequence parallelism: internlm2's smoke loss and gradients with
    ``seq_shard_attn`` under ``set_context(mesh, seq_shard=True)``, and the
    shard of the sequence each attention call took."""
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import layers, lm
    from repro_torch.models.specs import tree_leaves, tree_map
    from repro_torch.sharding import rules as R

    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"),
                              seq_shard_attn=True)
    params = lm.from_reference_params(cfg, _tree(inp, "params"),
                                      device="cpu")
    params = tree_map(lambda p: R.distribute(p, R.NamedSharding(mesh, ())),
                      params)
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
    bsh = R.NamedSharding(mesh, R.batch_partition(mesh, 2))
    tk, lb = (R.distribute(torch.from_numpy(inp[f"step/{k}"]).long(), bsh)
              for k in ("tokens", "labels"))
    apply, shards = layers._SeqShardAttention.apply, []

    def recorded(q, k, v, r, causal):
        shards.append((r, q.shape[1], k.shape[1]))
        return apply(q, k, v, r, causal)
    layers._SeqShardAttention.apply = recorded
    try:
        with R.set_context(mesh, seq_shard=True):
            x = lm._embed_tokens(params, cfg, tk)
            loss, _ = lm.lm_loss(params, cfg, tk, lb)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        layers._SeqShardAttention.apply = apply
    out["seq/x_placements"] = np.array([str(x.placements)])
    out["seq/loss"] = _full(loss)
    out["seq/shards"] = np.array(shards)
    out.update({"/".join(("seq/grads",) + path): _full(g)
                for (path, _), g in zip(tree_leaves(params), grads)})


def case_families(inp, out, mesh):
    """zamba2 (the SSD's heads pinned to ``model`` by ``dim_constraint``)
    and qwen3-moe (every MoE layer expert-parallel) at their smoke configs,
    batch 4 x 32: loss and gradients on the mesh and on one device."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize, tree_leaves, tree_map
    from repro_torch.sharding import rules as R

    rng = np.random.default_rng(4)
    for arch in ("zamba2-2.7b", "qwen3-moe-30b-a3b"):
        cfg = get_smoke_config(arch)
        params = materialize(lm.lm_specs(cfg),
                             torch.Generator().manual_seed(0), device="cpu")
        tok, lab = (torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)))
                    for _ in range(2))
        leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
        loss = lm.lm_loss(params, cfg, tok, lab)[0]
        grads = torch.autograd.grad(loss, leaves)
        rep = R.NamedSharding(mesh, ())
        dp = tree_map(lambda t: R.distribute(t.detach(), rep), params)
        dleaves = [t.requires_grad_() for _, t in tree_leaves(dp)]
        bsh = R.NamedSharding(mesh, R.batch_partition(mesh, 2))
        with R.set_context(mesh):
            dloss = lm.lm_loss(dp, cfg, R.distribute(tok, bsh),
                               R.distribute(lab, bsh))[0]
            dgrads = torch.autograd.grad(dloss, dleaves)
        out[f"families/{arch}/loss"] = np.array([float(loss),
                                                 float(_full(dloss))])
        out[f"families/{arch}/grad_gap"] = np.array(max(
            float(np.abs(_full(a) - b.numpy()).max()
                  / max(1.0, float(b.abs().max())))
            for a, b in zip(dgrads, grads)))


def _xlstm_on_mesh(out, key, rows, seed):
    """xlstm-125m cut to d_model 256, vocab 4096 and its own mLSTM -> sLSTM
    order, ``rows`` x 64 tokens, on a ``(1, 8)`` mesh laid out as its
    training cell lays it out (4 heads on a model axis of 8): loss and
    gradients on the mesh and on one device, under ``key``."""
    import dataclasses
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize, tree_leaves
    from repro_torch.sharding import rules as R

    mesh8 = make_test_mesh((1, 8))
    cfg = dataclasses.replace(
        get_config("xlstm-125m"), d_model=256, vocab=4096,
        segments=(lm.Segment("mlstm", "none", 1),
                  lm.Segment("slstm", "none", 1)))
    cell = build_cell("xlstm-125m", ShapeSpec("x", 64, rows, "train"),
                      mesh8, cfg=cfg)
    p_sh, _, b_sh = cell.in_shardings
    params = materialize(lm.lm_specs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.default_rng(seed)
    tok, lab = (torch.from_numpy(rng.integers(0, cfg.vocab, (rows, 64)))
                for _ in range(2))
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
    loss = lm.lm_loss(params, cfg, tok, lab)[0]
    grads = torch.autograd.grad(loss, leaves)

    def placed(tree, sh):
        if isinstance(tree, dict):
            return {k: placed(v, sh[k]) for k, v in tree.items()}
        return R.distribute(tree.detach(), sh)
    dp = placed(params, p_sh)
    dleaves = [t.requires_grad_() for _, t in tree_leaves(dp)]
    with R.set_context(mesh8, extra_dp=cfg.prefer_dp):
        dloss = lm.lm_loss(dp, cfg, R.distribute(tok, b_sh["tokens"]),
                           R.distribute(lab, b_sh["labels"]))[0]
        dgrads = torch.autograd.grad(dloss, dleaves)
    out[f"{key}/loss"] = np.array([float(loss), float(_full(dloss))])
    out[f"{key}/grad_gaps"] = np.array([
        float(np.abs(_full(a) - b.numpy()).max() / float(b.abs().max()))
        for a, b in zip(dgrads, grads)])


def case_xlstm(inp, out, mesh):
    """:func:`_xlstm_on_mesh` at 8 rows: the model axis splits the rows."""
    _xlstm_on_mesh(out, "xlstm", 8, 5)


def case_xlstm_pairs(inp, out, mesh):
    """:func:`_xlstm_on_mesh` at 2 and 3 rows: the model axis divides
    neither the rows nor the 4 heads, and splits the (row, head) pairs (8
    pairs, one a rank; 12, two on ranks 0-5 and none on 6 and 7)."""
    for rows in (2, 3):
        _xlstm_on_mesh(out, f"xlstm_pairs/{rows}", rows, 5 + rows)


def case_gqa(inp, out, mesh):
    """internlm2's smoke config (4 query heads, 2 kv heads) with its
    parameters laid out by ``BASE_RULES``, as on the card's route:
    ``_kernel_route`` taken (on CPU tensors the flash kernels' wrappers run
    their plain versions), so K/V are not repeated, and each rank attends
    with its own query head over the kv head it reads. Loss and
    gradients against one device (the plain route, K/V repeated), and
    the heads of every flash call."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import layers, lm
    from repro_torch.models.specs import tree_leaves
    from repro_torch.sharding import rules as R

    cfg = get_smoke_config("internlm2-1.8b")
    params = lm.from_reference_params(cfg, _tree(inp, "params"),
                                      device="cpu")
    tok, lab = (torch.from_numpy(inp[f"step/{k}"]).long()
                for k in ("tokens", "labels"))
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
    loss = lm.lm_loss(params, cfg, tok, lab)[0]
    grads = torch.autograd.grad(loss, leaves)
    sh = R.tree_shardings(mesh, lm.lm_specs(cfg), R.BASE_RULES)

    def place(t, h):
        return (R.distribute(t.detach(), h) if isinstance(h, R.NamedSharding)
                else {k: place(t[k], h[k]) for k in t})
    dp = place(params, sh)
    dleaves = [t.requires_grad_() for _, t in tree_leaves(dp)]
    bsh = R.NamedSharding(mesh, R.batch_partition(mesh, 2))
    route, forward, heads = layers._kernel_route, layers._flash_forward, []

    def recorded(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1]))
        return forward(q, k, v, **kw)
    layers._kernel_route = lambda *a, **kw: True
    layers._flash_forward = recorded
    try:
        with R.set_context(mesh):
            dloss = lm.lm_loss(dp, cfg, R.distribute(tok, bsh),
                               R.distribute(lab, bsh))[0]
            dgrads = torch.autograd.grad(dloss, dleaves)
    finally:
        layers._kernel_route, layers._flash_forward = route, forward
    out["gqa/loss"] = np.array([float(loss), float(_full(dloss))])
    out["gqa/grad_gap"] = np.array(max(
        float(np.abs(_full(a) - b.numpy()).max() / float(b.abs().max()))
        for a, b in zip(dgrads, grads)))
    out["gqa/heads"] = np.array(heads)
    out["gqa/wk"] = np.array(str(dp["seg0"]["attn"]["wk"].placements))


def case_decode(inp, out, mesh):
    """Serving on the mesh: a prompt of 8 through ``prefill``, then one
    ``decode_step``, with parameters and caches laid out as a serving
    cell lays them out (``launch.cells._pick_rules``), against the same
    calls on one device. internlm2's smoke config with 2 kv heads (the
    caches split over their sequence: each rank attends over its own rows
    and the ranks' softmaxes merge, ``layers._merge_decode``) and with 4
    (the caches split over heads, attention on each rank's own heads),
    qwen3-moe (each decode token's MoE on gathered tokens) and minicpm3
    (MLA's absorbed decode on local shards) and zamba2 (Mamba2's states
    and the shared block's caches). Kept: each output's largest
    gap over its largest entry, and how often each sharded path ran."""
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.cells import _pick_rules
    from repro_torch.models import layers, lm, mla, moe
    from repro_torch.models.specs import materialize, tree_leaves
    from repro_torch.sharding import rules as R

    def place(t, h):
        return (R.distribute(t, h) if isinstance(h, R.NamedSharding)
                else {k: place(t[k], h[k]) for k in t})

    def gap_abs(a, b):
        return float(np.abs(_full(a).astype(np.float64)
                            - b.float().numpy()).max()
                     / max(float(b.float().abs().max()), 1e-30))

    ran = {}
    paths = {(layers, "_sharded_decode"), (mla, "_sharded_absorbed_decode"),
             (moe, "_moe_gathered_tokens"), (layers, "_merge_decode")}
    real = {name: getattr(mod, name) for mod, name in paths}

    def counting(name):
        def fn(*a, **kw):
            ran[name] = ran.get(name, 0) + 1
            return real[name](*a, **kw)
        return fn
    rng = np.random.default_rng(7)
    cases = (("internlm2-1.8b", 2), ("internlm2-1.8b", 4),
             ("qwen3-moe-30b-a3b", None), ("minicpm3-4b", None),
             ("zamba2-2.7b", None))
    try:
        for mod, name in paths:
            setattr(mod, name, counting(name))
        for arch, kv in cases:
            cfg = get_smoke_config(arch)
            if kv is not None:
                cfg = dataclasses.replace(cfg, n_kv_heads=kv)
            key = f"decode/{arch}/{kv}"
            params = materialize(lm.lm_specs(cfg),
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
            c_specs = lm.cache_specs(cfg, 4, 16)
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)))
            nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)))
            with torch.no_grad():
                cache = materialize(c_specs, device="cpu")
                want_p, cache = lm.prefill(params, cfg, prompt, cache)
                want_d, cache = lm.decode_step(params, cfg, cache, nxt, 8)
            rules = _pick_rules(cfg, mesh, False, "decode")
            dparams = place(params, R.tree_shardings(
                mesh, lm.lm_specs(cfg), rules))
            c_sh = R.tree_shardings(mesh, c_specs, rules)
            dcache = place(materialize(c_specs, device="cpu"), c_sh)
            bsh = R.NamedSharding(mesh, R.batch_partition(mesh, 2))
            ran.clear()
            with torch.no_grad(), R.set_context(mesh):
                got_p, dcache = lm.prefill(dparams, cfg,
                                           R.distribute(prompt, bsh), dcache)
                got_d, dcache = lm.decode_step(dparams, cfg, dcache,
                                               R.distribute(nxt, bsh), 8)
            out[f"{key}/prefill_gap"] = np.array(gap_abs(got_p, want_p))
            out[f"{key}/decode_gap"] = np.array(gap_abs(got_d, want_d))
            out[f"{key}/cache_gap"] = np.array(max(
                gap_abs(a, b) for (_, a), (_, b) in
                zip(tree_leaves(dcache), tree_leaves(cache))))
            out[f"{key}/ran"] = np.array(
                [ran.get(name, 0) for name in sorted(real)])
            out[f"{key}/cache_placements"] = np.array(str(
                dcache["seg0"][next(iter(dcache["seg0"]))].placements))
    finally:
        for mod, name in paths:
            setattr(mod, name, real[name])


def case_moe(inp, out, mesh):
    """MoE expert parallelism: forward and gradients of ``sum(y * ct) +
    aux``."""
    from repro_torch.models import moe
    from repro_torch.sharding import rules as R

    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff=32, capacity_factor=4.0)
    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in _tree(inp, "moe/params").items()}
    x = torch.from_numpy(inp["moe/x"]).requires_grad_()
    with R.set_context(mesh):
        y, aux = moe.moe_apply(p, x, cfg)
        loss = (y * torch.from_numpy(inp["moe/ct"])).sum() + aux
        loss.full_tensor().backward()
    out["moe/out"] = _full(y)
    out["moe/aux"] = _full(aux)
    out["moe/out_placements"] = np.array([str(y.placements)])
    for k, v in p.items():
        out[f"moe/grad/{k}"] = v.grad.numpy()
    out["moe/grad/x"] = x.grad.numpy()


def case_elastic(inp, out, mesh, d):
    """Save from the 2 x 4 mesh, restore onto a 2 x 2 mesh (ranks 0-3);
    restore the reference's checkpoint onto the 2 x 4 mesh."""
    from repro_torch.checkpoint import store
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.specs import param
    from repro_torch.sharding.rules import (BASE_RULES, distribute,
                                            local_range, tree_shardings)

    specs = {"w": param((16, 8), ("embed", "mlp")),
             "e": param((32, 16), ("vocab", "embed"))}
    tree = {k: torch.from_numpy(inp[f"elastic/{k}"]) for k in specs}
    sh8 = tree_shardings(mesh, specs, BASE_RULES)
    tree8 = {k: distribute(t, sh8[k]) for k, t in tree.items()}
    ckpt = os.path.join(d, "port_ckpt")
    store.save(ckpt, 1, tree8)
    mesh4 = make_test_mesh((2, 2), ("data", "model"))
    sh4 = tree_shardings(mesh4, specs, BASE_RULES)
    template = {k: torch.zeros_like(t) for k, t in tree.items()}
    restored, step, _ = store.restore(ckpt, template, shardings=sh4)
    rank = dist.get_rank()
    if rank < 4:
        for k, t in restored.items():
            want = tree[k]
            for dim, p in enumerate(sh4[k].spec):
                if p is not None:
                    r = local_range(mesh4, sh4[k].spec, dim, want.shape[dim])
                    want = want.narrow(dim, r.start, len(r))
            out[f"elastic/local_equal/{k}"] = np.array(
                torch.equal(t.to_local(), want))
            out[f"elastic/placements/{k}"] = np.array(str(t.placements))
    ref, _, _ = store.restore(os.path.join(d, "ref_ckpt"), template,
                              shardings=sh8)
    for k, t in ref.items():
        out[f"elastic/ref/{k}"] = _full(t)
        out[f"elastic/ref_placements/{k}"] = np.array(str(t.placements))
    out["elastic/step"] = np.array(step)


def case_batches(inp, out, mesh):
    """Each rank's rows of ``batch_for_step`` on the 2 x 4 mesh and on a
    2 x 2 x 2 ``(pod, data, model)`` mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.data.pipeline import DataConfig, batch_for_step

    cfg = DataConfig(vocab=97, batch=8, seq_len=12, seed=3)
    cube = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    for name, m in (("2x4", mesh), ("2x2x2", cube)):
        for step in (0, 5):
            tokens, labels = batch_for_step(cfg, step, m)
            out[f"batch/{name}/{step}/tokens"] = tokens.to_local().numpy()
            out[f"batch/{name}/{step}/labels"] = labels.to_local().numpy()
            out[f"batch/{name}/{step}/full"] = tokens.full_tensor().numpy()


# the layouts of ``case_rope``: (name, placements on the 2 x 4 mesh)
ROPE_LAYOUTS = (("batch_seq", ("S0", "S1")), ("seq_heads", ("S1", "S2")),
                ("heads", ("R", "S2")), ("seq_seq", ("S1", "S1")),
                ("partial", ("P", "R")), ("head_dim", ("S3", "R")))


def case_rope(inp, out, mesh):
    """``apply_rope`` of DTensors ``x [3, 10, 4, 16]`` (uneven shards) laid
    out as ``ROPE_LAYOUTS`` say, float32 and bf16, positions ``5 + [S]`` and
    random int32 ``[B, S]``: the output and the gradient of a seeded
    cotangent, gathered, with the calls of the kernel's wrapper each way
    (``layers._rope_kernel``, counted). The partial sum holds x on the
    ranks of ``data`` 0 and zeros on the others."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import layers as L

    kinds = {"R": Replicate(), "P": Partial(),
             **{f"S{d}": Shard(d) for d in range(4)}}
    real, calls = L._rope_kernel, []

    def counted(x, positions, theta, inverse=False):
        calls.append(inverse)
        return real(x, positions, theta, inverse=inverse)

    gen = torch.Generator().manual_seed(4)
    x32 = torch.randn(3, 10, 4, 16, generator=gen) * 2
    d32 = torch.randn(3, 10, 4, 16, generator=gen)
    pos = {"seq": 5 + torch.arange(10),
           "rows": torch.randint(0, 300_000, (3, 10), generator=gen,
                                 dtype=torch.int32)}
    out["rope/x"], out["rope/d"] = x32.numpy(), d32.numpy()
    for pname, positions in pos.items():
        out[f"rope/positions/{pname}"] = positions.numpy()
    coord = mesh.get_coordinate()
    L._rope_kernel = counted
    try:
        for name, kind in ROPE_LAYOUTS:
            pl = [kinds[k] for k in kind]
            for dt in (torch.float32, torch.bfloat16):
                x, d = x32.to(dt), d32.to(dt)
                for pname, positions in pos.items():
                    key = f"rope/{name}/{str(dt).split('.')[1]}/{pname}"
                    if name == "partial":
                        xd = DTensor.from_local(
                            x if coord[0] == 0 else torch.zeros_like(x),
                            mesh, pl, run_check=False)
                        dd = DTensor.from_local(d, mesh, [Replicate()] * 2,
                                                run_check=False)
                    else:
                        xd, dd = (torch.distributed.tensor.distribute_tensor(
                            t, mesh, pl) for t in (x, d))
                    xd = xd.detach().requires_grad_()
                    calls.clear()
                    with implicit_replication():
                        y = L.apply_rope(xd, positions, 1e6)
                        y.backward(dd)
                    out[f"{key}/y"] = y.detach().full_tensor().float().numpy()
                    out[f"{key}/grad"] = xd.grad.full_tensor().float().numpy()
                    out[f"{key}/calls"] = np.array(
                        [calls.count(False), calls.count(True)])
    finally:
        L._rope_kernel = real


def case_launch(inp, out, mesh):
    """``launch.train --smoke --mesh 2x4`` from the reference's weights,
    every step's loss."""
    import repro_torch.launch.train as launch
    from repro_torch.models import lm

    losses = []
    real = launch.make_train_step

    def recorded(loss_fn, tcfg):
        step = real(loss_fn, tcfg)

        def run(*a):
            res = step(*a)
            losses.append(float(res[2]["loss"]))
            return res
        return run
    launch.make_train_step = recorded
    launch.init_params = lambda cfg, seed, device: lm.from_reference_params(
        cfg, _tree(inp, "params"), device=device)
    launch.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "6",
                 "--batch", "8", "--seq", "32", "--mesh", "2x4",
                 "--device", "cpu"])
    out["launch/losses"] = np.array(losses)


def run(rank, d):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(d, "pg"), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch.mesh import make_test_mesh
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    mesh = make_test_mesh((2, 4), ("data", "model"))
    for name, case in (("step", case_step), ("fsdp", case_fsdp),
                       ("tp", case_sharded_params),
                       ("seq", case_seq_shard),
                       ("families", case_families),
                       ("xlstm", case_xlstm),
                       ("xlstm_pairs", case_xlstm_pairs),
                       ("gqa", case_gqa),
                       ("decode", case_decode),
                       ("moe", case_moe), ("batch", case_batches),
                       ("rope", case_rope),
                       ("launch", case_launch)):
        try:
            case(inp, out, mesh)
        except Exception:
            out[f"{name}/error"] = np.array(traceback.format_exc())
    try:
        case_elastic(inp, out, mesh, d)
    except Exception:
        out["elastic/error"] = np.array(traceback.format_exc())
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    tempfile.tempdir = sys.argv[1]
    mp.spawn(run, args=(sys.argv[1],), nprocs=WORLD)
