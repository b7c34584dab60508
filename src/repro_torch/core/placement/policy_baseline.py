"""'Policy' baseline (Myung et al., TNNLS 2021) — the prior RL placement method the
paper compares against in Fig 10/11.

Myung's method is a policy-gradient (REINFORCE-family) placer whose network emits a
categorical distribution over physical cores per logical node, sampled without
replacement, trained with a moving-average baseline. We reproduce that shape:
per-node logits [n, n_cores] -> masked sequential sampling -> REINFORCE with
exponential-moving-average baseline. No critic, no clipping — the contrast with the
paper's PPO+GCN continuous-action method is exactly what Fig 10 measures.

Each iteration samples the whole candidate batch on ``device`` (one step per
node, vectorised over the batch: Gumbel-max over the masked logits, as
``jax.random.categorical`` draws), copies the placements to the host, scores
them in one scorer call (``cfg.backend``; ``None`` resolves by device:
``"cuda"`` on a CUDA device, so link-level objectives launch the link-traffic
kernel once an iteration, and ``"batch"`` on the CPU) and takes one AdamW step
on the REINFORCE loss. Randomness comes from ``torch.Generator``s seeded with
``cfg.seed``: the initial weights are drawn on the CPU, the Gumbel noise on
the device. ``cfg.init_params`` and ``cfg.gumbel`` replace them with given
weights and draws (the reference's, in the parity tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve_backend, resolve_device
from ...models.specs import materialize, param
from ...obs import maybe_span
from ...train.optim import AdamW, AdamWConfig
from ..noc_batch import make_scorer

#: the reference masks taken cores with this logit
MASKED = -1e30


@dataclasses.dataclass
class PolicyConfig:
    batch_size: int = 64
    lr: float = 5e-3
    iterations: int = 60
    d_hidden: int = 64
    baseline_decay: float = 0.9
    seed: int = 0
    # candidate scoring: "batch"|"torch"|"cuda"|"reference"; None resolves by
    # device: "cuda" on a CUDA device, "batch" (numpy float64) on the CPU
    backend: str | None = None
    objective: object = "comm_cost"   # repro_torch.deploy.objective spec
    init_params: dict | None = None   # {w1, b1, w2, b2} reference arrays
    gumbel: object = None       # [iterations, batch_size, n, n_cores] draws


def policy_specs(d_feat: int, n_cores: int, d_hidden: int):
    return {
        "w1": param((d_feat, d_hidden), ("p_in", "p_out")),
        "b1": param((d_hidden,), ("p_out",), init="zeros"),
        "w2": param((d_hidden, n_cores), ("p_in", "p_out"), scale=0.01),
        "b2": param((n_cores,), ("p_out",), init="zeros"),
    }


def policy_logits(params, feats):
    h = torch.relu(feats @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]        # [n, n_cores]


def _gumbel_noise(shape, generator: torch.Generator):
    """Standard Gumbel draws on the generator's device, as
    ``jax.random.gumbel`` makes them: ``-log(-log(u))``, ``u`` uniform on
    ``[tiny, 1)``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def sample_placements(logits, n_samples: int, generator=None, gumbel=None):
    """Sequential masked categorical sampling without replacement.

    Node ``i`` of every sample takes ``argmax(masked_logits[i] + g)``
    (Gumbel-max), then its core is masked for the nodes after it. ``gumbel``
    is the ``[n_samples, n, n_cores]`` noise; without it the noise is drawn
    from ``generator``. Returns placements ``[B, n]`` (int64) and log-probs
    ``[B]``.
    """
    n, n_cores = logits.shape
    if gumbel is None:
        gumbel = _gumbel_noise((n_samples, n, n_cores), generator)
    rows = torch.arange(n_samples, device=logits.device)
    taken = torch.zeros(n_samples, n_cores, dtype=torch.bool,
                        device=logits.device)
    choices = torch.empty(n_samples, n, dtype=torch.long,
                          device=logits.device)
    logp = torch.zeros(n_samples, dtype=logits.dtype, device=logits.device)
    for i in range(n):
        l = logits[i].expand(n_samples, n_cores).masked_fill(taken, MASKED)
        choice = torch.argmax(l + gumbel[:, i], dim=1)
        logp = logp + torch.log_softmax(l, dim=1)[rows, choice]
        taken[rows, choice] = True
        choices[:, i] = choice
    return choices, logp


def placement_logp(params, feats, placements):
    """Log-prob of given placements under the masked sequential policy:
    ``[B]``. One pass: the cores taken before each node are the exclusive
    cumulative sum of the placements' one-hot rows."""
    logits = policy_logits(params, feats)
    n, n_cores = logits.shape
    onehot = torch.nn.functional.one_hot(placements, n_cores)   # [B, n, C]
    before = (torch.cumsum(onehot, dim=1) - onehot) > 0
    l = logits.expand(placements.shape[0], n, n_cores).masked_fill(before,
                                                                   MASKED)
    logps = torch.log_softmax(l, dim=2).gather(2, placements[..., None])
    return logps[..., 0].sum(dim=1)


def _init_params(cfg: PolicyConfig, d_feat: int, n_cores: int, dev):
    if cfg.init_params is None:
        params = materialize(policy_specs(d_feat, n_cores, cfg.d_hidden),
                             torch.Generator().manual_seed(cfg.seed), dev)
    else:
        params = {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                  device=dev)
                  for k, v in cfg.init_params.items()}
    return {k: v.requires_grad_(True) for k, v in params.items()}


def run_policy_baseline(graph, noc, cfg: PolicyConfig = PolicyConfig(),
                        recorder=None, device=None):
    """Train the policy for ``cfg.iterations`` iterations on ``device``
    (``None``: the card) and return ``{"best_cost", "best_placement",
    "history"}``.

    ``recorder`` gets one ``policy.iter`` event per iteration and one span
    per phase of each iteration (``policy.sample``, ``policy.score``,
    ``policy.update``, each ending in a wait for its result); the
    trajectory is the same with or without it."""
    dev = resolve_device(device)
    feats = torch.as_tensor(graph.node_features(), dtype=torch.float32,
                            device=dev)
    params = _init_params(cfg, feats.shape[1], noc.n_cores, dev)
    names = sorted(params)
    opt = AdamW([params[k] for k in names], AdamWConfig(lr=cfg.lr))
    noise = (torch.Generator(device=dev).manual_seed(cfg.seed)
             if cfg.gumbel is None else None)
    score = make_scorer(noc, graph, resolve_backend(cfg.backend, dev),
                        cfg.objective, recorder=recorder, device=dev)
    baseline = None
    best_cost, best_placement = np.inf, None
    history = []
    for it in range(cfg.iterations):
        gumbel = (None if cfg.gumbel is None else torch.as_tensor(
            np.asarray(cfg.gumbel[it]), dtype=torch.float32, device=dev))
        with maybe_span(recorder, "policy.sample"):
            with torch.no_grad():
                placements, _ = sample_placements(
                    policy_logits(params, feats), cfg.batch_size,
                    generator=noise, gumbel=gumbel)
            placements_np = placements.cpu().numpy()
        with maybe_span(recorder, "policy.score"):
            costs = score(placements_np)    # whole candidate set in one call
        i = int(costs.argmin())
        if costs[i] < best_cost:
            best_cost, best_placement = float(costs[i]), placements_np[i].copy()
        rewards = -costs
        baseline = rewards.mean() if baseline is None else \
            cfg.baseline_decay * baseline + (1 - cfg.baseline_decay) * rewards.mean()
        with maybe_span(recorder, "policy.update"):
            adv = torch.as_tensor((rewards - baseline) / (rewards.std() + 1e-8),
                                  dtype=torch.float32, device=dev)
            loss = -torch.mean(placement_logp(params, feats, placements) * adv)
            opt.update(torch.autograd.grad(loss, [params[k] for k in names]))
            loss = float(loss.detach())
        history.append({"iter": it, "mean_cost": float(costs.mean()),
                        "best_cost": best_cost, "loss": loss})
        if recorder is not None:
            recorder.event("policy.iter", **history[-1])
    return {"best_cost": best_cost, "best_placement": best_placement,
            "history": history}
