"""PPO-clip training of the placement policy (paper §4.3 "Weight Update", Eq. 5).

One-shot placement is a contextual bandit: every episode is a single action (a
full placement) followed by the simulator reward (Eq. 4). PPO runs with a
state-value baseline from the critic, advantage normalization, reward scaling
against the Zigzag baseline, and reward clipping to [-10, 10] (the paper's
setting).

Paper hyperparameters (§5.1): gcn feature size 32, batch 256, lr 0.005,
ppo_epochs 10, clip 0.1–0.5, reward clip [-10, 10]. Defaults below mirror them.

Each iteration samples a rollout batch on the device, copies the actions to
the host, discretizes them with the float64 host resolver (bit-exact against
the sequential spiral), copies the placements back to the scorer, and runs
all ``ppo_epochs`` epochs of the update as a loop on the device. The scorer
follows ``cfg.backend``: ``"cuda"`` scores link-level objectives through the
link-traffic kernel.

Randomness comes from ``torch.Generator``s seeded with ``cfg.seed``: the
initial weights are drawn on the CPU, the rollout noise on the device.
``cfg.init_params`` and ``cfg.eps`` replace them with given weights and draws
(the reference's, in the parity tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve_device
from ...obs import maybe_span
from ...train.optim import AdamW, AdamWConfig
from ..noc_batch import make_scorer
from . import actor_critic as ac
from .discretize_batch import actions_to_placement_batch


@dataclasses.dataclass
class PPOConfig:
    batch_size: int = 256
    lr: float = 5e-3
    ppo_epochs: int = 10
    clip: float = 0.2           # paper reports 0.1 (range) and 0.5 (ppo_clip)
    entropy_coef: float = 1e-3
    reward_clip: float = 10.0
    iterations: int = 60
    d_gcn: int = 32             # paper: GCN feature size 32
    d_fc: int = 64
    freeze_gcn: bool = True     # paper: GCN pre-trained, not updated by PPO
    action_clip: float = 1.0
    seed: int = 0
    backend: str = "batch"      # rollout scoring: "batch"|"torch"|"cuda"|"reference"
    objective: object = "comm_cost"   # repro_torch.deploy.objective spec
    device_discretize: bool = False   # reference's device resolver: not ported
    init_params: tuple | None = None  # (actor, critic) reference param dicts
    eps: object = None          # [iterations, batch_size, n, 2] N(0,1) draws


def _ppo_epoch(actor, critic, opt_a, opt_c, lap, feats, acts, logp_old,
               rewards, clip: float, ent_coef: float):
    value = critic(lap, feats)
    adv = rewards - value.detach()
    # population std, as jnp.std computes it
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

    mu, log_std = actor(lap, feats)
    ratio = torch.exp(ac.gaussian_logp(acts, mu, log_std) - logp_old)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
    pg = -torch.mean(torch.minimum(unclipped, clipped))
    la = pg - ent_coef * ac.entropy(log_std)
    lc = torch.mean((rewards - value) ** 2)

    opt_a.update(torch.autograd.grad(la, opt_a.params))
    opt_c.update(torch.autograd.grad(lc, opt_c.params))
    return la.detach(), lc.detach()


def ppo_update(actor, critic, opt_a, opt_c, lap, feats, acts, logp_old,
               rewards, n_epochs: int, clip: float, ent_coef: float):
    """All ``n_epochs`` inner epochs on one rollout batch, in place.
    Returns the last epoch's (actor loss, critic loss) as tensors."""
    la = lc = None
    for _ in range(n_epochs):
        la, lc = _ppo_epoch(actor, critic, opt_a, opt_c, lap, feats, acts,
                            logp_old, rewards, clip, ent_coef)
    return la, lc


def make_optimizers(actor, critic, cfg: PPOConfig):
    """AdamW for both networks. ``freeze_gcn`` leaves the actor's GCN out of
    the update: the reference zeroes its gradients, which keeps its AdamW
    moments at zero and so its step at exactly zero."""
    adam = AdamWConfig(lr=cfg.lr)
    actor_params = [p for name, p in actor.named_parameters()
                    if not (cfg.freeze_gcn and name.startswith("gcn."))]
    return AdamW(actor_params, adam), AdamW(critic.parameters(), adam)


@dataclasses.dataclass
class PPOState:
    actor: ac.Actor
    critic: ac.Critic
    opt_a: AdamW
    opt_c: AdamW
    history: list
    best_cost: float
    best_placement: np.ndarray


def run_ppo(graph, noc, cfg: PPOConfig = PPOConfig(), baseline_cost=None,
            priority=None, recorder=None, device=None) -> PPOState:
    """Optimize a placement of ``graph`` on ``noc`` with PPO on ``device``
    (``None``: the card). Returns the best placement found.

    ``recorder`` emits one ``ppo.iter`` event per iteration — mean/min rollout
    cost, best-so-far, and the PPO policy / value losses — plus scoring
    dispatch counters and one span per phase of each iteration
    (``ppo.sample``, ``ppo.discretize``, ``ppo.score``, ``ppo.update``); the
    trajectory is the same with or without it."""
    if cfg.device_discretize:
        raise NotImplementedError(
            "device_discretize: the device resolver is not ported yet "
            "(ROADMAP queue 1, item 3: torch resolver)")
    dev = resolve_device(device)
    lap = torch.as_tensor(graph.laplacian(), dtype=torch.float32, device=dev)
    feats = torch.as_tensor(graph.node_features(), dtype=torch.float32,
                            device=dev)
    if cfg.init_params is None:
        init_gen = torch.Generator().manual_seed(cfg.seed)
        actor, critic = ac.init_actor_critic(init_gen, feats.shape[1],
                                             cfg.d_gcn, cfg.d_fc)
        actor, critic = actor.to(dev), critic.to(dev)
    else:
        actor, critic = ac.from_reference_params(*cfg.init_params, device=dev)
    opt_a, opt_c = make_optimizers(actor, critic, cfg)
    noise = (torch.Generator(device=dev).manual_seed(cfg.seed)
             if cfg.eps is None else None)

    if baseline_cost is None:
        from ...deploy.objective import as_objective
        from .baselines import zigzag
        # reward scale is anchored at the Zigzag deployment's score under the
        # *same* objective the rollouts are scored with
        baseline_cost = as_objective(cfg.objective).from_metrics(
            noc.evaluate(graph, zigzag(graph.n, noc)), noc)
    baseline_cost = max(baseline_cost, 1e-12)

    score = make_scorer(noc, graph, cfg.backend, cfg.objective,
                        recorder=recorder, device=dev)
    best_cost, best_placement = np.inf, None
    history = []
    for it in range(cfg.iterations):
        eps = (None if cfg.eps is None else torch.as_tensor(
            np.asarray(cfg.eps[it]), dtype=torch.float32, device=dev))
        # each phase ends waiting for its result, so the spans time the
        # device work too
        with maybe_span(recorder, "ppo.sample"):
            with torch.no_grad():
                mu, log_std = actor(lap, feats)
                acts, logp_old = ac.sample_actions(
                    mu, log_std, cfg.batch_size, generator=noise, eps=eps)
            acts_np = acts.cpu().numpy().astype(np.float64)
        with maybe_span(recorder, "ppo.discretize"):
            # the host float64 resolver is the discretizer of record
            placements = actions_to_placement_batch(
                acts_np, noc.rows, noc.cols, cfg.action_clip, priority)
        with maybe_span(recorder, "ppo.score"):
            costs = score(placements)    # whole rollout batch in one call
        b_min = int(costs.argmin())
        if costs[b_min] < best_cost:
            best_cost, best_placement = costs[b_min], placements[b_min]
        rewards = np.clip(cfg.reward_clip * (baseline_cost - costs) / baseline_cost,
                          -cfg.reward_clip, cfg.reward_clip)
        with maybe_span(recorder, "ppo.update"):
            rewards = torch.as_tensor(rewards, dtype=torch.float32,
                                      device=dev)
            la, lc = ppo_update(actor, critic, opt_a, opt_c, lap, feats, acts,
                                logp_old, rewards, cfg.ppo_epochs, cfg.clip,
                                cfg.entropy_coef)
            la, lc = float(la), float(lc)
        history.append({
            "iter": it,
            "mean_cost": float(costs.mean()),
            "min_cost": float(costs[b_min]),
            "best_cost": float(best_cost),
            "actor_loss": la,
            "critic_loss": lc,
        })
        if recorder is not None:
            recorder.event("ppo.iter", **history[-1])
    return PPOState(actor, critic, opt_a, opt_c, history, float(best_cost),
                    best_placement)
