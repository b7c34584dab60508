"""The port's token server against the JAX package, on the CPU.

``generate``'s greedy tokens must equal the reference's, seed for seed,
under weights carried across. A greedy token is an argmax, so a float32
difference between the two packages could flip it only where the top two
logits nearly tie: the test first asserts, on the reference's own path,
that every step's top-2 margin exceeds 1e-3 (a hundred times the logits'
parity tolerance, 1e-5 here, ``test_torch_lm.py``'s 1e-4 at worst); the
prompt seeds were chosen so that it holds. ``MicroBatchQueue`` is held to
the reference's own cases (``tests/test_service.py``).
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_reg  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models import specs as r_specs  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.launch import serve as p_serve  # noqa: E402
from repro_torch.launch.serve import MicroBatchQueue  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402

MARGIN = 1e-3


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _reference_margins(rp, rcfg, tokens, p):
    """Top-2 logit margins along the reference's own greedy path."""
    b, total = tokens.shape
    cache = r_specs.materialize(jax.random.PRNGKey(0),
                                r_lm.cache_specs(rcfg, b, total))
    logits, cache = r_lm.prefill(rp, rcfg, jnp.asarray(tokens[:, :p]), cache)
    margins = []
    for i in range(p, total):
        top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        logits, cache = r_lm.decode_step(rp, rcfg, cache,
                                         jnp.asarray(tokens[:, i:i + 1]),
                                         jnp.int32(i))
    return margins


@pytest.mark.parametrize("arch,seed", [("internlm2-1.8b", 0),
                                       ("h2o-danube-1.8b", 0),
                                       ("minicpm3-4b", 0),
                                       ("qwen3-moe-30b-a3b", 0),
                                       ("deepseek-v3-671b", 0),
                                       ("zamba2-2.7b", 0)])
def test_generate_greedy_tokens_match_reference(arch, seed):
    """Batch 2, a 30-token prompt (past h2o-danube's smoke window of 24, so
    decode reads a windowed cache; within zamba2's SSD chunk of 32), 6
    greedy tokens."""
    rcfg, pcfg = r_reg.get_smoke_config(arch), p_reg.get_smoke_config(arch)
    rp = r_specs.materialize(jax.random.PRNGKey(seed), r_lm.lm_specs(rcfg))
    pp = p_lm.from_reference_params(pcfg, _np_tree(rp), device="cpu")
    prompts = np.random.default_rng(seed).integers(0, rcfg.vocab, (2, 30))
    want = np.asarray(r_serve.generate(rp, rcfg, jnp.asarray(prompts,
                                                             jnp.int32), 6))
    margins = _reference_margins(rp, rcfg, want, 30)
    assert min(margins) > MARGIN, margins      # the precondition
    got = p_serve.generate(pp, pcfg, prompts, 6, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)


def test_generate_sampling_is_seeded():
    cfg = p_reg.get_smoke_config("internlm2-1.8b")
    from repro_torch.models.specs import materialize
    params = materialize(p_lm.lm_specs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    runs = [p_serve.generate(params, cfg, prompts, 5, temperature=1.5,
                             seed=s, device="cpu") for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    for r in runs:
        assert r.shape == (2, 13)
        assert torch.equal(r[:, :8], torch.as_tensor(prompts))
        assert int(r.min()) >= 0 and int(r.max()) < cfg.vocab


def test_main_serves_a_smoke_config_and_rejects_encdec(capsys):
    toks = p_serve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "10",
                         "--gen-len", "3"])
    assert toks.shape == (2, 13)
    assert "generated 6 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="enc-dec"):
        p_serve.main(["--arch", "seamless-m4t-medium", "--smoke", "--device",
                      "cpu"])
    # zamba2 (Mamba2 + the hybrid shared block) serves too
    toks = p_serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "10",
                         "--gen-len", "3"])
    assert toks.shape == (2, 13) and toks.dtype == torch.int64
    assert "generated 6 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
def test_main_serves_the_mla_and_moe_families(arch, capsys):
    toks = p_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "9", "--gen-len",
                         "4"])
    assert toks.shape == (2, 13) and toks.dtype == torch.int64
    assert "generated 8 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_main_serves_the_recurrent_families(arch, capsys):
    """The recurrent families through the launcher: a 32-token prompt (one
    zamba2 SSD chunk), 4 tokens each, with their state caches."""
    toks = p_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "32", "--gen-len",
                         "4"])
    assert toks.shape == (2, 36) and toks.dtype == torch.int64
    assert "generated 8 tokens" in capsys.readouterr().out


# ---- MicroBatchQueue (tests/test_service.py's cases) ---------------------------

def test_microbatch_queue_batches_and_propagates_errors():
    seen = []

    def process(items):
        seen.append(list(items))
        return [x * 2 for x in items]

    q = MicroBatchQueue(process, max_batch=4, window_s=0.05)
    out, threads = [None] * 4, []
    for i in range(4):
        def run(i=i):
            out[i] = q.submit(i, timeout=10)
        threads.append(threading.Thread(target=run))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert out == [0, 2, 4, 6]
    assert max(len(b) for b in seen) > 1    # at least one fused batch

    def boom(items):
        raise RuntimeError("kaput")

    qb = MicroBatchQueue(boom, window_s=0.0)
    with pytest.raises(RuntimeError, match="kaput"):
        qb.submit(1, timeout=10)
    qb.close()
    with pytest.raises(RuntimeError, match="closed"):
        qb.submit(2)
    q.close()


def test_microbatch_queue_result_count_mismatch():
    q = MicroBatchQueue(lambda items: [1, 2, 3], window_s=0.0)
    with pytest.raises(RuntimeError, match="returned 3 results"):
        q.submit("x", timeout=10)
    q.close()
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatchQueue(lambda items: items, max_batch=0)
