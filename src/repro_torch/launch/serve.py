"""Serving launcher (``repro.launch.serve``): batched prefill + decode with
KV caches on the card.

Drives ``lm.prefill`` once and then ``lm.decode_step`` step-locked over a
batch of prompts, greedy or with temperature sampling::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 4 --prompt-len 2048 --gen-len 32      # full width, one card
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --batch 4 --prompt-len 2048 --gen-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --device cpu --batch 2 --prompt-len 16 --gen-len 4

Attention (GQA, sliding window) and MLA models with dense or MoE MLPs
serve; their caches come from ``lm.cache_specs`` (K/V, or MLA's latent
``ckv``/``kr``). On the card, prefill's attention runs through the flash
kernel (``models.layers``). Weights are random, drawn from ``--seed``.

:class:`MicroBatchQueue` is the reusable continuous-batching front: a
thread-safe submit/drain queue that coalesces requests arriving within a
window into one batch for a caller-supplied batch processor (stdlib
threading only).
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from ..device import resolve_device


class MicroBatchQueue:
    """Coalesce concurrent submissions into micro-batches for one worker.

    ``process_batch`` is called from a single worker thread with a list of
    submitted items and must return one result per item, in order.
    :meth:`submit` blocks the calling thread until its item's result (or the
    batch's exception) is ready — the continuous-batching idiom: requests
    arriving within ``window_s`` of each other (up to ``max_batch``) share
    one processor dispatch.
    """

    _CLOSE = object()

    def __init__(self, process_batch, max_batch: int = 8,
                 window_s: float = 0.01):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._process = process_batch
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._pending: list = []          # [(item, event, slot)]
        self._wake = threading.Event()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, item, timeout: float | None = None):
        """Enqueue ``item``; block until its result is ready and return it
        (re-raising the batch's exception if processing failed)."""
        if self._closed:
            raise RuntimeError("queue is closed")
        done, slot = threading.Event(), {}
        with self._lock:
            self._pending.append((item, done, slot))
        self._wake.set()
        if not done.wait(timeout):
            raise TimeoutError(f"no result within {timeout}s")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker after the current batch; pending items still run."""
        self._closed = True
        self._wake.set()
        self._worker.join(timeout)

    def _run(self) -> None:
        while True:
            self._wake.wait()
            with self._lock:
                if not self._pending:
                    if self._closed:
                        return
                    self._wake.clear()
                    continue
            # batching window: let near-simultaneous submissions pile up
            if self.window_s > 0:
                deadline = time.perf_counter() + self.window_s
                while time.perf_counter() < deadline:
                    with self._lock:
                        if len(self._pending) >= self.max_batch:
                            break
                    time.sleep(min(0.001, self.window_s))
            with self._lock:
                batch = self._pending[:self.max_batch]
                del self._pending[:self.max_batch]
                if not self._pending:
                    self._wake.clear()
                    if self._closed:
                        self._wake.set()   # drain remaining then exit
            items = [it for it, _, _ in batch]
            try:
                results = self._process(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"process_batch returned {len(results)} results "
                        f"for {len(items)} items")
                for (_, done, slot), res in zip(batch, results):
                    slot["result"] = res
                    done.set()
            except Exception as e:  # noqa: BLE001 — propagate to submitters
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()


def generate(params, cfg, prompts, gen_len: int, max_len: int | None = None,
             temperature: float = 0.0, seed: int = 0, device=None):
    """prompts [B, P] int -> tokens [B, P + gen_len] (int64) on ``device``
    (``None``: the card). Greedy (the argmax) if ``temperature`` is 0, else
    sampled from ``softmax(logits / temperature)`` with a ``torch.Generator``
    seeded by ``seed``. The zero cache comes from ``lm.cache_specs``; prefill
    runs once, then one decode step per token (the last one's logits go
    unused, as in the reference), updating the cache in place."""
    from ..models import lm
    from ..models.specs import materialize

    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev).long()
    b, p = prompts.shape
    max_len = max_len or (p + gen_len)
    cache = materialize(lm.cache_specs(cfg, b, max_len), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [prompts]
    with torch.inference_mode():
        logits, cache = lm.prefill(params, cfg, prompts, cache)
        for i in range(gen_len):
            last = logits[:, -1]
            if temperature > 0:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = torch.argmax(last, dim=-1, keepdim=True)
            out.append(tok)
            logits, cache = lm.decode_step(params, cfg, cache, tok, p + i)
    return torch.cat(out, dim=1)


def main(argv=None):
    from ..configs.registry import get_config, get_smoke_config
    from ..models import lm
    from ..models.encdec import EncDecConfig
    from ..models.specs import materialize

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if isinstance(cfg, EncDecConfig):
        raise SystemExit("use examples/seamless_serve for enc-dec serving")
    dev = resolve_device(args.device)
    params = materialize(lm.lm_specs(cfg),
                         torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    toks = generate(params, cfg, prompts, args.gen_len,
                    temperature=args.temperature, seed=args.seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen_len
    print(f"generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s incl. prefill) on {dev}")
    print("sample:", toks[0, -args.gen_len:].tolist())
    return toks


if __name__ == "__main__":
    main()
