"""The port's synthetic data pipeline against the JAX package's, on the CPU.

The pipeline is numpy in both packages, so batches must be exactly equal
for every ``(seed, step)``; the reference's own properties (determinism,
shifted labels, vocab bounds, resume) are held on the port too.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.data import pipeline as r_pipe  # noqa: E402
from repro_torch.data import pipeline as p_pipe  # noqa: E402


@pytest.mark.parametrize("seed,step,vocab,batch,seq", [
    (0, 0, 100, 4, 16), (7, 3, 100, 4, 16), (1, 12, 37, 8, 32),
    (123, 5, 92544, 2, 64), (3, 999, 512, 1, 7)])
def test_batches_equal_the_reference(seed, step, vocab, batch, seq):
    rc = r_pipe.DataConfig(vocab=vocab, batch=batch, seq_len=seq, seed=seed)
    pc = p_pipe.DataConfig(vocab=vocab, batch=batch, seq_len=seq, seed=seed)
    want = r_pipe.global_batch(rc, step)
    got = p_pipe.global_batch(pc, step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for a, b in zip(p_pipe.batch_for_step(pc, step),
                    r_pipe.batch_for_step(rc, step)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reference_properties_hold():
    """Deterministic per step, steps differ, labels are the tokens shifted
    by one, tokens within the vocab, and a restart at step k reproduces
    the stream (the pipeline state is the step counter)."""
    cfg = p_pipe.DataConfig(vocab=37, batch=8, seq_len=32, seed=7)
    a1, b1 = p_pipe.batch_for_step(cfg, 3)
    a2, b2 = p_pipe.batch_for_step(cfg, 3)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    assert not np.array_equal(a1, p_pipe.batch_for_step(cfg, 4)[0])
    buf = p_pipe.global_batch(cfg, 3)
    np.testing.assert_array_equal(a1, buf[:, :-1])
    np.testing.assert_array_equal(b1, buf[:, 1:])
    assert a1.min() >= 0 and a1.max() < 37 and a1.shape == (8, 32)
    fresh = [p_pipe.batch_for_step(cfg, i)[0] for i in range(5)]
    np.testing.assert_array_equal(fresh[4], p_pipe.batch_for_step(cfg, 4)[0])
    assert p_pipe.PipelineState().step == 0


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


@pytest.mark.parametrize("step", [0, 3])
def test_batches_on_a_one_rank_mesh_equal_the_reference(one_rank, step):
    """Over a 1 x 1 mesh: int32 DTensors whose rows are the reference's
    sharded batch on its one-device mesh, exactly (each row from its own
    shard seed, so not ``global_batch``)."""
    from repro.launch.mesh import make_test_mesh as r_mesh
    from repro_torch.launch.mesh import make_test_mesh

    rc = r_pipe.DataConfig(vocab=37, batch=4, seq_len=16, seed=2)
    pc = p_pipe.DataConfig(vocab=37, batch=4, seq_len=16, seed=2)
    got = p_pipe.batch_for_step(pc, step, make_test_mesh((1, 1)))
    want = r_pipe.batch_for_step(rc, step, r_mesh((1, 1)))
    for a, b in zip(got, want):
        assert str(a.placements) == "(Shard(dim=0), Replicate())"
        np.testing.assert_array_equal(a.to_local().numpy(), np.asarray(b))
    buf = p_pipe.rows_for_step(pc, step, range(4))
    np.testing.assert_array_equal(got[0].to_local().numpy(), buf[:, :-1])
    assert not np.array_equal(buf, p_pipe.global_batch(pc, step))
