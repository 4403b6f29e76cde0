"""The port's deterministic data pipeline against the reference's (ports
of ``tests/test_integration.py``'s data cases): every batch bit for bit the
reference's, for every ``(config, step, shard, n_shards)`` drawn."""
import numpy as np
import pytest

from repro.data import pipeline as r_pipeline
from repro_torch.data import pipeline

CASES = [(step, shard, n) for n in (1, 2, 4) for shard in range(n)
         for step in (0, 5, 123456)]


@pytest.mark.parametrize("distribution", ["zipf", "uniform"])
def test_batch_for_step_bitwise_like_reference(distribution):
    kw = dict(vocab_size=1000, seq_len=16, global_batch=8, seed=3,
              distribution=distribution)
    cfg, r_cfg = pipeline.DataConfig(**kw), r_pipeline.DataConfig(**kw)
    for step, shard, n in CASES:
        got = pipeline.batch_for_step(cfg, step, shard, n)
        ref = r_pipeline.batch_for_step(r_cfg, step, shard, n)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype == np.int32
            assert got[k].shape == (8 // n, 16)
            np.testing.assert_array_equal(got[k], ref[k])


def test_data_determinism_and_sharding():
    cfg = pipeline.DataConfig(vocab_size=100, seq_len=8, global_batch=8)
    b1 = pipeline.batch_for_step(cfg, 5, shard=0, n_shards=2)
    b2 = pipeline.batch_for_step(cfg, 5, shard=0, n_shards=2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = pipeline.batch_for_step(cfg, 5, shard=1, n_shards=2)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    # targets are next-token shifted
    full = pipeline.batch_for_step(cfg, 0)
    np.testing.assert_array_equal(full["tokens"][:, 1:],
                                  full["targets"][:, :-1])
    with pytest.raises(ValueError, match="divide"):
        pipeline.batch_for_step(cfg, 0, shard=0, n_shards=3)


@pytest.mark.parametrize("start", [0, 7])
def test_prefetching_loader(start):
    """The loader yields consecutive steps from ``start_step``, each the
    reference's batch for that step and shard."""
    kw = dict(vocab_size=50, seq_len=4, global_batch=4)
    cfg, r_cfg = pipeline.DataConfig(**kw), r_pipeline.DataConfig(**kw)
    loader = pipeline.PrefetchingLoader(cfg, shard=1, n_shards=2,
                                        start_step=start, prefetch=2)
    try:
        seen = [next(loader) for _ in range(3)]
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    assert [s for s, _ in seen] == [start, start + 1, start + 2]
    for step, batch in seen:
        ref = r_pipeline.batch_for_step(r_cfg, step, 1, 2)
        np.testing.assert_array_equal(batch["tokens"], ref["tokens"])
        np.testing.assert_array_equal(batch["targets"], ref["targets"])
