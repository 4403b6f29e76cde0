"""``repro_torch.data`` — the deterministic, shard-aware synthetic token
stream (``pipeline``) that checkpoint recovery replays."""
