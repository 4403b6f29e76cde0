"""Where zamba2-7b's bf16 prefill parts from fp32, group by group.

    PYTHONPATH=src python -m repro_torch.launch.drift [--prompt-len 4096]

Full-width zamba2-7b with random weights from seed 0 and the serve entry
point's prompts (``launch.serve.lm_inputs``, seed 0, batch 2) prefilled
group by group, as ``zamba2.decode_step`` does (a group's mamba layers from
zeroed states, then the shared block over the KV cache), four ways: bf16
on the ``hopper`` backend (K6) and on ``torch`` (the scan), and the same
tree cast to fp32 on both. After each group it prints the relative
difference of the last token's hidden state between the two bf16 runs and
of each from the fp32 ``torch`` run, then the same for the logits (max
abs). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.serve import lm_inputs
from repro_torch.models import zamba2
from repro_torch.models.layers import _tree_map, layer_at, rms_norm
from repro_torch.models.mamba2 import mamba_block_cached
from repro_torch.train import steps


@torch.no_grad()
def prefill_by_group(params, cfg, tokens: torch.Tensor, backend: str):
    """(last-token hidden state after each group, last-token logits) of a
    prefill into a fresh cache."""
    per, n_groups, tail = zamba2._geometry(cfg)
    cache = zamba2.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                              tokens.device)
    x = params["embed"][tokens.long()]
    states = []
    for g in range(n_groups):
        for i in range(per):
            x = mamba_block_cached(
                [layer_at(params["groups"], g, i)], [x], cfg,
                [cache["groups_conv"][g, i]], [cache["groups_ssm"][g, i]],
                zero_state=True)[0]
        x = zamba2._shared_block(
            [params["shared"]], [x], cfg,
            caches=[{"k": cache["attn_k"][g], "v": cache["attn_v"][g]}],
            cache_pos=0, backend=backend)[0]
        states.append(x[:, -1].float())
    for i in range(tail):
        x = mamba_block_cached([layer_at(params["tail"], i)], [x], cfg,
                               [cache["tail_conv"][i]],
                               [cache["tail_ssm"][i]], zero_state=True)[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return states, (x[:, -1] @ params["lm_head"]).float()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt-len", type=int, default=4096)
    args = ap.parse_args()
    dev = resolve_device(None)
    cfg = get_config("zamba2-7b")
    params = steps.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    _, prompts, _ = lm_inputs(cfg, params, np.random.default_rng(0), 2,
                              args.prompt_len, "torch", dev)
    tokens = torch.from_numpy(prompts).to(dev)
    runs = {("bf16", b): prefill_by_group(params, cfg, tokens, b)
            for b in ("hopper", "torch")}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = _tree_map(lambda t: t.float(), params)
    runs.update({("fp32", b): prefill_by_group(params, cfg32, tokens, b)
                 for b in ("hopper", "torch")})
    name = torch.cuda.get_device_name(dev)
    print(f"zamba2-7b, random weights (seed 0), prompt {args.prompt_len} "
          f"x2, on {name}: last-token hidden state, relative difference")
    rel = lambda a, b: float((a - b).norm() / b.norm())
    (bh, lh), (bt, lt) = runs["bf16", "hopper"], runs["bf16", "torch"]
    (fh, lfh), (ft, lft) = runs["fp32", "hopper"], runs["fp32", "torch"]
    for g in range(len(bh)):
        print(f"group {g:2d}: bf16 hopper vs torch {rel(bh[g], bt[g]):.3e};"
              f" from fp32 torch: bf16 hopper {rel(bh[g], ft[g]):.3e}, "
              f"bf16 torch {rel(bt[g], ft[g]):.3e}, fp32 hopper "
              f"{rel(fh[g], ft[g]):.3e}")
    mx = lambda a, b: float((a - b).abs().max())
    print(f"logits, max|diff| (max|logit| {float(lft.abs().max()):.3f}): "
          f"bf16 hopper vs torch {mx(lh, lt):.3e}; from fp32 torch: bf16 "
          f"hopper {mx(lh, lft):.3e}, bf16 torch {mx(lt, lft):.3e}, fp32 "
          f"hopper {mx(lfh, lft):.3e}")


if __name__ == "__main__":
    main()
